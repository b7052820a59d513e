"""The whole train step's share of the card's peak, in %: the step's
operations (work/model.py: the mask model's products three times, the
data's transforms once) times the profiled steps, over the profiled
window's seconds, against the dense TF32 peak. Layer: device. Moves
train_step_ms."""

from harness import PEAKS

LAYER = "device"
MOVES = "train_step_ms"


def read(s):
    if "train_ops" not in s or s["busy_s"] <= 0:
        return None
    return 100.0 * s["train_ops"] / s["window_s"] / PEAKS["tf32_flops"]
