"""The whole demix's share of the card's peak, in %: the model's operations
for the chunks the profiled tracks need (ceil(N / chunk) each, without the
chunk-batch padding; work/model.py) over the profiled window's seconds,
against the dense TF32 peak (peaks.json). Layer: device. Moves demix_rate."""

from harness import PEAKS

LAYER = "device"
MOVES = "demix_rate"


def read(s):
    if "demix_ops" not in s or s["busy_s"] <= 0:
        return None
    return 100.0 * s["demix_ops"] / s["window_s"] / PEAKS["tf32_flops"]
