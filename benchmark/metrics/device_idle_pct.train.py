"""The profiled window's share in which nothing ran on the card (no
kernel, copy or fill), in %. Layer: device. Moves train_step_ms."""

LAYER = "device"
MOVES = "train_step_ms"


def read(s):
    if "train_ops" not in s or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
