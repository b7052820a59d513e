"""The profiled window's share in which nothing ran on the card (no
kernel, copy or fill), in %. Layer: device. Moves demix_rate."""

LAYER = "device"
MOVES = "demix_rate"


def read(s):
    if "demix_ops" not in s or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
