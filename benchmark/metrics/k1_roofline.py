"""K1, the synthesis assembly (synth_assembly): the share of its roofline over the profiled
tracks, in %: the least time its calls could take on the card (work/k1.py
over peaks.json) over the device time they took. Layer: kernels. Moves
demix_rate."""

from harness import roofline

LAYER = "kernels"
MOVES = "demix_rate"


def read(s):
    return roofline(s, "k1") if "demix_ops" in s else None
