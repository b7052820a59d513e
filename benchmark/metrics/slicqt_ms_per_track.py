"""Device time under the program's `slicqt_forward` and `slicqt_backward`
ranges (SliCQT.forward and .backward: cuFFT, K3, K1, the overlap-add) a
profiled track, in ms. Layer: ops.slicqt. Moves demix_rate."""

LAYER = "ops.slicqt"
MOVES = "demix_rate"


def read(s):
    t = s["stage_s"].get("slicqt_forward", 0.0) + s["stage_s"].get("slicqt_backward", 0.0)
    return 1e3 * t / s["units"] if "demix_ops" in s and t > 0 else None
