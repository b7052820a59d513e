"""Device time under the program's `mask_model_and_wiener` range
(Unmix.apply: the mask model, K4 or the LSTM with K5, and K2's Wiener-EM)
a profiled track, in ms. Layer: models and ops.wiener. Moves demix_rate."""

LAYER = "models + ops.wiener"
MOVES = "demix_rate"


def read(s):
    t = s["stage_s"].get("mask_model_and_wiener", 0.0)
    return 1e3 * t / s["units"] if "demix_ops" in s and t > 0 else None
