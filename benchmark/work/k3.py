"""K3, the sliCQT analysis gather and weight (`xumx_slicq::analysis_gather`).

Its own work, from the recorded shapes: the half spectrum X (N, S, nh)
complex64 read once (every position is read at bark-262) and the weighted
coefficients (N, S, K) complex64 written once. Six operations an output and
the small table are left out (under 1% of the byte time at 495 TFLOP/s).
"""

OP = "xumx_slicq::analysis_gather"


def work(dims, concrete, geom=None):
    (N, S, nh), (K, _) = dims[0], dims[1]
    return 0.0, 8.0 * N * S * (nh + K)
