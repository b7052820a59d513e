"""K2, one stereo Wiener-EM iteration over every bucket
(`xumx_slicq::wiener_em_grouped`).

Its own work, from the recorded shapes: the packed mixture x (n complex64)
and the magnitudes v (4 n float32) read once, the estimates (4 n
complex64) written once: 56 bytes an element of x. Its few hundred
operations a stereo position are left out: against 495 TFLOP/s they are
under 1% of the byte time, so the bound is the bytes.
"""

OP = "xumx_slicq::wiener_em_grouped"


def work(dims, concrete, geom=None):
    (n,), (nv,) = dims[0], dims[1]
    return 0.0, 8.0 * n + 4.0 * nv + 8.0 * nv
