"""K1, the sliCQT synthesis assembly (`xumx_slicq::synth_assembly`): the
half spectrum of every synthesis slice from the flat per-bucket spectra.

Its own work, from the op's recorded input shapes: the spectra
(N, S, raw) complex64 read once and the half spectrum (N, S, nh) complex64
written once. Its weighted sums (a few operations a byte) and its small
tables are left out: against 495 TFLOP/s they are under 1% of the byte
time, so the bound is the bytes.
"""

OP = "xumx_slicq::synth_assembly"


def work(dims, concrete, geom=None):
    """(operations, bytes) of one call."""
    (N, S, raw), (nh, _) = dims[0], dims[1]
    return 0.0, 8.0 * N * S * (raw + nh)
