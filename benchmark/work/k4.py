"""K4, the offline CDAE's four layers over every bucket
(`xumx_slicq::cdae_folded`), from the recorded size of the packed mixture
and the configuration's bucket table (`model.geometry`; the profiler does
not record the op's long int lists): the mixture holds B x C x S x sum of
F x M values, S the chunk's slices, which gives the chunk batch B.

Operations: 2 x the multiply-adds in which each input activation meets
each weight of a layer (no padding, no border zeros), over the four
layers: the convolutions' own work, once, however they are computed.
Bytes: the complex mixture read once (8 B a value), the weights once in
float32, the masks and the magnitudes written once (4 B each a value of
each target). The layers' intermediate activations are not counted: a
design that keeps them on chip need not move them.
"""

OP = "xumx_slicq::cdae_folded"


def layer_macs(B, C, F, S, T, fphi, n, h1, h2, tf2, realtime=False):
    """Multiply-adds of (enc1, enc2, dec1, dec2) for one bucket."""
    F1, K1 = F - fphi + 1, 2 * S if realtime else 2 * S - 1
    F2, K2 = F1 - fphi + 1, K1 - tf2 + 1
    a1, a2 = B * n * h1 * F1 * K1, B * n * h2 * F2 * K2
    return a1 * C * fphi * T, a2 * h1 * fphi * tf2, a2 * h1 * fphi * tf2, a1 * C * fphi * T


def work(dims, concrete, geom):
    (n,) = dims[0]
    realtime = bool(int(concrete[7]))
    C, S = geom["channels"], geom["slices"]
    per_b = C * S * sum(F * M for F, M in geom["buckets"])
    if n % per_b:
        raise ValueError(f"a packed mixture of {n} values is no chunk batch of {S} slices")
    B = n // per_b
    nt, h1, h2, tf2 = geom["targets"], geom["hidden_size_1"], geom["hidden_size_2"], geom["time_filter_2"]
    ops = nbytes = 0.0
    for (F, T), fphi in zip(geom["buckets"], geom["fphi"]):
        ops += 2.0 * sum(layer_macs(B, C, F, S, T, fphi, nt, h1, h2, tf2, realtime))
        a0 = B * C * F * S * T
        weights = nt * (2 * h1 * C * fphi * T + 2 * h2 * h1 * fphi * tf2 + h1 + h2 + h1 + C)
        nbytes += 8.0 * a0 + 4.0 * weights + 2 * 4.0 * nt * a0
    return ops, nbytes
