"""K5, one layer of the LSTM recurrence over every bucket, target and
direction (`xumx_slicq::lstm_recurrence`), from the recorded size of xp,
the op's batch, directions and targets, and the configuration's bucket
table (`model.geometry`: each bucket's M and hidden size H; the profiler
does not record the op's long int lists): xp holds targets x dirs x batch
x S x sum of M x 4H values, which gives the slices S, and a bucket's
sequences are S x M steps long.

Operations: 2 x the multiply-adds of W_hh h, 4H x H a step of each
sequence, plus ~10 a hidden unit a step for the gates and the cell.
Bytes: the input projections xp and W_hh read once, h written once, all
float32.
"""

OP = "xumx_slicq::lstm_recurrence"


def work(dims, concrete, geom):
    (n_xp,), (n_w,) = dims[0], dims[1]
    batch, dirs, targets = int(concrete[6]), int(concrete[7]), int(concrete[8])
    per_s = targets * dirs * batch * sum(M * 4 * H for (_, M), H in zip(geom["buckets"], geom["lstm_hidden"]))
    if n_xp % per_s:
        raise ValueError(f"xp of {n_xp} values fits no whole number of slices")
    S = n_xp // per_s
    ops = n_h = 0.0
    for (_, M), h in zip(geom["buckets"], geom["lstm_hidden"]):
        seqs_steps = targets * dirs * batch * S * M
        ops += seqs_steps * (8.0 * h * h + 10.0 * h)
        n_h += seqs_steps * h
    return ops, 4.0 * (n_xp + n_w + n_h)
