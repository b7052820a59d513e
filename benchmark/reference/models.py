"""The mask models and the Wiener-EM in plain PyTorch, from named weights.

The offline xumx-sliCQ-V2 model (sevagh/xumx-sliCQ, xumx_slicq_v2/model.py):
per bucket of the sliCQT, a mask network for the 4 targets, the masks
times the mixture magnitude, then one iteration of norbert's stereo
Wiener-EM. The mask network is the CDAE (`_SlicedUnmixCDAE`, model.py:86)
or the bidirectional 3-layer LSTM (`_SlicedUnmixLSTM`, model.py:297-472).

Weights are a dict {name: tensor} in the layout `param_spec` gives:
`blocks.{k}.<leaf>`, the 4 targets stacked on the leading axis. The CDAE
runs its convs and BatchNorm unfolded (the program folds BatchNorm into
its kernels; nothing here reads that); the LSTM's recurrence is walked
step by step (`walk`). A frozen copy of the measured package's plain
module code, with these differences: the convs take the weights as
arguments, and the recurrence walks every bucket of a hidden-size class,
and every track handed in, together.
"""

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

NB_TARGETS = 4
EPS = float(np.finfo(np.float32).eps)
BN_EPS = 1e-5
LSTM_LAYERS = 3
PAD_CLASSES = (2, 9)      # the walk pads hidden sizes up to these (larger ones walk alone)


def freq_filter(F: int) -> int:
    """The CDAE's frequency kernel 1/3/5 by block height (model.py:112-117)."""
    return 1 if F < 10 else 3 if F < 20 else 5


# -- the parameters ------------------------------------------------------------


def lstm_sizes(C: int, F: int) -> Tuple[int, bool, int]:
    """(h1, downsample, H) of the offline LSTM for a (C, F) bucket."""
    fc = F * C
    down = F > 10
    h1 = fc // 2 if down else fc
    return h1, down, h1 // 2 + h1 % 2


def param_spec(config: dict, shapes) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every weight and BatchNorm buffer of the model
    over the buckets `shapes` ((B, C, F, S, M) each); init names the draw
    (`weights.py`)."""
    spec, n = [], NB_TARGETS
    for k, (_, C, F, _, T) in enumerate(shapes):
        p = f"blocks.{k}."
        if config["model"] == "cdae":
            h1, h2, tf2, fphi = config["hidden_size_1"], config["hidden_size_2"], config["time_filter_2"], freq_filter(F)
            spec += [(p + "enc1_w", (n * h1, C, fphi, T), "fan"), (p + "enc2_w", (n * h2, h1, fphi, tf2), "fan"),
                     (p + "dec1_w", (n * h2, h1, fphi, tf2), "fan"), (p + "dec2_w", (n * h1, C, fphi, T), "fan"),
                     (p + "dec2_b", (n * C,), f"bound:{(C * fphi * T) ** -0.5}"),
                     (p + "input_mean", (F,), "whiten_mean"), (p + "input_scale", (F,), "whiten_scale")]
            for bn, ch in (("bn1", n * h1), ("bn2", n * h2), ("bn3", n * h1)):
                spec += [(p + f"{bn}.{leaf}", (ch,), leaf) for leaf in ("weight", "bias", "running_mean", "running_var")]
        else:
            h1, down, H = lstm_sizes(C, F)
            fc, dirs = F * C, 2
            if down:
                spec.append((p + "fc1_w", (n, h1, fc), "fan"))
                spec += [(p + f"bn1.{leaf}", (n * h1,), leaf) for leaf in ("weight", "bias", "running_mean", "running_var")]
            for layer in range(LSTM_LAYERS):
                inp = h1 if layer == 0 else H * dirs
                for leaf, shape in (("w_ih", (n, dirs, 4 * H, inp)), ("w_hh", (n, dirs, 4 * H, H)),
                                    ("b_ih", (n, dirs, 4 * H)), ("b_hh", (n, dirs, 4 * H))):
                    spec.append((p + f"{leaf}_l{layer}", shape, f"bound:{H ** -0.5}"))
            spec += [(p + "fc2_w", (n, h1, 2 * h1), "fan"), (p + "fc3_w", (n, fc, h1), "fan"),
                     (p + "fc3_b", (n, fc), f"bound:{h1 ** -0.5}")]
            spec += [(p + f"bn2.{leaf}", (n * h1,), leaf) for leaf in ("weight", "bias", "running_mean", "running_var")]
            spec += [(p + "input_mean", (F,), "whiten_mean"), (p + "input_scale", (F,), "whiten_scale")]
    return spec


# -- BatchNorm -----------------------------------------------------------------


def batch_norm(x, w: Dict[str, torch.Tensor], name: str, train: bool, dims, shape):
    """BatchNorm over `dims` with the affine and statistics of `name`,
    broadcast by `shape`. Train: the batch's mean and biased variance, the
    running buffers updated in place (momentum 0.1, unbiased variance)."""
    mean, var = w[name + ".running_mean"], w[name + ".running_var"]
    if train:
        n = x.numel() // mean.numel()
        m = x.mean(dims, keepdim=True)
        v = x.var(dims, unbiased=False, keepdim=True)
        with torch.no_grad():
            mean.mul_(0.9).add_(0.1 * m.reshape(mean.shape))
            var.mul_(0.9).add_(0.1 * v.reshape(var.shape) * (n / max(n - 1, 1)))
    else:
        m, v = mean.view(shape), var.view(shape)
    return (x - m) * torch.rsqrt(v + BN_EPS) * w[name + ".weight"].view(shape) + w[name + ".bias"].view(shape)


# -- the CDAE ------------------------------------------------------------------


def cdae_masks(w: Dict[str, torch.Tensor], k: int, x_mag: torch.Tensor, config: dict, train: bool = False):
    """Bucket k's masks (4, B, C, F, S, T) from its magnitude (B, C, F, S, T):
    whitening, conv (fphi, T) at stride T/2 over the slices laid end to end,
    a grouped conv, a grouped transposed conv, a grouped transposed conv
    (fphi, T) at stride T/2, BatchNorm and ReLU after the first three, a
    sigmoid on the first S*T outputs (model.py:86-200). The realtime model's
    enc1 is causal: the time axis left-padded by T - 1 (model.py:274-290)."""
    p = f"blocks.{k}."
    B, C, F, S, T = x_mag.shape
    hop, n = T // 2, NB_TARGETS
    ch = (1, -1, 1, 1)

    def bn(h, name):
        return batch_norm(h, w, p + name, train, (0, 2, 3), ch)

    x = (x_mag + w[p + "input_mean"][None, None, :, None, None]) * w[p + "input_scale"][None, None, :, None, None]
    x = x.reshape(B, C, F, S * T)
    if config["realtime"]:
        x = Fn.pad(x, (T - 1, 0))
    h = torch.relu(bn(Fn.conv2d(x, w[p + "enc1_w"], stride=(1, hop)), "bn1"))
    h = torch.relu(bn(Fn.conv2d(h, w[p + "enc2_w"], groups=n), "bn2"))
    h = torch.relu(bn(Fn.conv_transpose2d(h, w[p + "dec1_w"], groups=n), "bn3"))
    y = Fn.conv_transpose2d(h, w[p + "dec2_w"], w[p + "dec2_b"], stride=(1, hop), groups=n)
    return torch.sigmoid(y[..., : S * T]).reshape(B, n, C, F, S, T).transpose(0, 1)


# -- the LSTM ------------------------------------------------------------------


def _lstm_encode(w, k, x_mag):
    """(B, C, F, S, T) -> the sequences (4, frames, B, h1), through the
    whitening, the down-projection and the literal row-major reshapes of
    model.py:380-420 (a sequence's batch axis cuts across the chunk batch)."""
    p = f"blocks.{k}."
    B, C, F, S, T = x_mag.shape
    frames = S * T
    h1, down, _ = lstm_sizes(C, F)
    x = x_mag.reshape(B, C, F, frames)
    x = (x + w[p + "input_mean"][None, None, :, None]) * w[p + "input_scale"][None, None, :, None]
    h = x.reshape(-1, F * C)
    if down:
        h = torch.matmul(h, w[p + "fc1_w"].transpose(-1, -2))                     # (4, rows, h1)
        h = torch.tanh(batch_norm(h, w, p + "bn1", False, None, (NB_TARGETS, 1, -1)))
    else:
        h = h.expand(NB_TARGETS, *h.shape)
    return h.reshape(NB_TARGETS, frames, B, h1)


def _lstm_decode(w, k, h_seq, out, shape):
    p = f"blocks.{k}."
    B, C, F, S, T = shape
    h1, _, _ = lstm_sizes(C, F)
    h2 = torch.cat([h_seq, out], dim=-1).reshape(NB_TARGETS, -1, h_seq.shape[-1] + out.shape[-1])
    h2 = h2[..., : F * C] if h1 % 2 else h2
    h2 = torch.matmul(h2, w[p + "fc2_w"].transpose(-1, -2))
    h2 = torch.relu(batch_norm(h2, w, p + "bn2", False, None, (NB_TARGETS, 1, -1)))
    h3 = torch.sigmoid(torch.matmul(h2, w[p + "fc3_w"].transpose(-1, -2)) + w[p + "fc3_b"][:, None])
    return h3.reshape(NB_TARGETS, *shape)


def walk(xp: torch.Tensor, wt: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Many LSTM sequences of one hidden size P, walked together step by
    step from h = c = 0 (torch's gate order i, f, g, o).

    xp: (T, sequences, 4P), time-major; a sequence shorter than T runs on
    past its end on whatever follows (the caller drops those steps;
    sequences do not mix). wt: (sequences, P, 4P), each one's W_hh^T.
    Returns h (T, sequences, P). On a card, `block` steps at a time are
    replayed from one captured CUDA graph of the same operations, to spare
    the host a launch per operation."""
    T, n, G = xp.shape
    P = G // 4
    hs = torch.empty((T, n, P), dtype=xp.dtype, device=xp.device)
    c = torch.zeros((n, P), dtype=xp.dtype, device=xp.device)

    def step(x, h, out):
        g = torch.baddbmm(x[:, None], h[:, None], wt)[:, 0]
        s = torch.sigmoid(g)
        c.copy_(torch.addcmul(s[:, P: 2 * P] * c, s[:, :P], torch.tanh(g[:, 2 * P: 3 * P])))
        torch.mul(s[:, 3 * P:], torch.tanh(c), out=out)

    h = torch.zeros((n, P), dtype=xp.dtype, device=xp.device)
    t = 0
    if xp.is_cuda and T >= 2 * block:
        xin = torch.zeros((block, n, G), dtype=xp.dtype, device=xp.device)
        hin = torch.zeros((n, P), dtype=xp.dtype, device=xp.device)
        hout = torch.empty((block, n, P), dtype=xp.dtype, device=xp.device)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):                    # warm-up before capture, as CUDA graphs ask
            for _ in range(2):
                step(xin[0], hin, hout[0])
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            prev = hin
            for k in range(block):
                step(xin[k], prev, hout[k])
                prev = hout[k]
        c.zero_()
        while t + block <= T:
            xin.copy_(xp[t: t + block])
            hin.copy_(h)
            graph.replay()
            hs[t: t + block].copy_(hout)
            h = hs[t + block - 1]
            t += block
        del graph
    for s in range(t, T):
        step(xp[s], h, hs[s])
        h = hs[s]
    return hs


def lstm_masks(w: Dict[str, torch.Tensor], batches: Sequence[Sequence[torch.Tensor]]) -> List[List[torch.Tensor]]:
    """The eval-mode LSTM masks of several chunk batches (one per track),
    each a list of per-bucket magnitudes: per bucket and track the
    sequences of model.py:380-472, every bucket's and track's recurrence
    of one layer walked together by hidden-size class."""
    nb = len(batches[0])
    seqs = [[_lstm_encode(w, k, x[k]) for k in range(nb)] for x in batches]      # (4, frames, B, h1)
    first = seqs
    for layer in range(LSTM_LAYERS):
        seqs = _lstm_layer(w, layer, seqs)
    return [[_lstm_decode(w, k, first[t][k], seqs[t][k], batches[t][k].shape) for k in range(nb)]
            for t in range(len(batches))]


def _lstm_layer(w, layer, seqs):
    """One bidirectional layer over every (track, bucket): (4, frames, B, in)
    -> (4, frames, B, 2H)."""
    items = []          # (track, bucket, H, frames, B, xp (4, 2, frames, B, 4H))
    for t, per_bucket in enumerate(seqs):
        for k, x in enumerate(per_bucket):
            p = f"blocks.{k}."
            wih, bih, bhh = w[p + f"w_ih_l{layer}"], w[p + f"b_ih_l{layer}"], w[p + f"b_hh_l{layer}"]
            n, frames, B, _ = x.shape
            xp = torch.matmul(x.reshape(n, 1, frames * B, -1), wih.transpose(-1, -2))
            xp = (xp + bih[:, :, None] + bhh[:, :, None]).reshape(n, 2, frames, B, -1)
            items.append((t, k, wih.shape[2] // 4, frames, B, xp))
    out = {}
    for P, members in _classes(items):
        T = max(m[3] for m in members)
        rows = [4 * 2 * m[4] for m in members]
        xpad = torch.zeros((T, sum(rows), 4 * P), dtype=members[0][5].dtype, device=members[0][5].device)
        wts, r0 = [], 0
        for (t, k, H, frames, B, xp), nseq in zip(members, rows):
            # walk order: direction 1 reversed; sequences (target, direction, row); gates padded to P
            xw = torch.stack([xp[:, 0], xp[:, 1].flip(1)], 1).permute(0, 1, 3, 2, 4)    # (4, 2, B, frames, 4H)
            xw = Fn.pad(xw.reshape(4, 2, B, frames, 4, H), (0, P - H)).reshape(nseq, frames, 4 * P)
            xpad[:frames, r0: r0 + nseq] = xw.transpose(0, 1)
            whh = w[f"blocks.{k}.w_hh_l{layer}"].transpose(-1, -2).reshape(4, 2, H, 4, H)
            wt = Fn.pad(whh, (0, P - H, 0, 0, 0, P - H)).reshape(4, 2, 1, P, 4 * P).expand(4, 2, B, P, 4 * P)
            wts.append(wt.reshape(nseq, P, 4 * P))
            r0 += nseq
        hs = walk(xpad, torch.cat(wts))
        del xpad
        r0 = 0
        for (t, k, H, frames, B, _), nseq in zip(members, rows):
            h = hs[:frames, r0: r0 + nseq].transpose(0, 1).reshape(4, 2, B, frames, P)[..., :H]
            h = torch.cat([h[:, 0], h[:, 1].flip(2)], dim=-1)                         # (4, B, frames, 2H)
            out[(t, k)] = h.transpose(1, 2).contiguous()
            r0 += nseq
        del hs
    return [[out[(t, k)] for k in range(len(per_bucket))] for t, per_bucket in enumerate(seqs)]


def _classes(items):
    """The walk classes: each item into the smallest PAD_CLASSES size that
    holds its H, larger H on their own."""
    classes = {}
    for it in items:
        H = it[2]
        P = next((c for c in PAD_CLASSES if c >= H), H)
        classes.setdefault(P, []).append(it)
    return sorted(classes.items())


# -- the Wiener-EM -------------------------------------------------------------


def _unit_phase(x):
    nz = (x.real ** 2 + x.imag ** 2) > 0.0
    safe = torch.where(nz, x, torch.ones_like(x))
    return safe / torch.sqrt(safe.real ** 2 + safe.imag ** 2)


def post_filter(config: dict, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The model's estimates from the mixture x and magnitudes v of one
    bucket: Wiener-EM offline; the realtime model keeps the mixture's phase
    (phase.py:96-113)."""
    return v * _unit_phase(x)[None] if config["realtime"] else wiener(x, v)


def wiener(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One EM iteration of norbert's stereo Wiener filter for one bucket
    (norbert/__init__.py:10-260, use_softmask=False): x (B, 2, F, S, M)
    complex mixture, v (4, B, 2, F, S, M) magnitudes -> (4, B, 2, F, S, M)
    complex estimates. Mix-phase init, the stability scale
    m = max(1, 0.1 max|x|) over the whole bucket, the analytic 2x2 inverse."""
    shape = v.shape
    x = x.reshape(*x.shape[:3], -1)
    v = v.reshape(*v.shape[:4], -1)
    m = torch.clamp(torch.amax(torch.abs(x)) * 0.1, min=1.0)
    inv_m2 = 1.0 / (m * m)
    ph = _unit_phase(x)
    va, vb = v[:, :, 0], v[:, :, 1]
    vv = 0.5 * (va * va + vb * vb) * inv_m2
    pab = ph[:, 0] * torch.conj_physical(ph[:, 1])
    c00, c11 = (va * va).sum(-1) * inv_m2, (vb * vb).sum(-1) * inv_m2
    c01 = (va * vb * pab).sum(-1) * inv_m2
    wgt = 0.5 * (c00 + c11) + EPS
    R00, R11, R01 = (c00 / wgt)[..., None], (c11 / wgt)[..., None], (c01 / wgt)[..., None]
    sqeps = float(np.sqrt(EPS))
    A00 = (vv * R00).sum(0) + sqeps
    A11 = (vv * R11).sum(0) + sqeps
    A01 = (vv * R01).sum(0)
    det = A00 * A11 - (A01.real ** 2 + A01.imag ** 2)
    i00, i11, i01 = A11 / det, A00 / det, -A01 / det
    xs0, xs1 = x[:, 0] / m, x[:, 1] / m
    U0 = i00 * xs0 + i01 * xs1
    U1 = torch.conj_physical(i01) * xs0 + i11 * xs1
    y0 = vv * (R00 * U0 + R01 * U1)
    y1 = vv * (torch.conj_physical(R01) * U0 + R11 * U1)
    return (torch.stack([y0, y1], dim=2) * m).reshape(shape)
