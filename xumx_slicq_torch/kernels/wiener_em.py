"""K2: stereo Wiener-EM, one iteration, over every bucket of a packed layout.

Replaces the XLA-fused `wiener` + `_em_stereo` chain of the JAX package
(xumx_slicq_tpu/ops/wiener.py:107-185, in the layout of
`_em_stereo_native`, :271-308), which runs once per bucket. For each bucket k:

    m_k = max(1, 0.1 max|x|)                      one scalar over bucket k
    y_s = v_s e^{i angle(x)} / m_k                mix-phase init, scaled
    c00, c11, c01 = sum over frames of |y_s0|^2, |y_s1|^2, y_s0 conj(y_s1)
    R_s = c / (0.5 (c00 + c11) + eps)             per (b, f, source)
    Cxx = sum_s v_s R_s + sqrt(eps) I             per (b, f, frame), v_s from y
    y_s = v_s R_s (Cxx^-1 x / m_k) * m_k

Bucket k's x is (B, 2, F, T) complex64 and v (4, B, 2, F, T) float32,
T = S * M frames. m is per bucket and spans the whole chunk batch (the JAX
package computes it once per `wiener` call, :183): one m over a group of
buckets, or over one chunk, would change the result.

All buckets live in packed buffers (ops/packed.BucketLayout): x, v and y
of every bucket are contiguous views of one 1-D buffer each, so the whole
stage is one grouped call (`wiener_em_grouped`) and nothing is copied at
the bucket boundary. The Triton kernels (kernels/triton_wiener_em.py) run
it over tables of work items in three device launches: the per-bucket
max |x|^2 slots are zeroed, a frame reduction also takes each bucket's
max |x|^2 into its slot, then one elementwise pass. Bound: bytes -- each
position reads x (16 B) and v (32 B) and writes y (64 B). The plain
versions (`wiener_em_plain`, `wiener_em_grouped_plain`) are the same
function in plain PyTorch: the wrappers use them for CPU tensors only.
"""

import functools

import numpy as np
import torch

from ..ops.packed import BucketLayout

EPS = float(np.finfo(np.float32).eps)
CHUNK = 4096   # frames per pass-1 work item
BLOCK = 256    # frames per pass-2 work item


def work_items(layout: BucketLayout):
    """K2's tables for a layout. Per bucket, int64: [x offset, F, T,
    elements, pass-1 splits, first pass-1 item]. Work items, int32: pass 1
    [bucket, row, split] over CHUNK frames, pass 2 [bucket, row, block] over
    BLOCK frames, with row = b * F + f. Pass-1 items are in (bucket, row,
    split) order, so a row's partial sums are contiguous."""
    buckets, p1, p2 = [], [], []
    first = 0
    for k, ((B, C, F, S, M), off, n) in enumerate(zip(layout.shapes, layout.offsets, layout.sizes)):
        T = S * M
        splits, blocks = -(-T // CHUNK), -(-T // BLOCK)
        buckets.append([off, F, T, n, splits, first])
        rows = np.arange(B * F)
        for table, count in ((p1, splits), (p2, blocks)):
            r, c = np.meshgrid(rows, np.arange(count), indexing="ij")
            table.append(np.stack([np.full(r.size, k), r.ravel(), c.ravel()], axis=1))
        first += B * F * splits
    return (np.asarray(buckets, np.int64), np.concatenate(p1).astype(np.int32),
            np.concatenate(p2).astype(np.int32))


def stability_scale(x: torch.Tensor) -> torch.Tensor:
    """norbert's m = max(1, 0.1 max|x|) as a 0-dim float32 tensor, taken
    over one whole bucket (all chunks of the batch): a per-chunk maximum
    would change results whenever chunks are batched."""
    return torch.clamp(torch.amax(torch.abs(x)) * 0.1, min=1.0)


def wiener_em_plain(x: torch.Tensor, v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version for one bucket: (B, 2, F, T), (4, B, 2, F, T),
    scale m -> (4, B, 2, F, T) complex64."""
    sqeps = float(np.sqrt(EPS))
    nonzero = (x.real ** 2 + x.imag ** 2) > 0.0
    safe = torch.where(nonzero, x, torch.ones_like(x))
    phase = safe / torch.sqrt(safe.real ** 2 + safe.imag ** 2)         # 1 where x == 0
    y = (v * phase[None]) / m                                            # (S,B,C,F,T)
    xs = x / m
    x0, x1 = xs[:, 0], xs[:, 1]                                          # (B,F,T)
    y0, y1 = y[:, :, 0], y[:, :, 1]                                      # (S,B,F,T)
    a0 = y0.real ** 2 + y0.imag ** 2
    a1 = y1.real ** 2 + y1.imag ** 2
    vv = 0.5 * (a0 + a1)
    c00, c11 = a0.sum(-1), a1.sum(-1)                                    # (S,B,F)
    c01 = (y0 * torch.conj(y1)).sum(-1)
    w = 0.5 * (c00 + c11) + EPS
    R00, R11, R01 = (c00 / w)[..., None], (c11 / w)[..., None], (c01 / w)[..., None]
    A00 = (vv * R00).sum(0) + sqeps                                      # (B,F,T)
    A11 = (vv * R11).sum(0) + sqeps
    A01 = (vv * R01).sum(0)
    det = A00 * A11 - (A01.real ** 2 + A01.imag ** 2)
    i00, i11, i01 = A11 / det, A00 / det, -A01 / det
    u0 = i00 * x0 + i01 * x1
    u1 = torch.conj(i01) * x0 + i11 * x1
    out0 = vv * (R00 * u0 + R01 * u1)
    out1 = vv * (torch.conj(R01) * u0 + R11 * u1)
    return torch.stack([out0, out1], dim=2) * m


def _frames(block: torch.Tensor) -> torch.Tensor:
    """(..., F, S, M) -> (..., F, S * M), a view of a contiguous block."""
    return block.reshape(block.shape[:-2] + (-1,))


def wiener_em_grouped_plain(x: torch.Tensor, v: torch.Tensor, layout: BucketLayout) -> torch.Tensor:
    """Plain PyTorch version over a packed layout: every bucket through
    `wiener_em_plain` with its own stability scale. Returns the packed
    estimates (4 * layout.size,) complex64."""
    ys = []
    for xb, vb in zip(layout.split(x), layout.split(v, 4)):
        xb, vb = _frames(xb), _frames(vb)
        ys.append(wiener_em_plain(xb, vb, stability_scale(xb)).reshape(-1))
    return torch.cat(ys)


@functools.lru_cache(maxsize=64)
def _device_state(layout: BucketLayout, device: torch.device) -> dict:
    """K2's work tables, partial-sum buffer and per-bucket max |x|^2 slots
    for one layout on one device, built once."""
    buckets, items1, items2 = work_items(layout)
    return dict(
        buckets=torch.from_numpy(buckets).to(device),
        items1=torch.from_numpy(items1).to(device),
        items2=torch.from_numpy(items2).to(device),
        partials=torch.empty((items1.shape[0], 16), dtype=torch.float32, device=device),
        maxima=torch.empty(len(layout.shapes), dtype=torch.float32, device=device),
    )


def _check_grouped(x: torch.Tensor, v: torch.Tensor, layout: BucketLayout):
    if x.dtype != torch.complex64 or v.dtype != torch.float32:
        raise TypeError(f"wiener_em: need complex64 x and float32 v, got {x.dtype}, {v.dtype}")
    if x.dim() != 1 or x.numel() != layout.size or v.dim() != 1 or v.numel() != 4 * layout.size:
        raise ValueError(f"wiener_em_grouped: need packed x ({layout.size},) and v ({4 * layout.size},), "
                         f"got {tuple(x.shape)}, {tuple(v.shape)}")
    if any(s[1] != 2 for s in layout.shapes):
        raise ValueError("wiener_em_grouped: every bucket must be stereo")
    if not (x.is_contiguous() and v.is_contiguous()):
        raise ValueError("wiener_em: x and v must be contiguous")
    if x.device != v.device:
        raise ValueError(f"wiener_em: x on {x.device}, v on {v.device}")


def wiener_em_grouped(x: torch.Tensor, v: torch.Tensor, layout: BucketLayout) -> torch.Tensor:
    """K2 over every bucket of `layout` on CUDA tensors, its plain version
    on CPU tensors.

    x: packed mixture (layout.size,) complex64, v: packed magnitudes
    (4 * layout.size,) float32. Returns the packed estimates
    (4 * layout.size,) complex64 (`PackedBlocks(y, layout, 4)` views them
    per bucket). Three device launches per call, each counted in
    `wiener_em.launches`: zero the max slots, pass 1, pass 2."""
    _check_grouped(x, v, layout)
    if x.device.type == "cpu":
        return wiener_em_grouped_plain(x, v, layout)
    if x.device.type != "cuda":
        raise ValueError(f"wiener_em: unsupported device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or v.requires_grad):
        raise NotImplementedError("wiener_em: K2 has no backward kernel; call it under no_grad on a CUDA tensor")
    from . import triton_wiener_em

    state = _device_state(layout, x.device)
    y = torch.empty(4 * layout.size, dtype=torch.complex64, device=x.device)
    state["maxima"].zero_()                        # pass 1 takes each bucket's max into its slot
    wiener_em.launches += 1
    triton_wiener_em.pass1(x, v, state)
    wiener_em.launches += 1
    triton_wiener_em.pass2(x, v, state, y)
    wiener_em.launches += 1
    return y


def _check(x: torch.Tensor, v: torch.Tensor):
    if x.dim() != 4 or x.shape[1] != 2:
        raise ValueError(f"wiener_em: x must be (B, 2, F, T), got {tuple(x.shape)}")
    if v.dim() != 5 or v.shape[0] != 4 or tuple(v.shape[1:]) != tuple(x.shape):
        raise ValueError(f"wiener_em: v must be (4, {', '.join(map(str, x.shape))}), got {tuple(v.shape)}")
    if not (x.is_contiguous() and v.is_contiguous()):
        raise ValueError("wiener_em: x and v must be contiguous")


def wiener_em(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K2 for one bucket: a one-bucket `wiener_em_grouped` call.

    x: (B, 2, F, T) complex64, v: (4, B, 2, F, T) float32, both contiguous.
    Returns (4, B, 2, F, T) complex64. `wiener_em.launches` counts K2's
    device kernel launches, whichever wrapper made them."""
    _check(x, v)
    B, _, F, T = x.shape
    return wiener_em_grouped(x.reshape(-1), v.reshape(-1), BucketLayout([(B, 2, F, 1, T)])).view(v.shape)


wiener_em.launches = 0
