"""Multichannel Wiener-EM post-filter (norbert) in PyTorch.

Port of xumx_slicq_tpu/ops/wiener.py. The model path calls
`wiener(v, x, 1, use_softmask=False)` per bucket: mix-phase init, a
stability scale m = max(1, 0.1 max|x|) over the whole bucket (the chunk
batch included), exactly one EM iteration with the analytic 2x2 inverse,
and the scale undone.

`wiener_blocks` sends the stereo, one-iteration case -- the offline model's
path -- to kernel K2 (kernels/wiener_em.py), which works in the native
block layout over all buckets of a packed layout at once and carries the
gradient to the magnitudes through its backward kernel; every other case
runs the norbert-layout functions below (autograd of plain PyTorch).

Shape conventions of the norbert-layout functions:
    v: (B, frames, bins, ch, srcs) float  -- source magnitude estimates
    x: (B, frames, bins, ch) complex      -- mixture sliCQT
"""

from typing import List, Sequence

import numpy as np
import torch

from ..kernels.wiener_em import EPS, stability_scale, wiener_em_grouped
from .packed import PackedBlocks, pack


def _abs2(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 as re^2 + im^2: finite gradients at x == 0, where abs's are NaN."""
    return x.real ** 2 + x.imag ** 2


def _unit_phase(x: torch.Tensor) -> torch.Tensor:
    """exp(i angle(x)), and exactly 1 where x == 0 (angle's gradient at 0 is
    NaN; zeros occur in padded or silent audio)."""
    nonzero = _abs2(x) > 0.0
    safe = torch.where(nonzero, x, torch.ones_like(x))
    return safe / torch.sqrt(_abs2(safe))


def _invert2x2(M: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of (..., 2, 2) complex matrices
    (norbert/__init__.py:337-346)."""
    det = M[..., 0, 0] * M[..., 1, 1] - M[..., 0, 1] * M[..., 1, 0]
    inv_det = 1.0 / det
    row0 = torch.stack([inv_det * M[..., 1, 1], -inv_det * M[..., 0, 1]], dim=-1)
    row1 = torch.stack([-inv_det * M[..., 1, 0], inv_det * M[..., 0, 0]], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _invert(M: torch.Tensor, eps: float) -> torch.Tensor:
    nb_channels = M.shape[-1]
    if nb_channels == 1:
        return 1.0 / (M + eps)
    if nb_channels == 2:
        return _invert2x2(M)
    raise NotImplementedError("only 1 or 2 channels supported (as in the reference path)")


def expectation_maximization(y: torch.Tensor, x: torch.Tensor, iterations: int = 2, eps: float = None):
    """EM refinement of source estimates (norbert/__init__.py:10-150).

    y: (B, frames, bins, ch, srcs) complex initial estimates
    x: (B, frames, bins, ch) complex mixture
    Returns (y, v, R) as norbert does."""
    if eps is None:
        eps = EPS
    C = x.shape[-1]
    if C == 2:
        return _em_stereo(y, x, iterations, eps)

    reg = float(np.sqrt(eps)) * torch.eye(C, dtype=x.dtype, device=x.device)
    v = R = None
    for _ in range(iterations):
        v = torch.mean(_abs2(y), dim=3)                                  # (B,F,N,S)
        weight = torch.sum(v, dim=1) + eps                               # (B,N,S)
        cov = torch.einsum("bfncs,bfnds->bncds", y, y.conj())            # (B,N,C,C,S)
        R = cov / weight[:, :, None, None, :]
        Cxx = torch.einsum("bfns,bncds->bfncd", v.to(R.dtype), R) + reg
        inv_Cxx = _invert(Cxx, eps)
        G = torch.einsum("bncds,bfnde->bfnces", R, inv_Cxx) * v[:, :, :, None, None, :].to(R.dtype)
        y = torch.einsum("bfnces,bfne->bfncs", G, x)
    return y, v, R


def _em_stereo(y: torch.Tensor, x: torch.Tensor, iterations: int, eps: float):
    """C = 2 EM with the channel and source axes unrolled into explicit 2x2
    Hermitian algebra (same math as the einsum path / norbert); with
    invC = [[i00, i01], [conj(i01), i11]] and u = invC x, y_s = v_s R_s u."""
    if iterations <= 0:
        return y, None, None
    x0, x1 = x[..., 0], x[..., 1]                                        # (B,F,N)
    sqeps = float(np.sqrt(eps))
    nS = y.shape[-1]
    for _ in range(iterations):
        y0, y1 = y[..., 0, :], y[..., 1, :]                              # (B,F,N,S)
        a0, a1 = _abs2(y0), _abs2(y1)
        v = 0.5 * (a0 + a1)
        c00 = torch.sum(a0, dim=1)                                       # (B,N,S)
        c11 = torch.sum(a1, dim=1)
        c01 = torch.sum(y0 * torch.conj(y1), dim=1)
        w = 0.5 * (c00 + c11) + eps
        R00, R11, R01 = c00 / w, c11 / w, c01 / w
        A00 = sum(v[..., s] * R00[:, None, :, s] for s in range(nS)) + sqeps
        A11 = sum(v[..., s] * R11[:, None, :, s] for s in range(nS)) + sqeps
        A01 = sum(v[..., s] * R01[:, None, :, s] for s in range(nS))
        det = A00 * A11 - _abs2(A01)
        i00, i11 = A11 / det, A00 / det
        i01 = -A01 / det
        u0 = i00 * x0 + i01 * x1
        u1 = torch.conj(i01) * x0 + i11 * x1
        outs0 = [v[..., s] * (R00[:, None, :, s] * u0 + R01[:, None, :, s] * u1) for s in range(nS)]
        outs1 = [v[..., s] * (torch.conj(R01[:, None, :, s]) * u0 + R11[:, None, :, s] * u1) for s in range(nS)]
        y = torch.stack([torch.stack(outs0, dim=-1), torch.stack(outs1, dim=-1)], dim=-2)
    R = torch.stack([
        torch.stack([R00.to(x.dtype), R01], dim=-2),
        torch.stack([torch.conj(R01), R11.to(x.dtype)], dim=-2),
    ], dim=-3)                                                           # (B,N,C,C,S)
    return y, v, R


def softmask(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Single-channel ratio mask (norbert/__init__.py:263-309)."""
    total = torch.sum(v, dim=-1, keepdim=True)
    return v / (EPS + total) * x[..., None]


def wiener(v: torch.Tensor, x: torch.Tensor, iterations: int = 1, use_softmask: bool = False, eps: float = None) -> torch.Tensor:
    """Multichannel Wiener separation (norbert/__init__.py:153-260)."""
    if use_softmask:
        y = softmask(v, x)
    else:
        y = v.to(x.real.dtype) * _unit_phase(x)[..., None]
    if not iterations:
        return y
    max_abs = stability_scale(x)
    y = expectation_maximization(y / max_abs, x / max_abs, iterations, eps=eps)[0]
    return y * max_abs


# ---------------------------------------------------------------------------
# block-level wrappers over the sliCQT block layout
# ---------------------------------------------------------------------------


def blockwise_wiener(mix_block: torch.Tensor, mag_est: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """Wiener-EM over one bucket in norbert layout (reference phase.py:18-69).

    mix_block: (B, C, F, S, M) complex; mag_est: (4, B, C, F, S, M) float.
    Returns (4, B, C, F, S, M) complex."""
    nb_targets, B, C, F, S, M = mag_est.shape
    x = mix_block.reshape(B, C, F, S * M).permute(0, 3, 2, 1)          # (B, frames, F, C)
    v = mag_est.reshape(nb_targets, B, C, F, S * M).permute(1, 4, 3, 2, 0)
    y = wiener(v, x, iterations=iterations, use_softmask=False)
    return y.permute(4, 0, 3, 2, 1).reshape(nb_targets, B, C, F, S, M)


def blockwise_phasemix_sep(mix_block: torch.Tensor, mag_est: torch.Tensor) -> torch.Tensor:
    """Mix-phase reconstruction Y = mag * exp(i angle(X)) (reference
    phase.py:96-113): the realtime model's post-filter."""
    return mag_est.to(mix_block.real.dtype) * _unit_phase(mix_block)[None]


def wiener_blocks(mix_blocks: Sequence[torch.Tensor], mag_blocks: Sequence[torch.Tensor], iterations: int = 1) -> List[torch.Tensor]:
    """Wiener-EM across the bucket list (phase.py:7-15). Stereo with one
    iteration -- the model path -- runs K2 as one grouped call over every
    bucket, on the blocks' own buffers when they are packed (as
    SliCQT.forward and Unmix make them), else on one copy of each list;
    it returns `PackedBlocks`. The rest runs blockwise_wiener."""
    if iterations != 1 or mix_blocks[0].shape[1] != 2:
        return [blockwise_wiener(x, v, iterations) for x, v in zip(mix_blocks, mag_blocks)]
    x, v = pack(mix_blocks), pack(mag_blocks, 4)
    if x.layout != v.layout:
        raise ValueError("wiener_blocks: mixture and magnitude blocks differ in shape")
    return PackedBlocks(wiener_em_grouped(x.packed, v.packed, x.layout), x.layout, 4)


def phasemix_blocks(mix_blocks: Sequence[torch.Tensor], mag_blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """blockwise_phasemix_sep across the bucket list (phase.py:122-126)."""
    return [blockwise_phasemix_sep(x, v) for x, v in zip(mix_blocks, mag_blocks)]


def partition_by_m(Ms: Sequence[int], Fs: Sequence[int], n_classes: int = 8) -> List[List[int]]:
    """Partition bucket indices into <= n_classes size classes by their time
    resolution M, minimizing total zero padding sum F_b * (M_class - M_b)
    via exact DP over the M-sorted order (xumx_slicq_tpu/ops/wiener.py:
    236-268). Returns a list of index lists; each class pads its members'
    M to the class maximum."""
    order = sorted(range(len(Ms)), key=lambda i: Ms[i])
    m = [Ms[i] for i in order]
    f = [Fs[i] for i in order]
    n = len(m)
    K = min(n_classes, n)
    cost = [[0] * (n + 1) for _ in range(n + 1)]
    for i in range(n):
        for j in range(i + 1, n + 1):
            mc = m[j - 1]
            cost[i][j] = sum(f[k] * (mc - m[k]) for k in range(i, j))
    INF = float("inf")
    dp = [[INF] * (K + 1) for _ in range(n + 1)]
    par = [[0] * (K + 1) for _ in range(n + 1)]
    dp[0][0] = 0
    for j in range(1, n + 1):
        for k in range(1, K + 1):
            for i in range(j):
                c = dp[i][k - 1] + cost[i][j]
                if c < dp[j][k]:
                    dp[j][k] = c
                    par[j][k] = i
    classes: List[List[int]] = []
    j, k = n, K
    while j > 0:
        i = par[j][k]
        classes.append([order[t] for t in range(i, j)])
        j, k = i, k - 1
    return classes[::-1]


def wiener_blocks_grouped(mix_blocks: Sequence[torch.Tensor], mag_blocks: Sequence[torch.Tensor],
                          iterations: int = 1, classes: Sequence[Sequence[int]] = None,
                          n_classes: int = 8) -> List[torch.Tensor]:
    """The JAX package's size-class grouped Wiener-EM (wiener.py:311-375),
    kept for its API. There it was a compile-time lever: one EM chain per
    class of M instead of one per bucket, exact per bucket. Here
    `wiener_blocks` already runs every bucket in one grouped K2 call, each
    with its own stability scale, so this calls it; `classes` and
    `n_classes` are accepted and have no effect."""
    return wiener_blocks(mix_blocks, mag_blocks, iterations)
