"""K2: stereo Wiener-EM, one iteration, in the native block layout.

Replaces the XLA-fused `wiener` + `_em_stereo` chain of the JAX package
(xumx_slicq_tpu/ops/wiener.py:107-185, in the layout of
`_em_stereo_native`, :271-308) for one bucket:

    m   = max(1, 0.1 max|x|)                      one scalar over the bucket
    y_s = v_s e^{i angle(x)} / m                  mix-phase init, scaled
    c00, c11, c01 = sum over frames of |y_s0|^2, |y_s1|^2, y_s0 conj(y_s1)
    R_s = c / (0.5 (c00 + c11) + eps)             per (b, f, source)
    Cxx = sum_s v_s R_s + sqrt(eps) I             per (b, f, frame), v_s from y
    y_s = v_s R_s (Cxx^-1 x / m) * m

x: (B, 2, F, T) complex64 mixture, v: (4, B, 2, F, T) float32 magnitudes,
T = S * M frames. The Triton kernels (kernels/triton_wiener_em.py) run it in
two passes: a frame reduction, then one elementwise pass. Bound: bytes --
each position reads x (16 B) and v (32 B) and writes y (64 B), ~0.6 GB per
default stereo chunk over the 70 bark-262 buckets, ~0.18 ms at 3.35 TB/s.
`wiener_em_plain` is the same function in plain PyTorch: the wrapper uses it
for CPU tensors only.
"""

import numpy as np
import torch

EPS = float(np.finfo(np.float32).eps)


def stability_scale(x: torch.Tensor) -> torch.Tensor:
    """norbert's m = max(1, 0.1 max|x|) as a 0-dim float32 tensor, taken
    over the whole bucket (all chunks of the batch): a per-chunk maximum
    would change results whenever chunks are batched."""
    return torch.clamp(torch.amax(torch.abs(x)) * 0.1, min=1.0)


def wiener_em_plain(x: torch.Tensor, v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (B, 2, F, T), (4, B, 2, F, T), scale m ->
    (4, B, 2, F, T) complex64."""
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


def _check(x: torch.Tensor, v: torch.Tensor):
    if x.dtype != torch.complex64 or v.dtype != torch.float32:
        raise TypeError(f"wiener_em: need complex64 x and float32 v, got {x.dtype}, {v.dtype}")
    if x.dim() != 4 or x.shape[1] != 2:
        raise ValueError(f"wiener_em: x must be (B, 2, F, T), got {tuple(x.shape)}")
    if v.dim() != 5 or v.shape[0] != 4 or tuple(v.shape[1:]) != tuple(x.shape):
        raise ValueError(f"wiener_em: v must be (4, {', '.join(map(str, x.shape))}), got {tuple(v.shape)}")
    if not (x.is_contiguous() and v.is_contiguous()):
        raise ValueError("wiener_em: x and v must be contiguous")
    if x.device != v.device:
        raise ValueError(f"wiener_em: x on {x.device}, v on {v.device}")


def wiener_em(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K2 on CUDA tensors, its plain version on CPU tensors.

    x: (B, 2, F, T) complex64, v: (4, B, 2, F, T) float32, both contiguous.
    Returns (4, B, 2, F, T) complex64. `wiener_em.launches` counts kernel
    launches (one per call: the two passes of one bucket)."""
    _check(x, v)
    m = stability_scale(x)
    if x.device.type == "cpu":
        return wiener_em_plain(x, v, m)
    if x.device.type != "cuda":
        raise ValueError(f"wiener_em: unsupported device {x.device}")
    from . import triton_wiener_em

    y = triton_wiener_em.launch(x, v, m)
    wiener_em.launches += 1
    return y


wiener_em.launches = 0
