"""Triton kernels of K2, the stereo Wiener-EM (see kernels/wiener_em.py for
the function, its plain version and the wrapper).

This module imports triton at the top, as Triton's JIT requires of the
module that defines a kernel; only the wrapper imports it, inside the call
that launches on a CUDA tensor, so nothing here loads on a machine without
a card.

Design, for a bucket x (B, 2, F, T), v (4, B, 2, F, T):
* pass 1, grid (B*F rows, ceil(T / CHUNK) splits): each program walks
  CHUNK frames of one row in BLOCK steps and writes the partial frame sums
  c00, c11, Re c01, Im c01 of the 4 sources (16 floats). Splitting the
  frame axis keeps the card busy for the buckets with few rows and long
  rows (F = 1, S*M up to 85,264 at the default chunk);
* pass 2, grid (B*F rows, ceil(T / BLOCK) blocks): each program sums its
  row's partials, forms R, then for BLOCK frames recomputes the scaled init
  y from x and v (cheaper than storing it), the Hermitian Cxx + sqrt(eps) I,
  its analytic inverse and the filtered outputs, and writes y.
Complex values travel as interleaved (re, im) float32 pairs
(`torch.view_as_real`); the two strided loads of one pair hit the same
cache lines. Both passes read x and v once from device memory (pass 2's
second read mostly from L2 for the small buckets); nothing but the 16
partial sums per split is written besides y.
"""

import torch
import triton
import triton.language as tl

from .wiener_em import EPS

CHUNK = 4096   # frames per pass-1 program
BLOCK = 256    # frames per step (pass 1) and per program (pass 2)


@triton.jit
def _unit_phase(re, im):
    # exp(i angle(x)); exactly 1 where x == 0
    nz = (re * re + im * im) > 0.0
    sre = tl.where(nz, re, 1.0)
    sim = tl.where(nz, im, 0.0)
    r = tl.sqrt(sre * sre + sim * sim)
    return sre / r, sim / r


@triton.jit(do_not_specialize=["F", "T", "n_split", "v_stride"])
def _em_pass1(x_ptr, v_ptr, m_ptr, part_ptr, F, T, n_split, v_stride,
              CHUNK: tl.constexpr, BLOCK: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)            # b * F + f
    split = tl.program_id(1)
    b = row // F
    f = row - b * F
    m = tl.load(m_ptr)
    x0 = x_ptr + (b * 2 * F + f) * T * 2           # channel 0 of (b, f), floats
    x1 = x0 + F * T * 2
    v0 = v_ptr + (b * 2 * F + f) * T               # source 0, channel 0
    v1 = v0 + F * T
    src = tl.arange(0, 4).to(tl.int64)[:, None] * v_stride
    acc00 = tl.zeros((4, BLOCK), tl.float32)
    acc11 = tl.zeros((4, BLOCK), tl.float32)
    acc01r = tl.zeros((4, BLOCK), tl.float32)
    acc01i = tl.zeros((4, BLOCK), tl.float32)
    for k in range(0, CHUNK, BLOCK):
        t = split * CHUNK + k + tl.arange(0, BLOCK)
        mask = t < T
        u0r, u0i = _unit_phase(tl.load(x0 + 2 * t, mask=mask, other=0.0),
                               tl.load(x0 + 2 * t + 1, mask=mask, other=0.0))
        u1r, u1i = _unit_phase(tl.load(x1 + 2 * t, mask=mask, other=0.0),
                               tl.load(x1 + 2 * t + 1, mask=mask, other=0.0))
        va = tl.load(v0 + src + t[None, :], mask=mask[None, :], other=0.0)   # (4, BLOCK)
        vb = tl.load(v1 + src + t[None, :], mask=mask[None, :], other=0.0)
        y0r = va * u0r[None, :] / m
        y0i = va * u0i[None, :] / m
        y1r = vb * u1r[None, :] / m
        y1i = vb * u1i[None, :] / m
        acc00 += y0r * y0r + y0i * y0i
        acc11 += y1r * y1r + y1i * y1i
        acc01r += y0r * y1r + y0i * y1i             # y0 * conj(y1)
        acc01i += y0i * y1r - y0r * y1i
    out = part_ptr + (row * n_split + split) * 16 + tl.arange(0, 4)
    tl.store(out, tl.sum(acc00, axis=1))
    tl.store(out + 4, tl.sum(acc11, axis=1))
    tl.store(out + 8, tl.sum(acc01r, axis=1))
    tl.store(out + 12, tl.sum(acc01i, axis=1))


@triton.jit(do_not_specialize=["F", "T", "n_split", "v_stride"])
def _em_pass2(x_ptr, v_ptr, m_ptr, part_ptr, y_ptr, F, T, n_split, v_stride, eps, sqeps,
              BLOCK: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    blk = tl.program_id(1)
    b = row // F
    f = row - b * F
    m = tl.load(m_ptr)
    s4 = tl.arange(0, 4)
    c00 = tl.zeros((4,), tl.float32)
    c11 = tl.zeros((4,), tl.float32)
    c01r = tl.zeros((4,), tl.float32)
    c01i = tl.zeros((4,), tl.float32)
    for k in range(n_split):
        p = part_ptr + (row * n_split + k) * 16 + s4
        c00 += tl.load(p)
        c11 += tl.load(p + 4)
        c01r += tl.load(p + 8)
        c01i += tl.load(p + 12)
    w = 0.5 * (c00 + c11) + eps
    R00 = (c00 / w)[:, None]
    R11 = (c11 / w)[:, None]
    R01r = (c01r / w)[:, None]
    R01i = (c01i / w)[:, None]

    t = blk * BLOCK + tl.arange(0, BLOCK)
    mask = t < T
    x0 = x_ptr + (b * 2 * F + f) * T * 2
    x1 = x0 + F * T * 2
    x0r = tl.load(x0 + 2 * t, mask=mask, other=0.0)
    x0i = tl.load(x0 + 2 * t + 1, mask=mask, other=0.0)
    x1r = tl.load(x1 + 2 * t, mask=mask, other=0.0)
    x1i = tl.load(x1 + 2 * t + 1, mask=mask, other=0.0)
    u0r, u0i = _unit_phase(x0r, x0i)
    u1r, u1i = _unit_phase(x1r, x1i)
    v0 = v_ptr + (b * 2 * F + f) * T
    src = s4.to(tl.int64)[:, None] * v_stride
    va = tl.load(v0 + src + t[None, :], mask=mask[None, :], other=0.0)
    vb = tl.load(v0 + F * T + src + t[None, :], mask=mask[None, :], other=0.0)
    y0r = va * u0r[None, :] / m
    y0i = va * u0i[None, :] / m
    y1r = vb * u1r[None, :] / m
    y1i = vb * u1i[None, :] / m
    vv = 0.5 * ((y0r * y0r + y0i * y0i) + (y1r * y1r + y1i * y1i))       # (4, BLOCK)

    A00 = tl.sum(vv * R00, axis=0) + sqeps
    A11 = tl.sum(vv * R11, axis=0) + sqeps
    A01r = tl.sum(vv * R01r, axis=0)
    A01i = tl.sum(vv * R01i, axis=0)
    det = A00 * A11 - (A01r * A01r + A01i * A01i)
    i00 = A11 / det
    i11 = A00 / det
    i01r = -A01r / det
    i01i = -A01i / det
    xs0r = x0r / m
    xs0i = x0i / m
    xs1r = x1r / m
    xs1i = x1i / m
    # u = Cxx^-1 x / m, with Cxx^-1 = [[i00, i01], [conj(i01), i11]]
    u0r = i00 * xs0r + (i01r * xs1r - i01i * xs1i)
    u0i = i00 * xs0i + (i01r * xs1i + i01i * xs1r)
    u1r = (i01r * xs0r + i01i * xs0i) + i11 * xs1r
    u1i = (i01r * xs0i - i01i * xs0r) + i11 * xs1i
    u0r = u0r[None, :]
    u0i = u0i[None, :]
    u1r = u1r[None, :]
    u1i = u1i[None, :]
    # y_s0 = v_s (R00 u0 + R01 u1), y_s1 = v_s (conj(R01) u0 + R11 u1), times m
    o0r = vv * (R00 * u0r + (R01r * u1r - R01i * u1i)) * m
    o0i = vv * (R00 * u0i + (R01r * u1i + R01i * u1r)) * m
    o1r = vv * ((R01r * u0r + R01i * u0i) + R11 * u1r) * m
    o1i = vv * ((R01r * u0i - R01i * u0r) + R11 * u1i) * m
    y0 = y_ptr + (b * 2 * F + f) * T * 2
    offs = src * 2 + 2 * t[None, :]
    m2 = mask[None, :]
    tl.store(y0 + offs, o0r, mask=m2)
    tl.store(y0 + offs + 1, o0i, mask=m2)
    tl.store(y0 + F * T * 2 + offs, o1r, mask=m2)
    tl.store(y0 + F * T * 2 + offs + 1, o1i, mask=m2)


def launch(x: torch.Tensor, v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Run both passes on checked inputs (wiener_em validates them)."""
    B, _, F, T = x.shape
    y = torch.empty((4, B, 2, F, T), dtype=torch.complex64, device=x.device)
    xf = torch.view_as_real(x)
    yf = torch.view_as_real(y)
    n_split = triton.cdiv(T, CHUNK)
    part = torch.empty((B * F, n_split, 16), dtype=torch.float32, device=x.device)
    v_stride = B * 2 * F * T
    _em_pass1[(B * F, n_split)](xf, v, m, part, F, T, n_split, v_stride,
                                CHUNK=CHUNK, BLOCK=BLOCK, num_warps=4)
    _em_pass2[(B * F, triton.cdiv(T, BLOCK))](xf, v, m, part, yf, F, T, n_split, v_stride,
                                              EPS, EPS ** 0.5, BLOCK=BLOCK, num_warps=4)
    return y
