"""Triton kernels of K2, the stereo Wiener-EM over a packed bucket layout
(see kernels/wiener_em.py for the function, the layout, its plain versions
and the wrappers).

This module imports triton at the top, as Triton's JIT requires of the
module that defines a kernel; only the wrapper imports it, inside the call
that launches on a CUDA tensor, so nothing here loads on a machine without
a card.

Design, for all buckets of a layout in two kernel launches after the
wrapper zeroes one max|x|^2 slot per bucket (the TPU's XLA program ran one
fused chain per bucket; on the card 70 launch pairs, each with its own
max|x| pass, left the stage bound by host work):
* pass 1 walks a 1-D grid of (bucket, row, split) work items, row = b*F + f,
  CHUNK frames each (splitting keeps the card busy on the buckets with one
  bin and up to 85,264 frames per row). Since |y_s|^2 = v_s^2 / m^2, it sums
  the unscaled v_s0^2, v_s1^2 and v_s0 v_s1 u0 conj(u1), u = e^{i angle(x)},
  as 16 partial sums per item, and takes max|x|^2 over its frames into its
  bucket's float32 slot with one atomic max (max is order-free, so the
  result is deterministic; the slots start at 0 and hold no state from an
  earlier call);
* pass 2 walks (bucket, row, block) work items of BLOCK frames: it reads
  m_k = max(1, 0.1 sqrt(max|x|^2)), sums its row's partials scaled by
  1/m_k^2, forms R, then per frame the Hermitian Cxx + sqrt(eps) I, its
  analytic inverse and the filtered outputs, and writes y.
Bucket offsets and sizes come from a table at run time, so each pass
compiles once for every layout. Complex values are loaded and stored as
(BLOCK, 2) tiles of interleaved (re, im) float32, 8 contiguous bytes per
element; offsets are int64 (the packed estimates at chunk batch 8 hold
~700 M floats). Traffic: pass 1 reads x and v (48 B per position), pass 2
reads them again and writes y (112 B): 160 B against the 112 B bound.
"""

import torch
import triton
import triton.language as tl

from .wiener_em import BLOCK, CHUNK, EPS


@triton.jit
def _unit_phase(re, im):
    # exp(i angle(x)); exactly 1 where x == 0
    nz = (re * re + im * im) > 0.0
    sre = tl.where(nz, re, 1.0)
    sim = tl.where(nz, im, 0.0)
    r = tl.sqrt(sre * sre + sim * sim)
    return sre / r, sim / r


@triton.jit
def _work_item(it_ptr, bk_ptr, pid):
    # bucket, row, (2b F + f), the item's split or block, the bucket's table row
    item = it_ptr + pid * 3
    k = tl.load(item)
    row = tl.load(item + 1).to(tl.int64)
    c = tl.load(item + 2)
    bk = bk_ptr + k * 6
    x_off = tl.load(bk)
    F = tl.load(bk + 1)
    T = tl.load(bk + 2)
    n = tl.load(bk + 3)
    splits = tl.load(bk + 4)
    first = tl.load(bk + 5)
    b = row // F
    return k, row, b * 2 * F + (row - b * F), c, x_off, F, T, n, splits, first


@triton.jit
def _load_x(xc, t, mask):
    # one channel's (BLOCK,) re and im at frames t, from interleaved floats
    ri = tl.arange(0, 2)[None, :]
    return tl.split(tl.load(xc + 2 * t[:, None] + ri, mask=mask[:, None], other=0.0))


@triton.jit
def _em_pass1(x_ptr, v_ptr, bk_ptr, it_ptr, part_ptr, max_ptr,
              CHUNK: tl.constexpr, BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    k, row, bcf, split, x_off, F, T, n, splits, first = _work_item(it_ptr, bk_ptr, pid)
    pos = bcf * T                                   # channel 0 of (b, f) in the bucket
    x0 = x_ptr + (x_off + pos) * 2                  # floats
    x1 = x0 + F * T * 2
    v0 = v_ptr + 4 * x_off + pos
    v1 = v0 + F * T
    src = tl.arange(0, 4).to(tl.int64)[:, None] * n
    acc00 = tl.zeros((4, BLOCK), tl.float32)
    acc11 = tl.zeros((4, BLOCK), tl.float32)
    acc01r = tl.zeros((4, BLOCK), tl.float32)
    acc01i = tl.zeros((4, BLOCK), tl.float32)
    amax = tl.zeros((BLOCK,), tl.float32)
    t0 = split * CHUNK
    frames = tl.minimum(T - t0, CHUNK).to(tl.int32)
    for i in range(0, frames, BLOCK):
        t = t0 + i + tl.arange(0, BLOCK)
        mask = t < T
        x0r, x0i = _load_x(x0, t, mask)
        x1r, x1i = _load_x(x1, t, mask)
        amax = tl.maximum(amax, tl.maximum(x0r * x0r + x0i * x0i, x1r * x1r + x1i * x1i))
        u0r, u0i = _unit_phase(x0r, x0i)
        u1r, u1i = _unit_phase(x1r, x1i)
        wr = (u0r * u1r + u0i * u1i)[None, :]       # u0 conj(u1)
        wi = (u0i * u1r - u0r * u1i)[None, :]
        va = tl.load(v0 + src + t[None, :], mask=mask[None, :], other=0.0)   # (4, BLOCK)
        vb = tl.load(v1 + src + t[None, :], mask=mask[None, :], other=0.0)
        acc00 += va * va
        acc11 += vb * vb
        vab = va * vb
        acc01r += vab * wr
        acc01i += vab * wi
    out = part_ptr + pid.to(tl.int64) * 16 + tl.arange(0, 4)
    tl.store(out, tl.sum(acc00, axis=1))
    tl.store(out + 4, tl.sum(acc11, axis=1))
    tl.store(out + 8, tl.sum(acc01r, axis=1))
    tl.store(out + 12, tl.sum(acc01i, axis=1))
    tl.atomic_max(max_ptr + k, tl.max(amax, axis=0))


@triton.jit
def _em_pass2(x_ptr, v_ptr, bk_ptr, it_ptr, part_ptr, max_ptr, y_ptr, eps, sqeps,
              BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    k, row, bcf, blk, x_off, F, T, n, splits, first = _work_item(it_ptr, bk_ptr, pid)
    m = tl.maximum(tl.sqrt(tl.load(max_ptr + k)) * 0.1, 1.0)     # max|x|^2 of the bucket
    inv_m2 = 1.0 / (m * m)
    s4 = tl.arange(0, 4)
    c00 = tl.zeros((4,), tl.float32)
    c11 = tl.zeros((4,), tl.float32)
    c01r = tl.zeros((4,), tl.float32)
    c01i = tl.zeros((4,), tl.float32)
    p = part_ptr + (first + row * splits) * 16 + s4
    for j in range(splits.to(tl.int32)):
        c00 += tl.load(p + j * 16)
        c11 += tl.load(p + j * 16 + 4)
        c01r += tl.load(p + j * 16 + 8)
        c01i += tl.load(p + j * 16 + 12)
    c00 = c00 * inv_m2
    c11 = c11 * inv_m2
    w = 0.5 * (c00 + c11) + eps
    R00 = (c00 / w)[:, None]
    R11 = (c11 / w)[:, None]
    R01r = (c01r * inv_m2 / w)[:, None]
    R01i = (c01i * inv_m2 / w)[:, None]

    t = blk * BLOCK + tl.arange(0, BLOCK)
    mask = t < T
    pos = bcf * T
    x0 = x_ptr + (x_off + pos) * 2
    x0r, x0i = _load_x(x0, t, mask)
    x1r, x1i = _load_x(x0 + F * T * 2, t, mask)
    v0 = v_ptr + 4 * x_off + pos
    src = s4.to(tl.int64)[:, None] * n
    va = tl.load(v0 + src + t[None, :], mask=mask[None, :], other=0.0)
    vb = tl.load(v0 + F * T + src + t[None, :], mask=mask[None, :], other=0.0)
    vv = 0.5 * (va * va + vb * vb) * inv_m2                              # (4, BLOCK)

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
    u0r = (i00 * xs0r + (i01r * xs1r - i01i * xs1i))[None, :]
    u0i = (i00 * xs0i + (i01r * xs1i + i01i * xs1r))[None, :]
    u1r = ((i01r * xs0r + i01i * xs0i) + i11 * xs1r)[None, :]
    u1i = ((i01r * xs0i - i01i * xs0r) + i11 * xs1i)[None, :]
    # y_s0 = v_s (R00 u0 + R01 u1), y_s1 = v_s (conj(R01) u0 + R11 u1), times m
    o0r = vv * (R00 * u0r + (R01r * u1r - R01i * u1i)) * m
    o0i = vv * (R00 * u0i + (R01r * u1i + R01i * u1r)) * m
    o1r = vv * ((R01r * u0r + R01i * u0i) + R11 * u1r) * m
    o1i = vv * ((R01r * u0i - R01i * u0r) + R11 * u1i) * m
    y0 = y_ptr + (4 * x_off + pos) * 2
    offs = (src * 2 + 2 * t[None, :])[:, :, None] + tl.arange(0, 2)[None, None, :]   # (4, BLOCK, 2)
    m3 = mask[None, :, None]
    tl.store(y0 + offs, tl.join(o0r, o0i), mask=m3)
    tl.store(y0 + F * T * 2 + offs, tl.join(o1r, o1i), mask=m3)


def pass1(x: torch.Tensor, v: torch.Tensor, state: dict):
    """Launch pass 1 on checked packed inputs (wiener_em_grouped validates
    them) into zeroed max slots."""
    items = state["items1"]
    _em_pass1[(items.shape[0],)](torch.view_as_real(x), v, state["buckets"], items, state["partials"],
                                 state["maxima"], CHUNK=CHUNK, BLOCK=BLOCK, num_warps=4)


def pass2(x: torch.Tensor, v: torch.Tensor, state: dict, y: torch.Tensor):
    """Launch pass 2, writing the packed estimates y."""
    items = state["items2"]
    _em_pass2[(items.shape[0],)](torch.view_as_real(x), v, state["buckets"], items, state["partials"],
                                 state["maxima"], torch.view_as_real(y), EPS, EPS ** 0.5,
                                 BLOCK=BLOCK, num_warps=4)
