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

The backward (replacing XLA's autodiff of the same chain in the train
step) walks the same two tables, with the forward call's own partial sums
and max slots:
* backward pass 1, per (bucket, row, split): recompute R from the
  forward's partials, then per frame Cxx, its inverse, U = Cxx^-1 x / m,
  Z = m sum_s v_s R_s G_s and E_s = m G_s - Cxx^-1 Z (G the cotangent of
  y), and sum v_s U E_s^H over frames: 16 floats per item, laid out like
  the forward's partials;
* backward pass 2, per (bucket, row, block): sum the row's cotangents of
  R, map them through R = c / w to the cotangent of c, and write dL/dv
  per frame from the direct vv path, the path through Cxx^-1 and the path
  through c00, c11 and c01.
Bound: bytes. The function reads x, v and the cotangent (112 B per
position) and writes dL/dv (32 B): 144 B. Both passes read the three
inputs, so the two-pass floor is 256 B per position. 8 warps per program
keep each thread at one frame of the (4, BLOCK) source tiles.
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
def _row_sums(p, splits):
    # a row's 16 partial sums over its pass-1 items: four (4,) vectors
    s4 = tl.arange(0, 4)
    a = tl.zeros((4,), tl.float32)
    b = tl.zeros((4,), tl.float32)
    c = tl.zeros((4,), tl.float32)
    d = tl.zeros((4,), tl.float32)
    for j in range(splits.to(tl.int32)):
        a += tl.load(p + j * 16 + s4)
        b += tl.load(p + j * 16 + 4 + s4)
        c += tl.load(p + j * 16 + 8 + s4)
        d += tl.load(p + j * 16 + 12 + s4)
    return a, b, c, d


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
    c00, c11, c01r, c01i = _row_sums(part_ptr + (first + row * splits) * 16, splits)
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


@triton.jit
def _row_filter(part_ptr, max_ptr, k, first, row, splits, eps):
    # m_k, 1/m_k^2, w and R (each (4,) over sources) of one row, as pass 2 forms them
    m = tl.maximum(tl.sqrt(tl.load(max_ptr + k)) * 0.1, 1.0)
    inv_m2 = 1.0 / (m * m)
    c00, c11, c01r, c01i = _row_sums(part_ptr + (first + row * splits) * 16, splits)
    c00 = c00 * inv_m2
    c11 = c11 * inv_m2
    w = 0.5 * (c00 + c11) + eps
    return m, inv_m2, w, c00 / w, c11 / w, c01r * inv_m2 / w, c01i * inv_m2 / w


@triton.jit
def _frame_grad(x_ptr, v_ptr, g_ptr, x_off, pos, F, T, n, t, mask, m, inv_m2,
                R00, R11, R01r, R01i, sqeps):
    # per frame of one row: v, vv, x, U = Cxx^-1 x / m and E_s = m G_s - Cxx^-1 Z,
    # Z = m sum_s vv_s R_s G_s; R* are (4, 1), frame vectors come back as (1, BLOCK)
    x0 = x_ptr + (x_off + pos) * 2
    x0r, x0i = _load_x(x0, t, mask)
    x1r, x1i = _load_x(x0 + F * T * 2, t, mask)
    v0 = v_ptr + 4 * x_off + pos
    src = tl.arange(0, 4).to(tl.int64)[:, None] * n
    va = tl.load(v0 + src + t[None, :], mask=mask[None, :], other=0.0)              # (4, BLOCK)
    vb = tl.load(v0 + F * T + src + t[None, :], mask=mask[None, :], other=0.0)
    vv = 0.5 * (va * va + vb * vb) * inv_m2
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
    U0r = i00 * xs0r + (i01r * xs1r - i01i * xs1i)
    U0i = i00 * xs0i + (i01r * xs1i + i01i * xs1r)
    U1r = (i01r * xs0r + i01i * xs0i) + i11 * xs1r
    U1i = (i01r * xs0i - i01i * xs0r) + i11 * xs1i
    g0 = g_ptr + (4 * x_off + pos) * 2
    offs = (src * 2 + 2 * t[None, :])[:, :, None] + tl.arange(0, 2)[None, None, :]  # (4, BLOCK, 2)
    m3 = mask[None, :, None]
    G0r, G0i = tl.split(tl.load(g0 + offs, mask=m3, other=0.0))
    G1r, G1i = tl.split(tl.load(g0 + F * T * 2 + offs, mask=m3, other=0.0))
    # Z = m sum_s vv_s R_s G_s, with R_s = [[R00, R01], [conj(R01), R11]]
    Z0r = tl.sum(vv * (R00 * G0r + (R01r * G1r - R01i * G1i)), axis=0) * m
    Z0i = tl.sum(vv * (R00 * G0i + (R01r * G1i + R01i * G1r)), axis=0) * m
    Z1r = tl.sum(vv * ((R01r * G0r + R01i * G0i) + R11 * G1r), axis=0) * m
    Z1i = tl.sum(vv * ((R01r * G0i - R01i * G0r) + R11 * G1i), axis=0) * m
    # W = Cxx^-1 Z, E_s = m G_s - W
    W0r = i00 * Z0r + (i01r * Z1r - i01i * Z1i)
    W0i = i00 * Z0i + (i01r * Z1i + i01i * Z1r)
    W1r = (i01r * Z0r + i01i * Z0i) + i11 * Z1r
    W1i = (i01r * Z0i - i01i * Z0r) + i11 * Z1i
    E0r = m * G0r - W0r[None, :]
    E0i = m * G0i - W0i[None, :]
    E1r = m * G1r - W1r[None, :]
    E1i = m * G1i - W1i[None, :]
    return (va, vb, vv, U0r[None, :], U0i[None, :], U1r[None, :], U1i[None, :],
            E0r, E0i, E1r, E1i, x0r, x0i, x1r, x1i)


@triton.jit
def _em_bwd_pass1(x_ptr, v_ptr, g_ptr, bk_ptr, it_ptr, part_ptr, max_ptr, gpart_ptr, eps, sqeps,
                  CHUNK: tl.constexpr, BLOCK: tl.constexpr):
    # per (bucket, row, split): the frame sums of dL/dR_s = v_s U E_s^H
    pid = tl.program_id(0)
    k, row, bcf, split, x_off, F, T, n, splits, first = _work_item(it_ptr, bk_ptr, pid)
    m, inv_m2, w, R00, R11, R01r, R01i = _row_filter(part_ptr, max_ptr, k, first, row, splits, eps)
    R00 = R00[:, None]
    R11 = R11[:, None]
    R01r = R01r[:, None]
    R01i = R01i[:, None]
    pos = bcf * T
    acc00 = tl.zeros((4, BLOCK), tl.float32)
    acc11 = tl.zeros((4, BLOCK), tl.float32)
    acc01r = tl.zeros((4, BLOCK), tl.float32)
    acc01i = tl.zeros((4, BLOCK), tl.float32)
    t0 = split * CHUNK
    frames = tl.minimum(T - t0, CHUNK).to(tl.int32)
    for i in range(0, frames, BLOCK):
        t = t0 + i + tl.arange(0, BLOCK)
        mask = t < T
        (va, vb, vv, U0r, U0i, U1r, U1i, E0r, E0i, E1r, E1i,
         x0r, x0i, x1r, x1i) = _frame_grad(x_ptr, v_ptr, g_ptr, x_off, pos, F, T, n, t, mask, m, inv_m2,
                                           R00, R11, R01r, R01i, sqeps)
        acc00 += vv * (U0r * E0r + U0i * E0i)                      # Re(U0 conj(E0))
        acc11 += vv * (U1r * E1r + U1i * E1i)
        acc01r += vv * (U1r * E0r + U1i * E0i + U0r * E1r + U0i * E1i)   # conj(U1) E0 + U0 conj(E1)
        acc01i += vv * (U1r * E0i - U1i * E0r + U0i * E1r - U0r * E1i)
    out = gpart_ptr + pid.to(tl.int64) * 16 + tl.arange(0, 4)
    tl.store(out, tl.sum(acc00, axis=1))
    tl.store(out + 4, tl.sum(acc11, axis=1))
    tl.store(out + 8, tl.sum(acc01r, axis=1))
    tl.store(out + 12, tl.sum(acc01i, axis=1))


@triton.jit
def _em_bwd_pass2(x_ptr, v_ptr, g_ptr, bk_ptr, it_ptr, part_ptr, max_ptr, gpart_ptr, gv_ptr, eps, sqeps,
                  BLOCK: tl.constexpr):
    # per (bucket, row, block): dL/dR -> dL/dc through R = c / w, then dL/dv per frame
    pid = tl.program_id(0)
    k, row, bcf, blk, x_off, F, T, n, splits, first = _work_item(it_ptr, bk_ptr, pid)
    m, inv_m2, w, R00, R11, R01r, R01i = _row_filter(part_ptr, max_ptr, k, first, row, splits, eps)
    gR00, gR11, gR01r, gR01i = _row_sums(gpart_ptr + (first + row * splits) * 16, splits)
    gw = -(gR00 * R00 + gR11 * R11 + gR01r * R01r + gR01i * R01i) / w
    gc00 = (gR00 / w + 0.5 * gw)[:, None]
    gc11 = (gR11 / w + 0.5 * gw)[:, None]
    gc01r = (gR01r / w)[:, None]
    gc01i = (gR01i / w)[:, None]
    R00 = R00[:, None]
    R11 = R11[:, None]
    R01r = R01r[:, None]
    R01i = R01i[:, None]
    t = blk * BLOCK + tl.arange(0, BLOCK)
    mask = t < T
    pos = bcf * T
    (va, vb, vv, U0r, U0i, U1r, U1i, E0r, E0i, E1r, E1i,
     x0r, x0i, x1r, x1i) = _frame_grad(x_ptr, v_ptr, g_ptr, x_off, pos, F, T, n, t, mask, m, inv_m2,
                                       R00, R11, R01r, R01i, sqeps)
    # dL/dvv_s = Re(E_s^H R_s U)
    F0r = R00 * U0r + (R01r * U1r - R01i * U1i)
    F0i = R00 * U0i + (R01r * U1i + R01i * U1r)
    F1r = (R01r * U0r + R01i * U0i) + R11 * U1r
    F1i = (R01r * U0i - R01i * U0r) + R11 * U1i
    gvv = E0r * F0r + E0i * F0i + E1r * F1r + E1i * F1i
    u0r, u0i = _unit_phase(x0r, x0i)
    u1r, u1i = _unit_phase(x1r, x1i)
    phr = (u0r * u1r + u0i * u1i)[None, :]                         # u0 conj(u1)
    phi = (u0i * u1r - u0r * u1i)[None, :]
    q = gc01r * phr + gc01i * phi                                   # Re(conj(dL/dc01) u0 conj(u1))
    gva = (gvv * va + 2.0 * gc00 * va + q * vb) * inv_m2
    gvb = (gvv * vb + 2.0 * gc11 * vb + q * va) * inv_m2
    src = tl.arange(0, 4).to(tl.int64)[:, None] * n
    g0 = gv_ptr + 4 * x_off + pos + src + t[None, :]
    tl.store(g0, gva, mask=mask[None, :])
    tl.store(g0 + F * T, gvb, mask=mask[None, :])


def pass1(x: torch.Tensor, v: torch.Tensor, tables: dict, partials: torch.Tensor, maxima: torch.Tensor):
    """Launch pass 1 on checked packed inputs (wiener_em_grouped validates
    them) into zeroed max slots."""
    items = tables["items1"]
    _em_pass1[(items.shape[0],)](torch.view_as_real(x), v, tables["buckets"], items, partials,
                                 maxima, CHUNK=CHUNK, BLOCK=BLOCK, num_warps=4)


def pass2(x: torch.Tensor, v: torch.Tensor, tables: dict, partials: torch.Tensor, maxima: torch.Tensor,
          y: torch.Tensor):
    """Launch pass 2, writing the packed estimates y."""
    items = tables["items2"]
    _em_pass2[(items.shape[0],)](torch.view_as_real(x), v, tables["buckets"], items, partials,
                                 maxima, torch.view_as_real(y), EPS, EPS ** 0.5,
                                 BLOCK=BLOCK, num_warps=4)


def backward_pass1(x: torch.Tensor, v: torch.Tensor, gy: torch.Tensor, tables: dict, partials: torch.Tensor,
                   maxima: torch.Tensor, gpart: torch.Tensor):
    """Launch backward pass 1: the frame sums of dL/dR into gpart, laid
    out like the forward's partials."""
    items = tables["items1"]
    _em_bwd_pass1[(items.shape[0],)](torch.view_as_real(x), v, torch.view_as_real(gy), tables["buckets"], items,
                                     partials, maxima, gpart, EPS, EPS ** 0.5, CHUNK=CHUNK, BLOCK=BLOCK,
                                     num_warps=8)


def backward_pass2(x: torch.Tensor, v: torch.Tensor, gy: torch.Tensor, tables: dict, partials: torch.Tensor,
                   maxima: torch.Tensor, gpart: torch.Tensor, gv: torch.Tensor):
    """Launch backward pass 2, writing dL/dv into gv."""
    items = tables["items2"]
    _em_bwd_pass2[(items.shape[0],)](torch.view_as_real(x), v, torch.view_as_real(gy), tables["buckets"], items,
                                     partials, maxima, gpart, gv, EPS, EPS ** 0.5, BLOCK=BLOCK, num_warps=8)
