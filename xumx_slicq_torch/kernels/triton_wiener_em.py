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
  Z = m sum_s v_s R_s G_s and W = Cxx^-1 Z (G the cotangent of y), and
  sum v_s U E_s^H over frames, E_s = m G_s - W: 16 floats per item, laid
  out like the forward's partials;
* backward pass 2, per (bucket, row, block): sum the row's cotangents of
  R, map them through R = c / w to the cotangent of c, and write dL/dv
  per frame from the direct vv path, the path through Cxx^-1 and the path
  through c00, c11 and c01.
Bound: bytes. The function reads x, v and the cotangent (112 B per
position) and writes dL/dv (32 B): 144 B. Both passes read the three
inputs, so the two-pass floor is 256 B per position. The first design
held the four sources as (4, BLOCK) tiles, whose sums over sources
(Cxx, Z) crossed warps, and formed E and R_s U as tiles: pass 2 ran at
1.45 TB/s whatever its warp count (an H100). Now each source is a
frame vector of its own, so every sum over sources stays in its thread;
det is inverted once; and E_s enters both passes only through four terms
of U E_s^H per source, m Re(U conj(G_s)) and the like less W's share,
which is formed once per frame for all sources (_source_e).
"""

import torch
import triton
import triton.language as tl

from .wiener_em import BLOCK, CHUNK, EPS

# the backward passes' tiles (tools/k2b_sweep.py times the others): pass 1 sums BWD1_BLOCK frames at a
# time over its CHUNK; pass 2 takes its BLOCK-frame work item BWD2_SUB frames at a time
BWD1_BLOCK, BWD1_WARPS = 128, 4
BWD2_SUB, BWD2_WARPS = 64, 2


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
def _row_stats(p, splits, s):
    # source s's four row sums over its row's pass-1 items (16 floats an item: 4 sums x 4 sources)
    c00 = tl.load(p + s)
    c11 = tl.load(p + 4 + s)
    c01r = tl.load(p + 8 + s)
    c01i = tl.load(p + 12 + s)
    for j in range(1, splits.to(tl.int32)):
        q = p + j * 16
        c00 += tl.load(q + s)
        c11 += tl.load(q + 4 + s)
        c01r += tl.load(q + 8 + s)
        c01i += tl.load(q + 12 + s)
    return c00, c11, c01r, c01i


@triton.jit
def _source_filter(p, splits, s, inv_m2, eps):
    # source s's w and R (scalars) of one row, as the forward's pass 2 forms them
    c00, c11, c01r, c01i = _row_stats(p, splits, s)
    c00 = c00 * inv_m2
    c11 = c11 * inv_m2
    w = 0.5 * (c00 + c11) + eps
    return w, c00 / w, c11 / w, c01r * inv_m2 / w, c01i * inv_m2 / w


@triton.jit
def _load_source(v0, g0, s_off, FT, t, mask):
    # one source's v (channels 0, 1) and cotangent G (channels 0, 1, re and im) at frames t
    va = tl.load(v0 + s_off + t, mask=mask, other=0.0)
    vb = tl.load(v0 + s_off + FT + t, mask=mask, other=0.0)
    g0r, g0i = _load_x(g0 + 2 * s_off, t, mask)
    g1r, g1i = _load_x(g0 + 2 * (s_off + FT), t, mask)
    return va, vb, g0r, g0i, g1r, g1i


@triton.jit
def _z_terms(vv, R00, R11, R01r, R01i, g0r, g0i, g1r, g1i):
    # vv_s R_s G_s, with R_s = [[R00, R01], [conj(R01), R11]]
    return (vv * (R00 * g0r + (R01r * g1r - R01i * g1i)), vv * (R00 * g0i + (R01r * g1i + R01i * g1r)),
            vv * ((R01r * g0r + R01i * g0i) + R11 * g1r), vv * ((R01r * g0i - R01i * g0r) + R11 * g1i))


@triton.jit
def _source_e(m, U0r, U0i, U1r, U1i, a, b, c, d, g0r, g0i, g1r, g1i):
    # the source's terms of U E_s^H (E_s = m G_s - W): Re(U0 conj E0), Re(U1 conj E1), and the real and
    # imaginary parts of conj(U1) E0 + U0 conj(E1); a, b, c, d are W's share, the same for every source
    gA = g0r * U0r + g0i * U0i
    gB = g1r * U1r + g1i * U1i
    S1 = (g0r * U1r + g0i * U1i) + (g1r * U0r + g1i * U0i)
    S2 = (g1r * U0i - g1i * U0r) - (g0r * U1i - g0i * U1r)
    return m * gA - a, m * gB - b, m * S1 - c, m * S2 - d


@triton.jit
def _frame_e(x_ptr, v_ptr, g_ptr, x_off, pos, FT, n, t, mask, m, inv_m2, sqeps,
             Ra00, Ra11, Ra01r, Ra01i, Rb00, Rb11, Rb01r, Rb01i,
             Rc00, Rc11, Rc01r, Rc01i, Rd00, Rd11, Rd01r, Rd01i):
    # per frame of one row, each source a vector of its own (the sums over sources stay in each thread):
    # vv_s, Cxx and its inverse (one reciprocal of det), U = Cxx^-1 x / m, Z = m sum_s vv_s R_s G_s,
    # W = Cxx^-1 Z and the four e-terms of each source (_source_e). Returns x, then per source (v_s0, v_s1,
    # vv_s, its e-terms).
    x0 = x_ptr + (x_off + pos) * 2
    x0r, x0i = _load_x(x0, t, mask)
    x1r, x1i = _load_x(x0 + FT * 2, t, mask)
    v0 = v_ptr + 4 * x_off + pos
    g0 = g_ptr + (4 * x_off + pos) * 2
    va_a, vb_a, ga0r, ga0i, ga1r, ga1i = _load_source(v0, g0, 0 * n, FT, t, mask)
    va_b, vb_b, gb0r, gb0i, gb1r, gb1i = _load_source(v0, g0, 1 * n, FT, t, mask)
    va_c, vb_c, gc0r, gc0i, gc1r, gc1i = _load_source(v0, g0, 2 * n, FT, t, mask)
    va_d, vb_d, gd0r, gd0i, gd1r, gd1i = _load_source(v0, g0, 3 * n, FT, t, mask)
    vv_a = 0.5 * (va_a * va_a + vb_a * vb_a) * inv_m2
    vv_b = 0.5 * (va_b * va_b + vb_b * vb_b) * inv_m2
    vv_c = 0.5 * (va_c * va_c + vb_c * vb_c) * inv_m2
    vv_d = 0.5 * (va_d * va_d + vb_d * vb_d) * inv_m2
    A00 = ((vv_a * Ra00 + vv_b * Rb00) + (vv_c * Rc00 + vv_d * Rd00)) + sqeps
    A11 = ((vv_a * Ra11 + vv_b * Rb11) + (vv_c * Rc11 + vv_d * Rd11)) + sqeps
    A01r = (vv_a * Ra01r + vv_b * Rb01r) + (vv_c * Rc01r + vv_d * Rd01r)
    A01i = (vv_a * Ra01i + vv_b * Rb01i) + (vv_c * Rc01i + vv_d * Rd01i)
    rd = 1.0 / (A00 * A11 - (A01r * A01r + A01i * A01i))
    i00 = A11 * rd
    i11 = A00 * rd
    i01r = -A01r * rd
    i01i = -A01i * rd
    inv_m = 1.0 / m
    xs0r = x0r * inv_m
    xs0i = x0i * inv_m
    xs1r = x1r * inv_m
    xs1i = x1i * inv_m
    # U = Cxx^-1 x / m, with Cxx^-1 = [[i00, i01], [conj(i01), i11]]
    U0r = i00 * xs0r + (i01r * xs1r - i01i * xs1i)
    U0i = i00 * xs0i + (i01r * xs1i + i01i * xs1r)
    U1r = (i01r * xs0r + i01i * xs0i) + i11 * xs1r
    U1i = (i01r * xs0i - i01i * xs0r) + i11 * xs1i
    za0r, za0i, za1r, za1i = _z_terms(vv_a, Ra00, Ra11, Ra01r, Ra01i, ga0r, ga0i, ga1r, ga1i)
    zb0r, zb0i, zb1r, zb1i = _z_terms(vv_b, Rb00, Rb11, Rb01r, Rb01i, gb0r, gb0i, gb1r, gb1i)
    zc0r, zc0i, zc1r, zc1i = _z_terms(vv_c, Rc00, Rc11, Rc01r, Rc01i, gc0r, gc0i, gc1r, gc1i)
    zd0r, zd0i, zd1r, zd1i = _z_terms(vv_d, Rd00, Rd11, Rd01r, Rd01i, gd0r, gd0i, gd1r, gd1i)
    Z0r = ((za0r + zb0r) + (zc0r + zd0r)) * m
    Z0i = ((za0i + zb0i) + (zc0i + zd0i)) * m
    Z1r = ((za1r + zb1r) + (zc1r + zd1r)) * m
    Z1i = ((za1i + zb1i) + (zc1i + zd1i)) * m
    W0r = i00 * Z0r + (i01r * Z1r - i01i * Z1i)
    W0i = i00 * Z0i + (i01r * Z1i + i01i * Z1r)
    W1r = (i01r * Z0r + i01i * Z0i) + i11 * Z1r
    W1i = (i01r * Z0i - i01i * Z0r) + i11 * Z1i
    # W's share: Re(conj(W0) U0), Re(conj(W1) U1), Re(P + Q), Im(Q - P) with P = conj(W0) U1, Q = conj(W1) U0
    a = W0r * U0r + W0i * U0i
    b = W1r * U1r + W1i * U1i
    c = (W0r * U1r + W0i * U1i) + (W1r * U0r + W1i * U0i)
    d = (W1r * U0i - W1i * U0r) - (W0r * U1i - W0i * U1r)
    ea00, ea11, ea01r, ea01i = _source_e(m, U0r, U0i, U1r, U1i, a, b, c, d, ga0r, ga0i, ga1r, ga1i)
    eb00, eb11, eb01r, eb01i = _source_e(m, U0r, U0i, U1r, U1i, a, b, c, d, gb0r, gb0i, gb1r, gb1i)
    ec00, ec11, ec01r, ec01i = _source_e(m, U0r, U0i, U1r, U1i, a, b, c, d, gc0r, gc0i, gc1r, gc1i)
    ed00, ed11, ed01r, ed01i = _source_e(m, U0r, U0i, U1r, U1i, a, b, c, d, gd0r, gd0i, gd1r, gd1i)
    return (x0r, x0i, x1r, x1i,
            va_a, vb_a, vv_a, ea00, ea11, ea01r, ea01i, va_b, vb_b, vv_b, eb00, eb11, eb01r, eb01i,
            va_c, vb_c, vv_c, ec00, ec11, ec01r, ec01i, va_d, vb_d, vv_d, ed00, ed11, ed01r, ed01i)


@triton.jit
def _em_bwd_pass1(x_ptr, v_ptr, g_ptr, bk_ptr, it_ptr, part_ptr, max_ptr, gpart_ptr, eps, sqeps,
                  CHUNK: tl.constexpr, BLOCK: tl.constexpr):
    # per (bucket, row, split): the frame sums of dL/dR_s = v_s U E_s^H, each source's in vectors of its own
    pid = tl.program_id(0)
    k, row, bcf, split, x_off, F, T, n, splits, first = _work_item(it_ptr, bk_ptr, pid)
    m = tl.maximum(tl.sqrt(tl.load(max_ptr + k)) * 0.1, 1.0)
    inv_m2 = 1.0 / (m * m)
    p = part_ptr + (first + row * splits) * 16
    _wa, Ra00, Ra11, Ra01r, Ra01i = _source_filter(p, splits, 0, inv_m2, eps)
    _wb, Rb00, Rb11, Rb01r, Rb01i = _source_filter(p, splits, 1, inv_m2, eps)
    _wc, Rc00, Rc11, Rc01r, Rc01i = _source_filter(p, splits, 2, inv_m2, eps)
    _wd, Rd00, Rd11, Rd01r, Rd01i = _source_filter(p, splits, 3, inv_m2, eps)
    FT = F * T
    pos = bcf * T
    z = tl.zeros((BLOCK,), tl.float32)
    sa00, sa11, sa01r, sa01i = z, z, z, z
    sb00, sb11, sb01r, sb01i = z, z, z, z
    sc00, sc11, sc01r, sc01i = z, z, z, z
    sd00, sd11, sd01r, sd01i = z, z, z, z
    t0 = split * CHUNK
    frames = tl.minimum(T - t0, CHUNK).to(tl.int32)
    for i in range(0, frames, BLOCK):
        t = t0 + i + tl.arange(0, BLOCK)
        mask = t < T
        (_x0r, _x0i, _x1r, _x1i,
         _vaa, _vba, vv_a, ea00, ea11, ea01r, ea01i, _vab, _vbb, vv_b, eb00, eb11, eb01r, eb01i,
         _vac, _vbc, vv_c, ec00, ec11, ec01r, ec01i, _vad, _vbd, vv_d, ed00, ed11, ed01r, ed01i) = _frame_e(
            x_ptr, v_ptr, g_ptr, x_off, pos, FT, n, t, mask, m, inv_m2, sqeps,
            Ra00, Ra11, Ra01r, Ra01i, Rb00, Rb11, Rb01r, Rb01i, Rc00, Rc11, Rc01r, Rc01i, Rd00, Rd11, Rd01r, Rd01i)
        sa00 += vv_a * ea00
        sa11 += vv_a * ea11
        sa01r += vv_a * ea01r
        sa01i += vv_a * ea01i
        sb00 += vv_b * eb00
        sb11 += vv_b * eb11
        sb01r += vv_b * eb01r
        sb01i += vv_b * eb01i
        sc00 += vv_c * ec00
        sc11 += vv_c * ec11
        sc01r += vv_c * ec01r
        sc01i += vv_c * ec01i
        sd00 += vv_d * ed00
        sd11 += vv_d * ed11
        sd01r += vv_d * ed01r
        sd01i += vv_d * ed01i
    out = gpart_ptr + pid.to(tl.int64) * 16                # laid out like the forward's partials
    tl.store(out, tl.sum(sa00, axis=0))
    tl.store(out + 1, tl.sum(sb00, axis=0))
    tl.store(out + 2, tl.sum(sc00, axis=0))
    tl.store(out + 3, tl.sum(sd00, axis=0))
    tl.store(out + 4, tl.sum(sa11, axis=0))
    tl.store(out + 5, tl.sum(sb11, axis=0))
    tl.store(out + 6, tl.sum(sc11, axis=0))
    tl.store(out + 7, tl.sum(sd11, axis=0))
    tl.store(out + 8, tl.sum(sa01r, axis=0))
    tl.store(out + 9, tl.sum(sb01r, axis=0))
    tl.store(out + 10, tl.sum(sc01r, axis=0))
    tl.store(out + 11, tl.sum(sd01r, axis=0))
    tl.store(out + 12, tl.sum(sa01i, axis=0))
    tl.store(out + 13, tl.sum(sb01i, axis=0))
    tl.store(out + 14, tl.sum(sc01i, axis=0))
    tl.store(out + 15, tl.sum(sd01i, axis=0))


@triton.jit
def _source_gc(p, gp, splits, s, inv_m2, eps):
    # source s's R and the cotangent of its c: dL/dR through R = c / w, w = 0.5 (c00 + c11) + eps
    w, R00, R11, R01r, R01i = _source_filter(p, splits, s, inv_m2, eps)
    gR00, gR11, gR01r, gR01i = _row_stats(gp, splits, s)
    gw = -(gR00 * R00 + gR11 * R11 + gR01r * R01r + gR01i * R01i) / w
    return R00, R11, R01r, R01i, gR00 / w + 0.5 * gw, gR11 / w + 0.5 * gw, gR01r / w, gR01i / w


@triton.jit
def _source_gv(gv0, s_off, FT, t, mask, inv_m2, phr, phi, va, vb, e00, e11, e01r, e01i,
               R00, R11, R01r, R01i, gc00, gc11, gc01r, gc01i):
    # dL/dv of one source: dL/dvv_s = Re(E_s^H R_s U) from its e-terms, then the paths through c
    gvv = (R00 * e00 + R11 * e11) + (R01r * e01r + R01i * e01i)
    q = gc01r * phr + gc01i * phi                                 # Re(conj(dL/dc01) u0 conj(u1))
    tl.store(gv0 + s_off + t, (gvv * va + 2.0 * gc00 * va + q * vb) * inv_m2, mask=mask)
    tl.store(gv0 + s_off + FT + t, (gvv * vb + 2.0 * gc11 * vb + q * va) * inv_m2, mask=mask)


@triton.jit
def _em_bwd_pass2(x_ptr, v_ptr, g_ptr, bk_ptr, it_ptr, part_ptr, max_ptr, gpart_ptr, gv_ptr, eps, sqeps,
                  BLOCK: tl.constexpr, SUB: tl.constexpr):
    # per (bucket, row, block): dL/dR -> dL/dc through R = c / w, then dL/dv per frame, SUB frames at a time
    pid = tl.program_id(0)
    k, row, bcf, blk, x_off, F, T, n, splits, first = _work_item(it_ptr, bk_ptr, pid)
    m = tl.maximum(tl.sqrt(tl.load(max_ptr + k)) * 0.1, 1.0)
    inv_m2 = 1.0 / (m * m)
    p = part_ptr + (first + row * splits) * 16
    gp = gpart_ptr + (first + row * splits) * 16
    Ra00, Ra11, Ra01r, Ra01i, gca00, gca11, gca01r, gca01i = _source_gc(p, gp, splits, 0, inv_m2, eps)
    Rb00, Rb11, Rb01r, Rb01i, gcb00, gcb11, gcb01r, gcb01i = _source_gc(p, gp, splits, 1, inv_m2, eps)
    Rc00, Rc11, Rc01r, Rc01i, gcc00, gcc11, gcc01r, gcc01i = _source_gc(p, gp, splits, 2, inv_m2, eps)
    Rd00, Rd11, Rd01r, Rd01i, gcd00, gcd11, gcd01r, gcd01i = _source_gc(p, gp, splits, 3, inv_m2, eps)
    FT = F * T
    pos = bcf * T
    gv0 = gv_ptr + 4 * x_off + pos
    for i in tl.static_range(0, BLOCK, SUB):
        t = blk * BLOCK + i + tl.arange(0, SUB)
        mask = t < T
        (x0r, x0i, x1r, x1i,
         va_a, vb_a, _vva, ea00, ea11, ea01r, ea01i, va_b, vb_b, _vvb, eb00, eb11, eb01r, eb01i,
         va_c, vb_c, _vvc, ec00, ec11, ec01r, ec01i, va_d, vb_d, _vvd, ed00, ed11, ed01r, ed01i) = _frame_e(
            x_ptr, v_ptr, g_ptr, x_off, pos, FT, n, t, mask, m, inv_m2, sqeps,
            Ra00, Ra11, Ra01r, Ra01i, Rb00, Rb11, Rb01r, Rb01i, Rc00, Rc11, Rc01r, Rc01i, Rd00, Rd11, Rd01r, Rd01i)
        u0r, u0i = _unit_phase(x0r, x0i)
        u1r, u1i = _unit_phase(x1r, x1i)
        phr = u0r * u1r + u0i * u1i                                # u0 conj(u1)
        phi = u0i * u1r - u0r * u1i
        _source_gv(gv0, 0 * n, FT, t, mask, inv_m2, phr, phi, va_a, vb_a, ea00, ea11, ea01r, ea01i,
                   Ra00, Ra11, Ra01r, Ra01i, gca00, gca11, gca01r, gca01i)
        _source_gv(gv0, 1 * n, FT, t, mask, inv_m2, phr, phi, va_b, vb_b, eb00, eb11, eb01r, eb01i,
                   Rb00, Rb11, Rb01r, Rb01i, gcb00, gcb11, gcb01r, gcb01i)
        _source_gv(gv0, 2 * n, FT, t, mask, inv_m2, phr, phi, va_c, vb_c, ec00, ec11, ec01r, ec01i,
                   Rc00, Rc11, Rc01r, Rc01i, gcc00, gcc11, gcc01r, gcc01i)
        _source_gv(gv0, 3 * n, FT, t, mask, inv_m2, phr, phi, va_d, vb_d, ed00, ed11, ed01r, ed01i,
                   Rd00, Rd11, Rd01r, Rd01i, gcd00, gcd11, gcd01r, gcd01i)


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
    out like the forward's partials. Returns Triton's compiled kernel (its
    n_regs and n_spills)."""
    items = tables["items1"]
    return _em_bwd_pass1[(items.shape[0],)](
        torch.view_as_real(x), v, torch.view_as_real(gy), tables["buckets"], items, partials, maxima, gpart, EPS,
        EPS ** 0.5, CHUNK=CHUNK, BLOCK=BWD1_BLOCK, num_warps=BWD1_WARPS)


def backward_pass2(x: torch.Tensor, v: torch.Tensor, gy: torch.Tensor, tables: dict, partials: torch.Tensor,
                   maxima: torch.Tensor, gpart: torch.Tensor, gv: torch.Tensor):
    """Launch backward pass 2, writing dL/dv into gv. Returns Triton's
    compiled kernel."""
    items = tables["items2"]
    return _em_bwd_pass2[(items.shape[0],)](
        torch.view_as_real(x), v, torch.view_as_real(gy), tables["buckets"], items, partials, maxima, gpart, gv, EPS,
        EPS ** 0.5, BLOCK=BLOCK, SUB=BWD2_SUB, num_warps=BWD2_WARPS)
