"""K2: stereo Wiener-EM, one iteration, over every bucket of a packed layout,
with its backward.

Replaces the XLA-fused `wiener` + `_em_stereo` chain of the JAX package
(xumx_slicq_tpu/ops/wiener.py:107-185, in the layout of
`_em_stereo_native`, :271-308), which runs once per bucket, and XLA's
autodiff of it in the train step (xumx_slicq_tpu/training.py:256, 274).
For each bucket k:

    m_k = max(1, 0.1 max|x|)                      one scalar over bucket k
    y_s = v_s e^{i angle(x)} / m_k                mix-phase init, scaled
    c00, c11, c01 = sum over frames of |y_s0|^2, |y_s1|^2, y_s0 conj(y_s1)
    R_s = c / (0.5 (c00 + c11) + eps)             per (b, f, source)
    Cxx = sum_s v_s R_s + sqrt(eps) I             per (b, f, frame), v_s from y
    y_s = v_s R_s (Cxx^-1 x / m_k) * m_k

Bucket k's x is (B, 2, F, T) complex64 and v (4, B, 2, F, T) float32,
T = S * M frames. m is per bucket and spans the whole chunk batch (the JAX
package computes it once per `wiener` call, :183): one m over a group of
buckets, or over one chunk, would change the result. m depends on x alone,
so it carries no gradient; x is data and gets none either.

All buckets live in packed buffers (ops/packed.BucketLayout): x, v and y
of every bucket are contiguous views of one 1-D buffer each, so the whole
stage is one grouped call (`wiener_em_grouped`) and nothing is copied at
the bucket boundary. The Triton kernels (kernels/triton_wiener_em.py) run
it over tables of work items in three device launches: the per-bucket
max |x|^2 slots are zeroed, a frame reduction also takes each bucket's
max |x|^2 into its slot, then one elementwise pass. The backward is two
more launches of the same shape (`wiener_em_backward`): a frame reduction
of the cotangent of R, then one elementwise pass that writes dL/dv. Bound:
bytes -- forward, each position reads x (16 B) and v (32 B) and writes y
(64 B); backward, it reads x, v and the cotangent of y (112 B) and writes
dL/dv (32 B). The plain versions (`wiener_em_plain`,
`wiener_em_grouped_plain`, `wiener_em_backward_plain`) are the same
functions in plain PyTorch: the wrappers use them for CPU tensors only.
The forward's two device implementations are those of the registered op
`xumx_slicq::wiener_em_grouped` (kernels/ops.py), which the wrapper calls.
The plain versions conjugate with `torch.conj_physical`: an op's CPU
implementation may run where the lazy conjugate bit of `torch.conj` is not
honoured (under AOT dispatch, as `torch.library.opcheck` runs it, the
products came out unconjugated).

The closed-form backward, per (b, f) row with U = Cxx^-1 x / m and G_s the
cotangent of y_s (dL = sum Re(conj(G) dy)):

    Z = m sum_s v_s R_s G_s,  W = Cxx^-1 Z,  E_s = m G_s - W   per frame
    dL/dR_s = sum over frames of v_s U E_s^H                   (pass 1)
    dL/dc from dL/dR through R = c / w, w = 0.5 (c00 + c11) + eps
    dL/dv_s = Re(E_s^H R_s U)                                  (pass 2)
    dL/dv_sc = (dL/dv_s + 2 dL/dc_cc) v_sc / m^2 + Re(conj(dL/dc01) u0 conj(u1)) v_s,1-c / m^2
"""

import numpy as np
import torch

from ..device import device_cache
from ..ops.packed import BucketLayout

EPS = float(np.finfo(np.float32).eps)
CHUNK = 4096   # frames per pass-1 work item
BLOCK = 256    # frames per pass-2 work item


def work_items(layout: BucketLayout):
    """K2's tables for a layout. Per bucket, int64: [x offset, F, T,
    elements, pass-1 splits, first pass-1 item]. Work items, int32: pass 1
    [bucket, row, split] over CHUNK frames, pass 2 [bucket, row, block] over
    BLOCK frames, with row = b * F + f. Pass-1 items are in (bucket, row,
    split) order, so a row's partial sums are contiguous. The backward
    passes walk the same two tables."""
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


def _unit_phase(x: torch.Tensor) -> torch.Tensor:
    """exp(i angle(x)), exactly 1 where x == 0."""
    nonzero = (x.real ** 2 + x.imag ** 2) > 0.0
    safe = torch.where(nonzero, x, torch.ones_like(x))
    return safe / torch.sqrt(safe.real ** 2 + safe.imag ** 2)


def _row_filter(x: torch.Tensor, v: torch.Tensor, m: torch.Tensor):
    """The forward's shared intermediates for one bucket: vv_s (4, B, F, T),
    the row statistics c (4, B, F) and R (4, B, F, 1), the inverse of Cxx
    and U = Cxx^-1 x / m (B, F, T)."""
    sqeps = float(np.sqrt(EPS))
    inv_m2 = 1.0 / (m * m)
    ph = _unit_phase(x)
    va, vb = v[:, :, 0], v[:, :, 1]                                      # (S,B,F,T)
    vv = 0.5 * (va * va + vb * vb) * inv_m2
    pab = ph[:, 0] * torch.conj_physical(ph[:, 1])                                # (B,F,T)
    c00, c11 = (va * va).sum(-1) * inv_m2, (vb * vb).sum(-1) * inv_m2   # (S,B,F)
    c01 = (va * vb * pab).sum(-1) * inv_m2
    w = 0.5 * (c00 + c11) + EPS
    R00, R11, R01 = (c00 / w)[..., None], (c11 / w)[..., None], (c01 / w)[..., None]
    A00 = (vv * R00).sum(0) + sqeps                                      # (B,F,T)
    A11 = (vv * R11).sum(0) + sqeps
    A01 = (vv * R01).sum(0)
    det = A00 * A11 - (A01.real ** 2 + A01.imag ** 2)
    inv = (A11 / det, A00 / det, -A01 / det)                             # i00, i11, i01
    xs0, xs1 = x[:, 0] / m, x[:, 1] / m
    U0 = inv[0] * xs0 + inv[2] * xs1
    U1 = torch.conj_physical(inv[2]) * xs0 + inv[1] * xs1
    return dict(va=va, vb=vb, vv=vv, pab=pab, c=(c00, c11, c01), w=w[..., None], R=(R00, R11, R01),
                inv=inv, U=(U0, U1), inv_m2=inv_m2)


def wiener_em_plain(x: torch.Tensor, v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version for one bucket: (B, 2, F, T), (4, B, 2, F, T),
    scale m -> (4, B, 2, F, T) complex64."""
    f = _row_filter(x, v, m)
    R00, R11, R01 = f["R"]
    U0, U1 = f["U"]
    vv = f["vv"]
    out0 = vv * (R00 * U0 + R01 * U1)
    out1 = vv * (torch.conj_physical(R01) * U0 + R11 * U1)
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


def _em_backward_bucket(x: torch.Tensor, v: torch.Tensor, gy: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """dL/dv of `wiener_em_plain` for one bucket, in closed form, with the
    kernel's two passes: frame sums of dL/dR, then dL/dv per frame."""
    f = _row_filter(x, v, m)
    R00, R11, R01 = f["R"]
    i00, i11, i01 = f["inv"]
    U0, U1 = f["U"]
    vv, va, vb, w, inv_m2 = f["vv"], f["va"], f["vb"], f["w"], f["inv_m2"]
    G0, G1 = gy[:, :, 0], gy[:, :, 1]                                    # (S,B,F,T)
    Z0 = m * (vv * (R00 * G0 + R01 * G1)).sum(0)                         # m sum_s v_s R_s G_s
    Z1 = m * (vv * (torch.conj_physical(R01) * G0 + R11 * G1)).sum(0)
    E0 = m * G0 - (i00 * Z0 + i01 * Z1)                                  # m G_s - Cxx^-1 Z
    E1 = m * G1 - (torch.conj_physical(i01) * Z0 + i11 * Z1)
    # pass 1: dL/dR_s = sum over frames of v_s U E_s^H (Hermitian parts)
    gR00 = (vv * (U0 * torch.conj_physical(E0)).real).sum(-1, keepdim=True)
    gR11 = (vv * (U1 * torch.conj_physical(E1)).real).sum(-1, keepdim=True)
    gR01 = (vv * (torch.conj_physical(U1) * E0 + U0 * torch.conj_physical(E1))).sum(-1, keepdim=True)
    # pass 2: through R = c / w to dL/dc, then per frame to dL/dv
    gw = -(gR00 * R00 + gR11 * R11 + (torch.conj_physical(gR01) * R01).real) / w
    gc00, gc11, gc01 = gR00 / w + 0.5 * gw, gR11 / w + 0.5 * gw, gR01 / w
    F0 = R00 * U0 + R01 * U1                                             # R_s U
    F1 = torch.conj_physical(R01) * U0 + R11 * U1
    gvv = (torch.conj_physical(E0) * F0 + torch.conj_physical(E1) * F1).real
    q = (torch.conj_physical(gc01) * f["pab"]).real
    gva = (gvv * va + 2.0 * gc00 * va + q * vb) * inv_m2
    gvb = (gvv * vb + 2.0 * gc11 * vb + q * va) * inv_m2
    return torch.stack([gva, gvb], dim=2)


def wiener_em_backward_plain(x: torch.Tensor, v: torch.Tensor, gy: torch.Tensor,
                             layout: BucketLayout) -> torch.Tensor:
    """Plain PyTorch version of K2's backward over a packed layout: packed
    x (layout.size,), v (4 * layout.size,) and the cotangent gy of the
    packed estimates (4 * layout.size,) complex64 -> dL/dv
    (4 * layout.size,) float32."""
    gvs = []
    for xb, vb, gb in zip(layout.split(x), layout.split(v, 4), layout.split(gy, 4)):
        xb, vb, gb = _frames(xb), _frames(vb), _frames(gb)
        gvs.append(_em_backward_bucket(xb, vb, gb, stability_scale(xb)).reshape(-1))
    return torch.cat(gvs)


@device_cache
def _device_tables(layout: BucketLayout, device: torch.device) -> dict:
    """K2's work tables for one layout on one device, built once (outside a
    trace). They are read only; every call allocates its own partial sums
    and max slots."""
    buckets, items1, items2 = work_items(layout)
    return dict(
        buckets=torch.from_numpy(buckets).to(device),
        items1=torch.from_numpy(items1).to(device),
        items2=torch.from_numpy(items2).to(device),
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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"wiener_em: unsupported device {x.device}")


def layout_ints(layout: BucketLayout) -> list:
    """A layout as the flat int list the registered op takes (five per bucket)."""
    return [d for shape in layout.shapes for d in shape]


def layout_of_ints(shapes) -> BucketLayout:
    """The inverse of `layout_ints`."""
    return BucketLayout([shapes[i: i + 5] for i in range(0, len(shapes), 5)])


def launch_forward(x: torch.Tensor, v: torch.Tensor, layout: BucketLayout):
    """K2's three forward launches on checked CUDA tensors with the layout's
    cached tables; see `launch`."""
    return launch(x, v, _device_tables(layout, x.device))


def launch(x: torch.Tensor, v: torch.Tensor, tables: dict):
    """K2's three forward launches on checked CUDA tensors (the registered
    op's CUDA implementation, kernels/ops.py). Returns the packed estimates
    and the call's own pass-1 partial sums and max slots, which the
    backward reads: no state is shared between calls."""
    from . import triton_wiener_em

    partials = torch.empty((tables["items1"].shape[0], 16), dtype=torch.float32, device=x.device)
    maxima = torch.zeros(tables["buckets"].shape[0], dtype=torch.float32, device=x.device)
    wiener_em.launches += 1                        # the fill of the max slots
    triton_wiener_em.pass1(x, v, tables, partials, maxima)
    wiener_em.launches += 1
    y = torch.empty(v.shape[0], dtype=torch.complex64, device=x.device)
    triton_wiener_em.pass2(x, v, tables, partials, maxima, y)
    wiener_em.launches += 1
    return y, partials, maxima


def wiener_em_backward(x: torch.Tensor, v: torch.Tensor, gy: torch.Tensor, layout: BucketLayout,
                       partials: torch.Tensor = None, maxima: torch.Tensor = None) -> torch.Tensor:
    """K2's backward: dL/dv (4 * layout.size,) float32 from the cotangent gy
    of the packed estimates. On CUDA tensors it takes the forward call's
    `partials` and `maxima` (from `launch_forward`) and runs two Triton
    launches, counted in `wiener_em_backward.launches`; on CPU tensors it
    runs `wiener_em_backward_plain`."""
    _check_grouped(x, v, layout)
    if gy.dtype != torch.complex64 or gy.shape != (4 * layout.size,) or not gy.is_contiguous():
        raise ValueError(f"wiener_em_backward: need contiguous complex64 gy ({4 * layout.size},)")
    if x.device.type == "cpu":
        return wiener_em_backward_plain(x, v, gy, layout)
    if partials is None or maxima is None:
        raise ValueError("wiener_em_backward: a CUDA call needs the forward's partials and maxima")
    from . import triton_wiener_em

    tables = _device_tables(layout, x.device)
    gpart = torch.empty_like(partials)
    triton_wiener_em.backward_pass1(x, v, gy, tables, partials, maxima, gpart)
    wiener_em_backward.launches += 1
    gv = torch.empty_like(v)
    triton_wiener_em.backward_pass2(x, v, gy, tables, partials, maxima, gpart, gv)
    wiener_em_backward.launches += 1
    return gv


wiener_em_backward.launches = 0


class _WienerEM(torch.autograd.Function):
    """K2 with its backward kernel. The forward is the registered op
    `xumx_slicq::wiener_em_grouped` (kernels/ops.py), one node under
    torch.export; it saves its own partial sums and max slots, so a second
    forward before `backward()` cannot change the first one's gradient."""

    @staticmethod
    def forward(ctx, x, v, layout):
        from . import ops

        ctx.layout = layout
        t = _device_tables(layout, x.device)
        y, partials, maxima = ops.wiener_em_grouped(x, v, t["buckets"], t["items1"], t["items2"],
                                                    layout_ints(layout))
        if x.device.type == "cpu":
            ctx.save_for_backward(x, v)                # the plain backward recomputes from x and v
        else:
            ctx.save_for_backward(x, v, partials, maxima)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, v, *state = ctx.saved_tensors
        return None, wiener_em_backward(x, v, gy.contiguous(), ctx.layout, *state), None


def wiener_em_grouped(x: torch.Tensor, v: torch.Tensor, layout: BucketLayout) -> torch.Tensor:
    """K2 over every bucket of `layout` on CUDA tensors, its plain version
    on CPU tensors; differentiable in v through K2's backward (the kernel's
    on CUDA tensors, the plain closed form on CPU tensors).

    x: packed mixture (layout.size,) complex64, v: packed magnitudes
    (4 * layout.size,) float32. Returns the packed estimates
    (4 * layout.size,) complex64 (`PackedBlocks(y, layout, 4)` views them
    per bucket). Three device launches per call, each counted in
    `wiener_em.launches`: zero the max slots, pass 1, pass 2."""
    _check_grouped(x, v, layout)
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("wiener_em: the mixture x is data and takes no gradient; detach it")
    return _WienerEM.apply(x, v, layout)


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
    forward device launches, whichever wrapper made them."""
    _check(x, v)
    B, _, F, T = x.shape
    return wiener_em_grouped(x.reshape(-1), v.reshape(-1), BucketLayout([(B, 2, F, 1, T)])).view(v.shape)


wiener_em.launches = 0
