"""K4 (kernels/cdae_conv.py), the folded CDAE of every bucket, on the CPU.

The registered op's CPU implementation (the grouped plain version over
packed buffers) against each bucket's module in eval mode, BatchNorm from
its running statistics (not folded), at mel-12 and at hand-made buckets
with fphi 1, 3 and 5, offline and realtime, with 4 targets and with 2 (a
target-parallel rank's module), at 1e-6. The kernel's
own tables (plan rows, reduction steps, work items) walked in PyTorch, as
csrc/cdae_conv.cu walks them, against the plain version at 1e-5 (fp32 sums
in another order). And `Unmix.magnitudes(prepared=...)` against the JAX
package's folded `apply` at the hand-made buckets, at 1e-5 of the largest
value, through the golden tests/goldens/cdae_folded_<case>.npz (the `slow`
twin recomputes it live). No test here compiles a JAX program.
"""

import numpy as np
import pytest
import torch

import torch_goldens as goldens
from torch_port_utils import DEVICE, MEL12, complex_noise, perturb_cdae

from xumx_slicq_torch.kernels import cdae_conv
from xumx_slicq_torch.models import Unmix
from xumx_slicq_torch.models.cdae import SlicedCDAE
from xumx_slicq_torch.ops.packed import BucketLayout, PackedBlocks
from xumx_slicq_torch.ops.slicqt import SliCQT

torch.set_num_threads(1)

PLAIN_TOL = 1e-6
WALK_TOL = 1e-5
JAX_TOL = 1e-5
# (B, C, F, S, T): fphi 1, 3 and 5; odd and even S
HANDMADE = [(2, 2, 4, 5, 8), (2, 2, 12, 4, 12), (2, 2, 22, 3, 16)]
CASES = ["mel12", "handmade"]
REALTIME = [False, True]


def _shapes(case):
    if case == "mel12":
        return SliCQT(device=DEVICE, **MEL12).block_shapes(1, 2, 8192)
    return HANDMADE


def _blocks(shapes, realtime, targets, seed=0):
    g = torch.Generator().manual_seed(seed)
    blocks = [SlicedCDAE(C, F, T, realtime=realtime, targets=targets) for (_, C, F, _, T) in shapes]
    for blk in blocks:
        blk.reset_parameters(g)
        blk.eval()
    perturb_cdae(blocks, seed + 1)
    return blocks


def _case(case, realtime, targets):
    shapes = _shapes(case)
    layout = BucketLayout(shapes)
    blocks = _blocks(shapes, realtime, targets)
    arch = cdae_conv.CdaeArch(tuple((C, F, T, blk.fphi) for (_, C, F, _, T), blk in zip(shapes, blocks)), targets)
    with torch.no_grad():
        folded = [blk.fold_batchnorm() for blk in blocks]
    weights = cdae_conv.pack_weights(folded, arch)
    X = torch.from_numpy(complex_noise(7, (layout.size,)))
    return layout, blocks, folded, weights, X


@pytest.mark.parametrize("targets", [4, 2])
@pytest.mark.parametrize("realtime", REALTIME, ids=["offline", "realtime"])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_module(case, realtime, targets):
    """The op's CPU implementation against each bucket's module with its
    BatchNorm unfolded."""
    layout, blocks, _, weights, X = _case(case, realtime, targets)
    with torch.no_grad():
        mags, masks = cdae_conv.cdae_folded(X, weights, layout, realtime)
        for blk, xb, mb, gb in zip(blocks, layout.split(X), layout.split(masks, targets),
                                   layout.split(mags, targets)):
            xm = xb.abs()
            ref = blk(xm)
            assert mb.shape == ref.shape
            assert float((mb - ref).abs().max()) <= PLAIN_TOL
            ref_mag = ref * xm[None]
            assert float((gb - ref_mag).abs().max()) <= PLAIN_TOL * float(ref_mag.abs().max())


def mm_3xtf32(a: torch.Tensor, w_hi: torch.Tensor, w_lo: torch.Tensor, steps: int = 8) -> torch.Tensor:
    """a @ w, float32 (M, R) x (R, N), as csrc/cdae_conv.cu's tensor cores
    sum it from w's TF32 parts: a chunk of `steps` reduction steps at a
    time, with hi = tf32_round(a) and lo = tf32_round(a - hi), acc += lo_a
    hi_w, then hi_a lo_w, then hi_a hi_w, in float32."""
    ah = cdae_conv.tf32_round(a)
    al = cdae_conv.tf32_round(a - ah)
    acc = torch.zeros(a.shape[0], w_hi.shape[1], dtype=torch.float32)
    for k in range(0, a.shape[1], steps):
        s = slice(k, k + steps)
        acc += al[:, s] @ w_hi[s]
        acc += ah[:, s] @ w_lo[s]
        acc += ah[:, s] @ w_hi[s]
    return acc


def _split(w: torch.Tensor):
    """(hi, lo) of float32 w, as pack_weights splits the weights."""
    hi = cdae_conv.tf32_round(w)
    return hi, cdae_conv.tf32_round(w - hi)


def _check_lines(A, src, p, e, b, f, k, kr, rows, bm, g, lw, line_length):
    """The line gather of enc2, dec1 (lw = TF2 time steps a line) and dec2
    (lw = 2 half slices) as csrc/cdae_conv.cu runs it: per group of lw steps
    one line a row tile, row r at line position pos(r) = r' + (lw - 1)
    (row // ko - row0 // ko) (r' its place in the tile); each row copies the
    line's element pos(r) + lw - 1, a row that starts a tile or a k = 0 run
    also pos(r) .. pos(r) + lw - 2. Checks that no element is written twice
    and that every step t of every row reads its per-element gather A[row,
    step] at pos(r) + t (enc2) or pos(r) + lw - 1 - t (dec1, dec2), inside
    the line length the launch sizes."""
    tile, rel = rows // bm, rows % bm
    pos = rel + (lw - 1) * (rows // p["ko"] - (tile * bm) // p["ko"])
    start = (rel == 0) | (k == 0)
    sgn = int(e[1, 2])                       # dk of step 1: +1 (k + t) or -1 (k - t)
    aoff = 0 if sgn > 0 else 1 - lw
    heads = e[0::lw]                         # each line's step t = 0
    base = p["in_off"] + b * p["in_bstride"] + g * p["in_gstride"] + f * p["kin"] + kr
    line = torch.full((int(tile.max()) + 1, heads.shape[0], line_length), float("nan"))
    writes = torch.zeros(line.shape, dtype=torch.int64)
    lines = torch.arange(heads.shape[0])
    for j in range(lw):
        who = start if j < lw - 1 else torch.ones_like(start)
        fi = f[:, None] + heads[None, :, 1]
        ki = kr[:, None] + heads[None, :, 2] + aoff + j
        ok = (fi >= 0) & (fi < p["fin"]) & (ki >= 0) & (ki < p["kin"])
        val = torch.where(ok, src[torch.where(ok, base[:, None] + heads[None, :, 0] + aoff + j, 0)], 0)
        t_i, l_i = tile[who][:, None].expand(-1, lines.numel()), lines[None, :].expand(int(who.sum()), -1)
        x_i = (pos[who] + j)[:, None].expand(-1, lines.numel())
        line[t_i, l_i, x_i] = val[who]
        writes.index_put_((t_i, l_i, x_i), torch.ones_like(x_i), accumulate=True)
    assert int(writes.max()) == 1 and line_length % 32 == 16
    for t in range(lw):
        got = line[tile[:, None], lines[None, :], (pos + (t if sgn > 0 else lw - 1 - t))[:, None]]
        assert torch.equal(got, A[:, t::lw])


def _walk(X, weights, layout, realtime):
    """K4's four launches as csrc/cdae_conv.cu computes them, one plan row
    and target at a time: each row's reduction gathered through the step
    table with the kernel's bounds checks (a zero-filled copy where a step
    falls outside the input; enc1 copies the complex pair and whitens it as
    the fragment is built, 0 where the step is outside, not the whitening
    of 0), then, column tile by column tile as a block walks them, the 3xTF32
    product with the weights' split copy (hi and lo in the fragments' order)
    chunk by chunk, and the kernel's epilogue indices. Also checks that the
    work items cover every (bucket, target, row tile) once (an enc1 item
    holds two targets), heaviest first, and that the split copy is the
    fp32 matrix's."""
    arch, w = weights.arch, weights.w
    plan, items, rtab, sizes = cdae_conv.work_tables(layout, arch, realtime)
    plan, items, rtab = torch.from_numpy(plan), torch.from_numpy(items), torch.from_numpy(rtab)
    n, nb = arch.targets, len(layout.shapes)
    fld = {f: i for i, f in enumerate(cdae_conv.PLAN_FIELDS)}
    unpacked = [[w[o: o + n * r_pad * ldw].view(n, r_pad, ldw) for o, _, r_pad, _, ldw, _ in e["layers"].values()]
                for e in cdae_conv._offsets(arch)]
    h13, h2 = torch.full((sizes[4],), float("nan")), torch.full((sizes[5],), float("nan"))
    masks, mags = torch.full((n * layout.size,), float("nan")), torch.full((n * layout.size,), float("nan"))
    first = 0
    for li, (name, src, dst) in enumerate(zip(cdae_conv.LAYERS, (X, h13, h2, h13), (h13, h2, h13, masks))):
        bm, bn = cdae_conv.TILES[name]
        gt = cdae_conv.ENC1_TARGETS if name == "enc1" else 1
        layer_items = items[first: first + sizes[li]]
        first += sizes[li]
        expect, cost = set(), {}
        for k in range(nb):
            p = {f: int(plan[li * nb + k, i]) for f, i in fld.items()}
            assert p["r_pad"] % cdae_conv.RC[name] == 0 and p["ldw"] % 8 == 0 and p["w_off"] % 4 == 0
            expect |= {(li * nb + k, g, rt, min(gt, n - g)) for g in range(0, n, gt)
                       for rt in range(-(-p["rows"] // bm))}
            cost[li * nb + k] = p["r_pad"] * -(-p["ldw"] // bn)
            rows = torch.arange(p["rows"])
            b, rem = rows // p["foko"], rows % p["foko"]
            f, kk = rem // p["ko"], rem % p["ko"]
            kr = kk * p["kstride"] - p["kpad"]
            e = rtab[p["rtab_off"]: p["rtab_off"] + p["r_pad"]].long()
            fi, ki = f[:, None] + e[None, :, 1], kr[:, None] + e[None, :, 2]
            ok = (fi >= 0) & (fi < p["fin"]) & (ki >= 0) & (ki < p["kin"])
            for g in range(n):
                base = p["in_off"] + b * p["in_bstride"] + g * p["in_gstride"] + f * p["kin"] + kr
                copy = torch.where(ok, src[torch.where(ok, base[:, None] + e[None, :, 0], 0)], 0)
                if name in cdae_conv.LINE_WIDTH:
                    _check_lines(copy, src, p, e, b, f, kk, kr, rows, bm, g, cdae_conv.LINE_WIDTH[name],
                                 sizes[10 + li])
                if name == "enc1":          # the fragment: whiten the copied pair where the step is inside
                    fw = torch.where(ok, fi, 0)
                    A = torch.where(ok, (copy.abs() + w[p["white_off"] + fw]) * w[p["white_off"] + p["fin"] + fw], 0.0)
                else:
                    A = copy
                q = w[p["w_off"] + 2 * g * p["r_pad"] * p["ldw"]:][: 2 * p["r_pad"] * p["ldw"]]
                q = q.view(p["r_pad"] // 8, p["ldw"], 4, 2, 2)       # [8 steps][col][t][hi, lo][t, t + 4]
                w_hi, w_lo = (q[:, :, :, i].permute(0, 3, 2, 1).reshape(p["r_pad"], p["ldw"]) for i in (0, 1))
                fp32 = unpacked[k][li][g]
                assert torch.equal(w_hi, _split(fp32)[0]) and torch.equal(w_lo, _split(fp32)[1])
                for c0 in range(0, p["ldw"], bn):        # the block's column tiles
                    cols = torch.arange(c0, min(c0 + bn, p["ldw"]))
                    Y = mm_3xtf32(A, w_hi[:, cols], w_lo[:, cols])
                    Y, cols = Y[:, cols < p["n"]], cols[cols < p["n"]]
                    if name != "dec2":
                        o = p["out_off"] + b * p["out_bstride"] + g * p["out_gstride"] + rem
                        dst[o[:, None] + cols[None, :] * p["out_cstride"]] = torch.relu(
                            Y + w[p["bias_off"] + g * p["n"] + cols])
                        continue
                    hop = p["hop"]
                    c, t = cols // hop, cols % hop
                    pos = (b[:, None] * p["out_bstride"] + c[None, :] * p["out_cstride"] + rem[:, None] * hop
                           + t[None, :])
                    m = torch.sigmoid(Y + w[p["bias_off"] + g * (p["n"] // hop) + c])
                    dst[p["out_off"] + g * p["out_gstride"] + pos] = m
                    mags[p["out_off"] + g * p["out_gstride"] + pos] = m * X[p["x_off"] + pos].abs()
        assert {tuple(it) for it in layer_items.tolist()} == expect and len(layer_items) == len(expect)
        costs = [cost[it[0]] for it in layer_items.tolist()]
        assert costs == sorted(costs, reverse=True)          # heaviest items first
    return mags, masks


@pytest.mark.parametrize("targets", [4, 2])
@pytest.mark.parametrize("realtime", REALTIME, ids=["offline", "realtime"])
@pytest.mark.parametrize("case", CASES)
def test_kernel_tables_walk_matches_plain(case, realtime, targets):
    """The kernel's tables, walked as the kernel walks them, give the plain
    version's masks and magnitudes, and write every output."""
    layout, _, _, weights, X = _case(case, realtime, targets)
    with torch.no_grad():
        mags, masks = cdae_conv.cdae_folded(X, weights, layout, realtime)
        wmags, wmasks = _walk(X, weights, layout, realtime)
    assert not torch.isnan(wmasks).any() and not torch.isnan(wmags).any()
    assert float((wmasks - masks).abs().max()) <= WALK_TOL
    assert float((wmags - mags).abs().max()) <= WALK_TOL * float(mags.abs().max())


@pytest.mark.parametrize("steps", [160, 500, 1000], ids=["enc1", "dec2", "enc2_dec1"])
def test_3xtf32_keeps_fp32_accuracy(steps):
    """The kernel's 3xTF32 product (`mm_3xtf32`) over the reductions of the
    F = 86 bucket (enc1 160 steps, dec2 500, enc2 and dec1 1,000) on
    activation-scale data (ReLU outputs times weights of variance 1/R) stays
    within 1e-6 of float64, as fp32 FMAs summed step by step (the CUDA-core
    kernel's arithmetic) and fp32 BLAS do; single-pass TF32 does not. The
    errors are relative to the largest sum of |a| |w|, the scale of a sum's
    rounding error."""
    rng = np.random.default_rng(steps)
    a = np.maximum(rng.standard_normal((256, steps)), 0).astype(np.float32)
    w = (rng.standard_normal((steps, 56)) / np.sqrt(steps)).astype(np.float32)
    ref = a.astype(np.float64) @ w.astype(np.float64)
    scale = float((np.abs(a).astype(np.float64) @ np.abs(w).astype(np.float64)).max())
    at, wt = torch.from_numpy(a), torch.from_numpy(w)

    def err(y):
        return float(np.abs(y.numpy().astype(np.float64) - ref).max()) / scale

    fma = torch.zeros(256, 56)
    for k in range(steps):
        fma = torch.addcmul(fma, at[:, k: k + 1], wt[k: k + 1])
    assert err(fma) <= 1e-6 and err(at @ wt) <= 1e-6
    assert err(mm_3xtf32(at, *_split(wt))) <= 1e-6
    assert err(cdae_conv.tf32_round(at) @ cdae_conv.tf32_round(wt)) > 1e-5


def test_tf32_round_is_cvt_rna():
    """tf32_round keeps 10 mantissa bits, rounding to nearest with ties away
    from zero (PTX cvt.rna.tf32.f32), on either sign."""
    u = 2.0 ** -10                    # one TF32 ulp at 1
    x = torch.tensor([1 + u / 2, 1 + u / 2 - 2 ** -23, 1 + 3 * u / 2, 1 + u / 4, -(1 + u / 2), 3.0e-30, 0.0])
    ref = torch.tensor([1 + u, 1.0, 1 + 2 * u, 1.0, -(1 + u), 3.0e-30, 0.0])
    got = cdae_conv.tf32_round(x)
    assert torch.equal(got[:5], ref[:5]) and got[6] == 0
    assert (got.view(torch.int32) & 0x1FFF == 0).all() and abs(float(got[5]) / 3.0e-30 - 1) < 2 ** -10


def test_work_tables_at_the_main_path():
    """K4's tables at bark-262, a chunk batch of 4 default chunks, offline:
    every plan row's steps and columns padded to the kernel's chunks and n8
    tiles, the F = 86 bucket's items first in enc2 and dec1, and every dec2
    bucket with more than one column tile short enough to stay resident."""
    t = SliCQT(device=DEVICE)
    shapes = t.block_shapes(4, 2, 2621440)
    fphi = [SlicedCDAE(C, F, T).fphi for (_, C, F, _, T) in shapes]
    arch = cdae_conv.CdaeArch(tuple((C, F, T, f) for (_, C, F, _, T), f in zip(shapes, fphi)))
    plan, items, rtab, sizes = cdae_conv.work_tables(BucketLayout(shapes), arch, False)
    fld = {f: i for i, f in enumerate(cdae_conv.PLAN_FIELDS)}
    nb, wide = len(shapes), shapes.index(next(s for s in shapes if s[2] == 86))
    assert (plan[:, fld["ldw"]] % 8 == 0).all()
    first = np.cumsum([0] + sizes[:4])
    for li, name in enumerate(cdae_conv.LAYERS):
        layer = items[first[li]: first[li + 1]]
        assert (plan[li * nb: (li + 1) * nb, fld["r_pad"]] % cdae_conv.RC[name] == 0).all()
        assert sizes[6 + li] == plan[li * nb: (li + 1) * nb, fld["r_pad"]].max()
        if name in ("enc2", "dec1"):
            assert plan[layer[0, 0], fld["r_pad"]] >= 1000 and layer[0, 0] == li * nb + wide
    dec2 = plan[3 * nb:]
    tiles = -(-dec2[:, fld["ldw"]] // cdae_conv.DEC2_TILE[1])
    assert (dec2[tiles > 1, fld["r_pad"]] <= cdae_conv.DEC2_RESIDENT).all() and (tiles > 1).sum() > 40


def test_weights_round_trip_and_refusals():
    """pack_weights / unpack_weights are inverse; the wrapper refuses a
    gradient, a layout of other buckets and an unpacked mixture; an amp
    model's folded weights are refused on the CPU too."""
    layout, blocks, folded, weights, X = _case("handmade", False, 4)
    for p, q in zip(folded, cdae_conv.unpack_weights(weights.w, weights.arch)):
        assert p.keys() == q.keys()
        for k in p:
            assert torch.equal(p[k].detach(), q[k]), k
    with pytest.raises(ValueError, match="gradient"):
        cdae_conv.cdae_folded(X.clone().requires_grad_(), weights, layout, False)
    with pytest.raises(ValueError, match="buckets differ"):
        other = BucketLayout([(2, 2, 12, 4, 12)])
        cdae_conv.cdae_folded(X[: other.size].contiguous(), weights, other, False)
    with pytest.raises(ValueError, match="packed"):
        cdae_conv.cdae_folded(X.view(2, -1), weights, layout, False)
    amp = Unmix(HANDMADE, amp=True, device=DEVICE)
    Xb = layout.split(X)
    with torch.no_grad(), pytest.raises(ValueError, match="amp"):
        amp.magnitudes(Xb, amp.inference_weights())
    with torch.no_grad(), pytest.raises(ValueError, match="amp"):
        amp.blocks[0](Xb[0].abs(), amp.blocks[0].fold_batchnorm())


# -- Unmix.magnitudes(prepared=...) against the JAX package ------------------------


def _unmix(realtime):
    model = Unmix(HANDMADE, realtime=realtime, seed=3, device=DEVICE)
    perturb_cdae(model.blocks, 11)
    return model


def _mixture():
    return [complex_noise(20 + i, s, 0.5) for i, s in enumerate(HANDMADE)]


def _inputs_fingerprint(model, X):
    return goldens.state_fingerprint(model.state_dict(), *X)


def _jax_masks(model, X, realtime):
    """The JAX package's folded forward of the port's weights: masks per bucket."""
    import jax

    from xumx_slicq_torch.models.convert import to_reference_state_dict
    from xumx_slicq_tpu.models import Unmix as JaxUnmix
    from xumx_slicq_tpu.models.torch_import import import_cdae_state_dict

    ref_sd = to_reference_state_dict(model)
    params, stats = import_cdae_state_dict({k: v.numpy() for k, v in ref_sd.items()}, len(HANDMADE))
    ju = JaxUnmix(HANDMADE, realtime=realtime)
    _, masks, _ = jax.jit(lambda p, X: ju.apply(p, None, X))(ju.fold_batchnorm(params, stats), X)
    return [np.asarray(m) for m in masks]


@pytest.mark.parametrize("realtime", REALTIME, ids=["offline", "realtime"])
def test_magnitudes_match_jax_golden(realtime):
    """Unmix.magnitudes with inference weights (K4's CPU path) against the
    JAX package's folded apply, fphi 1/3/5: masks, and magnitudes against
    the JAX masks times |X|."""
    model, X = _unmix(realtime), _mixture()
    ref = goldens.load(f"cdae_folded_{'realtime' if realtime else 'offline'}", _inputs_fingerprint(model, X))
    with torch.no_grad():
        mags, masks = model.magnitudes([torch.from_numpy(x) for x in X], model.inference_weights())
    assert isinstance(mags, PackedBlocks)
    for i, (m, g, x) in enumerate(zip(masks, mags, X)):
        jm = ref[f"masks_{i}"]
        assert m.shape == jm.shape
        scale = float(np.abs(jm).max())
        assert float(np.abs(m.numpy() - jm).max()) <= JAX_TOL * scale
        jmag = jm * np.abs(x)[None]
        assert float(np.abs(g.numpy() - jmag).max()) <= JAX_TOL * float(np.abs(jmag).max())


@pytest.mark.slow
@pytest.mark.parametrize("realtime", REALTIME, ids=["offline", "realtime"])
def test_magnitudes_golden_matches_live_jax(realtime):
    """The golden of test_magnitudes_match_jax_golden recomputed from the JAX package."""
    model, X = _unmix(realtime), _mixture()
    ref = goldens.load(f"cdae_folded_{'realtime' if realtime else 'offline'}", _inputs_fingerprint(model, X))
    live = _jax_masks(model, X, realtime)
    for i, m in enumerate(live):
        np.testing.assert_allclose(ref[f"masks_{i}"], m, rtol=0, atol=JAX_TOL * float(np.abs(m).max()))


def _golden(realtime):
    model, X = _unmix(realtime), _mixture()
    return _inputs_fingerprint(model, X), {f"masks_{i}": m for i, m in enumerate(_jax_masks(model, X, realtime))}


GOLDENS = {f"cdae_folded_{name}": (lambda rt=rt: _golden(rt)) for name, rt in (("offline", False), ("realtime", True))}
