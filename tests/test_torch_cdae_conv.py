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


def _walk(X, weights, layout, realtime):
    """K4's four launches as csrc/cdae_conv.cu computes them, one plan row
    and target at a time: each row's reduction gathered through the step
    table with the kernel's bounds checks, times the packed [R_pad][ldw]
    weights, with the kernel's epilogue indices. Also checks that the work
    items cover every (bucket, target, row tile, column tile) once."""
    arch, w = weights.arch, weights.w
    plan, items, rtab, sizes = cdae_conv.work_tables(layout, arch, realtime)
    plan, items, rtab = torch.from_numpy(plan), torch.from_numpy(items), torch.from_numpy(rtab)
    n, nb = arch.targets, len(layout.shapes)
    fld = {f: i for i, f in enumerate(cdae_conv.PLAN_FIELDS)}
    h13, h2 = torch.full((sizes[4],), float("nan")), torch.full((sizes[5],), float("nan"))
    masks, mags = torch.full((n * layout.size,), float("nan")), torch.full((n * layout.size,), float("nan"))
    first = 0
    for li, (name, src, dst) in enumerate(zip(cdae_conv.LAYERS, (X, h13, h2, h13), (h13, h2, h13, masks))):
        bm, bn = cdae_conv.DEC2_TILE if name == "dec2" else cdae_conv.CONV_TILE
        layer_items = items[first: first + sizes[li]]
        first += sizes[li]
        expect = set()
        for k in range(nb):
            p = {f: int(plan[li * nb + k, i]) for f, i in fld.items()}
            expect |= {(li * nb + k, g, rt, ct) for g in range(n) for rt in range(-(-p["rows"] // bm))
                       for ct in range(p["ldw"] // bn)}
            rows = torch.arange(p["rows"])
            b, rem = rows // p["foko"], rows % p["foko"]
            f, kk = rem // p["ko"], rem % p["ko"]
            kr = kk * p["kstride"] - p["kpad"]
            e = rtab[p["rtab_off"]: p["rtab_off"] + p["r_pad"]].long()
            fi, ki = f[:, None] + e[None, :, 1], kr[:, None] + e[None, :, 2]
            ok = (fi >= 0) & (fi < p["fin"]) & (ki >= 0) & (ki < p["kin"])
            cols = torch.arange(p["n"])
            for g in range(n):
                base = p["in_off"] + b * p["in_bstride"] + g * p["in_gstride"] + f * p["kin"] + kr
                idx = torch.where(ok, base[:, None] + e[None, :, 0], 0)
                if name == "enc1":
                    fw = torch.where(ok, fi, 0)
                    v = (src[idx].abs() + w[p["white_off"] + fw]) * w[p["white_off"] + p["fin"] + fw]
                else:
                    v = src[idx]
                A = torch.where(ok, v, 0.0)
                Wm = w[p["w_off"] + g * p["r_pad"] * p["ldw"]:][: p["r_pad"] * p["ldw"]].view(p["r_pad"], p["ldw"])
                Y = (A @ Wm)[:, : p["n"]]
                if name != "dec2":
                    o = p["out_off"] + b * p["out_bstride"] + g * p["out_gstride"] + rem
                    dst[o[:, None] + cols[None, :] * p["out_cstride"]] = torch.relu(
                        Y + w[p["bias_off"] + g * p["n"] + cols])
                    continue
                hop = p["hop"]
                c, t = cols // hop, cols % hop
                pos = b[:, None] * p["out_bstride"] + c[None, :] * p["out_cstride"] + rem[:, None] * hop + t[None, :]
                m = torch.sigmoid(Y + w[p["bias_off"] + g * (p["n"] // hop) + c])
                dst[p["out_off"] + g * p["out_gstride"] + pos] = m
                mags[p["out_off"] + g * p["out_gstride"] + pos] = m * X[p["x_off"] + pos].abs()
        assert {tuple(it) for it in layer_items.tolist()} == expect and len(layer_items) == len(expect)
        costs = [int(plan[it[0], fld["r_pad"]]) for it in layer_items.tolist()]
        assert costs == sorted(costs, reverse=True)          # heaviest reductions first
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
