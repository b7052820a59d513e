"""The port's Wiener-EM and mix-phase post-filters against the JAX package's.

Blocks carry exact zeros (a silent slice and zero magnitudes), where the
unit phase must be 1 and nothing may turn NaN. One stereo iteration runs
K2's grouped plain version (the CPU path of the K2 wrappers) on the packed
layout, which SliCQT.forward and Unmix make and wiener_blocks makes from a
plain list with one copy; three iterations and mono run the norbert-layout
functions. Tolerance: 1e-5
relative to the largest output (fp32 reduction order; measured ~5e-7).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from torch_port_utils import DEVICE, MEL12, TINY_LEN, blocks_rel_err, complex_noise, noise, rel_err, to_np

from xumx_slicq_tpu.ops import wiener as jw
from xumx_slicq_torch.kernels.wiener_em import (BLOCK, stability_scale, wiener_em, wiener_em_grouped,
                                                wiener_em_plain, work_items)
from xumx_slicq_torch.models import Unmix
from xumx_slicq_torch.ops import wiener as tw
from xumx_slicq_torch.ops.packed import BucketLayout, PackedBlocks, layout_of, pack
from xumx_slicq_torch.ops.slicqt import SliCQT

REL_TOL = 1e-5
SHAPES = [(2, 2, 3, 5, 8), (2, 2, 1, 4, 12)]     # (B, C, F, S, M)


def _blocks(channels=2, seed=0):
    mix, mag = [], []
    for i, (B, _, F, S, M) in enumerate(SHAPES):
        x = complex_noise(seed + i, (B, channels, F, S, M), scale=20.0)
        x[..., 0, :] = 0                          # a silent slice: exact zeros
        v = np.abs(noise(seed + 10 + i, (4, B, channels, F, S, M), scale=5.0))
        v[1, ..., 2] = 0
        mix.append(x)
        mag.append(v)
    return mix, mag


@pytest.mark.parametrize("iterations", [1, 3])
def test_wiener_blocks_match_jax(iterations):
    mix, mag = _blocks()
    ref = jax.jit(jw.wiener_blocks, static_argnums=2)(mix, mag, iterations)
    out = tw.wiener_blocks([torch.from_numpy(x) for x in mix], [torch.from_numpy(v) for v in mag], iterations)
    assert [tuple(o.shape) for o in out] == [v.shape for v in mag]
    assert all(torch.isfinite(torch.view_as_real(o)).all() for o in out)
    assert blocks_rel_err([to_np(o) for o in out], [np.asarray(r) for r in ref]) < REL_TOL


def test_wiener_blocks_mono_match_jax():
    mix, mag = _blocks(channels=1, seed=5)
    ref = jax.jit(jw.wiener_blocks, static_argnums=2)(mix, mag, 1)
    out = tw.wiener_blocks([torch.from_numpy(x) for x in mix], [torch.from_numpy(v) for v in mag], 1)
    assert blocks_rel_err([to_np(o) for o in out], [np.asarray(r) for r in ref]) < REL_TOL


def test_phasemix_blocks_match_jax():
    mix, mag = _blocks(seed=7)
    ref = jw.phasemix_blocks([jnp.asarray(x) for x in mix], [jnp.asarray(v) for v in mag])
    out = tw.phasemix_blocks([torch.from_numpy(x) for x in mix], [torch.from_numpy(v) for v in mag])
    assert blocks_rel_err([to_np(o) for o in out], [np.asarray(r) for r in ref]) < REL_TOL
    # zero mixture -> unit phase 1: the estimate is the magnitude itself
    np.testing.assert_array_equal(to_np(out[0])[:, :, :, :, 0, :].real, mag[0][:, :, :, :, 0, :])


def test_unit_phase_zero_semantics():
    x = torch.tensor([0j, 3 + 4j, -2j], dtype=torch.complex64)
    np.testing.assert_allclose(to_np(tw._unit_phase(x)), np.asarray(jw._unit_phase(jnp.asarray(to_np(x)))), atol=1e-7)
    assert tw._unit_phase(x)[0] == 1


def test_k2_plain_matches_norbert_layout():
    """K2's native-layout plain version computes blockwise_wiener's stereo
    one-iteration result, with one scale m over the whole batch."""
    mix, mag = _blocks(seed=3)
    for x, v in zip(mix, mag):
        B, C, F, S, M = x.shape
        xt, vt = torch.from_numpy(x), torch.from_numpy(v)
        ref = tw.blockwise_wiener(xt, vt, 1)
        out = wiener_em_plain(xt.reshape(B, C, F, S * M), vt.reshape(4, B, C, F, S * M), stability_scale(xt))
        assert rel_err(out.reshape(ref.shape), ref) < REL_TOL


def test_k2_wrapper_on_cpu_is_the_plain_version():
    mix, mag = _blocks(seed=4)
    B, C, F, S, M = mix[0].shape
    x = torch.from_numpy(mix[0]).reshape(B, C, F, S * M)
    v = torch.from_numpy(mag[0]).reshape(4, B, C, F, S * M)
    before = wiener_em.launches
    assert torch.equal(wiener_em(x, v), wiener_em_plain(x, v, stability_scale(x)))
    assert wiener_em.launches == before
    with pytest.raises(ValueError):
        wiener_em(x, v[:, :, :, :, :-1])
    with pytest.raises(ValueError):
        wiener_em(x.transpose(2, 3), v)


def test_wiener_gradients_finite_at_zeros():
    """Zero coefficients (padded or silent audio) give finite gradients
    through the model path's post-filter."""
    mix, mag = _blocks(seed=9)
    v = [torch.from_numpy(m).requires_grad_(True) for m in mag]
    out = tw.wiener_blocks([torch.from_numpy(x) for x in mix], v, 1)
    sum(torch.view_as_real(o).square().sum() for o in out).backward()
    assert all(torch.isfinite(t.grad).all() for t in v)


@pytest.fixture(scope="module")
def mel12():
    return SliCQT(device=DEVICE, **MEL12)


def _analysis(t, seed=0):
    """Packed mel-12 blocks of 0.1-RMS noise with a silent first slice,
    zeroed through the views, so |X| and the magnitudes are 0 there."""
    X = t.forward(torch.from_numpy(noise(seed, (2, 2, TINY_LEN), 0.1)))
    for xb in X:
        xb[:, :, :, 0] = 0
    return X


def test_forward_blocks_are_views_of_one_buffer(mel12):
    X = mel12.forward(torch.from_numpy(noise(1, (2, 2, TINY_LEN), 0.1)))
    layout = X.layout
    assert isinstance(X, PackedBlocks) and layout == mel12.layout(2, 2, X[0].shape[3])
    assert X.packed.shape == (layout.size,) and X.packed.dtype == torch.complex64
    assert [tuple(x.shape) for x in X] == list(layout.shapes) == mel12.block_shapes(2, 2, TINY_LEN)
    for x, off in zip(X, layout.offsets):
        assert x.is_contiguous() and x._base is X.packed
        assert x.data_ptr() == X.packed.data_ptr() + off * X.packed.element_size()
    assert layout.offsets[-1] + layout.sizes[-1] == layout.size


def test_pack_copies_a_plain_list_once(mel12):
    """A plain blocks list packs into one buffer in the layout its shapes
    give (that of SliCQT.forward); packed blocks pack to themselves; and
    wiener_blocks gives the same estimates for either."""
    X = _analysis(mel12, seed=3)
    mags = [torch.from_numpy(np.abs(noise(50 + i, (4,) + tuple(x.shape), 0.2))) for i, x in enumerate(X)]
    assert pack(X) is X and layout_of(list(X)) == X.layout == BucketLayout(X.layout.shapes)
    V = pack(mags, 4)
    assert V.layout == X.layout and V.packed.shape == (4 * X.layout.size,)
    assert all(torch.equal(a, b) for a, b in zip(V, mags))
    assert layout_of(mags, 4) == X.layout and hash(layout_of(mags, 4)) == hash(X.layout)
    listed = tw.wiener_blocks(list(X), mags, 1)
    packed = tw.wiener_blocks(X, V, 1)
    assert isinstance(listed, PackedBlocks) and listed.layout == packed.layout == X.layout
    assert torch.equal(listed.packed, packed.packed)
    with pytest.raises(ValueError):
        tw.wiener_blocks(X, mags[::-1], 1)


def test_packed_path_matches_jax(mel12):
    """SliCQT.forward -> Unmix -> wiener_blocks on the packed layout, all
    buckets sharing one S, against the JAX package's wiener_blocks on the
    same blocks and magnitudes."""
    X = _analysis(mel12)
    model = Unmix(mel12.block_shapes(2, 2, TINY_LEN), seed=1, device=DEVICE)
    with torch.no_grad():
        folded = model.fold_batchnorm()
        Y, _ = model.apply(X, folded)
        mags, _ = model.magnitudes(X, folded)
    assert isinstance(Y, PackedBlocks) and Y.layout is X.layout and Y.packed.shape == (4 * X.layout.size,)
    assert mags.layout is X.layout and all(float(m[..., 0, :].abs().max()) == 0 for m in mags)
    ref = jax.jit(jw.wiener_blocks, static_argnums=2)([to_np(x) for x in X], [to_np(m) for m in mags], 1)
    assert blocks_rel_err([to_np(y) for y in Y], [np.asarray(r) for r in ref]) < REL_TOL
    assert all(torch.isfinite(torch.view_as_real(y)).all() for y in Y)


def test_grouped_scale_is_per_bucket(mel12):
    """Scaling one bucket's x and v by 1e3 leaves every other bucket's
    estimate as it was and gives that bucket its own one-bucket result: the
    stability scale m is per bucket, never one over the group."""
    layout = mel12.layout(2, 2, 5)
    x = torch.from_numpy(complex_noise(40, (layout.size,), 3.0))
    v = torch.from_numpy(np.abs(noise(41, (4 * layout.size,), 2.0)))
    base = PackedBlocks(wiener_em_grouped(x, v, layout), layout, 4)
    k = len(layout.shapes) // 2
    xs, vs = PackedBlocks(x.clone(), layout), PackedBlocks(v.clone(), layout, 4)
    xs[k].mul_(1e3)
    vs[k].mul_(1e3)
    assert float(stability_scale(xs[k])) > 10.0
    out = PackedBlocks(wiener_em_grouped(xs.packed, vs.packed, layout), layout, 4)
    for i, (a, b) in enumerate(zip(out, base)):
        if i != k:
            assert rel_err(a, b) < 1e-6, i
    B, C, F, S, M = layout.shapes[k]
    own = wiener_em(xs[k].reshape(B, C, F, S * M), vs[k].reshape(4, B, C, F, S * M))
    assert rel_err(out[k].reshape(own.shape), own) < 1e-6


@pytest.mark.parametrize("cfg", [MEL12, {}], ids=["mel-12", "bark-262"])
def test_work_items_cover_every_frame_once(cfg):
    """K2's work tables: pass-2 items tile every (bucket, row, frame) of the
    layout exactly once, and pass-1 item i holds the partial sums that pass 2
    reads at first + row * splits + split. At bark-262 with the default
    chunk and a chunk batch of 4: 5,916 and 85,624 items."""
    t = SliCQT(device=DEVICE, **cfg)
    S = t.n_slices(2621440 if not cfg else TINY_LEN)
    layout = t.layout(4 if not cfg else 2, 2, S)
    buckets, p1, p2 = work_items(layout)
    assert buckets.shape == (len(layout.shapes), 6)
    k = p1[:, 0]
    np.testing.assert_array_equal(buckets[k, 5] + p1[:, 1] * buckets[k, 4] + p1[:, 2], np.arange(len(p1)))
    rows = np.asarray([B * F for B, _, F, _, _ in layout.shapes])
    frames = sum(B * F * S * M for B, _, F, S, M in layout.shapes)
    assert len(set(map(tuple, p2.tolist()))) == len(p2)
    T = buckets[p2[:, 0], 2]
    assert (p2[:, 2] * BLOCK < T).all() and (p2[:, 1] < rows[p2[:, 0]]).all()
    assert int(np.minimum(T - p2[:, 2] * BLOCK, BLOCK).sum()) == frames
    if not cfg:
        assert (len(p1), len(p2), rows.sum(), frames) == (5916, 85624, 1052, 21771520)


def test_unmix_packs_with_grad_on(mel12):
    """With autograd on, Unmix packs the magnitudes by concatenation (out=
    writes do not differentiate): same estimates, finite gradients."""
    X = _analysis(mel12, seed=2)
    model = Unmix(mel12.block_shapes(2, 2, TINY_LEN), seed=4, device=DEVICE)
    with torch.no_grad():
        ref, _ = model.apply(X)
    Y, _ = model.apply(X)
    assert isinstance(Y, PackedBlocks) and Y.packed.requires_grad
    assert blocks_rel_err([to_np(y) for y in Y], [to_np(r) for r in ref]) < 1e-6
    torch.view_as_real(Y.packed).square().sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
    assert model.blocks[0].enc1_w.grad is not None
