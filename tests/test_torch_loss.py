"""The port's training losses, and the plain backward versions of K1 and K2.

Losses: the same numpy blocks and stems go to xumx_slicq_tpu.loss and
xumx_slicq_torch.loss, relative error <= 1e-5 (fp32 sums in another
order); their gradients must stay finite where a difference is exactly
zero. Backward: `wiener_em_backward_plain` against autograd of
`wiener_em_grouped_plain` (relative error <= 1e-4: fp32 sums in another
order through the 2x2 inverse; measured ~3e-7) and
`synth_assembly_backward_plain` against autograd of `synth_assembly_plain`
(<= 1e-6: the same products, summed in the same order), with exact zeros
in x.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from torch_port_utils import DEVICE, MEL12, complex_noise, noise, rel_err

from xumx_slicq_tpu import loss as jloss
from xumx_slicq_torch import loss as tloss
from xumx_slicq_torch.kernels.synth_assembly import (synth_assembly, synth_assembly_backward,
                                                     synth_assembly_backward_plain, synth_assembly_plain)
from xumx_slicq_torch.kernels.wiener_em import (wiener_em_backward, wiener_em_backward_plain,
                                                wiener_em_grouped, wiener_em_grouped_plain)
from xumx_slicq_torch.ops.packed import BucketLayout, PackedBlocks
from xumx_slicq_torch.ops.slicqt import SliCQT

SHAPES = [(2, 2, 3, 5, 8), (2, 2, 1, 4, 12), (2, 2, 7, 3, 6)]     # (B, C, F, S, M)


def _complex_blocks(seed, scale=1.0):
    return [complex_noise(seed + i, (4,) + s, scale) for i, s in enumerate(SHAPES)]


@pytest.mark.parametrize("zero_diff", [False, True], ids=["noise", "exact-zeros"])
def test_complex_mse_matches_jax(zero_diff):
    pred, target = _complex_blocks(0), _complex_blocks(10)
    if zero_diff:
        target[0][1] = pred[0][1]                          # a target matched exactly
    ref = float(jloss.complex_mse_loss([jnp.asarray(p) for p in pred], [jnp.asarray(t) for t in target]))
    tp = [torch.from_numpy(p).requires_grad_(True) for p in pred]
    out = tloss.complex_mse_loss(tp, [torch.from_numpy(t) for t in target])
    assert abs(out.item() - ref) <= 1e-5 * abs(ref)
    out.backward()
    assert all(torch.isfinite(torch.view_as_real(p.grad)).all() for p in tp)


def test_mask_sum_matches_jax():
    masks = [np.abs(noise(20 + i, (4,) + s)) for i, s in enumerate(SHAPES)]
    ref = float(jloss.mask_sum_loss([jnp.asarray(m) for m in masks]))
    out = float(tloss.mask_sum_loss([torch.from_numpy(m) for m in masks]))
    assert abs(out - ref) <= 1e-5 * abs(ref)


def test_sdsdr_matches_jax():
    target = noise(30, (4, 2, 2, 3000), 0.1)
    pred = target + noise(31, target.shape, 0.05)
    pred[2, 0] = target[2, 0]                              # a perfect stem: den = 0
    ref = float(jloss.sdsdr_loss(jnp.asarray(pred), jnp.asarray(target)))
    tp = torch.from_numpy(pred).requires_grad_(True)
    out = tloss.sdsdr_loss(tp, torch.from_numpy(target))
    assert abs(out.item() - ref) <= 1e-5 * abs(ref)
    out.backward()
    assert torch.isfinite(tp.grad).all()


def _k2_inputs(layout, seed):
    """Packed x and v with a silent first slice in every bucket (exact
    zeros), zero magnitudes in places, and a scale per bucket, so that
    each bucket's stability scale differs."""
    x = torch.from_numpy(complex_noise(seed, (layout.size,)))
    v = torch.from_numpy(np.abs(noise(seed + 1, (4 * layout.size,))))
    for k, (xb, vb) in enumerate(zip(PackedBlocks(x, layout), PackedBlocks(v, layout, 4))):
        xb.mul_(10.0 * (1 + k))
        xb[:, :, :, 0] = 0
        vb[1, ..., 2] = 0
        vb.mul_(1 + 3 * k)
    return x, v


@pytest.mark.parametrize("shapes", [SHAPES, "mel-12"], ids=["small", "mel-12"])
def test_k2_backward_plain_matches_autograd(shapes):
    layout = (SliCQT(device=DEVICE, **MEL12).layout(2, 2, 5) if shapes == "mel-12"
              else BucketLayout(shapes))
    x, v = _k2_inputs(layout, seed=3)
    gy = torch.from_numpy(complex_noise(5, (4 * layout.size,)))
    vr = v.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(wiener_em_grouped_plain(x, vr, layout), vr, gy)
    out = wiener_em_backward_plain(x, v, gy, layout)
    for k, (a, b) in enumerate(zip(layout.split(out, 4), layout.split(ref, 4))):
        assert rel_err(a, b) <= 1e-4, k
    assert torch.isfinite(out).all()
    # the wrappers: on CPU tensors the autograd Function runs this closed form
    vr2 = v.clone().requires_grad_(True)
    (fn,) = torch.autograd.grad(wiener_em_grouped(x, vr2, layout), vr2, gy)
    assert torch.equal(fn, out) and torch.equal(wiener_em_backward(x, v, gy, layout), out)


def test_k2_refuses_a_gradient_for_the_mixture():
    layout = BucketLayout(SHAPES[:1])
    x, v = _k2_inputs(layout, seed=7)
    with pytest.raises(ValueError, match="mixture"):
        wiener_em_grouped(x.requires_grad_(True), v.requires_grad_(True), layout)


@pytest.mark.parametrize("cfg", [MEL12, pytest.param({}, marks=pytest.mark.slow)], ids=["mel-12", "bark-262"])
def test_k1_backward_plain_matches_autograd(cfg):
    """The transposed table holds every (position, entry) of the forward
    table once, at most 3 per raw value; the gather through it equals
    autograd of the plain forward, raw values read by no position get
    zero, and the Function's backward is this gather."""
    t = SliCQT(device=DEVICE, **cfg)
    tab = t.synth_table
    real = tab.idx < tab.raw_len
    assert tab.tidx.shape[1] <= 3 and int((tab.tidx < t.nh).sum()) == int(real.sum())
    flat = torch.from_numpy(complex_noise(11, (2, 3, t.raw_len)))
    flat[:, 1] = 0                                         # a silent slice
    g = torch.from_numpy(complex_noise(12, (2, 3, t.nh)))
    fr = flat.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(synth_assembly_plain(fr, tab), fr, g)
    out = synth_assembly_backward_plain(g, tab)
    assert rel_err(out, ref) <= 1e-6
    unread = torch.ones(t.raw_len, dtype=torch.bool)
    unread[tab.idx[real].long()] = False
    assert unread.any() and float(out[..., unread].abs().sum()) == 0.0
    fr2 = flat.clone().requires_grad_(True)
    (fn,) = torch.autograd.grad(synth_assembly(fr2, tab), fr2, g)
    assert torch.equal(fn, out) and torch.equal(synth_assembly_backward(g, tab), out)
