"""The port's CDAE / Unmix against the JAX package's, under shared weights.

Weights are a seeded init (made once for the module, read into the JAX
package through the reference's names) with BatchNorm statistics and
affines perturbed (so that folding matters), moved into the port with
params_from_jax. The convs run in fp32 on both sides; tolerances are
relative to the largest value, at 1e-5 (measured ~4e-7), except where noted.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as Fn

from torch_port_utils import DEVICE, MEL12, TINY_LEN, blocks_rel_err, noise, rel_err, to_np

from xumx_slicq_tpu.models import Unmix as JaxUnmix
from xumx_slicq_tpu.models.cdae import SlicedCDAESpec, _dec2_ola, _enc1_frames
from xumx_slicq_tpu.models.torch_import import import_cdae_state_dict
from xumx_slicq_tpu.ops.slicqt import SliCQT as JaxSliCQT
from xumx_slicq_torch.models import Unmix
from xumx_slicq_torch.models.convert import load_reference_state_dict, params_from_jax, to_reference_state_dict
from xumx_slicq_torch.ops.slicqt import SliCQT

REL_TOL = 1e-5


@pytest.mark.parametrize("fphi", [1, 3, 5])
def test_enc1_strided_conv_matches_frames(fphi):
    """enc1 as one strided conv over the S*T time axis == _enc1_frames."""
    B, C, F, S, T, H = 2, 2, 7, 5, 12, 6
    x5 = noise(0, (B, C, F, S, T))
    w = noise(1, (H, C, fphi, T))
    ref = np.asarray(_enc1_frames(jnp.asarray(x5), jnp.asarray(w), fphi))
    out = Fn.conv2d(torch.from_numpy(x5).reshape(B, C, F, S * T), torch.from_numpy(w), stride=(1, T // 2))
    assert out.shape == ref.shape == (B, H, F - fphi + 1, 2 * S - 1)
    assert rel_err(out, ref) < REL_TOL


@pytest.mark.parametrize("realtime", [False, True], ids=["offline", "realtime"])
def test_dec2_strided_conv_transpose_matches_ola(realtime):
    """dec2 as one strided conv_transpose == _dec2_ola; the realtime
    encoder yields 2S frames, whose last half-frame is cut."""
    B, C, H, S, T, fphi = 2, 2, 6, 5, 12, 3
    K = 2 * S if realtime else 2 * S - 1
    h = noise(2, (B, H, 4, K))
    w = noise(3, (H, C, fphi, T))
    spec = SlicedCDAESpec(nb_channels=C, nb_f_bins=4 + fphi - 1, nb_t_bins=T, realtime=realtime)
    ref = np.asarray(_dec2_ola(jnp.asarray(h), jnp.asarray(w), spec, S))       # (B,C,F,S,T)
    out = Fn.conv_transpose2d(torch.from_numpy(h), torch.from_numpy(w), stride=(1, T // 2))[..., : S * T]
    assert rel_err(out.reshape(ref.shape), ref) < REL_TOL


@pytest.fixture(scope="module")
def weights_and_blocks():
    """Weights for both variants, made once: a seeded init under the
    reference's names, read by the JAX package's importer (no JAX init
    program to compile), with BatchNorm and whitening perturbed; and mel-12
    mixture blocks of a 0.3 s batch of 2."""
    j = JaxSliCQT(**MEL12)
    shapes = j.block_shapes(1, 2, TINY_LEN)
    ref_sd = to_reference_state_dict(Unmix(shapes, seed=1, device=DEVICE))
    params, stats = import_cdae_state_dict({k: v.numpy() for k, v in ref_sd.items()}, len(shapes))
    rng = np.random.default_rng(1)

    def jitter(path, a):
        a = np.asarray(a)
        name = jax.tree_util.keystr(path)
        if "var" in name:
            return a * rng.uniform(0.8, 1.25, a.shape).astype(np.float32)
        if "mean" in name or "bias" in name:
            return a + rng.uniform(-0.05, 0.05, a.shape).astype(np.float32)
        if "scale" in name:
            return a * rng.uniform(0.9, 1.1, a.shape).astype(np.float32)
        return a

    params = jax.tree_util.tree_map_with_path(jitter, params)
    stats = jax.tree_util.tree_map_with_path(jitter, stats)
    X = [np.array(b) for b in jax.jit(j.forward)(jnp.asarray(noise(4, (2, 2, TINY_LEN), 0.1)))]
    return shapes, params, stats, X


@pytest.mark.parametrize("realtime", [False, True], ids=["offline", "realtime"])
def test_unmix_apply_matches_jax(weights_and_blocks, realtime):
    shapes, params, stats, X = weights_and_blocks
    ju = JaxUnmix(shapes, realtime=realtime)
    Y_ref, M_ref, _ = jax.jit(lambda p, X: ju.apply(p, None, X))(ju.fold_batchnorm(params, stats), X)

    model = Unmix(shapes, realtime=realtime, device=DEVICE)
    model.load_state_dict(params_from_jax(params, stats))
    Xt = [torch.from_numpy(b) for b in X]
    with torch.no_grad():
        Y_fold, M_fold = model.apply(Xt, model.fold_batchnorm())
        Y_bn, M_bn = model.apply(Xt)                      # eval BatchNorm, unfolded
    assert float(np.std(np.concatenate([to_np(m).ravel() for m in M_fold]))) > 1e-3   # masks not saturated
    for Y, M in ((Y_fold, M_fold), (Y_bn, M_bn)):
        assert [tuple(y.shape) for y in Y] == [y.shape for y in Y_ref]
        assert blocks_rel_err([to_np(m) for m in M], [np.asarray(m) for m in M_ref]) < REL_TOL
        assert blocks_rel_err([to_np(y) for y in Y], [np.asarray(y) for y in Y_ref]) < REL_TOL


def test_canonical_parameter_count():
    """bark-262 with hidden widths 50/51: 15,010,446 parameters
    (COMPONENTS.md:46), from construction alone."""
    shapes = SliCQT(device=DEVICE).block_shapes(1, 2, 2 * 44100)
    assert len(shapes) == 70
    assert Unmix(shapes, device=DEVICE).num_params() == 15010446


def test_reference_state_dict_round_trip():
    """to_reference_state_dict writes the names the JAX importer reads, and
    load_reference_state_dict reads them back into the port."""
    shapes = SliCQT(device=DEVICE, **MEL12).block_shapes(1, 2, TINY_LEN)
    model = Unmix(shapes, seed=5, device=DEVICE)
    with torch.no_grad():
        for blk in model.blocks:
            blk.bn2.running_var.uniform_(0.5, 2.0)
    ref_sd = to_reference_state_dict(model)
    params, stats = import_cdae_state_dict({k: v.numpy() for k, v in ref_sd.items()}, len(shapes))
    back = params_from_jax(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats))
    own = model.state_dict()
    assert set(back) == set(own)
    for k in own:
        assert torch.equal(back[k], own[k].cpu()), k
    again = load_reference_state_dict(ref_sd)
    for k in own:
        assert torch.equal(again[k], own[k].cpu()), k
