"""The port's SliCQT against the JAX package's, at the mel-12 test geometry.

mel-12's frame alone round-trips at only ~4e-3, so these tests compare the
two packages with each other, never with the input signal. The JAX package
runs its slice (i)FFTs and per-bucket (i)DFTs as fp32 matmuls, the port as
FFTs: results agree to fp32 rounding of the sums, so every comparison is
relative to the largest value, at 1e-5 (measured ~3e-7 on these inputs).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from torch_port_utils import DEVICE, MEL12, SR, blocks_rel_err, complex_noise, noise, rel_err, to_np

from xumx_slicq_tpu.ops.slicqt import SliCQT as JaxSliCQT
from xumx_slicq_torch.kernels.synth_assembly import synth_assembly, synth_assembly_plain
from xumx_slicq_torch.ops.slicqt import SliCQT

REL_TOL = 1e-5      # FFT vs DFT-matmul fp32 summation order
L = int(0.5 * SR)


@pytest.fixture(scope="module")
def pair():
    return JaxSliCQT(**MEL12), SliCQT(device=DEVICE, **MEL12)


@pytest.fixture(scope="module")
def jax_backward(pair):
    """The JAX package's synthesis, jitted once for the module's cases."""
    return jax.jit(pair[0].backward, static_argnums=1)


@pytest.fixture(scope="module")
def jax_blocks(pair):
    j, _ = pair
    x = noise(0, (2, 2, L))
    return x, [np.array(b) for b in jax.jit(j.forward)(jnp.asarray(x))]


def test_forward_matches_jax_per_bucket(pair, jax_blocks):
    _, t = pair
    x, ref = jax_blocks
    out = t.forward(torch.from_numpy(x))
    assert [tuple(o.shape) for o in out] == [r.shape for r in ref] == t.block_shapes(2, 2, L)
    assert all(o.dtype == torch.complex64 for o in out)
    for o, r in zip(out, ref):
        assert rel_err(o, r) < REL_TOL


def _random_blocks(t, seed, B=2, C=2, length=L):
    return [complex_noise(seed + i, s) for i, s in enumerate(t.block_shapes(B, C, length))]


@pytest.mark.parametrize("source", ["jax_forward", "random"])
def test_backward_matches_jax(pair, jax_blocks, jax_backward, source):
    """Synthesis from the JAX package's own coefficients, and from random
    (non-Hermitian) blocks, where the port's half spectrum + irfft must
    still agree with the JAX package's fused synthesis."""
    _, t = pair
    blocks = jax_blocks[1] if source == "jax_forward" else _random_blocks(t, 10)
    ref = np.asarray(jax_backward([jnp.asarray(b) for b in blocks], L))
    out = t.backward([torch.from_numpy(b) for b in blocks], L)
    assert out.shape == (2, 2, L)
    assert rel_err(out, ref) < REL_TOL


def _jax_legacy_half_spectrum(j, blocks):
    """The JAX package's legacy assembly (slicqt.py:786-809): weighted
    positive pieces and mirror pieces at 128-aligned offsets, one dense
    gather through _inv_idx, the un-rotation phase."""
    B, C, _, S, _ = blocks[0].shape
    parity = np.arange(S) % 2
    specs = []
    for b, cb in zip(j.buckets, blocks):
        spec = jnp.einsum("bcsfm,mn->bcsfn", jnp.moveaxis(jnp.asarray(cb), 2, 3), jnp.asarray(b.dft_fwd),
                          precision=jax.lax.Precision.HIGHEST)
        specs.append(spec * jnp.asarray(b.inv_ramp)[parity][None, None, :, None, :])
    vals = [(s * jnp.asarray(b.w_pos)).reshape(B, C, S, -1) for b, s in zip(j.buckets, specs)]
    for b, s in zip(j.buckets, specs):
        if b.w_neg is not None:
            sub = s[..., b.neg_lo: b.neg_hi, :]
            neg = jnp.concatenate([sub[..., 1:], sub[..., -1:]], axis=-1).conj()
            vals.append((neg * jnp.asarray(b.w_neg)).reshape(B, C, S, -1))
    vals = [jnp.pad(v, ((0, 0),) * 3 + ((0, p),)) for v, p in zip(vals, j._piece_pads)]
    V = jnp.concatenate(vals + [jnp.zeros((B, C, S, 1), jnp.complex64)], axis=-1)
    fr = jnp.take(V, jnp.asarray(j._inv_idx), axis=-1).sum(-1)
    return fr * jnp.asarray(j._unrot)[parity][None, None]


def test_plain_k1_matches_jax_legacy_gather(pair):
    """K1's plain version (the CPU path of synth_spectrum) assembles the
    same half spectrum as the JAX package's unfused gather table, though
    the two tables index different flat layouts."""
    j, t = pair
    blocks = _random_blocks(t, 20)
    ref = np.asarray(jax.jit(lambda bl: _jax_legacy_half_spectrum(j, bl))(blocks))
    out = t.synth_spectrum([torch.from_numpy(b) for b in blocks])
    assert out.shape == (4, ref.shape[2], t.nh)
    assert rel_err(out.reshape(ref.shape), ref) < REL_TOL


def test_k1_wrapper_on_cpu_is_the_plain_version(pair):
    _, t = pair
    S = 7
    flat = torch.from_numpy(complex_noise(30, (3, S, t.raw_len)))
    before = synth_assembly.launches
    out = synth_assembly(flat, t.synth_table)
    assert torch.equal(out, synth_assembly_plain(flat, t.synth_table))
    assert synth_assembly.launches == before          # no kernel on the CPU
    with pytest.raises(ValueError):
        synth_assembly(flat[:, :, :-1], t.synth_table)
    with pytest.raises(TypeError):
        synth_assembly(flat.to(torch.complex128), t.synth_table)


@pytest.mark.parametrize("cfg", [dict(scale="mrstft", fbins=576, fmin=1.0), dict(scale="linear", fbins=96, fmin=40.0)],
                         ids=["mrstft", "linear-96"])
def test_other_scales_match_jax(cfg):
    """Scales with one wide bucket (linear) and a 226,360-sample slice
    (mrstft): forward and backward still agree with the JAX package."""
    j, t = JaxSliCQT(**cfg), SliCQT(device=DEVICE, **cfg)
    n = int(1.1 * SR)
    x = noise(3, (1, 1, n))
    ref = [np.array(b) for b in jax.jit(j.forward)(jnp.asarray(x))]
    assert blocks_rel_err([to_np(b) for b in t.forward(torch.from_numpy(x))], ref) < REL_TOL
    y_ref = np.asarray(jax.jit(j.backward, static_argnums=1)([jnp.asarray(b) for b in ref], n))
    assert rel_err(t.backward([torch.from_numpy(b) for b in ref], n), y_ref) < REL_TOL


def test_device_is_explicit():
    """No card here: asking for the default "cuda" must raise, not fall
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        SliCQT(**MEL12)


@pytest.mark.slow
def test_canonical_roundtrip_vs_jax():
    """bark-262: the port's round trip is at most 1.5x the JAX package's
    on the same 2 s of unit-variance noise."""
    j, t = JaxSliCQT(), SliCQT(device=DEVICE)
    n = 2 * SR
    x = noise(1, (1, 2, n))
    jr = float(np.abs(np.asarray(j.backward(j.forward(jnp.asarray(x)), n)) - x).max())
    tr = float(np.abs(to_np(t.backward(t.forward(torch.from_numpy(x)), n)) - x).max())
    assert tr <= 1.5 * jr, (tr, jr)
    assert blocks_rel_err([to_np(b) for b in t.forward(torch.from_numpy(x))],
                          [np.asarray(b) for b in j.forward(jnp.asarray(x))]) < REL_TOL
