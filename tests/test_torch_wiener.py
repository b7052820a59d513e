"""The port's Wiener-EM and mix-phase post-filters against the JAX package's.

Blocks carry exact zeros (a silent slice and zero magnitudes), where the
unit phase must be 1 and nothing may turn NaN. One stereo iteration runs
K2's plain version (the CPU path of the K2 wrapper); three iterations and
mono run the norbert-layout functions. Tolerance: 1e-5 relative to the
largest output (fp32 reduction order; measured ~5e-7).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from torch_port_utils import blocks_rel_err, complex_noise, noise, rel_err, to_np

from xumx_slicq_tpu.ops import wiener as jw
from xumx_slicq_torch.kernels.wiener_em import stability_scale, wiener_em, wiener_em_plain
from xumx_slicq_torch.ops import wiener as tw

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
    ref = jw.wiener_blocks([jnp.asarray(x) for x in mix], [jnp.asarray(v) for v in mag], iterations)
    out = tw.wiener_blocks([torch.from_numpy(x) for x in mix], [torch.from_numpy(v) for v in mag], iterations)
    assert [tuple(o.shape) for o in out] == [v.shape for v in mag]
    assert all(torch.isfinite(torch.view_as_real(o)).all() for o in out)
    assert blocks_rel_err([to_np(o) for o in out], [np.asarray(r) for r in ref]) < REL_TOL


def test_wiener_blocks_mono_match_jax():
    mix, mag = _blocks(channels=1, seed=5)
    ref = jw.wiener_blocks([jnp.asarray(x) for x in mix], [jnp.asarray(v) for v in mag], 1)
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
