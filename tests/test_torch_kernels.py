"""K1 and K2 against their plain PyTorch versions on the card.

    python -m pytest -m cuda tests/test_torch_kernels.py

Every test needs an NVIDIA GPU with sm_90 (the kernels build for sm_90a)
and skips without one; the check runs inside a fixture, so every test
worker collects the same tests. Tolerances are relative to the largest
plain value: 1e-5 for K1 (the same sums; only FMA contraction differs) and
1e-4 for K2 (fp32 division and square-root rounding through the 2x2
inverse).
"""

import pytest
import torch

from xumx_slicq_torch.kernels.synth_assembly import synth_assembly, synth_assembly_plain
from xumx_slicq_torch.kernels.wiener_em import stability_scale, wiener_em, wiener_em_plain
from xumx_slicq_torch.ops.slicqt import SliCQT

pytestmark = pytest.mark.cuda

MEL12 = dict(scale="mel", fbins=12, fmin=200.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda")


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("cfg,S", [(MEL12, 41), ({}, 292)], ids=["mel-12", "bark-262-default-chunk"])
def test_k1_matches_plain(cuda, cfg, S):
    t = SliCQT(device=cuda, **cfg)
    g = torch.Generator(device=cuda).manual_seed(0)
    flat = torch.randn((8, S, t.raw_len), generator=g, device=cuda, dtype=torch.complex64)
    before = synth_assembly.launches
    out = synth_assembly(flat, t.synth_table)
    torch.cuda.synchronize()
    assert synth_assembly.launches == before + 1
    assert out.shape == (8, S, t.nh)
    assert _rel(out, synth_assembly_plain(flat, t.synth_table)) < 1e-5


@pytest.mark.parametrize("B,F,T", [(1, 3, 500), (2, 5, 41 * 16), (1, 86, 292 * 16), (4, 1, 292 * 292)],
                         ids=["small", "mel-12-like", "bark-262-bucket-1", "bark-262-widest-batch-4"])
def test_k2_matches_plain(cuda, B, F, T):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((B, 2, F, T), generator=g, device=cuda, dtype=torch.complex64) * 30
    x[..., :7] = 0                                 # exact zeros: unit phase 1
    v = torch.rand((4, B, 2, F, T), generator=g, device=cuda) * 10
    before = wiener_em.launches
    out = wiener_em(x, v)
    torch.cuda.synchronize()
    assert wiener_em.launches == before + 1
    ref = wiener_em_plain(x, v, stability_scale(x))
    assert torch.isfinite(torch.view_as_real(out)).all()
    assert _rel(out, ref) < 1e-4


def test_transform_round_trip_on_card(cuda):
    t = SliCQT(device=cuda)
    x = torch.randn((1, 2, 2 * 44100), generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    with torch.inference_mode():
        err = float((t.backward(t.forward(x), x.shape[-1]) - x).abs().max())
    assert err <= 1e-5
