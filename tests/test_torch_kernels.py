"""K1 and K2 against their plain PyTorch versions on the card.

    python -m pytest -m cuda --noconftest tests/test_torch_kernels.py

Every test needs an NVIDIA GPU with sm_90 (the kernels build for sm_90a)
and skips without one; the check runs inside a fixture, so every test
worker collects the same tests. Tolerances are relative to the largest
plain value (of each bucket, for K2): 1e-5 for K1 (the same sums; only FMA
contraction differs) and 1e-4 for K2 (fp32 division and square-root
rounding through the 2x2 inverse).
"""

import pytest
import torch

from xumx_slicq_torch.kernels.synth_assembly import synth_assembly, synth_assembly_plain
from xumx_slicq_torch.kernels.wiener_em import (stability_scale, wiener_em, wiener_em_grouped,
                                                wiener_em_grouped_plain, wiener_em_plain)
from xumx_slicq_torch.ops import wiener as wiener_ops
from xumx_slicq_torch.ops.packed import PackedBlocks
from xumx_slicq_torch.ops.slicqt import SliCQT

pytestmark = pytest.mark.cuda

MEL12 = dict(scale="mel", fbins=12, fmin=200.0)
K2_LAUNCHES = 3                                    # device launches per K2 call, any number of buckets


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
    assert wiener_em.launches == before + K2_LAUNCHES
    ref = wiener_em_plain(x, v, stability_scale(x))
    assert torch.isfinite(torch.view_as_real(out)).all()
    assert _rel(out, ref) < 1e-4


def _packed_inputs(layout, device, seed):
    """Packed x and v with a silent first slice in every bucket and a
    scale that differs from bucket to bucket, so each m_k differs."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(layout.size, generator=g, device=device, dtype=torch.complex64)
    v = torch.rand(4 * layout.size, generator=g, device=device)
    for k, (xb, vb) in enumerate(zip(PackedBlocks(x, layout), PackedBlocks(v, layout, 4))):
        xb.mul_(10.0 * (1 + k % 7))
        xb[:, :, :, 0] = 0
        vb.mul_(1 + k % 5)
    return x, v


@pytest.mark.parametrize("cfg,length", [(MEL12, 2 * 44100), ({}, 2621440)], ids=["mel-12", "bark-262-default-chunk"])
def test_k2_grouped_matches_plain(cuda, cfg, length):
    """One grouped call over every bucket at chunk batch 4 (all 70 buckets
    at bark-262) against the grouped plain version, bucket by bucket."""
    t = SliCQT(device=cuda, **cfg)
    layout = t.layout(4, 2, t.n_slices(length))
    x, v = _packed_inputs(layout, cuda, seed=3)
    before = wiener_em.launches
    out = wiener_em_grouped(x, v, layout)
    torch.cuda.synchronize()
    assert wiener_em.launches - before == K2_LAUNCHES <= 3
    ref = wiener_em_grouped_plain(x, v, layout)
    assert torch.isfinite(torch.view_as_real(out)).all()
    for k, (a, b) in enumerate(zip(PackedBlocks(out, layout, 4), PackedBlocks(ref, layout, 4))):
        assert _rel(a, b) < 1e-4, k
    # a second call on quieter input reuses the cached tables and takes its own maxima
    again = wiener_em_grouped(x * 0.5, v, layout)
    assert _rel(again, wiener_em_grouped_plain(x * 0.5, v, layout)) < 1e-4


def test_k2_grouped_scale_is_per_bucket(cuda):
    """The kernel takes m per bucket: scaling one bucket's x and v by 1e3
    leaves every other bucket's estimate as it was, and that bucket equals
    its own one-bucket kernel result."""
    t = SliCQT(device=cuda, **MEL12)
    layout = t.layout(2, 2, t.n_slices(44100))
    x, v = _packed_inputs(layout, cuda, seed=5)
    base = PackedBlocks(wiener_em_grouped(x, v, layout), layout, 4)
    k = len(layout.shapes) // 2
    xs, vs = PackedBlocks(x.clone(), layout), PackedBlocks(v.clone(), layout, 4)
    xs[k].mul_(1e3)
    vs[k].mul_(1e3)
    assert float(stability_scale(xs[k])) > 10 * float(stability_scale(PackedBlocks(x, layout)[k]))
    out = PackedBlocks(wiener_em_grouped(xs.packed, vs.packed, layout), layout, 4)
    for i, (a, b) in enumerate(zip(out, base)):
        if i != k:
            assert _rel(a, b) < 1e-6, i
    B, C, F, S, M = layout.shapes[k]
    own = wiener_em(xs[k].reshape(B, C, F, S * M), vs[k].reshape(4, B, C, F, S * M))
    assert _rel(out[k].reshape(own.shape), own) < 1e-6


def test_wiener_blocks_on_card_always_launch_k2(cuda):
    """wiener_blocks on the card: packed blocks run the grouped kernel on
    their own buffers; a plain list is packed with one copy and runs it too."""
    t = SliCQT(device=cuda, **MEL12)
    layout = t.layout(2, 2, t.n_slices(44100))
    x, v = _packed_inputs(layout, cuda, seed=4)
    X, V = PackedBlocks(x, layout), PackedBlocks(v, layout, 4)
    before = wiener_em.launches
    packed = wiener_ops.wiener_blocks(X, V, 1)
    listed = wiener_ops.wiener_blocks(list(X), list(V), 1)
    torch.cuda.synchronize()
    assert wiener_em.launches - before == 2 * K2_LAUNCHES
    assert isinstance(packed, PackedBlocks) and packed.layout == layout
    assert all(torch.equal(a, b) for a, b in zip(packed, listed))


def test_transform_round_trip_on_card(cuda):
    t = SliCQT(device=cuda)
    x = torch.randn((1, 2, 2 * 44100), generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    with torch.inference_mode():
        err = float((t.backward(t.forward(x), x.shape[-1]) - x).abs().max())
    assert err <= 1e-5
