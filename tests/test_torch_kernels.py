"""K1, K2, K3, K4 and K5 against their plain PyTorch versions on the card.

    python -m pytest -m cuda --noconftest tests/test_torch_kernels.py

Every test needs an NVIDIA GPU with sm_90 (the kernels build for sm_90a)
and skips without one; the check runs inside a fixture, so every test
worker collects the same tests. Tolerances are relative to the largest
plain value (of each bucket, for K2): 1e-5 for K1 and its backward (the
same sums; only FMA contraction differs), 1e-6 per bucket for K3 (one
complex product an output), 1e-5 for K4's masks (absolute, masks in (0, 1))
and magnitudes (3xTF32 products, fp32 accuracy, summed in fp32 over up to
1,024 steps a layer in another order than cuDNN's, TF32 off), and 1e-4
for K2 and its backward
(fp32 division and square-root rounding through the 2x2 inverse, and row
sums taken in another order). K5 (the LSTM recurrence) is held to 1e-4
absolute on h, |h| < 1: accurate expf/tanhf against the CPU's sigmoid and
tanh, and gate sums in another order, carried through thousands of steps
of a contractive recurrence. K5b (its backward) is held to 1e-4 of the
largest plain value on d(xp) and d(W_hh^T), from the same h and c: the
same arithmetic in another order through up to 3,212 steps.
"""

import pytest
import torch

from torch_port_utils import perturb_cdae
from xumx_slicq_torch.kernels.analysis_gather import analysis_gather, analysis_gather_plain
from xumx_slicq_torch.kernels.cdae_conv import cdae_folded, cdae_folded_plain
from xumx_slicq_torch.kernels.cdae_conv import counters as k4_counters
from xumx_slicq_torch.kernels.lstm_recurrence import (RecurrenceLayout, lstm_recurrence, lstm_recurrence_backward,
                                                      lstm_recurrence_backward_grouped_plain,
                                                      lstm_recurrence_grouped_plain, lstm_recurrence_with_cell,
                                                      pack_recurrent_weights, work_items)
from xumx_slicq_torch.kernels.synth_assembly import (synth_assembly, synth_assembly_backward,
                                                     synth_assembly_backward_plain, synth_assembly_plain)
from xumx_slicq_torch.kernels.wiener_em import (CHUNK, stability_scale, wiener_em, wiener_em_backward,
                                                wiener_em_backward_plain, wiener_em_grouped,
                                                wiener_em_grouped_plain, wiener_em_plain)
from xumx_slicq_torch.models import Unmix
from xumx_slicq_torch.ops import wiener as wiener_ops
from xumx_slicq_torch.ops.packed import BucketLayout, PackedBlocks
from xumx_slicq_torch.ops.slicqt import SliCQT

pytestmark = pytest.mark.cuda

MEL12 = dict(scale="mel", fbins=12, fmin=200.0)
K2_LAUNCHES = 3                                    # device launches per K2 call, any number of buckets
TRAIN_LEN = 2 * 44100                             # the training layout: batch 32 of 2.0 s
K5_TOL = 1e-4
K5B_TOL = 1e-4
K2B_TOL = 1e-4
K4_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda")


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture
def no_tf32():
    """cuDNN in full fp32 (its default is TF32), for the plain versions' convs."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = old


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


@pytest.mark.parametrize("cfg,batch,length", [(MEL12, 4, 2621440), ({}, 4, 2621440), ({}, 32 * 5, TRAIN_LEN)],
                         ids=["mel-12", "bark-262-default-chunk", "bark-262-train-step"])
def test_k3_matches_plain(cuda, cfg, batch, length):
    """K3 against the per-bucket loop on the card, 1e-6 of each bucket's
    largest value; `SliCQT.forward` launches it once."""
    t = SliCQT(device=cuda, **cfg)
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((batch, 2, length), generator=g, device=cuda)
    X = t.half_spectrum(x)
    B, C, S, _ = X.shape
    layout = t.layout(B, C, S)
    ref = PackedBlocks(torch.empty(layout.size, dtype=torch.complex64, device=cuda), layout)
    analysis_gather_plain(X, t.forward_tables, ref)
    before = analysis_gather.launches
    got = PackedBlocks(analysis_gather(X, t.analysis_table), layout)
    torch.cuda.synchronize()
    assert analysis_gather.launches == before + 1
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    with torch.inference_mode():
        t.forward(x)
    assert analysis_gather.launches == before + 2


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


@pytest.mark.parametrize("cfg,rows,length", [(MEL12, 16, 2 * 44100), ({}, 4 * 32 * 2, TRAIN_LEN)],
                         ids=["mel-12", "bark-262-training"])
def test_k1_backward_matches_plain(cuda, cfg, rows, length):
    t = SliCQT(device=cuda, **cfg)
    g = torch.Generator(device=cuda).manual_seed(6)
    gout = torch.randn((rows, t.n_slices(length), t.nh), generator=g, device=cuda, dtype=torch.complex64)
    before = synth_assembly_backward.launches
    out = synth_assembly_backward(gout, t.synth_table)
    torch.cuda.synchronize()
    assert synth_assembly_backward.launches == before + 1
    assert _rel(out, synth_assembly_backward_plain(gout, t.synth_table)) < 1e-5
    # through the autograd Function: forward K1, backward K1's kernel
    flat = torch.randn((rows, gout.shape[1], t.raw_len), generator=g, device=cuda,
                       dtype=torch.complex64).requires_grad_(True)
    (gf,) = torch.autograd.grad(synth_assembly(flat, t.synth_table), flat, gout)
    assert synth_assembly_backward.launches == before + 2 and torch.equal(gf, out)


def _k2_grad(x, v, gy, layout):
    vr = v.clone().requires_grad_(True)
    (gv,) = torch.autograd.grad(wiener_em_grouped(x, vr, layout), vr, gy)
    return gv


def _bucket_rels(a, b, layout):
    return [_rel(p, q) for p, q in zip(PackedBlocks(a, layout, 4), PackedBlocks(b, layout, 4))]


@pytest.mark.parametrize("cfg,batch,length", [(MEL12, 2, 44100), ({}, 32, TRAIN_LEN)],
                         ids=["mel-12", "bark-262-training"])
def test_k2_backward_matches_plain(cuda, cfg, batch, length):
    """K2's backward kernels through the autograd Function, over every
    bucket, against the plain closed form, bucket by bucket."""
    t = SliCQT(device=cuda, **cfg)
    layout = t.layout(batch, 2, t.n_slices(length))
    x, v = _packed_inputs(layout, cuda, seed=7)
    gy = torch.randn(4 * layout.size, generator=torch.Generator(device=cuda).manual_seed(8), device=cuda,
                     dtype=torch.complex64)
    before = wiener_em_backward.launches
    gv = _k2_grad(x, v, gy, layout)
    torch.cuda.synchronize()
    assert wiener_em_backward.launches - before == 2
    assert torch.isfinite(gv).all()
    assert max(_bucket_rels(gv, wiener_em_backward_plain(x, v, gy, layout), layout)) < 1e-4


def test_k2_backward_scale_is_per_bucket(cuda):
    """One bucket's x and v scaled by 1e3: every other bucket's gradient
    stays as it was, and that bucket's matches the plain closed form."""
    t = SliCQT(device=cuda, **MEL12)
    layout = t.layout(2, 2, t.n_slices(44100))
    x, v = _packed_inputs(layout, cuda, seed=9)
    gy = torch.randn(4 * layout.size, generator=torch.Generator(device=cuda).manual_seed(10), device=cuda,
                     dtype=torch.complex64)
    base = _k2_grad(x, v, gy, layout)
    k = len(layout.shapes) // 2
    xs, vs = PackedBlocks(x.clone(), layout), PackedBlocks(v.clone(), layout, 4)
    xs[k].mul_(1e3)
    vs[k].mul_(1e3)
    out = _k2_grad(xs.packed, vs.packed, gy, layout)
    rels = _bucket_rels(out, base, layout)
    assert max(r for i, r in enumerate(rels) if i != k) < 1e-6
    assert _bucket_rels(out, wiener_em_backward_plain(xs.packed, vs.packed, gy, layout), layout)[k] < 1e-4


def test_k2_two_forwards_then_one_backward(cuda):
    """Each forward keeps its own partial sums and max slots: a second
    forward on other inputs before the first one's backward leaves the
    first gradient exactly as a lone forward gives it."""
    t = SliCQT(device=cuda, **MEL12)
    layout = t.layout(2, 2, t.n_slices(44100))
    x, v = _packed_inputs(layout, cuda, seed=11)
    x2, v2 = _packed_inputs(layout, cuda, seed=12)
    gy = torch.randn(4 * layout.size, generator=torch.Generator(device=cuda).manual_seed(13), device=cuda,
                     dtype=torch.complex64)
    alone = _k2_grad(x, v, gy, layout)
    vr, vr2 = v.clone().requires_grad_(True), (v2 * 7.0).requires_grad_(True)
    y = wiener_em_grouped(x, vr, layout)
    y2 = wiener_em_grouped(x2 * 3.0, vr2, layout)                # overwrites nothing of y's state
    (g1,) = torch.autograd.grad(y, vr, gy)
    torch.cuda.synchronize()
    assert torch.equal(g1, alone)
    assert torch.isfinite(torch.autograd.grad(y2, vr2, gy)[0]).all()


def test_k2_backward_long_one_bin_row(cuda):
    """K2's backward on a one-bin bucket whose rows run 3.5 pass-1 chunks
    (several partial sums a row, a ragged last pass-2 block) beside a
    small bucket, against the plain closed form and against autograd of
    the grouped plain forward, per bucket."""
    layout = BucketLayout([(2, 2, 1, 7, 2048), (2, 2, 3, 5, 37)])
    assert layout.shapes[0][3] * layout.shapes[0][4] > 3 * CHUNK
    x, v = _packed_inputs(layout, cuda, seed=23)
    gy = torch.randn(4 * layout.size, generator=torch.Generator(device=cuda).manual_seed(24), device=cuda,
                     dtype=torch.complex64)
    gv = _k2_grad(x, v, gy, layout)
    torch.cuda.synchronize()
    assert torch.isfinite(gv).all()
    assert max(_bucket_rels(gv, wiener_em_backward_plain(x, v, gy, layout), layout)) <= K2B_TOL
    vr = v.clone().requires_grad_(True)
    (ga,) = torch.autograd.grad(wiener_em_grouped_plain(x, vr, layout), vr, gy)
    assert max(_bucket_rels(gv, ga, layout)) <= K2B_TOL


def _k5_inputs(shapes, realtime, device, seed):
    """A K5 layout of block shapes (B, C, F, S, T) as the LSTM model sizes
    it, projections of the spread a trained model gives, and W_hh at
    torch's init bound."""
    from xumx_slicq_torch.models.lstm import SlicedLSTM

    blocks = [SlicedLSTM(C, F, T, realtime=realtime) for (_, C, F, _, T) in shapes]
    layout = RecurrenceLayout([b.lstm_hidden for b in blocks], [s[3] * s[4] for s in shapes], shapes[0][0],
                              1 if realtime else 2)
    g = torch.Generator().manual_seed(seed)
    xp = torch.randn(layout.xp_size, generator=g) * 2
    w_hh = [(torch.rand((4, layout.dirs, 4 * h, h), generator=g) * 2 - 1) / h ** 0.5 for h in layout.hidden]
    return layout, xp.to(device), pack_recurrent_weights(w_hh).to(device)


@pytest.mark.parametrize("cfg,realtime", [(MEL12, False), ({}, False), ({}, True)],
                         ids=["mel-12", "bark-262-offline", "bark-262-realtime"])
def test_k5_matches_plain(cuda, cfg, realtime):
    """One launch over every bucket at chunk batch 4 of 2 s (at bark-262
    H = 1..43 offline, both directions, and up to H = 86 realtime) against
    the grouped plain version on the CPU."""
    t = SliCQT(device=cuda, **cfg)
    layout, xp, w = _k5_inputs(t.block_shapes(4, 2, 2 * 44100), realtime, cuda, seed=14)
    if not cfg:
        assert max(layout.hidden) == (86 if realtime else 43)
    before = lstm_recurrence.launches
    out = lstm_recurrence(xp, w, layout)
    torch.cuda.synchronize()
    assert lstm_recurrence.launches == before + 1
    ref = lstm_recurrence_grouped_plain(xp.cpu(), w.cpu(), layout)
    assert torch.isfinite(out).all()
    assert float((out.cpu() - ref).abs().max()) <= K5_TOL


def test_k5_reverse_direction_keeps_positions(cuda):
    """With W_hh = 0 and the forget gate shut (its projection -100), each
    step stands alone: h at position s is o tanh(i g) of xp at s, for both
    directions, so a direction written in walk order instead of at its
    positions would show."""
    layout = RecurrenceLayout([1, 9, 17], [50, 37, 20], 2, 2)
    g = torch.Generator().manual_seed(15)
    xp = torch.randn(layout.xp_size, generator=g)
    for x, H in zip(layout.xp_blocks(xp), layout.hidden):
        x[..., H:2 * H] = -100.0
    out = lstm_recurrence(xp.to(cuda), torch.zeros(layout.w_size, device=cuda), layout).cpu()
    for x, h in zip(layout.xp_blocks(xp), layout.h_blocks(out)):
        i, _, gg, o = x.split(x.shape[-1] // 4, dim=-1)           # (4, dirs, frames, B, H)
        alone = torch.sigmoid(o) * torch.tanh(torch.sigmoid(i) * torch.tanh(gg))
        assert float((h - alone.permute(0, 2, 3, 1, 4).reshape(h.shape)).abs().max()) <= 1e-6


@pytest.mark.parametrize("realtime", [False, True], ids=["offline", "realtime"])
@pytest.mark.parametrize("cfg,batch,length", [(MEL12, 2, 2 * 44100), ({}, 4, 2621440)],
                         ids=["mel-12", "bark-262-default-chunk"])
def test_k4_matches_plain(cuda, no_tf32, cfg, batch, length, realtime):
    """K4, the folded CDAE of every bucket in four launches, against its
    plain version (the per-bucket module code, cuDNN) on the same packed
    mixture from SliCQT.forward; BatchNorm statistics and whitening
    perturbed, so that the folded biases and the whitening count."""
    t = SliCQT(device=cuda, **cfg)
    model = Unmix(t.block_shapes(1, 2, 2 * 44100), realtime=realtime, seed=2, device=cuda)
    perturb_cdae(model.blocks, 2)
    weights = model.inference_weights()
    a = torch.randn((batch, 2, length), generator=torch.Generator(cuda).manual_seed(3), device=cuda) * 0.1
    with torch.inference_mode():
        X = t.forward(a)
        before = {k: c.launches for k, c in k4_counters.items()}
        mags, masks = cdae_folded(X.packed, weights, X.layout, realtime)
        torch.cuda.synchronize()
        assert {k: c.launches - before[k] for k, c in k4_counters.items()} == dict.fromkeys(before, 1)
        ref_mags, ref_masks = cdae_folded_plain(X.packed, weights.w, X.layout, weights.arch, realtime)
    assert masks.shape == ref_masks.shape == (4 * X.layout.size,)
    assert float((masks - ref_masks).abs().max()) <= K4_TOL
    assert _rel(mags, ref_mags) <= K4_TOL


def test_k4_is_bit_equal_over_calls(cuda):
    """Two K4 calls on the same inputs at the main path's layout (bark-262, a
    chunk batch of 4 default chunks) give the same bits: every sum has a
    fixed order."""
    t = SliCQT(device=cuda)
    model = Unmix(t.block_shapes(1, 2, 2 * 44100), seed=7, device=cuda)
    perturb_cdae(model.blocks, 7)
    weights = model.inference_weights()
    a = torch.randn((4, 2, 2621440), generator=torch.Generator(cuda).manual_seed(8), device=cuda) * 0.1
    with torch.inference_mode():
        X = t.forward(a)
        first = cdae_folded(X.packed, weights, X.layout, False)
        second = cdae_folded(X.packed, weights, X.layout, False)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.parametrize("realtime", [False, True], ids=["offline", "realtime"])
def test_k4_widest_bucket_alone(cuda, no_tf32, realtime):
    """K4 on the F = 86 bucket alone (fphi 5: 1,000 steps in enc2 and 1,020
    in dec1, 16 columns in dec2, two thirds of the MACs of the main path)
    at the inference layout (a chunk batch of 4, 292 slices) against its
    plain version, BatchNorm and whitening perturbed; two calls bit-equal."""
    shape = (4, 2, 86, 292, 16)
    layout = BucketLayout([shape])
    model = Unmix([(1,) + shape[1:]], realtime=realtime, seed=5, device=cuda)
    assert model.blocks[0].fphi == 5
    perturb_cdae(model.blocks, 5)
    weights = model.inference_weights()
    X = torch.randn(layout.size, dtype=torch.complex64, generator=torch.Generator(cuda).manual_seed(6),
                    device=cuda) * 0.1
    with torch.inference_mode():
        mags, masks = cdae_folded(X, weights, layout, realtime)
        mags2, masks2 = cdae_folded(X, weights, layout, realtime)
        ref_mags, ref_masks = cdae_folded_plain(X, weights.w, layout, weights.arch, realtime)
    assert torch.equal(masks, masks2) and torch.equal(mags, mags2)
    assert float((masks - ref_masks).abs().max()) <= K4_TOL
    assert _rel(mags, ref_mags) <= K4_TOL


@pytest.mark.parametrize("realtime", [False, True], ids=["offline", "realtime"])
def test_cdae_unmix_on_card_matches_cpu(cuda, realtime):
    """The CDAE at mel-12 on the card through its inference weights (K4)
    against the same model on the CPU, BatchNorm statistics and whitening
    perturbed; the card's folded path launches K4 and nothing falls back."""
    t = SliCQT(device=cuda, **MEL12)
    x = torch.randn((1, 2, 44100), generator=torch.Generator().manual_seed(17)) * 0.1
    X = t.forward(x.to(cuda))
    shapes = [tuple(b.shape) for b in X]
    model = Unmix(shapes, realtime=realtime, seed=4, device=cuda)
    cpu = Unmix(shapes, realtime=realtime, seed=4, device="cpu")
    perturb_cdae(model.blocks, 4)
    perturb_cdae(cpu.blocks, 4)
    before = [c.launches for c in k4_counters.values()]
    with torch.inference_mode():
        _, masks = model.apply(X, model.inference_weights())
        torch.cuda.synchronize()
        assert [c.launches - n for c, n in zip(k4_counters.values(), before)] == [1] * 4
        _, ref = cpu.apply([b.cpu() for b in X], cpu.inference_weights())
    assert max(float((a.cpu() - b).abs().max()) for a, b in zip(masks, ref)) <= 1e-5


@pytest.mark.parametrize("realtime", [False, True], ids=["offline", "realtime"])
def test_lstm_unmix_on_card_matches_cpu(cuda, realtime):
    """The LSTM model at mel-12 on the card (three K5 launches, one a layer)
    against the same model on the CPU."""
    t = SliCQT(device=cuda, **MEL12)
    x = torch.randn((1, 2, 44100), generator=torch.Generator().manual_seed(16)) * 0.1
    X = t.forward(x.to(cuda))
    shapes = [tuple(b.shape) for b in X]
    model = Unmix(shapes, realtime=realtime, lstm=True, seed=4, device=cuda)
    cpu = Unmix(shapes, realtime=realtime, lstm=True, seed=4, device="cpu")
    before = lstm_recurrence.launches
    with torch.inference_mode():
        _, masks = model.apply(X, model.inference_weights())
        torch.cuda.synchronize()
        assert lstm_recurrence.launches == before + 3
        _, ref = cpu.apply([b.cpu() for b in X])
    assert max(float((a.cpu() - b).abs().max()) for a, b in zip(masks, ref)) <= 1e-5


def _k5_train_case(cuda, realtime, seed):
    """K5's training layout (batch 32 of 2 s at bark-262: up to 3,212 steps,
    H up to 43 offline and 86 realtime) on the card, and a cotangent of h."""
    layout, xp, w = _k5_inputs(SliCQT(device=cuda).block_shapes(32, 2, TRAIN_LEN), realtime, cuda, seed)
    dh = torch.randn(layout.h_size, generator=torch.Generator(device=cuda).manual_seed(seed + 1), device=cuda)
    return layout, xp, w, dh


@pytest.mark.parametrize("realtime", [False, True], ids=["offline", "realtime"])
def test_k5_train_forward_keeps_c(cuda, realtime):
    """K5's train-mode forward writes h and the cell state c, both as the
    grouped plain walk on the card gives them, in one launch."""
    layout, xp, w, _ = _k5_train_case(cuda, realtime, seed=17)
    assert max(layout.frames) == 3212
    before = lstm_recurrence.launches
    h, c = lstm_recurrence_with_cell(xp, w, layout)
    torch.cuda.synchronize()
    assert lstm_recurrence.launches == before + 1
    h_ref, c_ref = lstm_recurrence_grouped_plain(xp, w, layout, cell=True)
    assert torch.isfinite(c).all()
    assert float((h - h_ref).abs().max()) <= K5_TOL
    assert _rel(c, c_ref) <= K5_TOL


@pytest.mark.parametrize("realtime", [False, True], ids=["offline", "realtime"])
def test_k5b_matches_plain(cuda, realtime):
    """K5b through the autograd Function (one launch a layer) against the
    grouped plain reverse walk on the card, from the same h and c."""
    layout, xp, w, dh = _k5_train_case(cuda, realtime, seed=19)
    xr, wr = xp.clone().requires_grad_(True), w.clone().requires_grad_(True)
    before = lstm_recurrence_backward.launches
    dxp, dw = torch.autograd.grad(lstm_recurrence(xr, wr, layout), (xr, wr), dh)
    torch.cuda.synchronize()
    assert lstm_recurrence_backward.launches == before + 1
    h, c = lstm_recurrence_with_cell(xp, w, layout)
    dxp_ref, dw_ref = lstm_recurrence_backward_grouped_plain(xp, w, h, c, dh, layout)
    assert torch.isfinite(dxp).all() and torch.isfinite(dw).all()
    assert _rel(dxp, dxp_ref) <= K5B_TOL
    assert _rel(dw, dw_ref) <= K5B_TOL


def test_k5b_weight_gradient_is_bit_equal_over_runs(cuda):
    """No float atomics: two backward calls on the same inputs give the same bits."""
    layout, xp, w, dh = _k5_train_case(cuda, False, seed=21)
    h, c = lstm_recurrence_with_cell(xp, w, layout)
    dxp1, dw1 = lstm_recurrence_backward(xp, w, h, c, dh, layout)
    dxp2, dw2 = lstm_recurrence_backward(xp, w, h, c, dh, layout)
    torch.cuda.synchronize()
    assert torch.equal(dxp1, dxp2) and torch.equal(dw1, dw2)


@pytest.mark.parametrize("H", [132, 169, 263])
@pytest.mark.parametrize("dirs", [2, 1], ids=["offline", "realtime"])
def test_k5_and_k5b_take_any_hidden_size(cuda, H, dirs):
    """K5 (serving and train mode) and K5b at hidden sizes past one block's
    128 threads (a loop over tiles of units; W_hh read from L2 where shared
    memory cannot hold it), short sequences, beside a bucket of H = 3 and
    one of H = 86 (W_hh held in shared memory), against the grouped plain
    versions on the CPU."""
    layout = RecurrenceLayout((H, 3, 86), (40, 33, 25), 2, dirs)
    g = torch.Generator().manual_seed(H + dirs)
    xp = torch.randn(layout.xp_size, generator=g) * 2
    w_hh = [(torch.rand((4, dirs, 4 * h, h), generator=g) * 2 - 1) / h ** 0.5 for h in layout.hidden]
    w = pack_recurrent_weights(w_hh)
    dh = torch.randn(layout.h_size, generator=g)
    xc, wc = xp.to(cuda), w.to(cuda)
    out = lstm_recurrence(xc, wc, layout)
    h, c = lstm_recurrence_with_cell(xc, wc, layout)
    dxp, dw = lstm_recurrence_backward(xc, wc, h, c, dh.to(cuda), layout)
    torch.cuda.synchronize()
    h_ref, c_ref = lstm_recurrence_grouped_plain(xp, w, layout, cell=True)
    assert torch.equal(out, h)                                 # serving and train mode: the same arithmetic
    assert float((h.cpu() - h_ref).abs().max()) <= K5_TOL
    assert _rel(c.cpu(), c_ref) <= K5_TOL
    dxp_ref, dw_ref = lstm_recurrence_backward_grouped_plain(xp, w, h.cpu(), c.cpu(), dh, layout)
    assert torch.isfinite(dxp).all() and torch.isfinite(dw).all()
    assert _rel(dxp.cpu(), dxp_ref) <= K5B_TOL
    assert _rel(dw.cpu(), dw_ref) <= K5B_TOL


def _k5b_case(layout, seed):
    """Projections, W_hh at torch's init bound and a cotangent on the CPU."""
    g = torch.Generator().manual_seed(seed)
    xp = torch.randn(layout.xp_size, generator=g) * 2
    w = pack_recurrent_weights([(torch.rand((4, layout.dirs, 4 * h, h), generator=g) * 2 - 1) / h ** 0.5
                                for h in layout.hidden])
    return xp, w, torch.randn(layout.h_size, generator=g)


def _k5b_against_plain(cuda, layout, seed):
    """K5b on the card from K5's own h and c against the grouped plain
    reverse walk on the CPU from the same h and c, and a second run's bits."""
    xp, w, dh = _k5b_case(layout, seed)
    xc, wc, dhc = xp.to(cuda), w.to(cuda), dh.to(cuda)
    h, c = lstm_recurrence_with_cell(xc, wc, layout)
    dxp, dw = lstm_recurrence_backward(xc, wc, h, c, dhc, layout)
    dxp2, dw2 = lstm_recurrence_backward(xc, wc, h, c, dhc, layout)
    torch.cuda.synchronize()
    dxp_ref, dw_ref = lstm_recurrence_backward_grouped_plain(xp, w, h.cpu(), c.cpu(), dh, layout)
    assert torch.isfinite(dxp).all() and torch.isfinite(dw).all()
    assert _rel(dxp.cpu(), dxp_ref) <= K5B_TOL
    assert _rel(dw.cpu(), dw_ref) <= K5B_TOL
    assert torch.equal(dxp, dxp2) and torch.equal(dw, dw2)


@pytest.mark.parametrize("dirs", [2, 1], ids=["offline", "realtime"])
@pytest.mark.parametrize("H", [1, 2, 3, 4, 5, 8, 9, 16])
def test_k5b_every_group_width(cuda, H, dirs):
    """K5b's group walk at every group width: GS 1, 2 and 4 with the row
    loads (H = GS), 4 without them (H = 3), 8 (H = 5, 8) with d(W_hh)
    summed inside the walk, 16 (H = 9, 16) with its separate ring walk;
    three buckets whose lengths are longer than, not a multiple of, and
    shorter than the register ring, at sequence batch 3 (a block's last
    group partly empty)."""
    layout = RecurrenceLayout((H, H, H), (203, 64, 3), 3, dirs)
    assert set(work_items(layout, backward=True)[:, 9].tolist()) == {1 << (H - 1).bit_length()}
    _k5b_against_plain(cuda, layout, seed=30 + H + dirs)


@pytest.mark.parametrize("dirs", [2, 1], ids=["offline", "realtime"])
@pytest.mark.parametrize("H,held", [(43, True), (86, True), (132, False), (263, False)])
def test_k5b_wide_buckets(cuda, H, held, dirs):
    """K5b's block path with W_hh held in shared memory (H = 43, 86: the
    bark-262 buckets) and read from L2 (H = 132, 263: linear-262), beside a
    group bucket, against the plain version; the table's choice checked."""
    layout = RecurrenceLayout((H, 2), (37, 50), 2, dirs)
    items = work_items(layout, backward=True)
    assert set(items[items[:, 0] == H][:, 9].tolist()) == {0 if held else -1}
    _k5b_against_plain(cuda, layout, seed=H + dirs)


# -- the registered ops (kernels/ops.py) and export on the card --------------------


def _op_cases(cuda):
    """(name, op, CUDA args, the plain result on the CPU, launch counters,
    launches of each counter a call) of each registered op."""
    from xumx_slicq_torch.kernels import ops
    from xumx_slicq_torch.kernels.analysis_gather import gather_flat_plain
    from xumx_slicq_torch.kernels.cdae_conv import _device_tables as k4_tables
    from xumx_slicq_torch.kernels.lstm_recurrence import _device_plan, layout_args
    from xumx_slicq_torch.kernels.wiener_em import _device_tables, layout_ints

    t = SliCQT(device=cuda, **MEL12)
    g = torch.Generator().manual_seed(5)
    tab = t.synth_table
    flat = torch.randn((8, 41, t.raw_len), generator=g, dtype=torch.complex64)
    layout = t.layout(4, 2, 41)
    x = torch.randn(layout.size, generator=g, dtype=torch.complex64) * 30
    v = torch.rand(4 * layout.size, generator=g) * 10
    tables = _device_tables(layout, cuda)
    rl = RecurrenceLayout((1, 9, 43), (300, 120, 41), 2, 2)
    xp = torch.randn(rl.xp_size, generator=g)
    w = torch.randn(rl.w_size, generator=g) * 0.3
    items, smem = _device_plan(rl, cuda)
    k5_args = (xp.to(cuda), w.to(cuda), items, smem, *layout_args(rl))
    at = t.analysis_table
    X = torch.randn((8, 41, t.nh), generator=g, dtype=torch.complex64)
    k4_model = Unmix(t.block_shapes(1, 2, 44100), seed=6, device=cuda)
    perturb_cdae(k4_model.blocks, 6)
    weights = k4_model.inference_weights()
    plan, k4_items, rtab, sizes = k4_tables(layout, weights.arch, False, cuda)
    k4_args = (x.to(cuda), weights.w, plan, k4_items, rtab, layout_ints(layout), weights.arch.ints(), 0, sizes)
    return [
        ("synth_assembly", ops.synth_assembly, (flat.to(cuda), tab.idx, tab.w_re, tab.w_im, tab.unrot),
         [synth_assembly_plain(flat, SliCQT(device="cpu", **MEL12).synth_table)], [synth_assembly], 1),
        ("analysis_gather", ops.analysis_gather, (X.to(cuda), at.entries, at.w),
         [gather_flat_plain(X, at.entries.cpu(), at.w.cpu())], [analysis_gather], 1),
        ("wiener_em_grouped", ops.wiener_em_grouped,
         (x.to(cuda), v.to(cuda), tables["buckets"], tables["items1"], tables["items2"], layout_ints(layout)),
         [wiener_em_grouped_plain(x, v, layout)], [wiener_em], K2_LAUNCHES),
        ("lstm_recurrence", ops.lstm_recurrence, k5_args, [lstm_recurrence_grouped_plain(xp, w, rl)],
         [lstm_recurrence], 1),
        ("lstm_recurrence_cell", ops.lstm_recurrence_cell, k5_args,
         list(lstm_recurrence_grouped_plain(xp, w, rl, cell=True)), [lstm_recurrence], 1),
        ("cdae_folded", ops.cdae_folded, k4_args,
         list(cdae_folded_plain(x, weights.w.cpu(), layout, weights.arch, False)), list(k4_counters.values()), 1),
    ]


@pytest.mark.parametrize("which", range(6), ids=["k1", "k3", "k2", "k5", "k5_cell", "k4"])
def test_registered_op_on_the_card_matches_plain(cuda, which):
    """Each op's CUDA implementation launches its kernel (counted) and agrees
    with the plain version at the kernel's tolerance (1e-5 for K1 and K4, 1e-6
    for K3, 1e-4 for K2 per the largest value, 1e-4 absolute for K5's h and c)."""
    name, op, args, plain, counters, launches = _op_cases(cuda)[which]
    before = [c.launches for c in counters]
    out = op(*args)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [launches] * len(counters)
    outs = [out] if isinstance(out, torch.Tensor) else list(out)[: len(plain)]
    for got, ref in zip(outs, plain):
        assert got.device.type == "cuda" and got.shape == ref.shape
        if name.startswith("lstm"):
            assert float((got.cpu() - ref).abs().max()) <= K5_TOL
        else:
            assert _rel(got.cpu(), ref) <= {"synth_assembly": 1e-5, "analysis_gather": 1e-6,
                                            "cdae_folded": K4_TOL}.get(name, 1e-4)


@pytest.mark.parametrize("which", range(6), ids=["k1", "k3", "k2", "k5", "k5_cell", "k4"])
def test_registered_op_opcheck_on_the_card(cuda, which):
    _, op, args, _, _, _ = _op_cases(cuda)[which]
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("lstm", [False, True], ids=["cdae", "lstm"])
def test_export_round_trip_on_the_card(cuda, tmp_path, lstm):
    """A mel-12 model exported on the card, saved, loaded again: its graph
    holds the xumx_slicq op nodes, a call launches K1 and K3 once, K2
    three times and K4's four layers (the CDAE) or K5 three times (the
    LSTM), and it reproduces the
    Separator's chunk within 1e-5."""
    import json

    import numpy as np

    from xumx_slicq_torch.export import ExportedSeparator, export_model
    from xumx_slicq_torch.kernels.ops import graph_op_counts
    from xumx_slicq_torch.models.convert import to_reference_state_dict
    from xumx_slicq_torch.separator import Separator

    d = tmp_path / "model"
    d.mkdir()
    args = dict(fscale="mel", fbins=12, fmin=200.0, sample_rate=44100.0, seq_dur=0.3, nb_channels=2,
                realtime=False, lstm=lstm)
    (d / "xumx_slicq_v2.json").write_text(json.dumps({"args": args}))
    shapes = SliCQT(device="cpu", **MEL12).block_shapes(1, 2, int(0.3 * 44100))
    torch.save(to_reference_state_dict(Unmix(shapes, lstm=lstm, seed=3, device="cpu")), d / "xumx_slicq_v2.pth")
    meta = export_model(d, tmp_path / "out", chunk_lens=(16384,), device="cuda")
    assert meta["device"] == "cuda"
    es = ExportedSeparator(tmp_path / "out")
    counts = graph_op_counts(es.program(16384).graph)
    assert counts["synth_assembly"] == 1 and counts["analysis_gather"] == 1 and counts["wiener_em_grouped"] == 1
    assert counts["lstm_recurrence"] == (3 if lstm else 0) and counts["cdae_folded"] == (0 if lstm else 1)
    x = (np.random.default_rng(0).standard_normal((1, 2, 16384)) * 0.1).astype(np.float32)
    counters = (synth_assembly, analysis_gather, wiener_em, lstm_recurrence, *k4_counters.values())
    before = [c.launches for c in counters]
    est = es(x)
    torch.cuda.synchronize()
    moved = [c.launches - n for c, n in zip(counters, before)]
    assert moved == [1, 1, K2_LAUNCHES, 3 if lstm else 0] + [0 if lstm else 1] * 4
    ref = Separator.load(model_path=d, device=cuda, chunk_size=16384)(x)
    np.testing.assert_allclose(est, ref, rtol=0, atol=1e-5)
