"""The port's LSTM variant against the JAX package's, on the CPU.

Small geometries that reach every branch: hand-picked buckets with F = 17
(down-projection, odd h1, so H = 9 offline), F = 3 and F = 1 at B = 1 and
B = 3, and mel-12 (F in {4, 1}) for the whole model and the Separator.
Inputs come from numpy with a seed; weights from the JAX package's
init_lstm_params (through lstm_params_from_jax) or from the port (through
the reference's names, which both packages read). Tolerances: masks within
1e-5 absolute (measured ~6e-8: the same fp32 arithmetic, matmul sums in
another order), stems within 1e-5 absolute on 0.1-RMS input. The
recurrence's plain version is also held to torch.nn.LSTM, an independent
implementation, within 1e-5.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_goldens as goldens
from torch_port_utils import DEVICE, MEL12, TINY_ARGS, TINY_LEN, noise

from xumx_slicq_tpu.models import Unmix as JaxUnmix
from xumx_slicq_tpu.models.lstm import SlicedLSTMSpec, apply_lstm, init_lstm_batch_stats, init_lstm_params
from xumx_slicq_tpu.models.torch_import import import_lstm_state_dict
from xumx_slicq_tpu.separator import Separator as JaxSeparator
from xumx_slicq_torch.kernels import lstm_recurrence as k5
from xumx_slicq_torch.kernels.lstm_recurrence import (RecurrenceLayout, lstm_recurrence, lstm_recurrence_plain,
                                                      pack_recurrent_weights, work_items)
from xumx_slicq_torch.models import SlicedLSTM, Unmix
from xumx_slicq_torch.models.convert import load_reference_state_dict, lstm_params_from_jax, to_reference_state_dict
from xumx_slicq_torch.ops.slicqt import SliCQT
from xumx_slicq_torch.separator import Separator

ATOL = 1e-5
CHUNK = 8192


def _jitter(params, stats, seed):
    """Trained-looking BatchNorm and whitening: scales, shifts and running
    statistics away from their init, so that every term counts."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        a = np.array(a)
        name = jax.tree_util.keystr(path)
        if "scale" in name or "var" in name:
            return a * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if "bias" in name or "mean" in name:
            return a + rng.uniform(-0.3, 0.3, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(move, params), jax.tree_util.tree_map_with_path(move, stats)


def _port_unmix(shapes, realtime, seed=3):
    """A port LSTM model with seeded weights and moved BatchNorm/whitening."""
    model = Unmix(shapes, realtime=realtime, lstm=True, seed=seed, device=DEVICE)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(("input_mean", "bn1.bias", "bn2.bias", "running_mean")):
                t.add_(torch.rand(t.shape, generator=g) * 0.6 - 0.3)
            elif name.endswith(("input_scale", "bn1.weight", "bn2.weight", "running_var")):
                t.mul_(torch.rand(t.shape, generator=g) + 0.5)
    return model


def _jax_from_port(model, shapes, realtime):
    """The port model's weights in the JAX package, through the reference's
    names and import_lstm_state_dict with the model's F > 10 rule."""
    ju = JaxUnmix(shapes, realtime=realtime, lstm=True)
    sd = {k: v.numpy() for k, v in to_reference_state_dict(model).items()}
    params, stats = import_lstm_state_dict(sd, len(shapes), [s.downsample for s in ju.specs])
    return ju, params, stats


@pytest.mark.parametrize("H", [1, 9, 43])
def test_recurrence_plain_matches_nn_lstm(H):
    """One bidirectional layer against torch.nn.LSTM, target by target."""
    frames, B, n_in = 23, 3, 5
    x = torch.from_numpy(noise(H, (4, frames, B, n_in)))
    lstms = [torch.nn.LSTM(n_in, H, bidirectional=True) for _ in range(4)]
    w = {k: torch.stack([torch.stack([getattr(m, f"{k}_l0"), getattr(m, f"{k}_l0_reverse")]) for m in lstms])
         for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
    with torch.no_grad():
        xp = torch.matmul(x.reshape(4, 1, frames * B, n_in), w["weight_ih"].transpose(-1, -2)) \
            + w["bias_ih"][:, :, None] + w["bias_hh"][:, :, None]
        out = lstm_recurrence_plain(xp.view(4, 2, frames, B, 4 * H), w["weight_hh"])
        for t, m in enumerate(lstms):
            ref, _ = m(x[t])
            assert out.shape == (4, frames, B, 2 * H)
            assert float((out[t] - ref).abs().max()) <= ATOL, t


BLOCKS = [(1, 2, 17, 3, 8), (3, 2, 17, 2, 4), (1, 2, 3, 3, 8), (3, 2, 3, 2, 8), (1, 2, 1, 3, 4), (3, 2, 1, 2, 4)]


@pytest.fixture(scope="module")
def sliced_refs():
    """refs(realtime) -> {shape: (params, stats, x, JAX masks)} for every
    shape of BLOCKS, the six masks from one jitted program per variant."""
    cache = {}

    def refs(realtime):
        if realtime not in cache:
            specs, cases = [], []
            for B, C, F, S, T in BLOCKS:
                spec = SlicedLSTMSpec(C, F, T, realtime=realtime)
                params, stats = _jitter(init_lstm_params(jax.random.PRNGKey(F + B), spec),
                                        init_lstm_batch_stats(spec), F)
                specs.append(spec)
                cases.append((params, stats, np.abs(noise(B * F, (B, C, F, S, T)))))
            masks = jax.jit(lambda cs: [apply_lstm(p, st, x, sp)[0] for sp, (p, st, x) in zip(specs, cs)])(cases)
            cache[realtime] = {shape: (*case, np.asarray(m)) for shape, case, m in zip(BLOCKS, cases, masks)}
        return cache[realtime]

    return refs


@pytest.mark.parametrize("realtime", [False, True], ids=["offline", "realtime"])
@pytest.mark.parametrize("shape", BLOCKS, ids=lambda s: f"F{s[2]}-B{s[0]}")
def test_sliced_lstm_matches_jax(sliced_refs, shape, realtime):
    B, C, F, S, T = shape
    params, stats, x, ref = sliced_refs(realtime)[shape]
    spec = SlicedLSTMSpec(C, F, T, realtime=realtime)
    blk = SlicedLSTM(C, F, T, realtime=realtime).eval()
    assert (blk.downsample, blk.hidden_size_1, blk.lstm_hidden, blk.odd_lstm) == \
        (spec.downsample, spec.hidden_size_1, spec.lstm_hidden, spec.odd_lstm)
    sd = lstm_params_from_jax({"blocks": [params]}, {"blocks": [stats]})
    blk.load_state_dict({k.removeprefix("blocks.0."): v for k, v in sd.items()})
    out = blk(torch.from_numpy(x))
    assert out.shape == (4, B, C, F, S, T)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=ATOL)


def test_grouped_recurrence_matches_per_bucket():
    """The wrapper over a packed layout of buckets with H on both sides of
    the kernel's thread/block split, and its work table: every sequence of
    every bucket exactly once."""
    hidden, frames, B, dirs = (1, 9, 4, 17), (7, 5, 6, 3), 3, 2
    layout = RecurrenceLayout(hidden, frames, B, dirs)
    g = torch.Generator().manual_seed(0)
    xp = torch.randn(layout.xp_size, generator=g)
    w_hh = [torch.rand((4, dirs, 4 * h, h), generator=g) - 0.5 for h in hidden]
    out = lstm_recurrence(xp, pack_recurrent_weights(w_hh), layout)
    for x, w, h in zip(layout.xp_blocks(xp), w_hh, layout.h_blocks(out)):
        assert float((h - lstm_recurrence_plain(x, w)).abs().max()) <= 1e-6      # matmuls of other batch sizes
    items = work_items(layout)
    for k, (H, n) in enumerate(zip(hidden, frames)):
        mine = items[(items[:, 4] == layout.xp_offsets[k])]
        assert (mine[:, :4] == [H, n, B, dirs]).all()
        covered = sorted(q for first, count in mine[:, 7:9] for q in range(first, first + count))
        assert covered == list(range(4 * dirs * B))
        assert (mine[:, 8] == 1).all() == (H > 16)
    with pytest.raises(ValueError):
        lstm_recurrence(xp[:-1].contiguous(), pack_recurrent_weights(w_hh), layout)


@pytest.mark.parametrize("scale", ["bark", "linear"], ids=["bark-262", "linear-262"])
def test_work_items_walk_every_sequence_once(scale):
    """K5's and K5b's work tables at the main path's layout (chunk batch 4
    of the default chunk) and the training layout (batch 32 of 2 s),
    offline and realtime: every (bucket, target, direction, b) exactly
    once, each block within THREADS lanes, the blocks longest sequence
    first, and W_hh held in shared memory exactly where it fits."""
    t = SliCQT(device=DEVICE, scale=scale, fbins=262)
    for batch, length in ((4, 2621440), (32, 2 * 44100)):
        S = t.n_slices(length)
        shapes = t.layout(batch, 2, S).shapes
        for realtime in (False, True):
            hidden = [SlicedLSTM(C, F, M, realtime=realtime).lstm_hidden for (_, C, F, _, M) in shapes]
            layout = RecurrenceLayout(hidden, [S * M for *_, M in shapes], batch, 1 if realtime else 2)
            for backward in (False, True):
                items = work_items(layout, backward)
                assert items.shape[1] == k5.ITEM_FIELDS
                assert (np.diff(items[:, 1]) <= 0).all()
                for k, (H, n) in enumerate(zip(layout.hidden, layout.frames)):
                    mine = items[items[:, 4] == layout.xp_offsets[k]]
                    assert (mine[:, :7] == [H, n, batch, layout.dirs, layout.xp_offsets[k], layout.h_offsets[k],
                                            layout.w_offsets[k]]).all()
                    covered = sorted(q for first, count in mine[:, 7:9] for q in range(first, first + count))
                    assert covered == list(range(4 * layout.dirs * batch))
                    lanes = mine[:, 9]
                    assert (lanes == lanes[0]).all()
                    if H > k5.GROUP_H:
                        assert (mine[:, 8] == 1).all()
                        held = k5._block_smem(H, backward, w_held=True) <= k5.SMEM_LIMIT
                        assert lanes[0] == (0 if held else -1)
                    else:
                        assert lanes[0] == 1 << (H - 1).bit_length()
                        assert (mine[:, 8] * lanes <= k5.THREADS).all()
            if scale == "linear":
                assert set(hidden) == {263 if realtime else 132}


def test_backward_table_holds_w_hh_where_it_fits():
    """K5b's table: a wide bucket's block holds W_hh in shared memory when
    K5b's own need (`_block_smem(H, True, w_held=True)`) fits the limit,
    else reads it from L2; the launch's shared memory is its largest
    block's; a block that does not fit even without W_hh, or a group whose
    offsets pass 32 bits, raises. No kernel runs here."""
    layout = RecurrenceLayout((2, 43, 86, 132, 263), (50, 30, 20, 10, 5), 2, 2)
    lanes = {}
    for limit in (k5.SMEM_LIMIT, k5._block_smem(43, True, w_held=True) - 1):
        items = work_items(layout, backward=True, smem_limit=limit)
        mode = {int(H): set(items[items[:, 0] == H][:, 9].tolist()) for H in layout.hidden}
        lanes[limit] = mode
        for H in (43, 86, 132, 263):
            held = k5._block_smem(H, True, w_held=True) <= limit
            assert mode[H] == {0 if held else -1}
        assert mode[2] == {2}
        wide = [(H, m == 0) for H, m in zip(items[:, 0], items[:, 9]) if m <= 0]
        assert k5.smem_bytes(items, backward=True) == max(k5._block_smem(int(H), True, w_held=h) for H, h in wide)
    assert lanes[k5.SMEM_LIMIT][86] == {0} and lanes[k5.SMEM_LIMIT][132] == {-1}
    assert lanes[k5._block_smem(43, True, w_held=True) - 1][43] == {-1}
    # K5 holds W_hh in a smaller layout: at a limit between the two needs, K5 holds it and K5b does not
    between = k5._block_smem(86, False, w_held=True)
    for backward, mode in ((False, 0), (True, -1)):
        items = work_items(layout, backward, between)
        assert set(items[items[:, 0] == 86][:, 9].tolist()) == {mode}
    with pytest.raises(ValueError):
        work_items(layout, backward=True, smem_limit=k5._block_smem(263, True) - 1)
    with pytest.raises(ValueError):
        work_items(RecurrenceLayout((1,), (2 ** 29,), 4, 1), backward=True)


@pytest.fixture(scope="module")
def mel12_blocks():
    """The port's mel-12 blocks of a 0.3 s clip, and the same values for JAX."""
    x = noise(11, (1, 2, TINY_LEN), 0.1)
    Xt = list(SliCQT(device=DEVICE, **MEL12).forward(torch.from_numpy(x)))
    return Xt, [jnp.asarray(b.numpy()) for b in Xt]


def _unmix_matches_jax(Xt, Xj, realtime):
    """The port's Unmix(lstm=True) against the JAX Unmix.apply on the same
    blocks and weights: masks and complex estimates."""
    shapes = [tuple(x.shape) for x in Xt]
    model = _port_unmix(shapes, realtime)
    ju, params, stats = _jax_from_port(model, shapes, realtime)
    Y_ref, M_ref = jax.jit(lambda p, s, X: ju.apply(p, s, X)[:2])(params, stats, Xj)
    with torch.inference_mode():
        Y, M = model.apply(Xt, model.inference_weights())
    for a, b in zip(M, M_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL)
    for a, b in zip(Y, Y_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL)
    return model


@pytest.mark.parametrize("realtime", [False, True], ids=["offline", "realtime"])
def test_unmix_lstm_matches_jax(mel12_blocks, realtime):
    """The whole model at mel-12 (K5's grouped path: every bucket's layer
    in one recurrence call): masks and complex estimates."""
    _unmix_matches_jax(*mel12_blocks, realtime)


WIDE = (1, 2, 263, 3, 16)       # the linear-262 bucket: F = 263, C = 2; 48 steps


@pytest.mark.parametrize("realtime", [False, True], ids=["offline", "realtime"])
def test_sliced_lstm_matches_jax_past_h128(realtime):
    """A bucket of F = 263 (H = 132 offline, 263 realtime: past the 128
    that K5's block path once held, which the CPU path refused too) against
    apply_lstm, on a short block."""
    B, C, F, S, T = WIDE
    spec = SlicedLSTMSpec(C, F, T, realtime=realtime)
    params, stats = _jitter(init_lstm_params(jax.random.PRNGKey(7), spec), init_lstm_batch_stats(spec), 5)
    x = np.abs(noise(263, WIDE))
    ref = jax.jit(lambda p, st, x: apply_lstm(p, st, x, spec)[0])(params, stats, x)
    blk = SlicedLSTM(C, F, T, realtime=realtime).eval()
    assert blk.lstm_hidden == spec.lstm_hidden == (263 if realtime else 132)
    sd = lstm_params_from_jax({"blocks": [params]}, {"blocks": [stats]})
    blk.load_state_dict({k.removeprefix("blocks.0."): v for k, v in sd.items()})
    out = blk(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def linear262_blocks():
    """The port's --fscale linear --fbins 262 blocks of a 0.3 s clip (one
    bucket, F = 263), and the same values for JAX."""
    x = noise(13, (1, 2, TINY_LEN), 0.1)
    Xt = list(SliCQT(device=DEVICE, scale="linear", fbins=262).forward(torch.from_numpy(x)))
    return Xt, [jnp.asarray(b.numpy()) for b in Xt]


@pytest.mark.parametrize("realtime", [False, True], ids=["offline", "realtime"])
def test_unmix_lstm_matches_jax_at_linear262(linear262_blocks, realtime):
    """The whole LSTM model at linear-262, whose one bucket has H = 132
    offline and 263 realtime."""
    model = _unmix_matches_jax(*linear262_blocks, realtime)
    assert [blk.lstm_hidden for blk in model.blocks] == [263 if realtime else 132]


@pytest.mark.parametrize("realtime", [False, True], ids=["offline", "realtime"])
def test_reference_names_round_trip(realtime):
    """port -> reference names -> the JAX package's import (F > 10 flags)
    -> lstm_params_from_jax gives the port's weights back, and the port's
    own loader reads the same names. The buckets cover the
    down-projection with odd h1 (F = 17) and 6 <= F <= 10 (F = 9)."""
    shapes = [(1, 2, 17, 1, 8), (1, 2, 9, 1, 8), (1, 2, 1, 1, 4)]
    model = _port_unmix(shapes, realtime)
    own = model.state_dict()
    _, params, stats = _jax_from_port(model, shapes, realtime)
    back = lstm_params_from_jax(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats))
    ref_names = to_reference_state_dict(model)
    for sd in (back, load_reference_state_dict(ref_names)):
        assert set(sd) == set(own)
        for k, v in own.items():
            assert torch.equal(sd[k], v), k
    assert "sliced_umx.0.layer1s.3.0.weight" in ref_names and "sliced_umx.1.layer1s.0.0.weight" not in ref_names
    assert ("sliced_umx.0.lstms.2.weight_hh_l2_reverse" in ref_names) is not realtime


def test_port_loads_reference_names_at_bark24():
    """bark-24 from 50 Hz has a bucket with F = 9, where the down-projection
    rule F > 10 (the model's, lstm.py:41-43) and F * C > 10 (the JAX
    package's loader, xumx_slicq_tpu/separator.py:421) disagree: the port
    reads the reference's names by the first."""
    shapes = SliCQT(device=DEVICE, scale="bark", fbins=24, fmin=50.0).block_shapes(1, 2, 44100)
    assert any(6 <= s[2] <= 10 for s in shapes)
    model = _port_unmix(shapes, realtime=False)
    other = Unmix(shapes, lstm=True, seed=9, device=DEVICE)
    other.load_state_dict(load_reference_state_dict(to_reference_state_dict(model)))
    for (k, a), b in zip(model.state_dict().items(), other.state_dict().values()):
        assert torch.equal(a, b), k
    mid = next(i for i, s in enumerate(shapes) if 6 <= s[2] <= 10)
    assert not model.blocks[mid].downsample and shapes[mid][2] * shapes[mid][1] > 10


def test_parameter_counts_match_jax_at_bark262():
    """976,174 offline and 1,213,294 realtime parameters, and the JAX
    package's counts from shapes alone (jax.eval_shape of init_lstm_params,
    once per bucket height: the time axis does not size a weight)."""
    shapes = SliCQT(device=DEVICE).block_shapes(1, 2, 2 * 44100)
    for realtime, expected in ((False, 976174), (True, 1213294)):
        per_f = {}
        for _, C, F, _, T in shapes:
            if F not in per_f:
                spec = SlicedLSTMSpec(C, F, T, realtime=realtime)
                tree = jax.eval_shape(lambda k: init_lstm_params(k, spec), jax.random.PRNGKey(0))
                per_f[F] = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
        assert sum(per_f[s[2]] for s in shapes) == expected
        assert Unmix(shapes, realtime=realtime, lstm=True, device=DEVICE).num_params() == expected


def test_lstm_trains_and_keeps_batchnorm_unfolded():
    """BatchNorm folding still raises (the LSTM's BatchNorm stays unfolded,
    unmix.py:171-172); train mode and amp now build and run, and a
    backward reaches every parameter."""
    shapes = [(1, 2, 3, 2, 4), (1, 2, 17, 2, 4)]
    model = Unmix(shapes, lstm=True, device=DEVICE)
    with pytest.raises(ValueError):
        model.fold_batchnorm()
    X = [torch.from_numpy(noise(i, s) + 1j * noise(i + 9, s)) for i, s in enumerate(shapes)]
    for amp in (False, True):
        model = Unmix(shapes, lstm=True, amp=amp, device=DEVICE).train()
        _, masks = model.apply(X, generator=torch.Generator().manual_seed(0))
        sum(m.sum() for m in masks).backward()
        assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())
        assert all(m.dtype == torch.float32 for m in masks)


@pytest.fixture(scope="module")
def lstm_dir(tmp_path_factory):
    """A mel-12 LSTM model directory written by the port."""
    return _write_lstm_dir(tmp_path_factory.mktemp("lstm"))


SEPARATOR_CASES = {"chunk-batch-padded-to-4": (1, 2, 2 * CHUNK + 3000), "chunk-by-chunk-B2": (2, 2, CHUNK - 1000)}


def _separator_inputs(lstm_dir, case):
    """The case's seeded 0.1-RMS input and the fingerprint of it and of the
    directory's weights."""
    x = noise(12, SEPARATOR_CASES[case], 0.1)
    return x, goldens.state_fingerprint(torch.load(lstm_dir / "xumx_slicq_v2.pth", weights_only=True), x)


def _jax_separator_stems(lstm_dir, x) -> np.ndarray:
    ref = JaxSeparator.load(model_path=lstm_dir, runtime_backend="jax-cpu", chunk_size=CHUNK)
    return np.asarray(ref(x))


def _port_separator_stems(lstm_dir, x) -> np.ndarray:
    ours = Separator.load(model_path=lstm_dir, device=DEVICE, chunk_size=CHUNK)
    assert ours.model.lstm and not ours.model.realtime
    return ours(x)


@pytest.mark.parametrize("case", list(SEPARATOR_CASES))
def test_separator_lstm_matches_jax(lstm_dir, case):
    """Both packages' Separator.load on the same directory. 3 chunks run as
    one chunk batch padded to 4 with a zero chunk, which the LSTM's
    sequences mix in (models/lstm.py): the stems agree only because both
    batch the chunks alike. B = 2 runs chunk by chunk. The JAX package's
    stems are the golden tests/goldens/lstm_separator_<case>.npz
    (test_separator_lstm_golden_matches_live_jax recomputes it)."""
    x, inputs = _separator_inputs(lstm_dir, case)
    b = goldens.load(f"lstm_separator_{case}", inputs)["stems"]
    a = _port_separator_stems(lstm_dir, x)
    assert a.shape == b.shape == (4, x.shape[0], 2, x.shape[-1])
    np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


@pytest.mark.slow
@pytest.mark.parametrize("case", list(SEPARATOR_CASES))
def test_separator_lstm_golden_matches_live_jax(lstm_dir, case):
    x, inputs = _separator_inputs(lstm_dir, case)
    live = _jax_separator_stems(lstm_dir, x)
    np.testing.assert_allclose(goldens.load(f"lstm_separator_{case}", inputs)["stems"], live, rtol=0, atol=ATOL)
    np.testing.assert_allclose(_port_separator_stems(lstm_dir, x), live, rtol=0, atol=ATOL)


def _write_lstm_dir(d):
    (d / "xumx_slicq_v2.json").write_text(json.dumps({"args": dict(TINY_ARGS, lstm=True)}))
    shapes = SliCQT(device=DEVICE, **MEL12).block_shapes(1, 2, TINY_LEN)
    torch.save(to_reference_state_dict(_port_unmix(shapes, realtime=False)), d / "xumx_slicq_v2.pth")
    return d


def _golden_separator(case):
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as tmp:
        d = _write_lstm_dir(Path(tmp))
        x, inputs = _separator_inputs(d, case)
        return inputs, dict(stems=_jax_separator_stems(d, x))


GOLDENS = {f"lstm_separator_{case}": (lambda case=case: _golden_separator(case)) for case in SEPARATOR_CASES}


@pytest.mark.slow
def test_forward_device_lstm_matches_jax_past_8_chunks(lstm_dir):
    """forward_device on 10 chunks: both packages run waves of 8 and 2
    chunks (xumx_slicq_tpu/separator.py:286), whose zero-padded batches the
    LSTM's sequences mix in. Compiles two JAX programs (slow)."""
    ours = Separator.load(model_path=lstm_dir, device=DEVICE, chunk_size=CHUNK)
    ref = JaxSeparator.load(model_path=lstm_dir, runtime_backend="jax-cpu", chunk_size=CHUNK)
    x = noise(13, (1, 2, 10 * CHUNK - 100), 0.1)
    a = ours.forward_device(torch.from_numpy(x)).numpy()
    b = np.asarray(ref.forward_device(jnp.asarray(x)))
    assert a.shape == b.shape == (4, 1, 2, x.shape[-1])
    np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


@pytest.mark.slow
def test_devices_lstm_matches_jax_mesh_one_chunk(lstm_dir):
    """One chunk over 2 devices: the JAX mesh pads it to a chunk batch of 2
    (one zero chunk), and so does the port's Separator(devices=...)."""
    from xumx_slicq_tpu.parallel.mesh import make_mesh

    ours = Separator.load(model_path=lstm_dir, devices=[DEVICE, DEVICE], chunk_size=CHUNK)
    ref = JaxSeparator.load(model_path=lstm_dir, mesh=make_mesh(2, platform="cpu"), chunk_size=CHUNK)
    x = noise(14, (1, 2, CHUNK - 1000), 0.1)
    a, b = ours(x), np.asarray(ref(x))
    assert a.shape == b.shape == (4, 1, 2, x.shape[-1])
    np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def test_lstm_separator_needs_explicit_cpu(lstm_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Separator.load(model_path=lstm_dir)
