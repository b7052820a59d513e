"""Training the port's LSTM variant against the JAX package's, on the CPU.

The recurrence's backward (the plain versions of K5b) against autograd of
the grouped plain forward in float64 and against `jax.vjp` of the JAX
package's `_lstm_cell_scan`; train-mode BatchNorm1d; the inter-layer
dropout; one train step at mel-12 against JAX `make_train_step` with
rng=None (dropout off on both sides), offline with every loss term and
realtime; the bf16 loss against the JAX package's amp=True; and
`training_main --lstm` with a resume, whose directory both packages load.
Inputs come from numpy with a seed; the step's weights from the port's
seeded init with BatchNorm, whitening and running statistics moved, and
reach the JAX package through the reference's names. Tolerances, with
their reasons:
* plain backward against autograd (float64): 1e-10 of the largest value;
* plain backward against jax.vjp (float32): relative norm 1e-5 (the same
  arithmetic, sums in another order);
* BatchNorm1d: 1e-6 of the largest value (fp32 means in another order);
* the train step: loss 1e-5 relative, running statistics 1e-6 and the
  AdamW update 1e-3 (on the entries whose gradient is at least 100 times
  Adam's eps: nearer to it, g / (|g| + eps) turns rounding noise into
  update noise), as tests/test_torch_training.py; gradients 1e-4
  relative norm, with a norm floor of 1e-2 of the largest gradient norm
  (that test's 1e-3 is too small here): train-mode BatchNorm right after
  the LSTM leaves the last layer's biases and the whitening gradients that
  are small remainders of sums that cancel. Against the port run in
  float64, both packages' float32 gradients of such tensors are off by
  1e-4 to 5e-3 of their own norms (the JAX package's the larger), about
  1e-5 of the largest norm;
* bf16: loss 1e-2 relative (bf16 operands round at other places).
The step tests run 0.1 s clips (up to 2,640 steps a sequence): the plain
recurrence walks step by step in Python on the CPU.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from torch_port_utils import DEVICE, MEL12, keep_grads, noise, norm_rel

from xumx_slicq_tpu import loss as jloss
from xumx_slicq_tpu.models import Unmix as JaxUnmix
from xumx_slicq_tpu.models.lstm import _batch_norm1d, _lstm_cell_scan
from xumx_slicq_tpu.models.torch_import import import_lstm_state_dict
from xumx_slicq_tpu.ops.slicqt import SliCQT as JaxSliCQT
from xumx_slicq_tpu.separator import Separator as JaxSeparator
from xumx_slicq_tpu.training import make_train_step as jax_make_train_step
from xumx_slicq_torch.kernels.lstm_recurrence import (RecurrenceLayout, lstm_recurrence_backward_grouped_plain,
                                                      lstm_recurrence_backward_plain, lstm_recurrence_grouped_plain,
                                                      pack_recurrent_weights)
from xumx_slicq_torch.models import Unmix
from xumx_slicq_torch.models import lstm as lstm_module
from xumx_slicq_torch.models.convert import lstm_params_from_jax, to_reference_state_dict
from xumx_slicq_torch.models.nn import batch_norm1d
from xumx_slicq_torch.ops.slicqt import SliCQT
from xumx_slicq_torch.separator import Separator
from xumx_slicq_torch.training import dropout_seed, make_train_step, training_main

LR, WD = 1e-3, 1e-5
ADAM_EPS = 1e-8                 # torch's and optax's AdamW default
BATCH = 2
LEN = int(0.1 * 44100)


def _layout(H, dirs):
    """Buckets of hidden size H and 1, of two lengths, at sequence batch 3."""
    return RecurrenceLayout((H, 1, H), (7, 5, 4), 3, dirs)


def _w_hh(layout, g, dtype):
    return [((torch.rand((4, layout.dirs, 4 * h, h), generator=g, dtype=dtype) * 2 - 1) / h ** 0.5)
            for h in layout.hidden]


@pytest.mark.parametrize("dirs", [2, 1], ids=["bidirectional", "unidirectional"])
@pytest.mark.parametrize("H", [1, 9, 43])
def test_grouped_plain_backward_matches_autograd(H, dirs):
    """The grouped reverse walk (d(xp) and d(W_hh^T), packed) and the
    one-bucket one (d(xp), d(W_hh)) against autograd of the grouped plain
    forward, float64, H on both sides of K5's lane/block split."""
    layout = _layout(H, dirs)
    g = torch.Generator().manual_seed(H + dirs)
    xp = (torch.randn(layout.xp_size, generator=g, dtype=torch.float64) * 2).requires_grad_(True)
    w_hh = [w.requires_grad_(True) for w in _w_hh(layout, g, torch.float64)]
    dh = torch.randn(layout.h_size, generator=g, dtype=torch.float64)
    h = lstm_recurrence_grouped_plain(xp, pack_recurrent_weights(w_hh), layout)
    gx, *gw = torch.autograd.grad(h, [xp] + w_hh, dh)
    with torch.no_grad():
        w = pack_recurrent_weights(w_hh)
        h2, c2 = lstm_recurrence_grouped_plain(xp, w, layout, cell=True)
        dxp, dw = lstm_recurrence_backward_grouped_plain(xp.detach(), w, h2, c2, dh, layout)
        gwp = pack_recurrent_weights(gw)
    assert torch.equal(h2, h.detach())
    assert float((dxp - gx).abs().max()) <= 1e-10 * float(gx.abs().max())
    assert float((dw - gwp).abs().max()) <= 1e-10 * float(gwp.abs().max())
    for x, w_k, hk, ck, dk, ref_x, ref_w in zip(layout.xp_blocks(xp.detach()), w_hh, layout.h_blocks(h2),
                                                layout.h_blocks(c2), layout.h_blocks(dh), layout.xp_blocks(gx), gw):
        dx1, dw1 = lstm_recurrence_backward_plain(x, w_k.detach(), hk, ck, dk)
        assert float((dx1 - ref_x).abs().max()) <= 1e-10 * float(gx.abs().max())
        assert float((dw1 - ref_w).abs().max()) <= 1e-10 * float(gwp.abs().max())


def _plain_backward_against_jax_vjp(layout, seed):
    """The grouped plain backward against jax.vjp of _lstm_cell_scan (the
    JAX package's scan, W_ih = I and zero biases so that its input is xp),
    every target and direction of the layout's buckets, float32, the same
    numpy inputs: relative norm 1e-5."""
    rng = np.random.default_rng(seed)
    dirs = layout.dirs
    xp = (rng.standard_normal(layout.xp_size) * 2).astype(np.float32)
    w_hh = [((rng.random((4, dirs, 4 * h, h)) * 2 - 1) / h ** 0.5).astype(np.float32) for h in layout.hidden]
    dh = rng.standard_normal(layout.h_size).astype(np.float32)

    def layer(xs, ws):
        """The packed h of the layout through _lstm_cell_scan, vmapped over targets."""
        out = []
        for x, w in zip(xs, ws):                           # x (4, dirs, frames, B, 4H), w (4, dirs, 4H, H)
            G = x.shape[-1]
            eye, zero = jnp.eye(G, dtype=jnp.float32), jnp.zeros(G, jnp.float32)
            hs = [jax.vmap(lambda xt, wt, rev=rev: _lstm_cell_scan(xt, eye, wt, zero, zero, reverse=rev))(
                x[:, d], w[:, d]) for d, rev in ((0, False), (1, True))[:dirs]]
            out.append(jnp.concatenate(hs, axis=-1).reshape(-1))
        return jnp.concatenate(out)

    xs = [jnp.asarray(b.numpy()) for b in layout.xp_blocks(torch.from_numpy(xp))]
    _, vjp = jax.vjp(jax.jit(layer), xs, [jnp.asarray(w) for w in w_hh])
    jdx, jdw = vjp(jnp.asarray(dh))

    x, w = torch.from_numpy(xp), pack_recurrent_weights([torch.from_numpy(a) for a in w_hh])
    h, c = lstm_recurrence_grouped_plain(x, w, layout, cell=True)
    dxp, dw = lstm_recurrence_backward_grouped_plain(x, w, h, c, torch.from_numpy(dh), layout)
    for ours, ref in zip(layout.xp_blocks(dxp), jdx):
        assert norm_rel(ours, np.array(ref)) <= 1e-5
    for ours, ref in zip(layout.w_blocks(dw), jdw):
        assert norm_rel(ours, np.array(ref).swapaxes(-1, -2)) <= 1e-5


def test_plain_backward_matches_jax_grad():
    """Two buckets (H = 3 and 17), both directions."""
    _plain_backward_against_jax_vjp(RecurrenceLayout((3, 17), (9, 6), 2, 2), seed=3)


@pytest.mark.parametrize("dirs", [2, 1], ids=["bidirectional", "unidirectional"])
@pytest.mark.parametrize("H", [132, 263])
def test_plain_backward_matches_jax_grad_past_h128(H, dirs):
    """The linear-262 bucket's hidden sizes (132 offline, 263 realtime),
    which the port once refused, on 8 frames."""
    _plain_backward_against_jax_vjp(RecurrenceLayout((H,), (8,), 2, dirs), seed=H + dirs)


def test_batch_norm1d_train_matches_jax():
    """Train-mode BatchNorm1d, the 4 targets side by side: the output and
    the running buffers updated in place against _batch_norm1d(train=True),
    target by target."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((4, 37, 6)) * 3 + 1).astype(np.float32)
    scale, bias = rng.uniform(0.5, 2, (4, 6)).astype(np.float32), rng.uniform(-1, 1, (4, 6)).astype(np.float32)
    mean, var = rng.uniform(-1, 1, (4, 6)).astype(np.float32), rng.uniform(0.5, 2, (4, 6)).astype(np.float32)
    rm, rv = torch.from_numpy(mean.copy()), torch.from_numpy(var.copy())
    y = batch_norm1d(torch.from_numpy(x), torch.from_numpy(scale)[:, None], torch.from_numpy(bias)[:, None],
                     rm[:, None], rv[:, None], train=True)
    for t in range(4):
        ry, rs = _batch_norm1d(jnp.asarray(x[t]), dict(scale=scale[t], bias=bias[t]), dict(mean=mean[t], var=var[t]),
                               train=True)
        assert float(np.abs(y[t].numpy() - np.asarray(ry)).max()) <= 1e-6 * float(np.abs(ry).max())
        np.testing.assert_allclose(rm[t].numpy(), np.asarray(rs["mean"]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(rv[t].numpy(), np.asarray(rs["var"]), rtol=0, atol=1e-6)


def _mel12_model(realtime=False, amp=False, seed=3, batch=BATCH):
    """A port LSTM model at mel-12 with seeded weights and BatchNorm,
    whitening and running statistics moved as training moves them."""
    shapes = SliCQT(device=DEVICE, **MEL12).block_shapes(batch, 2, LEN)
    model = Unmix(shapes, realtime=realtime, lstm=True, amp=amp, seed=seed, device=DEVICE)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(("input_mean", "bn1.bias", "bn2.bias", "running_mean")):
                t.add_(torch.rand(t.shape, generator=g) * 0.6 - 0.3)
            elif name.endswith(("input_scale", "bn1.weight", "bn2.weight", "running_var")):
                t.mul_(torch.rand(t.shape, generator=g) + 0.5)
    return shapes, model


def test_dropout_semantics(monkeypatch):
    """Inter-layer dropout: after layers 0 and 1 only, over the whole packed
    h in one draw (rate 0.4, kept values scaled by 1 / 0.6), independent
    across targets and buckets, none in eval mode or without a generator,
    and the same masks from the same seed and step."""
    h = torch.ones(200000)
    kept = lstm_module._dropout(h, torch.Generator().manual_seed(0))
    assert set(kept.unique().tolist()) == {0.0, float(torch.ones(()) / 0.6)}
    assert abs(float((kept > 0).double().mean()) - 0.6) < 0.005

    layout = RecurrenceLayout((2, 3), (50, 40), 4, 2)
    kept = lstm_module._dropout(torch.ones(layout.h_size), torch.Generator().manual_seed(1))
    blocks = layout.h_blocks(kept)
    for b in blocks:
        assert not torch.equal(b[0], b[1]) and not torch.equal(b[2], b[3])
    assert not torch.equal(blocks[0][0, :40, :, :4], blocks[1][0, :, :, :4])

    calls = []
    real = lstm_module._dropout
    monkeypatch.setattr(lstm_module, "_dropout", lambda h, gen: calls.append(h.shape) or real(h, gen))
    shapes, model = _mel12_model(batch=1)
    X = [torch.from_numpy(noise(i, s) + 1j * noise(i + 50, s)) for i, s in enumerate(shapes)]
    n_h = sum(4 * s[3] * s[4] * s[0] * blk.dirs * blk.lstm_hidden for s, blk in zip(shapes, model.blocks))

    def masks(seed=None, train=True):
        model.train(train)
        with torch.no_grad():                                  # the running statistics move in train mode:
            state = {k: v.clone() for k, v in model.state_dict().items()}
            gen = None if seed is None else torch.Generator().manual_seed(seed)
            out = torch.cat([m.reshape(-1) for m in model.apply(X, generator=gen)[1]])
            model.load_state_dict(state)                       # every call starts from the same ones
        return out

    plain = masks()
    assert not calls
    drop = masks(dropout_seed(42, 1, 0))
    assert calls == [(n_h,), (n_h,)]                           # after layers 0 and 1, never after the last
    assert not torch.equal(drop, plain)
    assert torch.equal(masks(dropout_seed(42, 1, 0)), drop)
    assert not torch.equal(masks(dropout_seed(42, 1, 1)), drop)
    calls.clear()
    assert torch.equal(masks(dropout_seed(42, 1, 0), train=False), masks(train=False))
    assert not calls


def _batch(seed=0):
    """(2, 5, 2, L): random stems and their mix, one stem silent in the
    first item (exact zeros in the targets and their coefficients)."""
    stems = noise(seed, (BATCH, 4, 2, LEN), 0.1)
    stems[0, 1] = 0.0
    return np.concatenate([stems.sum(1, keepdims=True), stems], axis=1)


def _to_jax(model, shapes, realtime, amp=False):
    """The port model's weights in the JAX package, through the reference's
    names (the same F > 10 rule at mel-12), as numpy arrays (the JAX train
    step donates its device arrays)."""
    ju = JaxUnmix(shapes, realtime=realtime, lstm=True, amp=amp)
    sd = {k: v.numpy() for k, v in to_reference_state_dict(model).items()}
    params, stats = import_lstm_state_dict(sd, len(shapes), [s.downsample for s in ju.specs])
    return ju, jax.tree.map(np.array, params), jax.tree.map(np.array, stats)


@pytest.mark.parametrize("realtime,sdr_mcoef", [(False, 0.1), (True, -1.0)], ids=["offline-sdsdr", "realtime"])
def test_lstm_train_step_matches_jax(realtime, sdr_mcoef):
    """One step with dropout off on both sides (no generator; rng=None):
    offline with every loss term (complex MSE, mask sum and SD-SDR, so
    gradients pass K2's and K1's backward, then K5b's) and realtime. Loss,
    every gradient, the running statistics and the AdamW update. Each
    gradient is held to a norm floor of 1e-2 of the largest gradient norm
    (see the module's docstring); the update of a tensor whose gradient
    lies under that floor, to at most lr, as in test_torch_training."""
    batch = _batch()
    shapes, model = _mel12_model(realtime)
    ju, params, stats = _to_jax(model, shapes, realtime)
    opt = optax.chain(keep_grads(), optax.adamw(LR, weight_decay=WD))
    jstep, _ = jax_make_train_step(JaxSliCQT(**MEL12), ju, opt, sdr_mcoef=sdr_mcoef)
    p1, s1, o1, jl = jstep(params, stats, opt.init(params), jnp.asarray(batch))
    grads = lstm_params_from_jax(jax.tree.map(np.array, o1[0]), stats)
    after = lstm_params_from_jax(jax.tree.map(np.array, p1), jax.tree.map(np.array, s1))

    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD)
    step, _ = make_train_step(SliCQT(device=DEVICE, **MEL12), model, optimizer, sdr_mcoef=sdr_mcoef)
    loss = float(step(torch.from_numpy(batch)))
    ours = {n: p.grad for n, p in model.named_parameters()}

    assert abs(loss - float(jl)) <= 1e-5 * abs(float(jl))
    norms = {n: float(torch.linalg.vector_norm(grads[n])) for n in ours}
    floor = 1e-2 * max(norms.values())
    for name, g in ours.items():
        assert g is not None and torch.isfinite(g).all(), name
        assert norm_rel(g, grads[name], floor) <= 1e-4, name
    for name, a in model.state_dict().items():
        if "running_" in name:
            assert float((a - after[name]).abs().max()) <= 1e-6 * max(1.0, float(after[name].abs().max())), name
        elif name in norms and norms[name] >= floor:
            # Adam's first step g / (|g| + eps) turns rounding noise in entries near its eps into update noise
            big = grads[name].abs() >= 100 * ADAM_EPS
            assert norm_rel((a - before[name])[big], (after[name] - before[name])[big]) <= 1e-3, name
        elif name in norms:             # Adam's first step follows the sign of rounding noise: at most lr
            assert float((a - before[name]).abs().max()) <= LR * (1.01 + WD * float(a.abs().max())), name


def test_lstm_bf16_loss_matches_jax_amp():
    """--bf16 with --lstm: the port's step with bf16 operands for the
    projections and Linear layers against the JAX package's amp=True loss
    (the train step's loss_fn, training.py:245-260, forward only, rng=None).
    Master weights stay float32."""
    batch = _batch()
    shapes, model = _mel12_model(amp=True)
    ju, params, stats = _to_jax(model, shapes, False, amp=True)
    j = JaxSliCQT(**MEL12)

    @jax.jit
    def jax_loss(params, stats, batch):
        B, _, C, L = batch.shape
        blocks5 = [c.reshape(B, 5, *c.shape[1:]) for c in j.forward(batch.reshape(B * 5, C, L))]
        Y_est, Y_masks, _ = ju.apply(params, stats, [c[:, 0] for c in blocks5], train=True)
        Y_tgt = [c[:, 1:].swapaxes(0, 1) for c in blocks5]
        return jloss.complex_mse_loss(Y_est, Y_tgt) + jloss.mask_sum_loss(Y_masks)

    ref = float(jax_loss(params, stats, jnp.asarray(batch)))
    optimizer = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD)
    step, _ = make_train_step(SliCQT(device=DEVICE, **MEL12), model, optimizer)
    loss = float(step(torch.from_numpy(batch)))
    assert abs(loss - ref) <= 1e-2 * abs(ref)
    assert all(p.dtype == torch.float32 for p in model.state_dict().values() if p.is_floating_point())


TRAIN_ARGS = ["--synthetic-dataset", "--lstm", "--fscale", "mel", "--fbins", "12", "--fmin", "200.0",
              "--seq-dur", "0.1", "--batch-size", "4", "--debug", "--max-batches-per-epoch", "1",
              "--quiet", "--device", "cpu", "--nb-workers", "0"]


def test_lstm_training_main_resumes_and_both_packages_load(tmp_path):
    """training_main --lstm for one epoch, a resume for a second, with the
    history and the reference-named weights; both packages' Separator.load
    read the directory (mel-12: F > 10 and the JAX loader's F * C > 10
    agree) and give the same stems."""
    first = training_main(TRAIN_ARGS + ["--model-path", str(tmp_path), "--epochs", "1"])
    again = training_main(TRAIN_ARGS + ["--model-path", str(tmp_path), "--epochs", "2"])
    (train1, valid1), (train2, valid2) = first, again
    assert len(train2) == 2 and train2[:1] == train1 and valid2[:1] == valid1
    assert np.isfinite(train2 + valid2).all()
    manifest = json.loads((tmp_path / "xumx_slicq_tpu.json").read_text())
    assert manifest["epochs_trained"] == 2 and manifest["args"]["lstm"] is True
    assert (tmp_path / "xumx_slicq_torch.chkpnt").exists() and (tmp_path / "xumx_slicq_tpu.pth").exists()
    x = noise(8, (1, 2, 6000), 0.1)
    ours = Separator.load(model_path=tmp_path, device=DEVICE, chunk_size=LEN)
    assert ours.model.lstm
    ref = JaxSeparator.load(model_path=tmp_path, runtime_backend="jax-cpu", chunk_size=LEN)
    a, b = ours(x), np.asarray(ref(x))
    assert a.shape == b.shape == (4, 1, 2, x.shape[-1])
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
