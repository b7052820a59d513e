"""The port's trainer against the JAX package's, on the CPU at mel-12.

One train step: the same numpy batch (batch 2 of 0.3 s, the setup of
tests/test_grad_hardening.py) and the same weights (the JAX package's
seeded init, made once for the module's step tests, BatchNorm affines
perturbed, moved with params_from_jax) go through JAX `make_train_step` and
the port's. The JAX optimizer is a chain
whose first link keeps the gradients in its state, then AdamW, so one
call gives both. Tolerances, with their reasons:
* loss: relative 1e-5 (fp32 sums in another order);
* gradients: ||g_port - g_jax|| / ||g_jax|| <= 1e-4 per parameter tensor
  (fp32 sums in another order, through the 2x2 inverse), with a norm floor
  for gradients that are zero up to rounding (see the test);
* BatchNorm running statistics: within 1e-6 relative to max(1, |value|);
* parameters after one AdamW step: ||dp_port - dp_jax|| / ||dp_jax|| <= 1e-3
  (Adam's first step g / (|g| + eps) magnifies the error of tiny entries);
* bf16 convs: loss relative 1e-2 against the JAX package's amp=True.
Also: the datasets and loader bit-equal to xumx_slicq_tpu.data,
get_statistics, EarlyStopping, a training_main smoke run with resume, and
a port-trained model directory loaded by both packages' Separator.load.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from scipy.io import wavfile

import torch_goldens as goldens
from torch_port_utils import DEVICE, MEL12, TINY_LEN, keep_grads, noise, norm_rel

from xumx_slicq_tpu import data as jdata
from xumx_slicq_tpu import loss as jloss
from xumx_slicq_tpu.models import Unmix as JaxUnmix
from xumx_slicq_tpu.ops.slicqt import SliCQT as JaxSliCQT
from xumx_slicq_tpu.separator import Separator as JaxSeparator
from xumx_slicq_tpu.training import get_statistics as jax_get_statistics
from xumx_slicq_tpu.training import make_train_step as jax_make_train_step
from xumx_slicq_torch import data as tdata
from xumx_slicq_torch.models import Unmix
from xumx_slicq_torch.models.convert import params_from_jax
from xumx_slicq_torch.ops.slicqt import SliCQT
from xumx_slicq_torch.separator import Separator
from xumx_slicq_torch.training import EarlyStopping, get_statistics, make_train_step, training_main

LR, WD = 1e-3, 1e-5
BATCH = 2


def _batch(seed=0):
    """(2, 5, 2, L): random stems and their mix, one stem silent in the
    first item (exact zeros in the targets and their coefficients)."""
    stems = noise(seed, (BATCH, 4, 2, TINY_LEN), 0.1)
    stems[0, 1] = 0.0
    return np.concatenate([stems.sum(1, keepdims=True), stems], axis=1)


@pytest.fixture(scope="module")
def weights():
    """One set of weights for every step test, made once (the JAX init
    program takes ~12 s to compile)."""
    return _jax_weights()


def _jax_weights():
    """The JAX package's seeded init, which is the same offline, realtime
    and with bf16 convs (init_cdae_params reads neither flag), with
    BatchNorm and whitening moved as training moves them."""
    shapes = JaxSliCQT(**MEL12).block_shapes(BATCH, 2, TINY_LEN)
    params, stats = JaxUnmix(shapes).init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)

    def jitter(path, a):
        a = np.array(a)
        name = jax.tree_util.keystr(path)
        if "bn" in name and "scale" in name:
            return a * rng.uniform(0.8, 1.25, a.shape).astype(np.float32)
        if "bn" in name and "bias" in name:
            return a + rng.uniform(-0.1, 0.1, a.shape).astype(np.float32)
        if "input_mean" in name:       # whitening as trained: per-bin shifts and scales
            return a + rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)
        if "input_scale" in name:
            return a * rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        return a

    return shapes, jax.tree_util.tree_map_with_path(jitter, params), jax.tree.map(np.array, stats)


def _port_step(shapes, weights, batch, realtime=False, sdr_mcoef=-1.0, amp=False):
    model = Unmix(shapes, realtime=realtime, amp=amp, device=DEVICE)
    model.load_state_dict(weights)
    optimizer = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD)
    step, _ = make_train_step(SliCQT(device=DEVICE, **MEL12), model, optimizer, sdr_mcoef=sdr_mcoef)
    loss = float(step(torch.from_numpy(batch)))
    return dict(loss=loss, grads={n: p.grad for n, p in model.named_parameters()}, after=model.state_dict())


@pytest.mark.parametrize("realtime,sdr_mcoef", [(False, 0.1), (True, -1.0)], ids=["offline-sdsdr", "realtime"])
def test_train_step_matches_jax(weights, realtime, sdr_mcoef):
    """One step, offline with every loss term (complex MSE, mask sum and
    SD-SDR, so gradients pass K2's and K1's backward) and realtime. The
    whitening of a one-bin bucket has a gradient that train-mode BatchNorm
    cancels analytically; such tensors are held against a norm floor of
    1e-3 of the largest gradient norm instead of their own rounding noise."""
    batch = _batch()
    j = JaxSliCQT(**MEL12)
    shapes, params, stats = weights
    ju = JaxUnmix(shapes, realtime=realtime)
    opt = optax.chain(keep_grads(), optax.adamw(LR, weight_decay=WD))
    jstep, _ = jax_make_train_step(j, ju, opt, sdr_mcoef=sdr_mcoef)
    before = params_from_jax(params, stats)
    p1, s1, o1, jloss = jstep(params, stats, opt.init(params), jnp.asarray(batch))
    grads = params_from_jax(jax.tree.map(np.array, o1[0]), stats)
    after = params_from_jax(jax.tree.map(np.array, p1), jax.tree.map(np.array, s1))
    out = _port_step(shapes, before, batch, realtime, sdr_mcoef)

    assert abs(out["loss"] - float(jloss)) <= 1e-5 * abs(float(jloss))
    norms = {n: float(torch.linalg.vector_norm(grads[n])) for n in out["grads"]}
    floor = 1e-3 * max(norms.values())
    for name, g in out["grads"].items():
        assert g is not None and torch.isfinite(g).all(), name
        assert norm_rel(g, grads[name], floor) <= 1e-4, name
    for name, a in out["after"].items():
        if "running_" in name:
            assert float((a - after[name]).abs().max()) <= 1e-6 * max(1.0, float(after[name].abs().max())), name
        elif name in norms and norms[name] >= floor:
            assert norm_rel(a - before[name], after[name] - before[name]) <= 1e-3, name
        elif name in norms:             # Adam's first step follows the sign of rounding noise: at most lr
            assert float((a - before[name]).abs().max()) <= LR * (1.01 + WD * float(a.abs().max())), name


def _bf16_fingerprint(weights, batch) -> str:
    _, params, stats = weights
    return goldens.fingerprint(*jax.tree.leaves(params), *jax.tree.leaves(stats), batch)


def _jax_bf16_loss(weights, batch) -> float:
    """The JAX package's amp=True loss (the train step's loss_fn,
    training.py:245-260, evaluated forward only)."""
    j = JaxSliCQT(**MEL12)
    shapes, params, stats = weights
    ju = JaxUnmix(shapes, amp=True)

    @jax.jit
    def jax_loss(params, stats, batch):
        B, _, C, L = batch.shape
        blocks5 = [c.reshape(B, 5, *c.shape[1:]) for c in j.forward(batch.reshape(B * 5, C, L))]
        Y_est, Y_masks, _ = ju.apply(params, stats, [c[:, 0] for c in blocks5], train=True)
        Y_tgt = [c[:, 1:].swapaxes(0, 1) for c in blocks5]
        return jloss.complex_mse_loss(Y_est, Y_tgt) + jloss.mask_sum_loss(Y_masks)

    return float(jax_loss(params, stats, jnp.asarray(batch)))


def _port_bf16_loss(weights, batch) -> float:
    shapes, params, stats = weights
    out = _port_step(shapes, params_from_jax(params, stats), batch, amp=True)
    assert all(p.dtype == torch.float32 for p in out["after"].values() if p.is_floating_point())
    return out["loss"]


def test_bf16_train_step_matches_jax_amp(weights):
    """--bf16: the port's step with bf16 conv operands against the JAX
    package's amp=True loss, the golden tests/goldens/cdae_bf16_loss.npz
    (test_bf16_loss_golden_matches_live_jax recomputes it). Master weights
    stay float32."""
    batch = _batch()
    ref = float(goldens.load("cdae_bf16_loss", _bf16_fingerprint(weights, batch))["loss"])
    assert abs(_port_bf16_loss(weights, batch) - ref) <= 1e-2 * abs(ref)


@pytest.mark.slow
def test_bf16_loss_golden_matches_live_jax(weights):
    batch = _batch()
    live = _jax_bf16_loss(weights, batch)
    ref = float(goldens.load("cdae_bf16_loss", _bf16_fingerprint(weights, batch))["loss"])
    assert abs(ref - live) <= 1e-2 * abs(live)
    assert abs(_port_bf16_loss(weights, batch) - live) <= 1e-2 * abs(live)


def _golden_bf16():
    weights, batch = _jax_weights(), _batch()
    return _bf16_fingerprint(weights, batch), dict(loss=np.asarray(_jax_bf16_loss(weights, batch)))


GOLDENS = {"cdae_bf16_loss": _golden_bf16}


def test_early_stopping():
    es = EarlyStopping(patience=2)
    assert not es.step(1.0) and not es.step(0.9) and not es.step(1.1)
    assert es.step(1.2)
    first = EarlyStopping(patience=3)
    assert first.step(float("nan")) and first.best is None


def _wav_tree(root, names, n=9000):
    rng = np.random.default_rng(5)
    for name in names:
        d = root / "train" / name
        d.mkdir(parents=True)
        for stem in ["mixture"] + tdata.SOURCES:
            wavfile.write(str(d / f"{stem}.wav"), 44100, (rng.standard_normal((n, 2)) * 3000).astype(np.int16))


def _batches(loader, n=2):
    out = []
    for b in loader:
        out.append(b)
        if len(out) == n:
            break
    return out


@pytest.mark.parametrize("workers", [0, 2])
def test_datasets_and_loader_match_jax(tmp_path, workers):
    """The same trees and seeds give bit-equal items and batches: MUSDB
    training (random crops, track mixing, folded gain/channelswap), its
    validation split, and the synthetic dataset."""
    _wav_tree(tmp_path, ["a", "b", "Leaf - Summerghost"])
    pairs = [(tdata.MUSDBDataset.load_datasets(3, 0.1, 2, str(tmp_path)),
              jdata.MUSDBDataset.load_datasets(3, 0.1, 2, str(tmp_path))),
             ((tdata.SyntheticDataset(n_tracks=2, seq_duration=0.1, seed=4),),
              (jdata.SyntheticDataset(n_tracks=2, seq_duration=0.1, seed=4),))]
    for ours, ref in pairs:
        for a, b in zip(ours, ref):
            assert len(a) == len(b)
            la = tdata.DataLoader(a, 2, shuffle=True, seed=9, drop_last=True, workers=workers)
            lb = jdata.DataLoader(b, 2, shuffle=True, seed=9, drop_last=True, workers=workers)
            for _ in range(2):                               # two epochs
                for x, y in zip(_batches(la), _batches(lb)):
                    np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(a.getitem_seeded(len(a) - 1, 77), b.getitem_seeded(len(b) - 1, 77))
    valid = pairs[0][0][1]
    assert [t["name"] for t in valid.tracks] == ["Leaf - Summerghost"]
    np.testing.assert_array_equal(tdata.pad_collate([np.ones((5, 2, 3)), np.ones((5, 2, 5))]),
                                  jdata.pad_collate([np.ones((5, 2, 3)), np.ones((5, 2, 5))]))


def test_get_statistics_matches_jax():
    ds = tdata.SyntheticDataset(n_tracks=2, seq_duration=0.3, seed=2, track_duration=1.5)
    jds = jdata.SyntheticDataset(n_tracks=2, seq_duration=0.3, seed=2, track_duration=1.5)
    means, stds = get_statistics(SliCQT(device=DEVICE, **MEL12), ds, window_s=1.0)
    jmeans, jstds = jax_get_statistics(JaxSliCQT(**MEL12), jds, window_s=1.0)
    assert len(means) == len(jmeans)
    for a, b in zip(means + stds, jmeans + jstds):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


TRAIN_ARGS = ["--synthetic-dataset", "--fscale", "mel", "--fbins", "12", "--fmin", "200.0",
              "--seq-dur", "0.3", "--batch-size", "4", "--debug", "--max-batches-per-epoch", "2",
              "--quiet", "--device", "cpu", "--nb-workers", "0"]


@pytest.fixture(scope="module")
def trained_dir(tmp_path_factory):
    """Two epochs of training_main on the CPU, then a resume for a third."""
    d = tmp_path_factory.mktemp("trained")
    first = training_main(TRAIN_ARGS + ["--model-path", str(d), "--epochs", "2"])
    again = training_main(TRAIN_ARGS + ["--model-path", str(d), "--epochs", "3"])
    return d, first, again


def test_training_main_smoke_and_resume(trained_dir):
    d, (train1, valid1), (train2, valid2) = trained_dir
    assert len(train1) == 2 and len(train2) == 3 and np.isfinite(train2 + valid2).all()
    assert train2[:2] == train1 and valid2[:2] == valid1
    assert train2[2] < train2[1] < train2[0]
    manifest = json.loads((d / "xumx_slicq_tpu.json").read_text())
    assert manifest["epochs_trained"] == 3 and manifest["args"]["device"] == "cpu"
    assert set(manifest["scheduler"]) == {"lr", "best", "num_bad_epochs", "cooldown_counter", "threshold", "eps"}
    assert (d / "xumx_slicq_torch.chkpnt").exists() and (d / "xumx_slicq_tpu.pth").exists()


def test_trained_dir_loads_in_both_packages(trained_dir):
    d = trained_dir[0]
    x = noise(8, (1, 2, 20000), 0.1)
    ours = Separator.load(model_path=d, device=DEVICE, chunk_size=TINY_LEN)(x)
    ref = np.asarray(JaxSeparator.load(model_path=d, runtime_backend="jax-cpu", chunk_size=TINY_LEN)(x))
    assert ours.shape == ref.shape == (4, 1, 2, x.shape[-1])
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("flag", [["--n-devices", "3"], ["--tp", "2"]])
def test_unported_flags_raise(tmp_path, flag):
    """Multi-rank training is ported (tests/test_torch_parallel.py); a mesh
    the batch (4, not divisible by dp = 3) or the devices (one CPU for
    --tp 2 with --n-devices -1) cannot hold raises, as in the JAX trainer."""
    with pytest.raises(ValueError):
        training_main(TRAIN_ARGS + ["--model-path", str(tmp_path), "--epochs", "1"] + flag)
