"""Training across ranks (parallel/mesh.py) on the CPU over gloo.

The JAX package's mesh tests (tests/test_training.py:275-385), on the
port: data parallelism (dp = 2) against one process, for the CDAE and for
the LSTM with dropout on; the hybrid dp x tp = 2 x 2 against dp = 2; the
checkpoint a 2 x 2 run writes, read back by one process; the tp rule
against the JAX package's; entry.dryrun_multichip(4); and that a failing
rank fails the run. Each rank runs
one intra-op thread (the ranks inherit the test's). Same seed, same data,
same global batch: only the order of float sums may differ, hence the JAX
tests' bounds: 2e-4 at the first step, 1e-3 over the trajectories
(training and eval-mode validation losses, the latter reading the synced
running statistics), 2e-4 for tp against dp.

AdamW's update does not change when a tensor's gradient is scaled, so the
losses cannot see a reduction that scales gradients (a gather backward
that sums over the tp ranks, a missing / dp, the whitening averaged over
the tp group). One step's gradients after the reduction are therefore
held, tensor by tensor, to the one-process gradients: within 1e-3 of
each tensor's norm, plus 1e-6 of the whole gradient's norm for tensors
whose gradient is rounding noise (the CDAE's whitening mean: the
BatchNorm after the first convolution cancels a shift of its input).
A gradient scaled by 2 or 1/2 breaks that bound by more than 100x on
every tensor whose norm exceeds 2e-6 of the whole's.
"""

import numpy as np
import pytest
import torch

from torch_port_utils import DEVICE, MEL12, TINY_LEN, grad_batch, step_gradients, train_then_gradients

from xumx_slicq_tpu.parallel import make_mesh as jax_make_mesh
from xumx_slicq_tpu.parallel import mesh as jax_mesh
from xumx_slicq_tpu.parallel import target_shardings
from xumx_slicq_torch.models import Unmix
from xumx_slicq_torch.models.convert import jax_trees
from xumx_slicq_torch.ops.slicqt import SliCQT
from xumx_slicq_torch.parallel import mesh
from xumx_slicq_torch.training import CHECKPOINT, MANIFEST, rank_devices, build_argparser, training_main


GRAD_RTOL, GRAD_FLOOR = 1e-3, 1e-6
# one step's gradients over 4 ranks: (tp, lstm) of each case
GRAD_CASES = {"dp4": (1, False), "dp2_tp2": (2, False), "lstm_dp2_tp2": (2, True)}


def _args(path, lstm=False, epochs=2, batches=1, extra=()):
    return (["--synthetic-dataset", "--device", "cpu", "--fscale", "mel", "--fbins", "12", "--fmin", "200.0",
             "--seq-dur", "0.3", "--batch-size", "4", "--epochs", str(epochs), "--debug",
             "--max-batches-per-epoch", str(batches), "--quiet", "--nb-workers", "1", "--model-path", str(path)]
            + (["--lstm"] if lstm else []) + list(extra))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One spawn of 4 ranks: the CDAE trained over dp x tp = 2 x 2, then one
    step's gradients (rank 0's, after the reduction, gathered into the
    one-process layout) of each GRAD_CASES mesh on `grad_batch()`."""
    root = tmp_path_factory.mktemp("four")
    argv = _args(root / "tp", extra=["--n-devices", "4", "--tp", "2"])
    cases = [(4, tp, lstm) for tp, lstm in GRAD_CASES.values()]
    losses, grads = mesh.spawn(train_then_gradients, ["cpu"] * 4, args=(argv, ["cpu"] * 4, cases))[0]
    return root, losses, dict(zip(GRAD_CASES, grads))


@pytest.fixture(scope="module")
def cdae_runs(four_ranks):
    """The CDAE trained 2 epochs of 1 step (batch 4) in one process, over
    dp = 2 and over dp x tp = 2 x 2."""
    root, tp_losses = four_ranks[:2]
    runs = {"tp": tp_losses}
    for name, extra in (("one", ["--n-devices", "1"]), ("dp2", ["--n-devices", "2"])):
        runs[name] = training_main(_args(root / name, extra=extra))
    return root, runs


def _close_trajectories(a, b, first=2e-4, rest=1e-3):
    (a_train, a_valid), (b_train, b_valid) = a, b
    assert np.isfinite(a_train).all() and np.isfinite(a_valid).all()
    np.testing.assert_allclose(a_train[0], b_train[0], rtol=first)
    np.testing.assert_allclose(a_train, b_train, rtol=rest)
    np.testing.assert_allclose(a_valid, b_valid, rtol=rest)


def test_dp_matches_one_process(cdae_runs):
    _, runs = cdae_runs
    _close_trajectories(runs["dp2"], runs["one"])


def test_hybrid_dp_tp_matches_dp(cdae_runs):
    _, runs = cdae_runs
    np.testing.assert_allclose(runs["tp"][0], runs["dp2"][0], rtol=2e-4)
    np.testing.assert_allclose(runs["tp"][1], runs["dp2"][1], rtol=2e-4)


def test_lstm_dp_matches_one_process(tmp_path):
    """With dropout on: every rank draws the global batch's masks."""
    one = training_main(_args(tmp_path / "one", lstm=True, extra=["--n-devices", "1"]))
    dp2 = training_main(_args(tmp_path / "dp2", lstm=True, extra=["--n-devices", "2"]))
    _close_trajectories(dp2, one)


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_step_gradients_match_one_process(four_ranks, case):
    """After reduce_gradients, each tensor's gradient is the one-process
    gradient: dp = 4, dp x tp = 2 x 2, and the LSTM (dropout on) on 2 x 2."""
    ref, got = step_gradients(None, GRAD_CASES[case][1], grad_batch()), four_ranks[2][case]
    assert got.keys() == ref.keys()
    whole = float(torch.sqrt(sum(g.norm() ** 2 for g in ref.values())))
    for name, g in ref.items():
        err, norm = float((got[name] - g).norm()), float(g.norm())
        assert err <= GRAD_RTOL * norm + GRAD_FLOOR * whole, (name, err, norm, whole)


def test_tp_checkpoint_loads_in_one_process_and_resumes(cdae_runs):
    """The 2 x 2 run's files have a one-process run's layout: its
    checkpoint loads into a one-process Unmix (the same keys and shapes)
    and the run resumes there for a third epoch."""
    root, runs = cdae_runs
    state = torch.load(root / "tp" / CHECKPOINT, weights_only=True)
    shapes = SliCQT(device=DEVICE, **MEL12).block_shapes(4, 2, TINY_LEN)
    model = Unmix(shapes, device=DEVICE)
    ref = model.state_dict()
    assert {k: tuple(v.shape) for k, v in state["model"].items()} == {k: tuple(v.shape) for k, v in ref.items()}
    model.load_state_dict(state["model"])
    opt = torch.optim.AdamW(model.parameters())
    opt.load_state_dict(state["optimizer"])
    for p in model.parameters():
        assert opt.state[p]["exp_avg"].shape == p.shape
    assert (root / "tp" / "xumx_slicq_tpu.pth").exists() and (root / "tp" / MANIFEST).exists()
    train, valid = training_main(_args(root / "tp", epochs=3, extra=["--n-devices", "1"]))
    assert train[:2] == runs["tp"][0] and len(train) == 3 and np.isfinite(train[2]) and np.isfinite(valid[2])


def test_tp_rule_against_jax():
    """The port's tp rule splits what the JAX package's target_shardings
    shards, leaf for leaf, on both models' trees (tests/test_training.py:
    360-385's cases included), and its name set is the JAX package's."""
    from jax.sharding import PartitionSpec as P

    assert mesh._TARGET_STACKED_NAMES == jax_mesh._TARGET_STACKED_NAMES
    jmesh = jax_make_mesh(8, tp=2)
    shapes = SliCQT(device=DEVICE, **MEL12).block_shapes(1, 2, TINY_LEN)
    for lstm in (False, True):
        model = Unmix(shapes, lstm=lstm, device=DEVICE)
        params, stats = jax_trees(model)
        sh = target_shardings({"params": params, "batch_stats": stats}, jmesh)
        blk = sh["params"]["blocks"][0]
        for name, t in model.state_dict().items():
            if not name.startswith("blocks.0.") or name.endswith("num_batches_tracked"):
                continue
            key = name[len("blocks.0."):]
            if "." in key:                                   # BatchNorm: params or batch_stats
                bn, leaf = key.split(".")
                jleaf = mesh.jax_leaf_name(key)
                spec = (blk if leaf in ("weight", "bias") else sh["batch_stats"]["blocks"][0])[bn][jleaf].spec
            elif lstm and "_l" in key:                       # (target, direction) stacked layer weights
                spec = blk["lstm"][int(key[-1])][mesh.jax_leaf_name(key)].spec
            else:
                spec = blk[key].spec
            assert mesh.is_target_stacked(name, t.shape) == (spec == P("tp")), name
    for name, shape, stacked in (("blocks.0.enc1_w", (200, 2, 1, 8), True), ("blocks.0.dec2_b", (8,), True),
                                 ("blocks.0.bn1.weight", (200,), True), ("blocks.0.input_mean", (4,), False),
                                 ("count", (), False), ("blocks.0.future_buf", (4, 8), False)):
        assert mesh.is_target_stacked(name, shape) is stacked, name
    assert [list(mesh.local_targets(r, 2)) for r in range(2)] == [[0, 1], [2, 3]]


def test_mesh_sizes_follow_the_jax_trainer():
    """--n-devices -1 shrinks as the JAX trainer's (training.py:475-484);
    explicit counts that do not divide raise."""
    def devices(*argv):
        return rank_devices(build_argparser().parse_args(["--device", "cpu", "--batch-size", "4", *argv]))

    assert devices() == ["cpu"]
    assert devices("--n-devices", "4", "--tp", "2") == ["cpu"] * 4
    with pytest.raises(ValueError, match="exceeds"):
        devices("--tp", "2")
    with pytest.raises(ValueError, match="divisible by --tp"):
        devices("--n-devices", "3", "--tp", "2")
    with pytest.raises(ValueError, match="batch size"):
        devices("--n-devices", "8")


def test_spawn_fails_when_a_rank_fails():
    """A rank that fails fails the run, with its traceback, while the others
    wait in a collective: no run returns with a dead rank."""
    from torch_port_utils import fail_on_rank

    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        mesh.spawn(fail_on_rank, ["cpu", "cpu"], args=(1,))


def test_dryrun_multichip():
    from xumx_slicq_torch.entry import dryrun_multichip

    assert np.isfinite(dryrun_multichip(4))
