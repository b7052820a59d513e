"""The harness's whole loop on the CPU, on tiny cells dropped into a
temporary copy of the benchmark as a later change would add them: the
last line's keys, `correct` true on the sound program and false with the
timed path broken underneath, and no JAX module in the process."""

import ast
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import walk  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "xumx_slicq_tpu", "cadenza"}
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}

ALTER_STEMS = """
import xumx_slicq_torch.separator as S
_orig = S.Separator._chunk_fn
def _altered(self, audio):
    est = _orig(self, audio)
    est[0, 0] *= 1.001          # one target's stems of one chunk, altered where they are produced
    return est
S.Separator._chunk_fn = _altered
"""
NAN_STEMS = """
import xumx_slicq_torch.separator as S
_orig = S.Separator._chunk_fn
def _altered(self, audio):
    est = _orig(self, audio)
    est[:, 0, :, :9] = float("nan")   # every target of one chunk not a number, as a faulty Wiener-EM row gives
    return est
S.Separator._chunk_fn = _altered
"""
WRAP_STEP = """
import xumx_slicq_torch.training as T
_orig = T.make_train_step
def _wrapped(*a, **k):
    step, valid = _orig(*a, **k)
    return (lambda batch, generator=None: {call}), valid
T.make_train_step = _wrapped
"""
NAN_FROM_STEP_2 = """
import xumx_slicq_torch.training as T
_orig = T.make_train_step
def _wrapped(slicqt, model, opt, *a, **k):
    step, valid = _orig(slicqt, model, opt, *a, **k)
    calls = []
    def _step(batch, generator=None):
        loss = step(batch, generator)
        calls.append(1)
        if len(calls) == 2:
            {what}
        return loss
    return _step, valid
T.make_train_step = _wrapped
"""
FAULTS = {
    "state_unchanged": "import torch\ntorch.optim.AdamW.step = lambda self, closure=None: None\n",
    "half_batch": WRAP_STEP.format(call="step(batch[: batch.shape[0] // 2], generator)"),
    "loss_altered": WRAP_STEP.format(call="step(batch, generator) * 1.001"),
    # a row of not-a-number estimates at step 2, as a faulty Wiener-EM gives: seen in the loss, or in a leaf
    "loss_not_a_number": NAN_FROM_STEP_2.format(what="loss = loss * float('nan')"),
    "leaf_not_a_number": NAN_FROM_STEP_2.format(
        what="[p for n, p in model.named_parameters() if n.endswith('enc1_w')][-1].data.view(-1)[0] = float('nan')"),
}

# The program turns TF32 on as it runs; the reference notes the precision it runs in.
PROGRAM_SETS_TF32 = """
import sys, torch
import xumx_slicq_torch.separator as S, xumx_slicq_torch.training as T
import reference.demix as RD, reference.train as RT
def _tf32_on(f):
    def g(*a, **k):
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        return f(*a, **k)
    return g
def _noted(f):
    def g(*a, **k):
        print("reference tf32:", torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
              file=sys.stderr)
        return f(*a, **k)
    return g
S.Separator.forward = _tf32_on(S.Separator.forward)
T.make_train_step = _tf32_on(T.make_train_step)
RD.Demixer.demix = _noted(RD.Demixer.demix)
RT.Trainer.step = _noted(RT.Trainer.step)
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = walk.checkout(tmp_path_factory.mktemp("bench"))
    walk.add_tiny_cells(r)
    return r


@pytest.mark.parametrize("cell,seconds", [("tiny_cdae.demix", 0.3), ("tiny_lstm.demix", 3.0),
                                          ("tiny_cdae.train", 0.3), ("tiny_cdae_rt.train", 0.3)])
def test_a_new_cell_runs_and_its_last_line_has_the_keys(root, cell, seconds):
    res, err, modules = walk.run(root, cell, seconds=seconds)
    assert set(res) == RESULT_KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    assert err.strip().splitlines()[-1].startswith("check ")
    assert not {m.split(".")[0] for m in modules} & FORBIDDEN


def test_a_traced_run_reports_busy_and_window(root):
    res, _, _ = walk.run(root, "tiny_cdae.demix", trace=1)
    assert res["correct"] is True
    assert {"busy_s", "window_s"} <= set(res["device"]) and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", [ALTER_STEMS, NAN_STEMS], ids=["scaled", "not_a_number"])
def test_altered_stems_are_not_correct(root, fault):
    res, _, _ = walk.run(root, "tiny_cdae.demix", fault=fault)
    assert res["correct"] is False and res["checks"]["stem_gap"]["value"] > res["checks"]["stem_gap"]["limit"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_train_step_is_not_correct(root, fault):
    res, _, _ = walk.run(root, "tiny_cdae_rt.train", fault=FAULTS[fault])
    assert res["correct"] is False


@pytest.mark.parametrize("cell", ["tiny_cdae.demix", "tiny_cdae.train"])
def test_the_reference_runs_in_the_configured_precision_whatever_the_program_sets(root, cell):
    _, err, _ = walk.run(root, cell, fault=PROGRAM_SETS_TF32)
    noted = [line for line in err.splitlines() if line.startswith("reference tf32:")]
    assert noted and set(noted) == {"reference tf32: False False"}


@pytest.mark.parametrize("reading,fails", [(2e-6, False), (3e-6, False), (3.1e-6, True), (float("nan"), True),
                                           (float("inf"), True), (None, True)])
def test_a_reading_fails_above_its_limit_or_when_it_is_not_a_number(reading, fails):
    import harness

    readings = {} if reading is None else {"stem_gap": reading}
    assert harness.failures(readings, {"stem_gap": 3e-6}) == (["stem_gap"] if fails else [])


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_reference_imports_nothing_of_the_program_or_jax():
    for path in (walk.BENCH / "reference").glob("*.py"):
        assert not set(_imports(path)) & (FORBIDDEN | {"xumx_slicq_torch"}), path


def test_the_benchmark_imports_no_jax():
    for path in walk.BENCH.rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path


def _cli(root, cell):
    import subprocess

    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "3", "--seconds", "1",
                           "--trace", "0"], cwd=root, capture_output=True, text=True, timeout=300)


def test_without_a_card_it_refuses_and_prints_no_result(root):
    p = _cli(root, "tiny_cdae.demix")
    assert p.returncode != 0 and p.stdout.strip() == "" and "no CUDA card" in p.stderr


def test_with_only_the_benchmark_files_it_refuses(tmp_path):
    import shutil

    root = walk.checkout(tmp_path)
    (root / "xumx_slicq_torch").unlink()                 # BENCHMARK.json and benchmark/ alone
    shutil.rmtree(root / "benchmark" / "__pycache__", ignore_errors=True)
    p = _cli(root, "cdae_realtime.train_b64")
    assert p.returncode != 0 and p.stdout.strip() == ""
