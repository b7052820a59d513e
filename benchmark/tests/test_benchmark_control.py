"""The control of each cell's `correct`, on the card: the reference in the
precision below the configured one (TF32 on) put in the program's place
fails the cell's limits, where the program passes them, by the comparison
a run makes (`harness.failures`, which decides the run's `failed` and
`correct`). At the cells' full widths and transform, on fewer tracks or a
smaller batch than a run's.

    python -m pytest -m cuda benchmark/tests/test_benchmark_control.py
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import harness  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control's precision (TF32) exists only there")
    harness.setup_env()
    return torch.device("cuda:0")


@pytest.mark.parametrize("cell", ["cdae_offline.demix_catalog", "lstm_offline.demix_catalog"])
def test_demix_control_fails_where_the_program_passes(card, cell):
    import control

    wl, config, traffic = harness.cell_files(cell)          # held back from BENCHMARK.json: PERF.md §7
    small = dict(traffic, tracks=2)                       # a 4-chunk and an 8-chunk batch
    out = {r["side"]: r for r in control.demix_readings(config, small, [5], [5], card)}
    print({side: r["stem_gap"] for side, r in out.items()}, wl["limits"])
    assert not harness.failures(out["program"], wl["limits"])
    assert harness.failures(out["control_tf32"], wl["limits"])


@pytest.mark.parametrize("cell", ["cdae_realtime.train_b64", "cdae_offline.train_b64"])
def test_train_control_fails_where_the_program_passes(card, cell):
    import control

    wl, config, traffic = harness.cell_files(cell)
    small = dict(traffic, batch=16)
    out = {r["side"]: r for r in control.train_readings(config, small, [5], [5], card)}
    print({side: {k: r[k] for k in wl["limits"]} for side, r in out.items()}, wl["limits"])
    assert not harness.failures(out["program"], wl["limits"])
    assert harness.failures(out["control_tf32"], wl["limits"])
    assert harness.failures(out["fault_half_batch"], wl["limits"])
