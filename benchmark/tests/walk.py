"""A copy of the benchmark in a temporary checkout, with tiny cells added as
a later change would add them (files only), and a run of one of its cells
on the CPU in a fresh process.

The tiny cells mirror the real ones: `tiny_cdae.demix` and
`tiny_lstm.demix` are listed wherever `cdae_offline.demix_catalog` and
`lstm_offline.demix_catalog` are, `tiny_cdae.train` wherever
`cdae_offline.train_b64` is, `tiny_cdae_rt.train` wherever
`cdae_realtime.train_b64` is. The offline cells, which BENCHMARK.json holds
back until the program's fault that they show is mended, are first put
back into the copy's manifest from `data/held_cells.json`, as the change
that brings them back will do.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
DATA = Path(__file__).resolve().parent / "data"
TINY = {
    "tiny_cdae.demix": ("tiny_cdae", "tiny_demix", "cdae_offline.demix_catalog"),
    "tiny_lstm.demix": ("tiny_lstm", "tiny_demix", "lstm_offline.demix_catalog"),
    "tiny_cdae.train": ("tiny_cdae", "tiny_train", "cdae_offline.train_b64"),
    "tiny_cdae_rt.train": ("tiny_cdae_rt", "tiny_train", "cdae_realtime.train_b64"),
}
LIMITS = {"tiny_demix": {"stem_gap": 1e-4}, "tiny_train": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2}}


def checkout(tmp: Path) -> Path:
    """A checkout at tmp: BENCHMARK.json and benchmark/ copied, the program linked."""
    root = tmp / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    os.symlink(ROOT / "xumx_slicq_torch", root / "xumx_slicq_torch")
    return root


def with_held_cells(bench: dict) -> dict:
    """The manifest with the held-back cells, configurations and metrics put
    back, and the held cells added to the lists of the metrics they share."""
    held = json.loads((DATA / "held_cells.json").read_text())
    out = json.loads(json.dumps(bench))
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        out[key] += held[key]
    for m in out["end_to_end"] + out["per_layer"]:
        if "workloads" in m:
            m["workloads"] += held["also_reported_by"].get(m["name"], [])
    return out


def add_tiny_cells(root: Path):
    """The held-back cells and the tiny cells in the manifest, and the tiny cells' files."""
    bench = with_held_cells(json.loads((root / "BENCHMARK.json").read_text()))
    for cell, (config, traffic, twin) in TINY.items():
        shutil.copy(DATA / f"{config}.json", root / "benchmark" / "configs" / f"{config}.json")
        shutil.copy(DATA / f"{traffic}.json", root / "benchmark" / "traffic" / f"{traffic}.json")
        why = f"a CPU test size of {twin}"
        wl = {"config": config, "traffic": traffic, "chips": 1, "why": why, "limits": LIMITS[traffic]}
        (root / "benchmark" / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
        bench["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1, "why": why})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if twin in m.get("workloads", ()):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def run(root: Path, cell: str, seed: int = 7, seconds: float = 0.3, trace: int = 0, fault: str = "",
        timeout: float = 600):
    """One run of `cell` on the CPU in a fresh process, after the Python
    statements `fault` (which may break the timed path); returns (the
    result line as a dict, stderr, the modules the process held)."""
    code = f"""
import json, sys, time
start = time.time()
sys.path.insert(0, {str(root / 'benchmark')!r})
import harness, torch
harness.setup_env()
torch.set_num_threads(2)
{fault}
import run
out = run.run_cell({cell!r}, {seed}, {seconds}, {bool(trace)}, device="cpu", start=start)
harness.emit(out["result"], out["checks"])
print(json.dumps(sorted(sys.modules)))
"""
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    p = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=timeout,
                       env=env)
    if p.returncode != 0:
        raise RuntimeError(f"run failed ({p.returncode}):\n{p.stderr[-4000:]}")
    lines = p.stdout.strip().splitlines()
    return json.loads(lines[-2]), p.stderr, json.loads(lines[-1])
