"""The benchmark's shared machinery: files found by name, the environment,
the chip checks, profiling, the per-layer readers and the result line.

A cell is `workloads/<cell>.json` (its configuration, traffic and why); a
configuration `configs/<config>.json`; a traffic mix `traffic/<traffic>.json`,
whose `kind` names the generator `traffic/<kind>.py`; a per-layer metric
`metrics/<metric>.py`; a kernel's work count `work/<kernel>.py`. Which
metrics a cell reports comes from BENCHMARK.json at the checkout's root.
"""

import importlib.util
import json
import math
import os
import statistics
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "xumx_slicq_tpu", "cadenza")
PEAKS = json.loads((BENCH / "peaks.json").read_text())


def setup_env():
    """Caches of the program inside the checkout, at fixed paths; no JAX or flax from any library."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)


def set_precision(tf32: bool):
    """TF32 in cuBLAS's matmuls and in cuDNN on or off (PyTorch's default
    leaves cuDNN's on). A run sets the configured precision before the
    program and again before the reference, so that nothing the program
    sets moves the reference's arithmetic."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def load_json(*parts) -> dict:
    return json.loads(BENCH.joinpath(*parts).read_text())


def load_module(*parts):
    """A module of the benchmark by its file path (names may hold dots)."""
    path = BENCH.joinpath(*parts)
    if not path.exists():
        raise FileNotFoundError(path)
    name = "bench_" + "_".join(parts).replace(".", "_").replace("/", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def applies(metric: dict, cell: str) -> bool:
    """Whether an entry of BENCHMARK.json's end_to_end or per_layer lists is
    the cell's: one in its `workloads`; an end-to-end metric without that
    list (setup_s) is every cell's. Every per-layer entry has the list."""
    if "moves" in metric or "workloads" in metric:
        return cell in metric["workloads"]
    return True


def failures(readings: dict, limits: dict) -> list:
    """The names of the readings that fail their limits: above the limit,
    missing, or not a number. A run is correct only where this is empty."""
    return [k for k, limit in limits.items()
            if not (isinstance(readings.get(k), (int, float)) and readings[k] <= limit)]


def cell_files(name: str):
    """(workload, config, traffic): a cell's files, found by name, whether
    or not BENCHMARK.json lists the cell."""
    wl = load_json("workloads", f"{name}.json")
    return wl, load_json("configs", f"{wl['config']}.json"), load_json("traffic", f"{wl['traffic']}.json")


def cell_spec(name: str):
    """(workload, config, traffic, the cell's BENCHMARK.json entry), checked
    against each other; a run is only of a cell BENCHMARK.json lists."""
    bench = manifest()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    wl, config, traffic = cell_files(name)
    for key in ("config", "traffic", "chips", "why"):
        if wl[key] != entry[key]:
            raise SystemExit(f"workloads/{name}.json and BENCHMARK.json disagree on {key!r}")
    return wl, config, traffic, entry


def check_cards(chips: int):
    """Refuse to run without the cards the cell asks for."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: torch.cuda.is_available() is False (the benchmark never runs on the CPU)")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell asks for {chips} cards, {torch.cuda.device_count()} present")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}


def power_limit() -> str:
    """The card's name and power limit from nvidia-smi, or why not."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read: {e}"


def p95(values) -> float:
    return statistics.quantiles(values, n=100, method="inclusive")[94] if len(values) > 1 else values[0]


class Profile:
    """torch.profiler over one fixed unit of work, its Chrome trace under
    TMPDIR, reduced (`traces.summarize`) and deleted."""

    def __init__(self, device, record_shapes: bool):
        self.device, self.record_shapes = device, record_shapes

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self.prof = profile(activities=acts, record_shapes=self.record_shapes)
        self.prof.__enter__()
        self.span = record_function("bench.window")
        self.span.__enter__()
        self._sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        return self

    def __exit__(self, *exc):
        import tempfile

        from traces import load, summarize

        self._sync()
        self.span.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            del self.prof
            self.summary = summarize(load(path))
        finally:
            os.unlink(path)
        return False


def roofline(summary: dict, kernel: str):
    """A kernel's share of its roofline in % over the traced window: the sum
    over its op's calls of the least time the card could take (operations
    over the TF32 peak or bytes over the memory rate, whichever is larger)
    over the sum of their device time; None where it did not run."""
    work = load_module("work", f"{kernel}.py")
    calls = [c for c in summary.get("ops", {}).get(work.OP, []) if c["device_s"] > 0]
    if not calls:
        return None
    least = 0.0
    for c in calls:
        ops, nbytes = work.work(c["dims"], c["concrete"], summary["geometry"])
        least += max(ops / PEAKS["tf32_flops"], nbytes / PEAKS["hbm_bytes_per_s"])
    return 100.0 * least / sum(c["device_s"] for c in calls)


def per_layer(cell: str, summary: dict) -> dict:
    """The cell's per-layer metrics that find something to read."""
    bench = manifest()
    out = {}
    for m in bench["per_layer"]:
        if not applies(m, cell):
            continue
        mod = load_module("metrics", f"{m['name']}.py")
        value = mod.read(summary)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def end_to_end(cell: str, values: dict) -> dict:
    bench = manifest()
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in bench["end_to_end"] if applies(m, cell) and m["name"] in values}


def emit(result: dict, checks: dict):
    """The compared numbers as the last lines on stderr, then the result line
    on stdout with them under `checks`, last."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks}), flush=True)
