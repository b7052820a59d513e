"""Run one cell of the benchmark of the PyTorch port (xumx_slicq_torch).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. It finds the cell's files by name (harness.py), builds the
system under test from the seed, warms every shape the cell uses, measures
for --seconds (--trace 0: the cell's end-to-end metrics) or profiles a
fixed unit of work (--trace 1: its per-layer metrics), then checks what the
timed path produced against the plain reference. The last line of stdout
is one JSON object: correct, attempted, failed, metrics, device and, with
--trace 1, breakdown; then `checks`, each compared number beside its
limit, which also close stderr.
"""

import time

START = time.time()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

import harness  # noqa: E402


class Context:
    """What a traffic generator gets: the cell's files, the run's arguments
    and device, and `window_start()` to call as its measurement begins."""

    def __init__(self, cell, wl, config, traffic, seed, seconds, trace, device, start):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.limits = wl["limits"]
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.start, self.setup_s = start, None
        self.marks = []

    def mark(self, what: str):
        """Note the seconds since the start at a step of set-up or check (printed on stderr)."""
        self.marks.append((what, time.time() - self.start))

    def window_start(self):
        self.mark("window")
        self.setup_s = time.time() - self.start


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device=None, start=None) -> dict:
    """One run of a cell; the result line's fields. device None: the first
    card, which must be there; tests pass "cpu" to drive the rest on the host."""
    import torch

    wl, config, traffic, entry = harness.cell_spec(cell)
    if device is None:
        harness.check_cards(entry["chips"])
        device = "cuda:0"
    device = torch.device(device)
    harness.set_precision(config["tf32"])
    kind = harness.load_module("traffic", f"{traffic['kind']}.py")
    ctx = Context(cell, wl, config, traffic, seed, seconds, trace, device, START if start is None else start)
    out = kind.run(ctx)
    dev = {**harness.card_info(device), "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": bool(out["correct"]), "attempted": out["attempted"], "failed": out["failed"]}
    if trace:
        s = out["summary"]
        result["metrics"] = harness.per_layer(cell, s)
        dev.update(busy_s=s["busy_s"], window_s=s["window_s"])
        result["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
    else:
        result["metrics"] = harness.end_to_end(cell, {**out["values"], "setup_s": ctx.setup_s})
    result["device"] = dev
    ctx.mark("end")
    return {"result": result, "checks": out["checks"], "marks": ctx.marks}


def main(argv=None) -> int:
    harness.setup_env()
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        print(f"refused: the run loaded {bad}", file=sys.stderr)
        return 3
    print("at (s): " + ", ".join(f"{w} {t:.1f}" for w, t in out["marks"]), file=sys.stderr)
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    harness.emit(out["result"], out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
