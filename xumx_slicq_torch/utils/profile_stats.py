"""Aggregate a torch.profiler Chrome trace: device self-time per kernel name
and per `record_function` stage, and host self-time per op, per run.

The port's counterpart of xumx_slicq_tpu/utils/hlo_stats.py (which groups an
xprof trace by source line). Capture a trace with `torch.profiler`
(`utils.runtime.profile_trace`, `bench_torch.py --profile`, the trainer's
`--profile-dir`), then:

    python -m xumx_slicq_torch.utils.profile_stats trace.json --runs 3

Device activity is every kernel, copy and fill on the card's timeline
(categories kernel, gpu_memcpy, gpu_memset); they do not nest, so each
event's duration is its self time. A device event belongs to the innermost
`record_function` range (category user_annotation) that was open on the
host thread when it was launched: its launch call (cuda_runtime or
cuda_driver) carries the same correlation id. Host ops (cpu_op) nest, so a
host op's self time is its duration less that of the events directly
inside it. Totals are divided by `runs`, the number of timed calls inside
the trace window.
"""

import argparse
import bisect
import collections
import json
import sys
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
OUTSIDE = "(no stage)"


def load_trace(path) -> list:
    """The complete ("X") events of a Chrome trace file."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _host_trees(events):
    """Per host thread, its cpu_op and user_annotation events sorted so that
    a parent comes before its children."""
    threads = collections.defaultdict(list)
    for e in events:
        if e.get("cat") in ("cpu_op", "user_annotation"):
            threads[(e.get("pid"), e.get("tid"))].append(e)
    for evs in threads.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
    return threads


def _self_times(evs):
    """Self time of each event of one thread (a list sorted parent first)."""
    stack, self_us = [], {}
    for e in evs:
        end = e["ts"] + e["dur"]
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < end - 1e-3:
            stack.pop()
        if stack:
            self_us[id(stack[-1])] -= e["dur"]
        self_us[id(e)] = e["dur"]
        stack.append(e)
    return self_us


def _stage_of_launches(events, threads):
    """correlation id -> the innermost user_annotation open at its launch."""
    spans = {}
    for key, evs in threads.items():
        ann = [e for e in evs if e.get("cat") == "user_annotation"]
        spans[key] = (ann, [a["ts"] for a in ann])
    out = {}
    for e in events:
        if e.get("cat") not in LAUNCH_CATEGORIES:
            continue
        corr = (e.get("args") or {}).get("correlation")
        ann, starts = spans.get((e.get("pid"), e.get("tid")), ((), []))
        stage = OUTSIDE
        # the innermost open range is the latest-starting one that still covers the launch
        for i in range(bisect.bisect_right(starts, e["ts"]) - 1, -1, -1):
            a = ann[i]
            if a["ts"] + a["dur"] >= e["ts"]:
                stage = a["name"]
                break
        if corr is not None:
            out[corr] = stage
    return out


def aggregate(events, runs: int = 1) -> dict:
    """Per-run totals of a trace's events (see the module note):
    device_ms, device_events, kernels {name: [count, ms]}, stages_device_ms
    {stage: ms}, host_ops {name: [count, self ms]}, stages_host_ms
    {stage: wall ms of its ranges}."""
    threads = _host_trees(events)
    stage_of = _stage_of_launches(events, threads)
    kernels = collections.defaultdict(lambda: [0, 0.0])
    stages = collections.defaultdict(float)
    device_us, n_device = 0.0, 0
    for e in events:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        k = kernels[e["name"]]
        k[0] += 1
        k[1] += e["dur"]
        device_us += e["dur"]
        n_device += 1
        stages[stage_of.get((e.get("args") or {}).get("correlation"), OUTSIDE)] += e["dur"]
    host_ops = collections.defaultdict(lambda: [0, 0.0])
    stages_host = collections.defaultdict(float)
    for evs in threads.values():
        self_us = _self_times(evs)
        for e in evs:
            if e.get("cat") == "cpu_op":
                h = host_ops[e["name"]]
                h[0] += 1
                h[1] += self_us[id(e)]
            else:
                stages_host[e["name"]] += e["dur"]
    per_run = 1e3 * runs
    return dict(
        runs=runs,
        device_ms=device_us / per_run,
        device_events=n_device / runs,
        kernels={k: [c / runs, us / per_run] for k, (c, us) in kernels.items()},
        stages_device_ms={k: us / per_run for k, us in stages.items()},
        host_ops={k: [c / runs, us / per_run] for k, (c, us) in host_ops.items()},
        stages_host_ms={k: us / per_run for k, us in stages_host.items()},
    )


def top(table: dict, n: int) -> list:
    """The n heaviest rows of a {name: [count, ms]} table as [name, count, ms]."""
    return [[k, c, ms] for k, (c, ms) in sorted(table.items(), key=lambda kv: -kv[1][1])[:n]]


def summarize(path, runs: int = 1) -> dict:
    return aggregate(load_trace(path), runs)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("trace", help="a Chrome trace written by torch.profiler (export_chrome_trace)")
    p.add_argument("--runs", type=int, default=1,
                   help="timed calls inside the trace window; totals are divided by this")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--json", action="store_true", help="print the whole aggregate as one JSON object")
    args = p.parse_args(argv)

    if not Path(args.trace).exists():
        raise FileNotFoundError(args.trace)
    agg = summarize(args.trace, args.runs)
    if args.json:
        print(json.dumps(agg))
        return 0
    print(f"device self time: {agg['device_ms']:.3f} ms/run over {agg['device_events']:.1f} device events/run")
    print(f"{'ms':>10}  stage (device)")
    for stage, ms in sorted(agg["stages_device_ms"].items(), key=lambda kv: -kv[1]):
        print(f"{ms:10.3f}  {stage}")
    print(f"{'ms':>10} {'count':>8}  kernel")
    for name, count, ms in top(agg["kernels"], args.top):
        print(f"{ms:10.3f} {count:8.1f}  {name[:100]}")
    print(f"{'ms':>10} {'count':>8}  host op (self)")
    for name, count, ms in top(agg["host_ops"], args.top):
        print(f"{ms:10.3f} {count:8.1f}  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
