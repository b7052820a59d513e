"""Reduce a torch.profiler Chrome trace to what the per-layer metrics read.

Device activity is every kernel, copy and fill on the card's timeline
(categories kernel, gpu_memcpy, gpu_memset). Each is attributed through its
launch (cuda_runtime or cuda_driver, same correlation id) to what was open
on the launching host thread: the innermost `record_function` range (the
program's stages) and the innermost registered kernel op
(`xumx_slicq::...`), whose recorded input shapes and values the work
counts read. Only the span named WINDOW counts: the device's busy time is
the union of device intervals inside it, and its idle gaps are named by
the host op that was running in them. Adapted from the measured package's
utils/profile_stats.py.
"""

import collections
import json

DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH = ("cuda_runtime", "cuda_driver")
HOST = ("cpu_op", "user_annotation")
OP_PREFIX = "xumx_slicq::"
WINDOW = "bench.window"
TOP = 10


def load(path) -> list:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _sweep(spans, times):
    """For sorted query times, the spans (sorted by start, parents first)
    open at each, outermost first: one pass with a stack."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i]["ts"] <= t:
            s = spans[i]
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < s["ts"]:
                stack.pop()
            stack.append(s)
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < t:
            stack.pop()
        out.append([s for s in stack if s["ts"] + s["dur"] >= t])
    return out


def summarize(events: list) -> dict:
    """{window_s, busy_s, device_events, memcpy_s, stage_s, ops, device_ops, idle_gaps}.

    ops: {op name: [{"dims", "concrete", "device_s"} per call that launched
    device work]}; device_ops and idle_gaps: the TOP heaviest [name, seconds]."""
    threads = collections.defaultdict(list)
    for e in events:
        if e.get("cat") in HOST:
            threads[(e.get("pid"), e.get("tid"))].append(e)
    for evs in threads.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
    windows = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    if not windows:
        raise ValueError(f"no {WINDOW} span in the trace")
    win = windows[0]
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    main = (win.get("pid"), win.get("tid"))

    launch = {}
    for e in events:
        if e.get("cat") in LAUNCH:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = e
    stage_us = collections.defaultdict(float)
    op_calls = {}
    device_us = collections.defaultdict(float)
    intervals, n_dev, memcpy_us = [], 0, 0.0
    by_thread = collections.defaultdict(list)
    for e in events:
        if e.get("cat") not in DEVICE:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        n_dev += 1
        intervals.append((a, b))
        device_us[e["name"]] += e["dur"]
        if e["cat"] == "gpu_memcpy":
            memcpy_us += e["dur"]
        le = launch.get((e.get("args") or {}).get("correlation"))
        if le is None:
            stage_us["(no launch)"] += e["dur"]
        else:
            by_thread[(le.get("pid"), le.get("tid"))].append((le["ts"], e))
    for key, items in by_thread.items():
        items.sort(key=lambda it: it[0])
        spans = threads.get(key, [])
        for (_, e), open_ in zip(items, _sweep(spans, [t for t, _ in items])):
            stages = [s["name"] for s in open_ if s.get("cat") == "user_annotation" and s["name"] != WINDOW]
            stage_us[stages[-1] if stages else "(no stage)"] += e["dur"]
            ops = [s for s in open_ if s.get("cat") == "cpu_op" and s["name"].startswith(OP_PREFIX)]
            if ops:
                op = ops[-1]
                args = op.get("args") or {}
                call = op_calls.setdefault(id(op), {"op": op["name"], "dims": args.get("Input Dims"),
                                                    "concrete": args.get("Concrete Inputs"), "device_s": 0.0})
                call["device_s"] += e["dur"] * 1e-6
    busy = _union(intervals)
    busy_us = sum(b - a for a, b in busy)

    # idle gaps inside the window, named by the innermost host op open on the main thread at their middle
    gaps = collections.defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    spans = threads.get(main, [])
    holes = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    for (a, b), open_ in zip(holes, _sweep(spans, [(a + b) / 2 for a, b in holes])):
        open_ = [s for s in open_ if s is not win]
        gaps[open_[-1]["name"] if open_ else "(python, no op)"] += b - a
    ops = collections.defaultdict(list)
    for call in op_calls.values():
        ops[call.pop("op")].append(call)
    return dict(
        window_s=(w1 - w0) * 1e-6,
        busy_s=busy_us * 1e-6,
        device_events=n_dev,
        memcpy_s=memcpy_us * 1e-6,
        stage_s={k: v * 1e-6 for k, v in stage_us.items()},
        ops=dict(ops),
        device_ops=[[k, v * 1e-6] for k, v in sorted(device_us.items(), key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=[[k, v * 1e-6] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
    )
