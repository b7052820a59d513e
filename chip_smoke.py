#!/usr/bin/env python3
"""Smoke run of the PyTorch port (xumx_slicq_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from this checkout (K1 with nvcc into
build/xumx_slicq_torch/, K2 with Triton), holds each against its plain
PyTorch version at the shapes of the main path (K2 as one grouped call
over all 70 buckets of the packed layout), checks the canonical
bark-262 transform round trip on the card, runs the full-width offline
Separator on the card and on the CPU and compares the stems, demixes a
seeded 236 s stereo track (the MUSDB18-HQ test-set average length) with
launch counts and timings, and runs the realtime Separator once. Weights are
random, drawn from a seed. Any failed check exits non-zero.

Output: one line per phase; before the last line, the card's name and power
limit as nvidia-smi reports them and one JSON object with the kernels'
numbers; the last line is {"ok": true, "device": {...}}. It needs one card
and exits non-zero without one, and when the port's package is not next to
this script.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate (data sheet)
FP32_FLOPS = 67e12              # H100 SXM fp32 outside the tensor cores (data sheet)
TRACK_SECONDS = 236             # MUSDB18-HQ test-set average track length
K1_TOL = 1e-5                   # max |kernel - plain| / max |plain|: same sums, FMA contraction
K2_TOL = 1e-4                   # same, per bucket: fp32 division/sqrt rounding through the 2x2 inverse
ROUNDTRIP_TOL = 1e-5            # transform round trip on unit-variance noise
STEM_TOL = 1e-4                 # |cuda - cpu| stems, fp32 both sides with TF32 off, 0.1-RMS input


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def phase(name: str, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean device time of fn over reps calls, from CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of the byte time and the op time."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def k2_inputs(layout, g):
    """Packed K2 inputs on the card: a silent first slice in every bucket
    (exact zeros) and a scale that differs from bucket to bucket, so that
    each bucket has a stability scale m_k > 1 of its own."""
    from xumx_slicq_torch.ops.packed import PackedBlocks

    x = torch.randn(layout.size, generator=g, device=g.device, dtype=torch.complex64)
    v = torch.rand(4 * layout.size, generator=g, device=g.device)
    for k, (xb, vb) in enumerate(zip(PackedBlocks(x, layout), PackedBlocks(v, layout, 4))):
        xb.mul_(10.0 * (1 + k % 7))
        xb[:, :, :, 0] = 0
        vb.mul_(1 + k % 5)
    return x, v


def bucket_errors(out, ref, layout):
    """(max abs err, max over buckets of max |out - ref| / max |ref|) of
    packed estimates."""
    from xumx_slicq_torch.ops.packed import PackedBlocks

    err, rel = 0.0, 0.0
    for a, b in zip(PackedBlocks(out, layout, 4), PackedBlocks(ref, layout, 4)):
        e = float((a - b).abs().max())
        err, rel = max(err, e), max(rel, e / float(b.abs().max()))
    return err, rel


def breakdown(sep, slicqt, track, batch: int, chunk: int):
    """Where one track's time goes: the time of each stage on the track's
    chunk batch between CUDA events (device time, plus any gap where the
    host launches slower than the device runs), then one profiled demix
    for the device's busy share and its heaviest kernels."""
    from torch.profiler import ProfilerActivity, profile

    from xumx_slicq_torch.ops import wiener as wiener_ops

    dev = slicqt.device
    n = track.shape[-1]
    flat = np.zeros((batch, 2, chunk), np.float32)
    for ci in range(-(-n // chunk)):
        seg = track[0, :, ci * chunk: (ci + 1) * chunk]
        flat[ci, :, : seg.shape[-1]] = seg
    a = torch.from_numpy(flat).to(dev)
    model, folded = sep.model, sep._folded
    with torch.inference_mode():
        X = slicqt.forward(a)
        mags, _ = model.magnitudes(X, folded)                     # packed, as the model hands them to K2
        Y, _ = model.apply(X, folded)
        Yb = [y.reshape((-1,) + y.shape[2:]) for y in Y]
        stages = {
            "slicqt_forward": cuda_ms(lambda: slicqt.forward(a), reps=3),
            "cdae": cuda_ms(lambda: model.magnitudes(X, folded), reps=3),
            "cdae_and_wiener": cuda_ms(lambda: model.apply(X, folded), reps=3),
            "wiener_k2": cuda_ms(lambda: wiener_ops.wiener_blocks(X, mags), reps=3),
            "slicqt_backward": cuda_ms(lambda: slicqt.backward(Yb, chunk), reps=3),
        }
        del X, mags, Y, Yb
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        sep(track)
        torch.cuda.synchronize()
        wall = time.time() - t0
    # device-side entries only (kernels, copies): a CPU op's entry repeats
    # the time of the kernels it launched
    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    k2_rows = [e for e in rows if "_em_pass" in e.key]
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:10]
    phase("track_breakdown", stage_device_ms=stages, profiled_wall_ms=wall * 1e3,
          device_busy_ms=busy_ms if rows else "not measured",
          device_busy_share=busy_ms / (wall * 1e3) if rows else "not measured",
          kernel_launches=sum(e.count for e in rows),
          k2_kernels=[[e.key[:60], e.count, e.self_device_time_total / 1e3] for e in k2_rows],
          top_kernels=[[e.key[:60], e.count, e.self_device_time_total / 1e3] for e in top])


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    try:
        import xumx_slicq_torch
    except ImportError as e:
        fail(f"the port's package is not next to this script: {e}")
    check(Path(xumx_slicq_torch.__file__).resolve().parent.parent == ROOT,
          f"xumx_slicq_torch imported from {xumx_slicq_torch.__file__}, not from {ROOT}")
    from xumx_slicq_torch.kernels import build
    from xumx_slicq_torch.kernels.synth_assembly import synth_assembly, synth_assembly_plain
    from xumx_slicq_torch.kernels import triton_wiener_em
    from xumx_slicq_torch.kernels.wiener_em import (_device_state, stability_scale, wiener_em, wiener_em_grouped,
                                                    wiener_em_grouped_plain, wiener_em_plain)
    from xumx_slicq_torch.models import Unmix
    from xumx_slicq_torch.ops.slicqt import SliCQT
    from xumx_slicq_torch.separator import Separator

    # -- phase 1: the card ----------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cap = torch.cuda.get_device_capability(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("card", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
          capability=list(cap), devices=torch.cuda.device_count(),
          matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
          cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    check(cap == (9, 0), f"sm_90 card required for the sm_90a kernels, got capability {cap}")

    # -- phase 2: build the kernels -------------------------------------------
    t0 = time.time()
    logs = build.build_all(extra_flags=("-Xptxas", "-v"))
    nvcc_s = time.time() - t0
    for name, log in logs.items():
        for line in log.strip().splitlines():
            print(f"  nvcc {name}: {line}")
    g = torch.Generator(device=dev).manual_seed(0)
    xs = torch.randn((1, 2, 3, 500), generator=g, device=dev, dtype=torch.complex64)
    vs = torch.rand((4, 1, 2, 3, 500), generator=g, device=dev)
    t0 = time.time()
    ys = wiener_em(xs, vs)
    torch.cuda.synchronize()
    triton_s = time.time() - t0
    small_err = float((ys - wiener_em_plain(xs, vs, stability_scale(xs))).abs().max() / ys.abs().max())
    phase("build", nvcc_seconds=round(nvcc_s, 3), triton_seconds=round(triton_s, 3),
          libraries=sorted(logs), k2_small_rel_err=small_err)
    check(small_err <= K2_TOL, f"K2 small-shape check: rel err {small_err} > {K2_TOL}")

    # main-path shapes: a 236 s track is 4 default chunks, one chunk batch of 4
    slicqt = SliCQT(device=dev)
    chunk = 2621440
    N_track = TRACK_SECONDS * 44100
    nchunks = -(-N_track // chunk)
    batch = next(b for b in Separator._CHUNK_BATCH_BUCKETS if b >= nchunks)
    S = slicqt.n_slices(chunk)
    kernels = {}

    # -- phase 3: K1 against its plain version --------------------------------
    table = slicqt.synth_table
    rows = 4 * batch * 2
    flat = torch.randn((rows, S, slicqt.raw_len), generator=g, device=dev, dtype=torch.complex64)
    ref = synth_assembly_plain(flat, table)
    out = synth_assembly(flat, table)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    rel = err / float(ref.abs().max())
    del ref, out
    k1_ms = cuda_ms(lambda: synth_assembly(flat, table), reps=20)
    k1_plain_ms = cuda_ms(lambda: synth_assembly_plain(flat, table), reps=3, warm=1)
    nh, O = table.idx.shape
    k1_bytes = flat.numel() * 8 + nh * O * 12 + table.unrot.numel() * 8 + rows * S * nh * 8
    k1_bound, k1_by = bound(k1_bytes, rows * S * nh * (4 * O + 6))
    phase("k1_synth_assembly", shape=[rows, S, slicqt.raw_len], out_shape=[rows, S, nh],
          max_abs_err=err, rel_err=rel, tol=K1_TOL, ms=k1_ms, plain_ms=k1_plain_ms,
          bound_ms=k1_bound, bound_by=k1_by, gbytes=k1_bytes / 1e9)
    check(rel <= K1_TOL, f"K1 disagrees with its plain version: rel err {rel} > {K1_TOL}")
    kernels["synth_assembly"] = dict(
        name="synth_assembly", route="cuda", source="xumx_slicq_torch/csrc/synth_assembly.cu",
        replaces="xumx_slicq_tpu/ops/slicqt.py:727", max_abs_err=err, ms=k1_ms,
        plain_ms=k1_plain_ms, bound_ms=k1_bound, bound_by=k1_by, library_ms=None)
    del flat

    # -- phase 4: K2, one grouped call over all 70 buckets ---------------------
    layout = slicqt.layout(batch, 2, S)
    xk, vk = k2_inputs(layout, g)
    before = wiener_em.launches
    yk = wiener_em_grouped(xk, vk, layout)
    torch.cuda.synchronize()
    k2_call_launches = wiener_em.launches - before
    err, rel = bucket_errors(yk, wiener_em_grouped_plain(xk, vk, layout), layout)
    del yk
    k2_ms = cuda_ms(lambda: wiener_em_grouped(xk, vk, layout), reps=20)
    k2_plain_ms = cuda_ms(lambda: wiener_em_grouped_plain(xk, vk, layout), reps=3, warm=1)
    state = _device_state(layout, xk.device)                   # K2's tables, built by the call above
    yk = torch.empty(4 * layout.size, dtype=torch.complex64, device=dev)
    pass1_ms = cuda_ms(lambda: (state["maxima"].zero_(), triton_wiener_em.pass1(xk, vk, state)), reps=20)
    pass2_ms = cuda_ms(lambda: triton_wiener_em.pass2(xk, vk, state, yk), reps=20)
    positions = layout.size // 2                               # (b, f, t) positions
    # per position: read x (2 x 8 B) and v (8 x 4 B), write y (8 x 8 B);
    # ~400 fp32 operations per position, counted from the plain version.
    # The two passes read x and v twice: 160 B per position
    k2_bound, k2_by = bound(positions * 112, positions * 400)
    k2_floor = positions * 160 / HBM_BYTES_PER_S * 1e3
    phase("k2_wiener_em", buckets=len(layout.shapes), batch=batch, positions=positions,
          launches_per_call=k2_call_launches, max_abs_err=err, rel_err=rel, tol=K2_TOL, ms=k2_ms,
          pass1_ms=pass1_ms, pass2_ms=pass2_ms, plain_ms=k2_plain_ms, bound_ms=k2_bound, bound_by=k2_by,
          two_pass_floor_ms=k2_floor, share_of_bound=k2_bound / k2_ms, gbytes=positions * 112 / 1e9)
    check(rel <= K2_TOL, f"K2 disagrees with its plain version: rel err {rel} > {K2_TOL}")
    check(k2_call_launches <= 3, f"K2 made {k2_call_launches} device launches in one call, expected <= 3")
    kernels["wiener_em"] = dict(
        name="wiener_em", route="triton", source="xumx_slicq_torch/kernels/triton_wiener_em.py",
        replaces="xumx_slicq_tpu/ops/wiener.py:107", max_abs_err=err, ms=k2_ms,
        plain_ms=k2_plain_ms, bound_ms=k2_bound, bound_by=k2_by, library_ms=None)
    del xk, vk, yk

    # -- phase 5: transform round trip on the card ----------------------------
    rng = np.random.default_rng(0)
    sig = torch.from_numpy(rng.standard_normal((1, 2, chunk)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        rt = float((slicqt.backward(slicqt.forward(sig), chunk) - sig).abs().max())
    phase("roundtrip", samples=chunk, max_abs_err=rt, tol=ROUNDTRIP_TOL)
    check(rt <= ROUNDTRIP_TOL, f"bark-262 round trip error {rt} > {ROUNDTRIP_TOL}")
    del sig

    # -- phase 6: full-width offline Separator, card against CPU --------------
    shapes = slicqt.block_shapes(1, 2, 2 * 44100)
    sep = Separator(slicqt, Unmix(shapes, seed=0, device=dev), device=dev)
    n_params = sep.model.num_params()
    check(n_params == 15010446, f"canonical Unmix has {n_params} parameters, expected 15010446")
    clip = (rng.standard_normal((1, 2, 4 * 44100)) * 0.1).astype(np.float32)
    t0 = time.time()
    est_gpu = sep(clip)
    gpu_first_s = time.time() - t0
    slicqt_cpu = SliCQT(device="cpu")
    sep_cpu = Separator(slicqt_cpu, Unmix(slicqt_cpu.block_shapes(1, 2, 2 * 44100), seed=0, device="cpu"),
                        device="cpu")
    t0 = time.time()
    est_cpu = sep_cpu(clip)
    cpu_s = time.time() - t0
    diff = float(np.abs(est_gpu - est_cpu).max())
    phase("separator_cuda_vs_cpu", params=n_params, samples=clip.shape[-1], max_abs_diff=diff,
          tol=STEM_TOL, stem_max=float(np.abs(est_cpu).max()), cuda_first_call_s=gpu_first_s, cpu_s=cpu_s)
    check(est_gpu.shape == (4, 1, 2, clip.shape[-1]) and np.isfinite(est_gpu).all(), "bad GPU stems")
    check(diff <= STEM_TOL, f"GPU stems differ from CPU stems by {diff} > {STEM_TOL}")
    del sep_cpu, slicqt_cpu

    # -- phase 7: the main path, a 236 s track --------------------------------
    track = (rng.standard_normal((1, 2, N_track)) * 0.1).astype(np.float32)
    sep(track)                                                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    synth_assembly.launches = 0
    wiener_em.launches = 0
    t0 = time.time()
    est = sep(track)                                           # the counted main-path run
    torch.cuda.synchronize()
    times = [time.time() - t0]
    launches = {"synth_assembly": synth_assembly.launches, "wiener_em": wiener_em.launches}
    peak = torch.cuda.max_memory_allocated()
    check(est.shape == (4, 1, 2, N_track) and np.isfinite(est).all(), "bad stems for the 236 s track")
    del est   # a caller that keeps the stems makes the next demix page-lock fresh host memory
    for _ in range(2):
        t0 = time.time()
        sep(track)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    phase("track_236s", samples=N_track, chunks=nchunks, chunk_batch=batch, s_per_track=times,
          s_per_track_median=float(np.median(times)), max_memory_allocated_bytes=peak,
          launches=launches, k2_device_launches_per_chunk_batch=launches["wiener_em"])
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
        kernels[name]["launches"] = n
    check(launches["wiener_em"] <= 3, f"K2 made {launches['wiener_em']} device launches for one chunk batch")
    breakdown(sep, slicqt, track, batch, chunk)

    # -- phase 8: realtime Separator ------------------------------------------
    sep_rt = Separator(slicqt, Unmix(shapes, realtime=True, seed=0, device=dev), device=dev)
    est_rt = sep_rt(clip)
    phase("separator_realtime", shape=list(est_rt.shape), finite=bool(np.isfinite(est_rt).all()))
    check(est_rt.shape == (4, 1, 2, clip.shape[-1]) and np.isfinite(est_rt).all(), "bad realtime stems")

    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms"]
    print(card)
    print(json.dumps({"kernels": [{k: kern[k] for k in order} for kern in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
