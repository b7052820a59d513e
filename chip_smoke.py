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
launch counts and timings, and runs the realtime Separator once. Then the
LSTM variant: K5 (CUDA C++, the LSTM recurrence) against its plain version
over all 70 buckets offline and realtime, at 2 s and at the main path's
layout, timed there beside cuDNN's LSTM and per hidden size (ns a step of
each group's longest chain), its error against a float64 walk, the
canonical LSTM Separator on the card against the CPU, the 236 s track
through it offline and realtime, its realtime model once, and the LSTM at
--fscale linear --fbins 262 (H = 132 and 263) on the card against the CPU.
Then the training path: K1's and K2's backward kernels against their plain versions
at the training shapes, one train step on the card against the CPU at
mel-12, 13 full-width train steps (batch 32 of 2.0 s) with launch counts,
memory and a profile, and the trainer's CLI with a resume and a reload.
Last, training the LSTM variant: K5's train-mode forward and K5b (its
backward through time) against their plain versions at the training
layout, offline and realtime, timed beside cuDNN's LSTM; one LSTM train
step on the card against the CPU at mel-12; 13 canonical LSTM train steps
with K5 and K5b launches counted; and the trainer's CLI with --lstm.
Weights are random, drawn from a seed. Any failed check exits non-zero.

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
K1B_TOL = 1e-5                  # K1 backward: the same products and sums as its plain version
# K2 backward, max |kernel - plain| over each bucket's largest gradient: fp32 division through the
# 2x2 inverse and row sums over up to ~1e4 frames taken in another order, as for the forward
K2B_TOL = 1e-4
TRAIN_LOSS_TOL = 1e-4           # train step, card against CPU at mel-12: loss, relative
TRAIN_GRAD_TOL = 1e-3           # ... gradients, ||cuda - cpu|| / ||cpu|| per tensor (cuFFT, cuDNN sum orders)
BF16_LOSS_TOL = 1e-2            # ... the same step with bf16 conv operands (--bf16): ~3 decimal digits
TRAIN_BATCH, TRAIN_SECONDS = 32, 2.0    # the JAX trainer's defaults (training.py:349-372)
# K5 against its plain version, max |h_kernel - h_plain| with |h| < 1: accurate expf/tanhf against
# torch's sigmoid/tanh and gate sums in another order, carried through up to 3,212 steps (2 s layout,
# plain version on the CPU) or 85,264 steps (the main path's layout, plain version on the card) of a
# contractive recurrence
K5_TOL = 1e-4
LSTM_STEM_TOL = 1e-4            # |cuda - cpu| LSTM stems, fp32 both sides, 0.1-RMS input
LSTM_PARAMS = {False: 976174, True: 1213294}    # the JAX package's counts at bark-262 (offline, realtime)
# One K5 step's dependent chain at H = 1 in SM cycles, from instruction latencies timed on an H100 with clock64
# (tools/k5_ab.py --latency): FFMA or FADD 7, FFMA + MUFU.EX2 23, FFMA + MUFU.RCP 23. The chain of a step of
# csrc/lstm_recurrence.cu is gate FFMA, EX2, FADD, RCP, the cell's two FFMAs, EX2, FADD, RCP and the output
# FFMA: 4 x 23 + 2 x 7. (The kernel's own row_sum and cell_ timed as one chain take 119, its ten MUFU
# operations queueing at the SFU; the previous design's chain, libm's tanhf five times, 168.)
STEP_CHAIN_CYCLES = 4 * 23 + 2 * 7
CUDNN_MAX_STEPS = 65535         # cuDNN's LSTM refuses longer sequences (CUDNN_STATUS_NOT_SUPPORTED on an H100)
# K5b against its plain version on the card, from the same h and c, max |kernel - plain| / max |plain| of
# d(xp) and of d(W_hh^T): the same arithmetic in another order (FMA contraction, libm's tanhf, sums of the
# matvec in another order), carried back through up to 3,212 steps
K5B_TOL = 1e-4
# One K5b step's dependent chain in cycles, reckoned from csrc/lstm_recurrence.cu for the one-lane group:
# dh = dh_out + dh_rec (add, 4), dc = dc_rec + dh o (1 - tc^2) (multiply and FMA, 8), the four gate
# gradients side by side (three dependent multiplies, 12) and dh_rec, four dependent FMAs (16): ~40. The
# gate recompute reads only saved values and lies off the chain.
STEP_CHAIN_CYCLES_BACKWARD = 40
# LSTM train step, card against CPU at mel-12: gradients ||cuda - cpu|| / max(||cpu||, 1e-2 of the largest
# norm) per tensor. Train-mode BatchNorm after the LSTM leaves some gradients (the last layer's biases, the
# whitening) small remainders of cancelling sums, whose float32 rounding reaches 1e-5 of the largest norm
LSTM_GRAD_FLOOR = 1e-2


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


def breakdown(sep, slicqt, track, batch: int, chunk: int, name: str = "track_breakdown", model: str = "cdae"):
    """Where one track's time goes: the time of each stage on the track's
    chunk batch between CUDA events (device time, plus any gap where the
    host launches slower than the device runs), then one profiled demix
    for the device's busy share and its heaviest kernels. `model` names the
    mask model's stage (the CDAE's or the LSTM's)."""
    from torch.profiler import ProfilerActivity, profile

    from xumx_slicq_torch.ops import wiener as wiener_ops

    dev = slicqt.device
    n = track.shape[-1]
    flat = np.zeros((batch, 2, chunk), np.float32)
    for ci in range(-(-n // chunk)):
        seg = track[0, :, ci * chunk: (ci + 1) * chunk]
        flat[ci, :, : seg.shape[-1]] = seg
    a = torch.from_numpy(flat).to(dev)
    mask_model, folded = sep.model, sep._prepared
    with torch.inference_mode():
        X = slicqt.forward(a)
        mags, _ = mask_model.magnitudes(X, folded)                # packed, as the model hands them to K2
        Y, _ = mask_model.apply(X, folded)
        Yb = [y.reshape((-1,) + y.shape[2:]) for y in Y]
        stages = {
            "slicqt_forward": cuda_ms(lambda: slicqt.forward(a), reps=3),
            model: cuda_ms(lambda: mask_model.magnitudes(X, folded), reps=3),
            f"{model}_and_wiener": cuda_ms(lambda: mask_model.apply(X, folded), reps=3),
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
    phase(name, stage_device_ms=stages, profiled_wall_ms=wall * 1e3,
          device_busy_ms=busy_ms if rows else "not measured",
          device_busy_share=busy_ms / (wall * 1e3) if rows else "not measured",
          kernel_launches=sum(e.count for e in rows),
          k2_kernels=[[e.key[:60], e.count, e.self_device_time_total / 1e3] for e in k2_rows],
          top_kernels=[[e.key[:60], e.count, e.self_device_time_total / 1e3] for e in top])


def profiled(fn):
    """(wall ms, device busy ms or None, device launches, top 10 device
    entries, top 8 host ops by self time) of one call of fn, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    events = prof.key_averages()
    # a host range (the optimizer's step) also shows as a device annotation of its name: not a kernel
    host = {e.key for e in events if not str(e.device_type).endswith("CUDA")}
    rows = [e for e in events
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0 and e.key not in host]
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:10]
    busy = sum(e.self_device_time_total for e in rows) / 1e3 if rows else None
    host_top = sorted((e for e in events if e.key in host), key=lambda e: -e.self_cpu_time_total)[:8]
    return (wall, busy, sum(e.count for e in rows),
            [[e.key[:60], e.count, e.self_device_time_total / 1e3] for e in top],
            [[e.key[:60], e.count, e.self_cpu_time_total / 1e3] for e in host_top])


def k1_backward(slicqt, g, kernels):
    """K1's backward against its plain version at the training shapes:
    4 targets x batch 32 x 2 channels, 2.0 s."""
    from xumx_slicq_torch.kernels.synth_assembly import synth_assembly_backward, synth_assembly_backward_plain

    table = slicqt.synth_table
    rows, S = 4 * TRAIN_BATCH * 2, slicqt.n_slices(int(TRAIN_SECONDS * 44100))
    gout = torch.randn((rows, S, slicqt.nh), generator=g, device=g.device, dtype=torch.complex64)
    ref = synth_assembly_backward_plain(gout, table)
    out = synth_assembly_backward(gout, table)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    rel = err / float(ref.abs().max())
    del out, ref
    ms = cuda_ms(lambda: synth_assembly_backward(gout, table), reps=20)
    plain_ms = cuda_ms(lambda: synth_assembly_backward_plain(gout, table), reps=3, warm=1)
    W = table.tidx.shape[1]
    nbytes = gout.numel() * 8 + rows * S * slicqt.raw_len * 8 + table.tidx.numel() * 12 + table.unrot.numel() * 8
    bms, by = bound(nbytes, rows * S * slicqt.raw_len * W * 10)
    phase("k1_backward", shape=[rows, S, slicqt.nh], out_shape=[rows, S, slicqt.raw_len], width=W,
          max_abs_err=err, rel_err=rel, tol=K1B_TOL, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
          gbytes=nbytes / 1e9)
    check(rel <= K1B_TOL, f"K1 backward disagrees with its plain version: rel err {rel} > {K1B_TOL}")
    kernels["synth_assembly_backward"] = dict(
        name="synth_assembly_backward", route="cuda", source="xumx_slicq_torch/csrc/synth_assembly.cu",
        replaces="xumx_slicq_tpu/training.py:263", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None)


def k2_backward(slicqt, g, kernels):
    """K2's backward over all 70 buckets at the training layout (batch 32
    of 2.0 s) against its plain closed form and against autograd of the
    grouped plain forward, bucket by bucket, on inputs like k2_inputs."""
    from xumx_slicq_torch.kernels import triton_wiener_em
    from xumx_slicq_torch.kernels.wiener_em import (_device_tables, launch_forward, wiener_em_backward,
                                                    wiener_em_backward_plain, wiener_em_grouped,
                                                    wiener_em_grouped_plain)

    layout = slicqt.layout(TRAIN_BATCH, 2, slicqt.n_slices(int(TRAIN_SECONDS * 44100)))
    x, v = k2_inputs(layout, g)
    gy = torch.randn(4 * layout.size, generator=g, device=g.device, dtype=torch.complex64)
    vr = v.clone().requires_grad_(True)
    (gk,) = torch.autograd.grad(wiener_em_grouped(x, vr, layout), vr, gy)      # through the Function
    torch.cuda.synchronize()
    err, rel = bucket_errors(gk, wiener_em_backward_plain(x, v, gy, layout), layout)
    vr = v.clone().requires_grad_(True)
    (ga,) = torch.autograd.grad(wiener_em_grouped_plain(x, vr, layout), vr, gy)
    _, rel_autograd = bucket_errors(gk, ga, layout)
    del vr, ga, gk
    _, parts, maxima = launch_forward(x, v, layout)
    ms = cuda_ms(lambda: wiener_em_backward(x, v, gy, layout, parts, maxima), reps=20)
    tables = _device_tables(layout, x.device)
    gpart, gv = torch.empty_like(parts), torch.empty_like(v)
    pass1_ms = cuda_ms(lambda: triton_wiener_em.backward_pass1(x, v, gy, tables, parts, maxima, gpart), reps=20)
    pass2_ms = cuda_ms(lambda: triton_wiener_em.backward_pass2(x, v, gy, tables, parts, maxima, gpart, gv),
                       reps=20)
    plain_ms = cuda_ms(lambda: wiener_em_backward_plain(x, v, gy, layout), reps=3, warm=1)
    positions = layout.size // 2
    # per position: read x (16 B), v (32 B) and gy (64 B), write dL/dv (32 B); ~700 fp32
    # operations per position, counted from the plain version. Both passes read the three inputs.
    bms, by = bound(positions * 144, positions * 700)
    phase("k2_backward", buckets=len(layout.shapes), batch=TRAIN_BATCH, positions=positions, max_abs_err=err,
          rel_err=rel, rel_err_vs_autograd=rel_autograd, tol=K2B_TOL, ms=ms, pass1_ms=pass1_ms,
          pass2_ms=pass2_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
          two_pass_floor_ms=positions * 256 / HBM_BYTES_PER_S * 1e3, gbytes=positions * 144 / 1e9)
    check(rel <= K2B_TOL, f"K2 backward disagrees with its plain version: rel err {rel} > {K2B_TOL}")
    check(rel_autograd <= K2B_TOL, f"K2 backward disagrees with autograd: rel err {rel_autograd} > {K2B_TOL}")
    kernels["wiener_em_backward"] = dict(
        name="wiener_em_backward", route="triton", source="xumx_slicq_torch/kernels/triton_wiener_em.py",
        replaces="xumx_slicq_tpu/training.py:256", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None)


def k5_inputs(slicqt, batch: int, S: int, realtime: bool, g):
    """K5's layout for the canonical LSTM model at (batch, S), projections
    with the spread of a trained model's, and W_hh at torch's init bound."""
    from xumx_slicq_torch.kernels.lstm_recurrence import RecurrenceLayout, pack_recurrent_weights
    from xumx_slicq_torch.models.lstm import SlicedLSTM

    shapes = slicqt.layout(batch, 2, S).shapes
    hidden = [SlicedLSTM(C, F, M, realtime=realtime).lstm_hidden for (_, C, F, _, M) in shapes]
    layout = RecurrenceLayout(hidden, [S * M for (*_, M) in shapes], batch, 1 if realtime else 2)
    xp = torch.randn(layout.xp_size, generator=g, device=g.device) * 2
    w_hh = [(torch.rand((4, layout.dirs, 4 * h, h), generator=g, device=g.device) * 2 - 1) / h ** 0.5
            for h in hidden]
    return layout, xp, pack_recurrent_weights(w_hh)


def cudnn_lstms(layout, xp, w, max_steps=None):
    """cuDNN's LSTM (torch.nn.LSTM) set up to compute K5's function, one
    call per (bucket, target, direction): W_ih = I and zero biases on K5's
    own projections, W_hh from w. One call per direction because the
    directions' projections differ. Yields (module, projections in walk
    order, bucket, target, direction); max_steps leaves out the buckets with
    longer sequences. For yardsticks timed here only; the port never calls it."""
    for k, (x, wt) in enumerate(zip(layout.xp_blocks(xp), layout.w_blocks(w))):
        H = layout.hidden[k]
        if max_steps is not None and layout.frames[k] > max_steps:
            continue
        m = torch.nn.LSTM(4 * H, H).to(xp.device)
        with torch.no_grad():
            m.weight_ih_l0.copy_(torch.eye(4 * H))
            m.bias_ih_l0.zero_()
            m.bias_hh_l0.zero_()
        for t in range(4):
            for d in range(layout.dirs):
                with torch.no_grad():
                    m.weight_hh_l0.copy_(wt[t, d].T)
                yield m, (x[t, d] if d == 0 else x[t, d].flip(0)), k, t, d


def cudnn_lstm_ms(layout, xp, w, max_steps=None) -> float:
    """The yardstick for K5: the device time of cudnn_lstms' forward calls, summed."""
    with torch.no_grad():
        return sum(cuda_ms(lambda: m(seq), reps=1, warm=1) for m, seq, *_ in cudnn_lstms(layout, xp, w, max_steps))


def max_sm_clock_mhz() -> float:
    return float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                capture_output=True, text=True, timeout=60).stdout.split()[0])


def k5_per_hidden(layout, xp, w, clock_mhz: float):
    """K5 on the buckets of each hidden size alone (a layout of those
    buckets, at their lengths): per H the buckets, the longest chain, the
    launch's ms and ns (and cycles at the max SM clock) per step of that
    chain."""
    from xumx_slicq_torch.kernels.lstm_recurrence import RecurrenceLayout, lstm_recurrence

    rows = {}
    for H in sorted(set(layout.hidden)):
        ks = [k for k, h in enumerate(layout.hidden) if h == H]
        sub = RecurrenceLayout([H] * len(ks), [layout.frames[k] for k in ks], layout.batch, layout.dirs)
        xs = torch.cat([xp[layout.xp_offsets[k]: layout.xp_offsets[k] + layout.xp_sizes[k]] for k in ks])
        ws = torch.cat([w[layout.w_offsets[k]: layout.w_offsets[k] + layout.w_sizes[k]] for k in ks])
        ms = cuda_ms(lambda: lstm_recurrence(xs, ws, sub), reps=3, warm=1)
        steps = max(sub.frames)
        rows[H] = dict(buckets=len(ks), steps=steps, ms=ms, ns_per_step=ms * 1e6 / steps,
                       cycles_per_step=ms * 1e3 * clock_mhz / steps)
    return rows


def k5_error_f64(layout, xp, w, ks):
    """K5 on the buckets ks alone against the grouped plain walk in float64
    on the card: per bucket (H, steps, max |h_kernel - h_f64|)."""
    from xumx_slicq_torch.kernels.lstm_recurrence import lstm_recurrence, lstm_recurrence_grouped_plain

    sub = type(layout)([layout.hidden[k] for k in ks], [layout.frames[k] for k in ks], layout.batch, layout.dirs)
    xs = torch.cat([xp[layout.xp_offsets[k]: layout.xp_offsets[k] + layout.xp_sizes[k]] for k in ks])
    ws = torch.cat([w[layout.w_offsets[k]: layout.w_offsets[k] + layout.w_sizes[k]] for k in ks])
    out = lstm_recurrence(xs, ws, sub)
    ref = lstm_recurrence_grouped_plain(xs.double(), ws.double(), sub)
    return [[sub.hidden[i], sub.frames[i], float((a.double() - b).abs().max())]
            for i, (a, b) in enumerate(zip(sub.h_blocks(out), sub.h_blocks(ref)))]


def k5_lstm_recurrence(slicqt, g, kernels, batch: int, S: int):
    """K5 against its plain version over all 70 buckets, offline and
    realtime: on the CPU at the chunk batch of 2 s clips, and on the card
    at the main path's layout (chunk batch `batch` of the default chunk,
    the longest chains); there K5 per layer with its bound (the larger of
    its byte time and its serial floor), the plain version's time and
    cuDNN's beside it, K5 on each hidden-size group alone (ns a step of its
    longest chain), and K5's error on the longest chain and on the widest
    bucket against a float64 walk."""
    from xumx_slicq_torch.kernels.lstm_recurrence import lstm_recurrence, lstm_recurrence_grouped_plain

    S2 = slicqt.n_slices(2 * 44100)
    errs, small = {}, {}
    for realtime in (False, True):
        layout, xp, w = k5_inputs(slicqt, batch, S2, realtime, g)
        before = lstm_recurrence.launches
        out = lstm_recurrence(xp, w, layout)
        torch.cuda.synchronize()
        check(lstm_recurrence.launches == before + 1, "K5 made more than one launch for one layer")
        name = "realtime" if realtime else "offline"
        errs[name] = float((out.cpu() - lstm_recurrence_grouped_plain(xp.cpu(), w.cpu(), layout)).abs().max())
        check(bool(torch.isfinite(out).all()) and errs[name] <= K5_TOL,
              f"K5 {name} disagrees with its plain version: {errs[name]} > {K5_TOL}")
        small[name] = dict(max_hidden=max(layout.hidden), max_steps=max(layout.frames),
                           ms=cuda_ms(lambda: lstm_recurrence(xp, w, layout), reps=5),
                           cudnn_ms=cudnn_lstm_ms(layout, xp, w))
    clock_mhz = max_sm_clock_mhz()
    main = {}
    for realtime in (False, True):
        layout, xp, w = k5_inputs(slicqt, batch, S, realtime, g)
        nbytes = (layout.xp_size + layout.h_size + layout.w_size) * 4
        # per (sequence, step): 4H x H multiply-adds, the 4H gate adds, ~14 operations a unit for the cell
        ops = sum(4 * layout.dirs * layout.batch * n * (8 * h * h + 4 * h + 14 * h)
                  for h, n in zip(layout.hidden, layout.frames))
        byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
        # the longest sequence's steps, one after another, each at least one step's dependent chain
        floor_ms = max(layout.frames) * STEP_CHAIN_CYCLES / (clock_mhz * 1e3)
        name = "realtime" if realtime else "offline"
        out = lstm_recurrence(xp, w, layout)
        # the plain version on the card, run once: its output is the reference for the longest chains
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ref = lstm_recurrence_grouped_plain(xp, w, layout)
        end.record()
        end.synchronize()
        err = float((out - ref).abs().max())
        finite = bool(torch.isfinite(out).all())
        del out, ref
        check(finite and err <= K5_TOL, f"K5 {name} disagrees with its plain version at the main path's layout: "
              f"{err} > {K5_TOL}")
        longest = max(range(len(layout.frames)), key=lambda k: (layout.frames[k], -layout.hidden[k]))
        widest = max(range(len(layout.hidden)), key=lambda k: layout.hidden[k])
        f64 = k5_error_f64(layout, xp, w, [longest, widest])
        check(all(e <= K5_TOL for *_, e in f64), f"K5 {name} against a float64 walk: {f64} > {K5_TOL}")
        main[name] = dict(max_abs_err=err, ms=cuda_ms(lambda: lstm_recurrence(xp, w, layout), reps=5),
                          plain_ms=start.elapsed_time(end), bound_ms=max(byte_ms, op_ms, floor_ms),
                          bound_by="bytes" if byte_ms >= max(op_ms, floor_ms) else "operations",
                          byte_bound_ms=byte_ms, operations_rate_ms=op_ms, serial_floor_ms=floor_ms,
                          gbytes=nbytes / 1e9, max_steps=max(layout.frames),
                          err_vs_float64=[dict(hidden=h, steps=n, max_abs_err=e) for h, n, e in f64],
                          per_hidden=k5_per_hidden(layout, xp, w, clock_mhz))
        main[name]["share_of_floor"] = floor_ms / main[name]["ms"]
        if not realtime:       # the main path: cuDNN, on the buckets whose length it takes
            main[name]["cudnn_ms_buckets_it_takes"] = cudnn_lstm_ms(layout, xp, w, CUDNN_MAX_STEPS)
            main[name]["cudnn_refuses_buckets"] = sum(n > CUDNN_MAX_STEPS for n in layout.frames)
        del xp, w
    phase("k5_lstm_recurrence", tol=K5_TOL, max_abs_err_2s=errs, chunk_batch=batch, slices_2s=S2, at_2s=small,
          slices_main=S, at_main_path=main, step_chain_cycles=STEP_CHAIN_CYCLES, max_sm_clock_mhz=clock_mhz)
    off = main["offline"]
    kernels["lstm_recurrence"] = dict(
        name="lstm_recurrence", route="cuda", source="xumx_slicq_torch/csrc/lstm_recurrence.cu",
        replaces="xumx_slicq_tpu/models/lstm.py:145", max_abs_err=off["max_abs_err"], ms=off["ms"],
        plain_ms=off["plain_ms"],
        # the serial floor is a bound by operations: the longest sequence's dependent chain of them
        bound_ms=off["bound_ms"], bound_by=off["bound_by"],
        # no library call computes this at the main path's inputs: cuDNN refuses its longest sequences
        library_ms=None)


def lstm_separator_cuda_vs_cpu(slicqt, dev, rng):
    """The canonical LSTM model (bark-262, weights from seed 0) through the
    offline Separator on the card and on the CPU, on a 1 s clip."""
    from xumx_slicq_torch.models import Unmix
    from xumx_slicq_torch.ops.slicqt import SliCQT
    from xumx_slicq_torch.separator import Separator

    shapes = slicqt.block_shapes(1, 2, 2 * 44100)
    sep = Separator(slicqt, Unmix(shapes, lstm=True, seed=0, device=dev), device=dev)
    n_params = sep.model.num_params()
    check(n_params == LSTM_PARAMS[False], f"canonical LSTM Unmix has {n_params} parameters, expected {LSTM_PARAMS[False]}")
    clip = (rng.standard_normal((1, 2, 44100)) * 0.1).astype(np.float32)
    t0 = time.time()
    est_gpu = sep(clip)
    gpu_first_s = time.time() - t0
    slicqt_cpu = SliCQT(device="cpu")
    sep_cpu = Separator(slicqt_cpu, Unmix(slicqt_cpu.block_shapes(1, 2, 2 * 44100), lstm=True, seed=0, device="cpu"),
                        device="cpu")
    t0 = time.time()
    est_cpu = sep_cpu(clip)
    cpu_s = time.time() - t0
    diff = float(np.abs(est_gpu - est_cpu).max())
    phase("lstm_separator_cuda_vs_cpu", params=n_params, samples=clip.shape[-1], max_abs_diff=diff,
          tol=LSTM_STEM_TOL, stem_max=float(np.abs(est_cpu).max()), cuda_first_call_s=gpu_first_s, cpu_s=cpu_s)
    check(est_gpu.shape == (4, 1, 2, clip.shape[-1]) and np.isfinite(est_gpu).all(), "bad LSTM GPU stems")
    check(diff <= LSTM_STEM_TOL, f"LSTM GPU stems differ from CPU stems by {diff} > {LSTM_STEM_TOL}")
    return sep


def lstm_track_236s(sep, track, kernels, batch: int):
    """The 236 s track through the offline LSTM Separator: one chunk batch,
    so K5 launches once per layer, 3 times; K2 and K1 on the path too."""
    from xumx_slicq_torch.kernels.lstm_recurrence import lstm_recurrence
    from xumx_slicq_torch.kernels.synth_assembly import synth_assembly
    from xumx_slicq_torch.kernels.wiener_em import wiener_em

    counters = {"lstm_recurrence": lstm_recurrence, "wiener_em": wiener_em, "synth_assembly": synth_assembly}
    sep(track)                                                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.time()
    est = sep(track)                                           # the counted run of the LSTM path
    torch.cuda.synchronize()
    times = [time.time() - t0]
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    check(est.shape == (4, 1, 2, track.shape[-1]) and np.isfinite(est).all(), "bad LSTM stems for the 236 s track")
    del est
    for _ in range(2):
        t0 = time.time()
        sep(track)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    phase("lstm_track_236s", samples=track.shape[-1], chunk_batch=batch, s_per_track=times,
          s_per_track_median=float(np.median(times)), max_memory_allocated_bytes=peak, launches=launches)
    check(launches["lstm_recurrence"] == 3, f"K5 made {launches['lstm_recurrence']} launches for one chunk batch, "
          "expected 3 (one a layer)")
    check(launches["wiener_em"] > 0 and launches["synth_assembly"] > 0, f"LSTM path kernel launches {launches}")
    kernels["lstm_recurrence"]["launches"] = launches["lstm_recurrence"]
    breakdown(sep, sep.slicqt, track, batch, sep.chunk_size, name="lstm_track_breakdown", model="lstm")


def lstm_realtime_track_236s(slicqt, dev, track, batch: int):
    """The 236 s track through the realtime LSTM Separator (the canonical
    realtime LSTM model, weights from seed 0): s/track of 3 runs after a
    warm-up, peak memory, and K5 launched once a layer (3 a chunk batch)."""
    from xumx_slicq_torch.kernels.lstm_recurrence import lstm_recurrence
    from xumx_slicq_torch.models import Unmix
    from xumx_slicq_torch.separator import Separator

    sep = Separator(slicqt, Unmix(slicqt.block_shapes(1, 2, 2 * 44100), realtime=True, lstm=True, seed=0,
                                  device=dev), device=dev)
    sep(track)                                                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = lstm_recurrence.launches
    times = []
    for i in range(3):
        t0 = time.time()
        est = sep(track)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        if i == 0:
            k5 = lstm_recurrence.launches - before
            check(est.shape == (4, 1, 2, track.shape[-1]) and np.isfinite(est).all(),
                  "bad realtime LSTM stems for the 236 s track")
        del est
    phase("lstm_realtime_track_236s", samples=track.shape[-1], chunk_batch=batch, s_per_track=times,
          s_per_track_median=float(np.median(times)), max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
          k5_launches=k5)
    check(k5 == 3, f"the realtime LSTM demix launched K5 {k5} times for one chunk batch, expected 3")


def lstm_linear262(dev, rng, g):
    """--fscale linear --fbins 262: one bucket of F = 263, so H = 132
    offline and 263 realtime (past one block's 128 threads; W_hh too large
    for shared memory, read from L2 every step). The LSTM model's masks on
    the card against the CPU on a 1 s clip, offline and realtime; K5 timed
    at the main path's layout (chunk batch 4 of the default chunk), K5's
    train-mode forward and K5b at the training layout (batch 32 of 2 s)."""
    from xumx_slicq_torch.kernels.lstm_recurrence import (lstm_recurrence, lstm_recurrence_backward,
                                                          lstm_recurrence_with_cell)
    from xumx_slicq_torch.models import Unmix
    from xumx_slicq_torch.ops.slicqt import SliCQT

    t = SliCQT(scale="linear", fbins=262, device=dev)
    x = torch.from_numpy((rng.standard_normal((1, 2, 44100)) * 0.1).astype(np.float32))
    res = {}
    for realtime in (False, True):
        name = "realtime" if realtime else "offline"
        X = t.forward(x.to(dev))
        shapes = [tuple(b.shape) for b in X]
        model = Unmix(shapes, realtime=realtime, lstm=True, seed=0, device=dev)
        cpu = Unmix(shapes, realtime=realtime, lstm=True, seed=0, device="cpu")
        before = lstm_recurrence.launches
        with torch.inference_mode():
            _, masks = model.apply(X, model.inference_weights())
            torch.cuda.synchronize()
            k5 = lstm_recurrence.launches - before
            _, ref = cpu.apply([b.cpu() for b in X])
        diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(masks, ref))
        check(k5 == 3, f"linear-262 {name}: K5 launched {k5} times, expected 3")
        check(all(bool(torch.isfinite(m).all()) for m in masks) and diff <= LSTM_STEM_TOL,
              f"linear-262 {name}: LSTM masks on the card differ from the CPU by {diff} > {LSTM_STEM_TOL}")
        layout, xp, w = k5_inputs(t, 4, t.n_slices(2621440), realtime, g)
        main_ms = cuda_ms(lambda: lstm_recurrence(xp, w, layout), reps=1, warm=1)
        main_steps = max(layout.frames)
        del xp, w
        layout, xp, w = k5_inputs(t, TRAIN_BATCH, t.n_slices(int(TRAIN_SECONDS * 44100)), realtime, g)
        dh = torch.randn(layout.h_size, generator=g, device=dev)
        train_ms = cuda_ms(lambda: lstm_recurrence_with_cell(xp, w, layout), reps=3, warm=1)
        h, c = lstm_recurrence_with_cell(xp, w, layout)
        k5b_ms = cuda_ms(lambda: lstm_recurrence_backward(xp, w, h, c, dh, layout), reps=3, warm=1)
        res[name] = dict(hidden=model.blocks[0].lstm_hidden, clip_steps=shapes[0][3] * shapes[0][4],
                         masks_max_abs_diff=diff, k5_main_path_ms=main_ms, main_path_steps=main_steps,
                         k5_ns_per_step=main_ms * 1e6 / main_steps, k5_train_forward_ms=train_ms,
                         k5b_ms=k5b_ms, train_steps=max(layout.frames))
        del xp, w, dh, h, c
        torch.cuda.empty_cache()
    phase("lstm_linear262", tol=LSTM_STEM_TOL, **res)


def lstm_realtime(slicqt, dev, clip):
    """The realtime LSTM model once: parameters, shapes, finite stems, K5 launched."""
    from xumx_slicq_torch.kernels.lstm_recurrence import lstm_recurrence
    from xumx_slicq_torch.models import Unmix
    from xumx_slicq_torch.separator import Separator

    sep = Separator(slicqt, Unmix(slicqt.block_shapes(1, 2, 2 * 44100), realtime=True, lstm=True, seed=0,
                                  device=dev), device=dev)
    n_params = sep.model.num_params()
    before = lstm_recurrence.launches
    est = sep(clip)
    n = lstm_recurrence.launches - before
    phase("lstm_realtime", params=n_params, shape=list(est.shape), finite=bool(np.isfinite(est).all()), k5_launches=n)
    check(n_params == LSTM_PARAMS[True], f"realtime LSTM Unmix has {n_params} parameters, expected {LSTM_PARAMS[True]}")
    check(est.shape == (4, 1, 2, clip.shape[-1]) and np.isfinite(est).all(), "bad realtime LSTM stems")
    check(n > 0, "K5 was not launched by the realtime LSTM model")


def _train_batch(seed: int, length: int, batch: int) -> np.ndarray:
    stems = (np.random.default_rng(seed).standard_normal((batch, 4, 2, length)) * 0.1).astype(np.float32)
    stems[0, 1] = 0.0                                          # a silent stem: exact zeros
    return np.concatenate([stems.sum(1, keepdims=True), stems], axis=1)


def train_cuda_vs_cpu(dev, lstm: bool = False):
    """One train step with every loss term (so through K2's and K1's
    backward kernels, and with `lstm` K5's and K5b) at mel-12, batch 2 of
    0.3 s, on the card and on the CPU from the same weights and batch (the
    LSTM's dropout off); and the card's step with bf16 operands (--bf16)
    against the CPU's fp32 loss."""
    from xumx_slicq_torch.kernels.lstm_recurrence import lstm_recurrence, lstm_recurrence_backward
    from xumx_slicq_torch.models import Unmix
    from xumx_slicq_torch.ops.slicqt import SliCQT
    from xumx_slicq_torch.training import make_train_step

    length = int(0.3 * 44100)
    batch = _train_batch(1, length, 2)
    res = []
    before = (lstm_recurrence.launches, lstm_recurrence_backward.launches)
    for d, amp in ((dev, False), (torch.device("cpu"), False), (dev, True)):
        t = SliCQT(scale="mel", fbins=12, fmin=200.0, device=d)
        model = Unmix(t.block_shapes(2, 2, length), lstm=lstm, amp=amp, seed=1, device=d)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-5)
        step, _ = make_train_step(t, model, opt, sdr_mcoef=0.1)
        loss = float(step(torch.from_numpy(batch).to(d)))
        res.append((loss, {n: p.grad.cpu().double() for n, p in model.named_parameters()}))
    k5 = (lstm_recurrence.launches - before[0], lstm_recurrence_backward.launches - before[1])
    (lg, gg), (lc, gc), (lb, _) = res
    bf16_rel = abs(lb - lc) / abs(lc)
    loss_rel = abs(lg - lc) / abs(lc)
    norms = {n: float(torch.linalg.vector_norm(a)) for n, a in gc.items()}
    # gradients that train-mode BatchNorm cancels, and with the LSTM its cancelling sums: rounding noise
    floor = (LSTM_GRAD_FLOOR if lstm else 1e-3) * max(norms.values())
    rels = {n: float(torch.linalg.vector_norm(gg[n] - gc[n])) / max(norms[n], floor) for n in gc}
    worst = max(rels, key=rels.get)
    name = "lstm_train_cuda_vs_cpu" if lstm else "train_cuda_vs_cpu"
    phase(name, loss_cuda=lg, loss_cpu=lc, loss_rel=loss_rel, loss_tol=TRAIN_LOSS_TOL, max_grad_rel=rels[worst],
          worst_tensor=worst, grad_tol=TRAIN_GRAD_TOL, grad_floor=floor / max(norms.values()), tensors=len(gc),
          loss_cuda_bf16=lb, bf16_loss_rel=bf16_rel, bf16_tol=BF16_LOSS_TOL, k5_launches=k5[0], k5b_launches=k5[1])
    check(np.isfinite(lg) and loss_rel <= TRAIN_LOSS_TOL, f"{name}: loss on the card {lg} vs CPU {lc}")
    check(rels[worst] <= TRAIN_GRAD_TOL, f"{name}: gradients on the card differ from the CPU: {worst} {rels[worst]}")
    check(bf16_rel <= BF16_LOSS_TOL, f"{name}: bf16 loss on the card {lb} vs fp32 on the CPU {lc}")
    check(k5 == ((6, 6) if lstm else (0, 0)), f"{name}: the two card steps launched K5 and K5b {k5} times")


def train_steps(dev, slicqt, kernels, lstm: bool = False):
    """The training path at full width: the canonical model (with `lstm`
    the canonical LSTM model and the trainer's dropout, a generator
    reseeded every step), batch 32 of 2.0 s from a seeded SyntheticDataset,
    AdamW at the JAX trainer's defaults. 10 steps on one fixed batch, then 3
    steps with SD-SDR on fresh batches from the loader, then one valid step;
    launches of every kernel counted per step, peak memory and one profiled
    step."""
    from xumx_slicq_torch.data import DataLoader, SyntheticDataset
    from xumx_slicq_torch.kernels.lstm_recurrence import lstm_recurrence, lstm_recurrence_backward
    from xumx_slicq_torch.kernels.synth_assembly import synth_assembly, synth_assembly_backward
    from xumx_slicq_torch.kernels.wiener_em import wiener_em, wiener_em_backward
    from xumx_slicq_torch.models import Unmix
    from xumx_slicq_torch.training import dropout_seed, make_train_step

    counters = {"synth_assembly": synth_assembly, "synth_assembly_backward": synth_assembly_backward,
                "wiener_em": wiener_em, "wiener_em_backward": wiener_em_backward,
                "lstm_recurrence": lstm_recurrence, "lstm_recurrence_backward": lstm_recurrence_backward}
    loader = DataLoader(SyntheticDataset(n_tracks=8, seq_duration=TRAIN_SECONDS, samples_per_track=4, seed=0),
                        TRAIN_BATCH, shuffle=True, seed=0, drop_last=True, workers=4)

    def next_batch():                  # 32 items: each epoch of the loader is one batch
        it = iter(loader)
        batch = torch.from_numpy(next(it)).to(dev)
        it.close()
        return batch

    fixed = next_batch()
    model = Unmix(slicqt.block_shapes(TRAIN_BATCH, 2, int(TRAIN_SECONDS * 44100)), lstm=lstm, seed=0, device=dev)
    n_params = model.num_params()
    check(n_params == (LSTM_PARAMS[False] if lstm else 15010446), f"canonical Unmix has {n_params} parameters")
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-5)
    step, valid = make_train_step(slicqt, model, opt)
    step_sdr, _ = make_train_step(slicqt, model, opt, sdr_mcoef=0.1)
    dropout = torch.Generator(device=dev) if lstm else None

    def run(i, batch, fn):
        if dropout is not None:
            dropout.manual_seed(dropout_seed(42, 1, i))
        return fn(batch, dropout)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    losses, times, per_step = [], [], []
    for i in range(13):
        before = {k: fn.launches for k, fn in counters.items()}
        t0 = time.time()
        loss = run(i, fixed, step) if i < 10 else run(i, next_batch(), step_sdr)
        losses.append(float(loss))                             # waits for the step
        times.append(time.time() - t0)
        per_step.append({k: fn.launches - before[k] for k, fn in counters.items()})
    vloss = float(valid(fixed))
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    wall, busy, n_launches, top, host_top = profiled(lambda: run(13, fixed, step))
    name = "lstm_train_steps" if lstm else "train_steps"
    phase(name, batch=TRAIN_BATCH, seconds=TRAIN_SECONDS, params=n_params, losses=losses, valid_loss=vloss,
          first_step_s=times[0], step_s=times, median_ms_steps_3_10=float(np.median(times[2:10])) * 1e3,
          median_ms_sdr_steps=float(np.median(times[10:])) * 1e3, max_memory_allocated_bytes=peak,
          launches=launches, launches_per_step=per_step, profiled_step_wall_ms=wall,
          device_busy_ms=busy if busy is not None else "not measured",
          device_busy_share=busy / wall if busy is not None else "not measured", kernel_launches=n_launches,
          top_kernels=top, top_host_ops_ms=host_top)
    check(all(np.isfinite(losses)) and np.isfinite(vloss), f"{name}: non-finite loss: {losses}, valid {vloss}")
    check(losses[9] < losses[0], f"{name}: the loss on the fixed batch did not fall: {losses[0]} -> {losses[9]}")
    k5 = 3 if lstm else 0                                      # one launch a layer, forward and backward
    for i, n in enumerate(per_step):
        check(n["wiener_em"] == 3 and n["wiener_em_backward"] == 2, f"step {i + 1}: K2 launches {n}")
        check(n["lstm_recurrence"] == k5 and n["lstm_recurrence_backward"] == k5, f"step {i + 1}: K5 launches {n}")
        sdr = i >= 10
        check((n["synth_assembly_backward"] > 0) == sdr and (n["synth_assembly"] > 0) == sdr,
              f"step {i + 1}: K1 launches {n} (SD-SDR {sdr})")
    path = ["synth_assembly", "wiener_em"] + (["lstm_recurrence"] if lstm else [])
    for name in path:
        check(launches[name] > 0 and launches[name + "_backward"] > 0, f"{name} or its backward was not launched")
    for name in (["lstm_recurrence_backward"] if lstm else ["synth_assembly_backward", "wiener_em_backward"]):
        kernels[name]["launches"] = launches[name]             # each backward kernel's count from its own path


def trainer_cli(dev, clip, lstm: bool = False):
    """training_main on the card with its defaults (bark-262, AdamW,
    plateau schedule; with `lstm`, --lstm), one short epoch, a resume for a
    second, then Separator.load of the directory it wrote and a demix."""
    import shutil

    from xumx_slicq_torch.separator import Separator
    from xumx_slicq_torch.training import training_main

    name = "lstm_trainer_cli" if lstm else "trainer_cli"
    d = ROOT / "build" / f"chip_smoke_{name}"
    shutil.rmtree(d, ignore_errors=True)
    args = ["--synthetic-dataset", "--batch-size", "8", "--epochs", "1", "--max-batches-per-epoch", "3",
            "--debug", "--model-path", str(d), "--quiet"] + (["--lstm"] if lstm else [])
    t0 = time.time()
    train1, valid1 = training_main(args)
    args[args.index("--epochs") + 1] = "2"
    train2, valid2 = training_main(args)
    train_s = time.time() - t0
    sep = Separator.load(model_path=d, device=dev)
    est = sep(clip)
    phase(name, train_loss=train2, valid_loss=valid2, seconds=train_s, lstm=sep.model.lstm,
          files=sorted(p.name for p in d.iterdir()), stems_shape=list(est.shape))
    check(sep.model.lstm == lstm, f"{name}: the trained directory loaded with lstm={sep.model.lstm}")
    check(len(train2) == 2 and train2[:1] == train1 and valid2[:1] == valid1, f"{name}: resume lost the history")
    check(all(np.isfinite(train2 + valid2)), f"{name}: non-finite trainer losses {train2} {valid2}")
    check(est.shape == (4, 1, 2, clip.shape[-1]) and np.isfinite(est).all(), f"{name}: bad stems")
    shutil.rmtree(d, ignore_errors=True)


def cudnn_lstm_backward_ms(layout, xp, w, dh):
    """The yardsticks for K5 in train mode and K5b: the device time of
    cudnn_lstms' forward calls and of their backward calls (data and
    weights, from the cotangent dh of h), each summed."""
    fwd = bwd = 0.0
    for m, seq, k, t, d in cudnn_lstms(layout, xp, w):
        H = layout.hidden[k]
        seq = seq.clone().requires_grad_(True)
        gh = layout.h_blocks(dh)[k][t, :, :, d * H:(d + 1) * H]
        gh = (gh if d == 0 else gh.flip(0)).contiguous()              # walk order
        fwd += cuda_ms(lambda: m(seq), reps=1, warm=1)
        out, _ = m(seq)
        bwd += cuda_ms(lambda: torch.autograd.grad(out, (seq, m.weight_hh_l0), gh, retain_graph=True),
                       reps=1, warm=1)
        del out
    return fwd, bwd


def k5_backward(slicqt, g, kernels):
    """K5's train-mode forward (h and the cell state c) and K5b against their
    plain versions on the card at the training layout (batch 32 of 2 s:
    3,212 steps at most, H up to 43 offline and 86 realtime), K5b from the
    kernel's own h and c; a second K5b run must give the same bits. Per
    layer: K5b's ms (its launch and the sum of its d(W_hh) rows), its byte
    bound and serial floor, the plain versions' ms and cuDNN's."""
    from xumx_slicq_torch.kernels.lstm_recurrence import (lstm_recurrence, lstm_recurrence_backward,
                                                          lstm_recurrence_backward_grouped_plain,
                                                          lstm_recurrence_grouped_plain, lstm_recurrence_with_cell)

    S2 = slicqt.n_slices(int(TRAIN_SECONDS * 44100))
    clock_mhz = max_sm_clock_mhz()
    res = {}
    for realtime in (False, True):
        name = "realtime" if realtime else "offline"
        layout, xp, w = k5_inputs(slicqt, TRAIN_BATCH, S2, realtime, g)
        dh = torch.randn(layout.h_size, generator=g, device=g.device)
        before = (lstm_recurrence.launches, lstm_recurrence_backward.launches)
        h, c = lstm_recurrence_with_cell(xp, w, layout)
        dxp, dw = lstm_recurrence_backward(xp, w, h, c, dh, layout)
        torch.cuda.synchronize()
        check((lstm_recurrence.launches, lstm_recurrence_backward.launches) == (before[0] + 1, before[1] + 1),
              "K5 train-mode forward and K5b: one launch each expected")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        h_ref, c_ref = lstm_recurrence_grouped_plain(xp, w, layout, cell=True)
        end.record()
        end.synchronize()
        fwd_plain_ms = start.elapsed_time(end)
        h_err = float((h - h_ref).abs().max())
        c_rel = float((c - c_ref).abs().max() / c_ref.abs().max())
        del h_ref, c_ref
        start.record()
        dxp_ref, dw_ref = lstm_recurrence_backward_grouped_plain(xp, w, h, c, dh, layout)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        dxp_err = float((dxp - dxp_ref).abs().max())
        dxp_rel = dxp_err / float(dxp_ref.abs().max())
        dw_rel = float((dw - dw_ref).abs().max() / dw_ref.abs().max())
        finite = bool(torch.isfinite(dxp).all() and torch.isfinite(dw).all())
        del dxp_ref, dw_ref
        dxp2, dw2 = lstm_recurrence_backward(xp, w, h, c, dh, layout)
        bit_equal = bool(torch.equal(dxp, dxp2) and torch.equal(dw, dw2))
        del dxp2, dw2
        check(h_err <= K5_TOL and c_rel <= K5_TOL, f"K5 train-mode forward {name}: h err {h_err}, c rel {c_rel}")
        check(finite and dxp_rel <= K5B_TOL and dw_rel <= K5B_TOL,
              f"K5b {name} disagrees with its plain version: d(xp) {dxp_rel}, d(W_hh) {dw_rel} > {K5B_TOL}")
        check(bit_equal, f"K5b {name}: two runs on the same inputs gave different bits")
        ms = cuda_ms(lambda: lstm_recurrence_backward(xp, w, h, c, dh, layout), reps=10)
        serve_ms = cuda_ms(lambda: lstm_recurrence(xp, w, layout), reps=10)
        train_fwd_ms = cuda_ms(lambda: lstm_recurrence_with_cell(xp, w, layout), reps=10)
        cudnn_fwd_ms, cudnn_bwd_ms = cudnn_lstm_backward_ms(layout, xp, w, dh)
        # the function reads xp, h, c, dh and W_hh^T once and writes d(xp) and d(W_hh^T) once. Operations
        # per (sequence, step): the gate recompute (4H x H multiply-adds), dh_rec (the same), d(W_hh) (the
        # same), ~30 a unit for the cell
        nbytes = (2 * layout.xp_size + 3 * layout.h_size + 2 * layout.w_size) * 4
        ops = sum(4 * layout.dirs * layout.batch * n * (24 * hh * hh + 30 * hh)
                  for hh, n in zip(layout.hidden, layout.frames))
        bms, by = bound(nbytes, ops)
        res[name] = dict(max_hidden=max(layout.hidden), max_steps=max(layout.frames), h_max_abs_err=h_err,
                         c_rel_err=c_rel, dxp_max_abs_err=dxp_err, dxp_rel_err=dxp_rel, dw_rel_err=dw_rel,
                         bit_equal_second_run=bit_equal, ms=ms, plain_ms=plain_ms, plain_forward_ms=fwd_plain_ms,
                         forward_serve_ms=serve_ms, forward_train_ms=train_fwd_ms, bound_ms=bms, bound_by=by,
                         gbytes=nbytes / 1e9,
                         serial_floor_ms=max(layout.frames) * STEP_CHAIN_CYCLES_BACKWARD / (clock_mhz * 1e3),
                         cudnn_forward_ms=cudnn_fwd_ms, cudnn_backward_ms=cudnn_bwd_ms)
        del xp, w, dh, h, c, dxp, dw
        torch.cuda.empty_cache()
    phase("k5_backward", tol=K5B_TOL, batch=TRAIN_BATCH, slices=S2, step_chain_cycles=STEP_CHAIN_CYCLES_BACKWARD,
          max_sm_clock_mhz=clock_mhz, **res)
    off = res["offline"]
    kernels["lstm_recurrence_backward"] = dict(
        name="lstm_recurrence_backward", route="cuda", source="xumx_slicq_torch/csrc/lstm_recurrence.cu",
        replaces="xumx_slicq_tpu/training.py:273", max_abs_err=off["dxp_max_abs_err"], ms=off["ms"],
        plain_ms=off["plain_ms"], bound_ms=off["bound_ms"], bound_by=off["bound_by"],
        library_ms=off["cudnn_backward_ms"])


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
    from xumx_slicq_torch.kernels.wiener_em import (_device_tables, stability_scale, wiener_em, wiener_em_grouped,
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
    tables = _device_tables(layout, xk.device)                 # K2's tables, built by the call above
    parts = torch.empty((tables["items1"].shape[0], 16), dtype=torch.float32, device=dev)
    maxima = torch.zeros(len(layout.shapes), dtype=torch.float32, device=dev)
    yk = torch.empty(4 * layout.size, dtype=torch.complex64, device=dev)
    pass1_ms = cuda_ms(lambda: (maxima.zero_(), triton_wiener_em.pass1(xk, vk, tables, parts, maxima)), reps=20)
    pass2_ms = cuda_ms(lambda: triton_wiener_em.pass2(xk, vk, tables, parts, maxima, yk), reps=20)
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
    del sep, sep_rt

    # -- phases 9-14: the LSTM variant, K5 --------------------------------------
    k5_lstm_recurrence(slicqt, g, kernels, batch, S)
    torch.cuda.empty_cache()
    sep_lstm = lstm_separator_cuda_vs_cpu(slicqt, dev, rng)
    lstm_track_236s(sep_lstm, track, kernels, batch)
    del sep_lstm
    lstm_realtime_track_236s(slicqt, dev, track, batch)
    del track
    lstm_realtime(slicqt, dev, clip)
    torch.cuda.empty_cache()
    lstm_linear262(dev, rng, g)
    torch.cuda.empty_cache()

    # -- phases 15-19: the backward kernels and the training path ------------
    k1_backward(slicqt, g, kernels)
    k2_backward(slicqt, g, kernels)
    torch.cuda.empty_cache()
    train_cuda_vs_cpu(dev)
    train_steps(dev, slicqt, kernels)
    torch.cuda.empty_cache()
    trainer_cli(dev, clip)

    # -- phases 20-23: training the LSTM variant, K5b ---------------------------
    torch.cuda.empty_cache()
    k5_backward(slicqt, g, kernels)
    train_cuda_vs_cpu(dev, lstm=True)
    train_steps(dev, slicqt, kernels, lstm=True)
    torch.cuda.empty_cache()
    trainer_cli(dev, clip, lstm=True)

    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms"]
    print(card)
    print(json.dumps({"kernels": [{k: kern[k] for k in order} for kern in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
