#!/usr/bin/env python3
"""Smoke run of the PyTorch port (xumx_slicq_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from this checkout (K1, K3, K4 and K5 with nvcc
into build/xumx_slicq_torch/, K2 with Triton), holds each against its plain
PyTorch version at the shapes of the main path (K2 as one grouped call
over all 70 buckets of the packed layout; K3, the analysis gather and
weight of all 70 buckets in one launch, also at the train step's two
layouts; K4, the folded CDAE of all 70 buckets in four launches on the
tensor cores (3xTF32), offline and realtime, each launch timed beside its
tensor-core bound, the fp32 CUDA-core one and cuDNN), checks the canonical
bark-262 transform round trip on the card, runs the full-width offline
Separator on the card and on the CPU and compares the stems, demixes a
seeded 236 s stereo track (the MUSDB18-HQ test-set average length) with
launch counts and timings (K4 once a layer; no cuDNN conv kernel in its
profile), and runs the realtime Separator on the card against the CPU and
on the 236 s track. Then the
LSTM variant: K5 (CUDA C++, the LSTM recurrence) against its plain version
over all 70 buckets offline and realtime, at 2 s and at the main path's
layout, timed there beside cuDNN's LSTM and per hidden size (ns a step of
each group's longest chain), its error against a float64 walk (offline), the
canonical LSTM Separator on the card against the CPU, the 236 s track
through it offline and realtime, its realtime model once, and the LSTM at
--fscale linear --fbins 262 (H = 132 and 263) on the card against the CPU.
Then the training path: K1's and K2's backward kernels against their plain versions
at the training shapes (K2's with each pass's registers, spills and TB/s),
one train step on the card against the CPU at mel-12, 13 full-width train
steps (batch 32 of 2.0 s) with launch counts,
memory and a profile, and the trainer's CLI with a resume and a reload.
Last, training the LSTM variant: K5's train-mode forward and K5b (its
backward through time) against their plain versions at the training
layout, offline and realtime, timed beside cuDNN's LSTM and per hidden
size; one LSTM train
step on the card against the CPU at mel-12; 13 canonical LSTM train steps
with K5 and K5b launches counted; and the trainer's CLI with --lstm.
Then evaluation: the BSS-eval v4 engine on the card against the float64
host engine on a 30 s pair, int16 staging, and a 236 s pair timed with its
peak memory; evaluation_main over a synthetic tree of two 30 s tracks in
its three scoring modes; and bench_torch.py (the default mode and the
device-resident evaluation throughput) in processes of their own.
Last, the tools: the canonical offline CDAE and LSTM models exported with
torch.export at one default chunk (K1, K2 and K5 as registered ops), each
artifact loaded in a fresh process and held to Separator._chunk_fn with
its launches per call (K3 and K1 once, K2 3 times, K5 3 times for the
LSTM); the oracle sliCQT search over 6 seeded configs on
the card, one config's oracle SDR against the CPU; two tuning trials at
bark-262; and utils.profile_stats held to torch.profiler's own totals on
the track's profile. Then several devices and ranks: the 236 s track
through Separator(devices=[card, card]) against the single-device stems
(after the track's phases); the canonical CDAE's weights written as the
JAX package's params.msgpack and served from it against the .pth route;
entry()'s forward step on the card; the trainer's step on 2 ranks sharing
the card over gloo, data-parallel (the CDAE at batch 32 of 2 s and the
LSTM at a small batch) and target-parallel (tp = 2), against the same steps
in one process, with step and collective times, each rank's memory and
launches; and the Cadenza runner (enhance, HAAQI in 2 shards, merge) for
one seeded 10 s song and 2 listeners. The chunk batches as the JAX
package forms them: the canonical LSTM over Separator(devices=[card,
card]) on the 236 s track and a one-chunk clip (each wave one chunk batch
on the first replica), and the first card's widest wave at 4 devices (32
chunks); the CDAE's and the LSTM's forward_device on 9 default chunks
(waves of 8 and 1), each against _chunk_fn on the same zero-padded wave
batches; the dp step's collectives a step (one per BatchNorm each way,
its moments merged in two passes); and one canonical CDAE and LSTM train
step on an all-zero batch (finite loss and parameters, the backward
kernels launched). Weights are random, drawn from a seed. Any failed check
exits non-zero.

    python3 chip_smoke.py --phases export_cdae,slicqfinder

runs only the named phases after the build (k3_analysis_gather, k4_cdae,
export_cdae, export_lstm, slicqfinder, tuning, profile_stats, separator_devices, msgpack_weights,
entry, mesh, cadenza, separator_devices_lstm, lstm_forward_device_waves,
cdae_forward_device_waves, silent_train_step; and on a machine with
several cards mesh_cards and separator_devices_cards, one rank or replica
a card, NCCL), for development, and prints no result line.

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
TF32_FLOPS = 495e12             # H100 SXM dense TF32 on the tensor cores (data sheet)
TRACK_SECONDS = 236             # MUSDB18-HQ test-set average track length
K1_TOL = 1e-5                   # max |kernel - plain| / max |plain|: same sums, FMA contraction
K3_TOL = 1e-6                   # K3, per bucket, max |kernel - plain| / max |plain|: one complex product an output
K2_TOL = 1e-4                   # same, per bucket: fp32 division/sqrt rounding through the 2x2 inverse
ROUNDTRIP_TOL = 1e-5            # transform round trip on unit-variance noise
# K4 against its plain version (cuDNN convs, TF32 off) on the same packed inputs, max |mask_kernel - mask_plain|
# with masks in (0, 1): 3xTF32 products (fp32 accuracy) summed in fp32, up to 1,024 steps a layer in another
# order, through four layers
K4_TOL = 1e-5
# names of cuDNN's conv kernels and their layout helpers in a profile (the CDAE before K4: PERF.md section 5)
CUDNN_CONV_MARKERS = ("cudnn", "genericTranspose", "dgrad", "wgrad", "fprop", "scaleTensor", "implicit_convolve",
                      "convolve_", "conv2d")
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
# One K5b step's dependent chain at H = 1 in SM cycles, timed on an H100 with clock64 (tools/k5_ab.py --latency,
# k5b_step_h1_kernel: 29.8): csrc/lstm_recurrence.cu's cell_chain_ and rec_contributions, dh = dh_out + dh_rec,
# dc = dc_rec + dh kd, the gate gradients, dh_rec's two-deep FMA tree. The gate recompute reads only saved values
# and lies off the chain (the previous design's arithmetic of the same chain: 45.0)
STEP_CHAIN_CYCLES_BACKWARD = 30
# LSTM train step, card against CPU at mel-12: gradients ||cuda - cpu|| / max(||cpu||, 1e-2 of the largest
# norm) per tensor. Train-mode BatchNorm after the LSTM leaves some gradients (the last layer's biases, the
# whitening) small remainders of cancelling sums, whose float32 rounding reaches 1e-5 of the largest norm
LSTM_GRAD_FLOOR = 1e-2
# BSS-eval v4 on the card (float32, ridge 1e-7) against the float64 host engine (ridge 1e-10), per window in dB:
# the bound tests/test_bsseval.py:102 holds the JAX package's device engine to; also the evaluator's modes'
# aggregate SDR
BSS_TOL_DB = 0.1
BSS_STAGING_TOL_DB = 1e-4       # int16 staged and scaled on the card against float32 = int16 / 32768 (exact)
# A reloaded torch.export artifact against Separator._chunk_fn on the same chunk, max abs diff on 0.1-RMS input:
# the same ops on the same weights in another process (cuDNN may pick other conv algorithms there); the bound
# tests/test_export.py holds the JAX package's artifacts to
EXPORT_TOL = 1e-5
EXPORT_CHUNK = 2621440          # the Separator's default chunk, one artifact at batch 1
# The oracle SDR of one config on the card against the port on the CPU, mean over segments, in dB: stems that
# agree to ~1e-6 of their scale move an SDR of ~10-20 dB by far less
ORACLE_SDR_TOL_DB = 1e-3
# utils.profile_stats against torch.profiler's key_averages on the same profile: device ms and events; the
# stages' sum against the total
PROFILE_TOL = 0.01


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


T0 = time.time()


def phase(name: str, **fields):
    print(json.dumps({"phase": name, "elapsed_s": round(time.time() - T0, 1), **fields}), flush=True)


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
    from xumx_slicq_torch.utils.profile_stats import top

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
    agg = profile_aggregate(prof, name)
    busy_ms = agg["device_ms"]
    phase(name, stage_device_ms=stages, profiled_wall_ms=wall * 1e3,
          device_busy_ms=busy_ms if busy_ms else "not measured",
          device_busy_share=busy_ms / (wall * 1e3) if busy_ms else "not measured",
          kernel_launches=agg["device_events"], profile_stage_device_ms=agg["stages_device_ms"],
          k2_kernels=[[k[:60], c, ms] for k, (c, ms) in agg["kernels"].items() if "_em_pass" in k],
          k4_kernels=[[k[:60], c, ms] for k, (c, ms) in agg["kernels"].items() if "cdae_layer" in k],
          top_kernels=[[k[:60], c, ms] for k, c, ms in top(agg["kernels"], 10)])
    if model == "cdae":   # the folded CDAE runs as K4: no cuDNN conv, layout transpose or scaling kernel
        conv = [k for k, _, _ in top(agg["kernels"], 10) if any(m in k for m in CUDNN_CONV_MARKERS)]
        check(not conv, f"{name}: cuDNN conv kernels among the demix's top kernels: {conv}")
    return prof, agg


def profile_aggregate(prof, name: str) -> dict:
    """The profile as a Chrome trace under build/, aggregated by
    xumx_slicq_torch.utils.profile_stats (device self-time per kernel and
    per record_function stage, host self-time per op)."""
    from xumx_slicq_torch.utils.profile_stats import summarize

    path = ROOT / "build" / "chip_smoke_profiles" / f"{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return summarize(path)


def profiled(fn, name: str):
    """(wall ms, device busy ms or None, device launches, top 10 device
    entries, top 8 host ops by self time) of one call of fn, from
    torch.profiler, aggregated by utils.profile_stats."""
    from torch.profiler import ProfilerActivity, profile

    from xumx_slicq_torch.utils.profile_stats import top

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    agg = profile_aggregate(prof, name)
    return (wall, agg["device_ms"] or None, agg["device_events"],
            [[k[:60], c, ms] for k, c, ms in top(agg["kernels"], 10)],
            [[k[:60], c, ms] for k, c, ms in top(agg["host_ops"], 8)])


def k3_analysis_gather(slicqt, g, kernels, batch: int, chunk: int):
    """K3 against its plain version (the per-bucket loop it replaced) at the
    inference layout (a chunk batch of `batch` default chunks, stereo) and
    at the train step's two calls (32 mixtures and 128 targets of 2.0 s),
    per bucket to K3_TOL, each timed beside the plain version and its bound;
    then SliCQT.forward at the inference layout: its K3 launches (one a
    call), its ms and its device launches from one profiled call."""
    from xumx_slicq_torch.kernels.analysis_gather import analysis_gather, analysis_gather_plain
    from xumx_slicq_torch.ops.packed import PackedBlocks

    dev = slicqt.device
    table = slicqt.analysis_table
    K = table.K
    src = table.entries[:, 0].cpu().numpy()
    positions = int(np.unique(np.where(src < 0, ~src, src)).size)   # half-spectrum positions K3 reads
    train_len = int(TRAIN_SECONDS * 44100)
    res = {}
    for name, B, length in (("inference", batch, chunk), ("train_mixtures", TRAIN_BATCH, train_len),
                            ("train_targets", 4 * TRAIN_BATCH, train_len)):
        with torch.inference_mode():
            X = slicqt.half_spectrum(torch.randn((B, 2, length), generator=g, device=dev))
            N, S = B * 2, X.shape[2]
            layout = slicqt.layout(B, 2, S)
            ref = PackedBlocks(torch.empty(layout.size, dtype=torch.complex64, device=dev), layout)
            analysis_gather_plain(X, slicqt.forward_tables, ref)
            before = analysis_gather.launches
            out = analysis_gather(X, table)
            torch.cuda.synchronize()
            check(analysis_gather.launches == before + 1, f"K3 {name}: one call launched "
                  f"{analysis_gather.launches - before} kernels")
            err, rel = 0.0, 0.0
            for a, b in zip(PackedBlocks(out, layout), ref):
                e = float((a - b).abs().max())
                err, rel = max(err, e), max(rel, e / float(b.abs().max()))
            del out
            ms = cuda_ms(lambda: analysis_gather(X, table), reps=20)
            plain_ms = cuda_ms(lambda: analysis_gather_plain(X, slicqt.forward_tables, ref), reps=3, warm=1)
        # read each half-spectrum position once per (row, slice), the table and both
        # parities' weights once; write every coefficient once. 6 fp32 operations an output
        nbytes = N * S * positions * 8 + K * (16 + 16) + N * S * K * 8
        b_ms, b_by = bound(nbytes, N * S * K * 6)
        res[name] = dict(rows=N, slices=S, coefficients=N * S * K, max_abs_err=err, rel_err=rel, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
                         gbytes=nbytes / 1e9)
        check(rel <= K3_TOL, f"K3 {name} disagrees with its plain version: rel err {rel} > {K3_TOL} per bucket")
        del X, ref
    a = torch.randn((batch, 2, chunk), generator=g, device=dev) * 0.1
    with torch.inference_mode():
        before = analysis_gather.launches
        slicqt.forward(a)
        torch.cuda.synchronize()
        per_forward = analysis_gather.launches - before
        forward_ms = cuda_ms(lambda: slicqt.forward(a), reps=5)
        wall, busy, n_launches, top, _ = profiled(lambda: slicqt.forward(a), "k3_slicqt_forward")
    phase("k3_analysis_gather", buckets=len(slicqt.buckets), K=K, positions_read=positions, tol=K3_TOL, **res,
          slicqt_forward=dict(k3_launches_per_call=per_forward, ms=forward_ms, profiled_wall_ms=wall,
                              device_busy_ms=busy if busy is not None else "not measured",
                              device_launches=n_launches, top_kernels=top))
    check(per_forward == 1, f"SliCQT.forward launched K3 {per_forward} times, expected 1")
    inf = res["inference"]
    kernels["analysis_gather"] = dict(
        name="analysis_gather", route="cuda", source="xumx_slicq_torch/csrc/analysis_gather.cu",
        replaces="xumx_slicq_tpu/ops/slicqt.py:678", max_abs_err=max(r["max_abs_err"] for r in res.values()),
        ms=inf["ms"], plain_ms=inf["plain_ms"], bound_ms=inf["bound_ms"], bound_by=inf["bound_by"], library_ms=None)


K4_LAYERS = ("enc1", "enc2", "dec1", "dec2")


def k4_counters() -> dict:
    """K4's launch counters, one a layer (`cdae_conv.counters`), by kernel name."""
    from xumx_slicq_torch.kernels.cdae_conv import counters

    return {f"cdae_{name}": c for name, c in counters.items()}


def perturbed(model, seed: int = 1):
    """`model`, a CDAE Unmix, with each bucket's BatchNorm statistics and
    affines and its whitening drawn off their defaults from `seed`: at a
    fresh model's, the folded biases are 0 and the whitening is the
    identity, so a kernel that misread them would pass. The same draws on
    any device, so a card's model and a CPU's stay equal."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for blk in model.blocks:
            for bn in (blk.bn1, blk.bn2, blk.bn3):
                for t, lo, hi in ((bn.running_mean, -0.1, 0.1), (bn.running_var, 0.6, 1.6),
                                  (bn.weight, 0.8, 1.2), (bn.bias, -0.1, 0.1)):
                    t.copy_(torch.empty(t.shape).uniform_(lo, hi, generator=g))
            blk.input_mean.copy_(torch.empty(blk.input_mean.shape).uniform_(-0.2, 0.0, generator=g))
            blk.input_scale.copy_(torch.empty(blk.input_scale.shape).uniform_(0.5, 2.0, generator=g))
    return model


def k4_work(layout, arch, realtime: bool) -> dict:
    """Per K4 layer, (MACs, bytes) of this layout: MACs each input activation
    times each kernel weight it meets (no padding, no border zeros), bytes
    each input read once (the complex mixture 8 B a value) and each output
    written once (dec2 writes masks and magnitudes), weights included."""
    from xumx_slicq_torch.kernels.cdae_conv import _offsets

    n, h1, h2, tf2 = arch.targets, arch.h1, arch.h2, arch.tf2
    work = {name: [0, 0] for name in K4_LAYERS}
    wbytes = {name: 0 for name in K4_LAYERS}
    for o in _offsets(arch):
        for name, (_, R, _, N, _, _) in o["layers"].items():
            wbytes[name] += 4 * n * R * N
    for (B, C, F, S, T), (_, _, _, fphi) in zip(layout.shapes, arch.buckets):
        F1, K1 = F - fphi + 1, 2 * S if realtime else 2 * S - 1
        F2, K2 = F1 - fphi + 1, K1 - tf2 + 1
        a0, a1, a2 = B * C * F * S * T, B * n * h1 * F1 * K1, B * n * h2 * F2 * K2
        for name, macs, nbytes in (("enc1", a1 * C * fphi * T, 8 * a0 + 4 * a1),
                                   ("enc2", a2 * h1 * fphi * tf2, 4 * a1 + 4 * a2),
                                   ("dec1", a2 * h1 * fphi * tf2, 4 * a2 + 4 * a1),
                                   ("dec2", a1 * C * fphi * T, 4 * a1 + 8 * a0 + 2 * 4 * n * a0)):
            work[name][0] += macs
            work[name][1] += nbytes
    return {k: (m, b + wbytes[k]) for k, (m, b) in work.items()}


def k4_bound(nbytes: float, macs: float):
    """(bound_ms, bound_by) of a K4 layer on the tensor cores: 3xTF32 does
    three TF32 products a MAC."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, 3 * 2 * macs / TF32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def plain_layers_ms(X, weights, layout, realtime: bool) -> dict:
    """Per K4 layer, (plain ms, library ms) over every bucket at this layout,
    device time: the plain version's layer (`cdae_conv.plain_layers`, enc1
    with |X|, dec2 with mask x |X|; cuDNN with TF32 off), and cuDNN's
    conv2d / conv_transpose2d alone (with bias): the library's way to
    compute the layer. Each layer's input comes from the plain version."""
    import torch.nn.functional as Fn

    from xumx_slicq_torch.kernels.cdae_conv import plain_layers, unpack_weights

    n = weights.arch.targets
    plain = {name: [] for name in K4_LAYERS}
    library = {name: [] for name in K4_LAYERS}
    params = unpack_weights(weights.w, weights.arch)
    with torch.inference_mode():
        for xb, p, (B, C, F, S, T) in zip(layout.split(X), params, layout.shapes):
            hop = T // 2
            layers = dict(zip(K4_LAYERS, plain_layers(p, realtime, n, S, T)))
            x = ((xb.abs() + p["input_mean"][None, None, :, None, None])      # enc1's conv input
                 * p["input_scale"][None, None, :, None, None]).reshape(B, C, F, S * T)
            x = Fn.pad(x, (T - 1, 0)) if realtime else x
            h1 = layers["enc1"](xb.abs())
            h2 = layers["enc2"](h1)
            h3 = layers["dec1"](h2)
            convs = {
                "enc1": lambda x, p=p, hop=hop: Fn.conv2d(x, p["enc1_w"], p["enc1_b"], stride=(1, hop)),
                "enc2": lambda h, p=p: Fn.conv2d(h, p["enc2_w"], p["enc2_b"], groups=n),
                "dec1": lambda h, p=p: Fn.conv_transpose2d(h, p["dec1_w"], p["dec1_b"], groups=n),
                "dec2": lambda h, p=p, hop=hop: Fn.conv_transpose2d(h, p["dec2_w"], p["dec2_b"], stride=(1, hop),
                                                                    groups=n),
            }
            for name, h in (("enc1", x), ("enc2", h1), ("dec1", h2), ("dec2", h3)):
                library[name].append(lambda f=convs[name], h=h: f(h))
            plain["enc1"].append(lambda f=layers["enc1"], xb=xb: f(xb.abs()))
            plain["enc2"].append(lambda f=layers["enc2"], h=h1: f(h))
            plain["dec1"].append(lambda f=layers["dec1"], h=h2: f(h))
            plain["dec2"].append(lambda f=layers["dec2"], h=h3, xb=xb: f(h) * xb.abs()[None])
        out = {name: (cuda_ms(lambda fs=plain[name]: [f() for f in fs], reps=2, warm=1),
                      cuda_ms(lambda fs=library[name]: [f() for f in fs], reps=2, warm=1)) for name in K4_LAYERS}
    del plain, library
    torch.cuda.empty_cache()
    return out


def k4_cdae(slicqt, g, kernels, batch: int, chunk: int):
    """K4 against its plain version (the per-bucket module code, cuDNN with
    TF32 off) at the inference layout (a chunk batch of `batch` default
    chunks from SliCQT.forward of 0.1-RMS noise), offline and realtime: the
    masks' and magnitudes' errors, each launch's ms (CUDA events around the
    four launches) against its bound, and the plain version's and cuDNN's ms,
    whole and per layer over the buckets. BatchNorm statistics and whitening
    are drawn off their defaults (`perturbed`)."""
    from xumx_slicq_torch.kernels import cdae_conv
    from xumx_slicq_torch.models import Unmix

    dev = slicqt.device
    shapes = slicqt.block_shapes(1, 2, 2 * 44100)
    a = torch.randn((batch, 2, chunk), generator=g, device=dev) * 0.1
    with torch.inference_mode():
        X = slicqt.forward(a)
    layout = X.layout
    res = {}
    for realtime in (False, True):
        name = "realtime" if realtime else "offline"
        model = perturbed(Unmix(shapes, realtime=realtime, seed=0, device=dev))
        weights = model.inference_weights()
        plan, items, rtab, sizes = cdae_conv._device_tables(layout, weights.arch, realtime, dev)
        with torch.inference_mode():
            before = {k: c.launches for k, c in cdae_conv.counters.items()}
            mags, masks = cdae_conv.cdae_folded(X.packed, weights, layout, realtime)
            torch.cuda.synchronize()
            per_call = {k: c.launches - before[k] for k, c in cdae_conv.counters.items()}
            ref_mags, ref_masks = cdae_conv.cdae_folded_plain(X.packed, weights.w, layout, weights.arch, realtime)
            torch.cuda.synchronize()
            err = float((masks - ref_masks).abs().max())
            mag_err = float((mags - ref_mags).abs().max())
            mag_rel = mag_err / float(ref_mags.abs().max())
            finite = bool(torch.isfinite(masks).all() and torch.isfinite(mags).all())
            del mags, masks, ref_mags, ref_masks
            events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            per_layer = {k: [] for k in K4_LAYERS}
            total = []
            for _ in range(6):
                cdae_conv.launch(X.packed, weights.w, plan, items, rtab, layout, weights.arch.targets, sizes, events)
                torch.cuda.synchronize()
                for i, k in enumerate(K4_LAYERS):
                    per_layer[k].append(events[i].elapsed_time(events[i + 1]))
                total.append(events[0].elapsed_time(events[4]))
            ms = cuda_ms(lambda: cdae_conv.cdae_folded(X.packed, weights, layout, realtime), reps=10)
            plain_ms = cuda_ms(lambda: cdae_conv.cdae_folded_plain(X.packed, weights.w, layout, weights.arch,
                                                                   realtime), reps=2, warm=1)
        per_layer_plain = plain_layers_ms(X.packed, weights, layout, realtime)
        layers = {}
        for k, (macs, nbytes) in k4_work(layout, weights.arch, realtime).items():
            b_ms, b_by = k4_bound(nbytes, macs)
            fp32_ms = bound(nbytes, 2 * macs)[0]
            k_ms = float(np.median(per_layer[k][1:]))
            layers[k] = dict(items=sizes[K4_LAYERS.index(k)], gmac=macs / 1e9, gbytes=nbytes / 1e9,
                             bound_ms=b_ms, bound_by=b_by, ms=k_ms, share_of_bound=b_ms / k_ms,
                             fp32_bound_ms=fp32_ms, share_of_fp32_bound=fp32_ms / k_ms,
                             plain_ms=per_layer_plain[k][0], library_ms=per_layer_plain[k][1], runs_ms=per_layer[k])
        res[name] = dict(launches_per_call=per_call, max_abs_err=err, mags_max_abs_err=mag_err,
                         mags_rel_err=mag_rel, finite=finite, ms=ms, four_launches_ms=float(np.median(total[1:])),
                         plain_ms=plain_ms, library_ms=sum(v[1] for v in per_layer_plain.values()),
                         bound_ms=sum(v["bound_ms"] for v in layers.values()),
                         fp32_bound_ms=sum(v["fp32_bound_ms"] for v in layers.values()), layers=layers,
                         bound_arithmetic=f"bound = max(bytes / {HBM_BYTES_PER_S:.3g} B/s, 3 x 2 MACs / "
                                          f"{TF32_FLOPS:.3g} FLOP/s: 3xTF32 on the tensor cores) a layer, summed; "
                                          f"fp32_bound = max(bytes / {HBM_BYTES_PER_S:.3g} B/s, 2 MACs / "
                                          f"{FP32_FLOPS:.3g} FLOP/s: fp32 on the CUDA cores)")
        check(finite, f"K4 {name}: non-finite masks or magnitudes")
        check(per_call == dict.fromkeys(K4_LAYERS, 1), f"K4 {name}: one call launched {per_call}")
        check(err <= K4_TOL, f"K4 {name} disagrees with its plain version: masks max abs err {err} > {K4_TOL}")
        check(mag_rel <= K4_TOL, f"K4 {name}: magnitudes rel err {mag_rel} > {K4_TOL}")
        del model, weights
        torch.cuda.empty_cache()
    phase("k4_cdae", buckets=len(layout.shapes), batch=batch, slices=layout.shapes[0][3], tol=K4_TOL, **res)
    off = res["offline"]
    for k in K4_LAYERS:
        lay = off["layers"][k]
        kernels[f"cdae_{k}"] = dict(
            name=f"cdae_{k}", route="cuda", source="xumx_slicq_torch/csrc/cdae_conv.cu",
            replaces={"enc1": "xumx_slicq_tpu/models/cdae.py:150", "enc2": "xumx_slicq_tpu/models/cdae.py:227",
                      "dec1": "xumx_slicq_tpu/models/cdae.py:231", "dec2": "xumx_slicq_tpu/models/cdae.py:112"}[k],
            max_abs_err=max(res[m]["max_abs_err"] for m in res), ms=lay["ms"], plain_ms=lay["plain_ms"],
            bound_ms=lay["bound_ms"], bound_by=lay["bound_by"], library_ms=lay["library_ms"])


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
    compiled = {"pass1": triton_wiener_em.backward_pass1(x, v, gy, tables, parts, maxima, gpart),
                "pass2": triton_wiener_em.backward_pass2(x, v, gy, tables, parts, maxima, gpart, gv)}
    plain_ms = cuda_ms(lambda: wiener_em_backward_plain(x, v, gy, layout), reps=3, warm=1)
    positions = layout.size // 2
    # each pass reads x, v and gy (112 B a position); pass 2 also writes dL/dv (32 B)
    passes = {name: dict(ms=t, n_regs=getattr(compiled[name], "n_regs", "not read"),
                         n_spills=getattr(compiled[name], "n_spills", "not read"),
                         tbytes_per_s=positions * nb / (t * 1e-3) / 1e12)
              for name, t, nb in (("pass1", pass1_ms, 112), ("pass2", pass2_ms, 144))}
    # per position: read x (16 B), v (32 B) and gy (64 B), write dL/dv (32 B); ~700 fp32
    # operations per position, counted from the plain version. Both passes read the three inputs.
    bms, by = bound(positions * 144, positions * 700)
    phase("k2_backward", buckets=len(layout.shapes), batch=TRAIN_BATCH, positions=positions, max_abs_err=err,
          rel_err=rel, rel_err_vs_autograd=rel_autograd, tol=K2B_TOL, ms=ms, passes=passes, plain_ms=plain_ms,
          bound_ms=bms, bound_by=by, two_pass_floor_ms=positions * 256 / HBM_BYTES_PER_S * 1e3,
          gbytes=positions * 144 / 1e9)
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


def _buckets_alone(layout, ks):
    """The layout of the buckets ks alone, and take(packed, kind) that cuts a
    packed buffer of `kind` ("xp", "h" or "w") down to those buckets."""
    sub = type(layout)([layout.hidden[k] for k in ks], [layout.frames[k] for k in ks], layout.batch, layout.dirs)
    spans = {"xp": (layout.xp_offsets, layout.xp_sizes), "h": (layout.h_offsets, layout.h_sizes),
             "w": (layout.w_offsets, layout.w_sizes)}

    def take(t, kind):
        offs, lens = spans[kind]
        return torch.cat([t[offs[k]: offs[k] + lens[k]] for k in ks])
    return sub, take


def k5_per_hidden(layout, xp, w, clock_mhz: float):
    """K5 on the buckets of each hidden size alone (a layout of those
    buckets, at their lengths): per H the buckets, the longest chain, the
    launch's ms and ns (and cycles at the max SM clock) per step of that
    chain."""
    from xumx_slicq_torch.kernels.lstm_recurrence import lstm_recurrence

    rows = {}
    for H in sorted(set(layout.hidden)):
        sub, take = _buckets_alone(layout, [k for k, h in enumerate(layout.hidden) if h == H])
        xs, ws = take(xp, "xp"), take(w, "w")
        ms = cuda_ms(lambda: lstm_recurrence(xs, ws, sub), reps=3, warm=1)
        steps = max(sub.frames)
        rows[H] = dict(buckets=len(sub.hidden), steps=steps, ms=ms, ns_per_step=ms * 1e6 / steps,
                       cycles_per_step=ms * 1e3 * clock_mhz / steps)
    return rows


def k5b_per_hidden(layout, xp, w, h, c, dh, clock_mhz: float):
    """K5b on the buckets of each hidden size alone (as k5_per_hidden): per H
    the buckets, the longest chain, the launch's ms (with the sum of its
    d(W_hh) rows) and ns (and cycles at the max SM clock) a step of that
    chain."""
    from xumx_slicq_torch.kernels.lstm_recurrence import lstm_recurrence_backward

    rows = {}
    for H in sorted(set(layout.hidden)):
        sub, take = _buckets_alone(layout, [k for k, hh in enumerate(layout.hidden) if hh == H])
        args = (take(xp, "xp"), take(w, "w"), take(h, "h"), take(c, "h"), take(dh, "h"), sub)
        ms = cuda_ms(lambda: lstm_recurrence_backward(*args), reps=3, warm=1)
        steps = max(sub.frames)
        rows[H] = dict(buckets=len(sub.hidden), steps=steps, ms=ms, ns_per_step=ms * 1e6 / steps,
                       cycles_per_step=ms * 1e3 * clock_mhz / steps)
    return rows


def k5_error_f64(layout, xp, w, ks):
    """K5 on the buckets ks alone against the grouped plain walk in float64
    on the card: per bucket (H, steps, max |h_kernel - h_f64|)."""
    from xumx_slicq_torch.kernels.lstm_recurrence import lstm_recurrence, lstm_recurrence_grouped_plain

    sub, take = _buckets_alone(layout, ks)
    xs, ws = take(xp, "xp"), take(w, "w")
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
    longest chain), and, offline, K5's error on the longest chain and on the
    widest bucket against a float64 walk."""
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
        # against a float64 walk on the main path's layout only: the walk takes as long as the plain one
        f64 = [] if realtime else k5_error_f64(layout, xp, w, [longest, widest])
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
    so K5 launches once per layer, 3 times, K3 once; K2 and K1 on the path
    too."""
    counters = _lstm_path_counters()
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
    check(launches["analysis_gather"] == 1, f"K3 made {launches['analysis_gather']} launches for one chunk batch, "
          "expected 1")
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
    from xumx_slicq_torch.kernels.analysis_gather import analysis_gather
    from xumx_slicq_torch.kernels.lstm_recurrence import lstm_recurrence, lstm_recurrence_backward
    from xumx_slicq_torch.kernels.synth_assembly import synth_assembly, synth_assembly_backward
    from xumx_slicq_torch.kernels.wiener_em import wiener_em, wiener_em_backward
    from xumx_slicq_torch.models import Unmix
    from xumx_slicq_torch.training import dropout_seed, make_train_step

    counters = {"synth_assembly": synth_assembly, "synth_assembly_backward": synth_assembly_backward,
                "wiener_em": wiener_em, "wiener_em_backward": wiener_em_backward,
                "lstm_recurrence": lstm_recurrence, "lstm_recurrence_backward": lstm_recurrence_backward,
                "analysis_gather": analysis_gather}
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
    name = "lstm_train_steps" if lstm else "train_steps"
    wall, busy, n_launches, top, host_top = profiled(lambda: run(13, fixed, step), name)
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
        check(n["analysis_gather"] == 2, f"step {i + 1}: K3 launches {n}, expected 2 (mixture and targets)")
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
            "--debug", "--model-path", str(d), "--quiet", "--n-devices", "1"] + (["--lstm"] if lstm else [])
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
    bound and serial floor, the plain versions' ms and cuDNN's; per hidden
    size, K5b alone (tools/k5_ab.py --walk-only times its walk without the
    separate d(W_hh) pass)."""
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
                         cudnn_forward_ms=cudnn_fwd_ms, cudnn_backward_ms=cudnn_bwd_ms,
                         per_hidden=k5b_per_hidden(layout, xp, w, h, c, dh, clock_mhz))
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


def bsseval_device(dev, card: str):
    """The BSS-eval v4 engine on the card (ops/bsseval.DeviceBssEval,
    float32: cuFFT, cuBLAS, cuSOLVER) against the port's float64 host
    engine on a 30 s separation-like 4-stem stereo pair, int16 staging
    against float staging, then a 236 s pair already on the card: ms a
    track, peak memory and the host rescorings of non-finite scores."""
    from xumx_slicq_torch.ops.bsseval import DeviceBssEval, bss_eval_images, eval_track_device

    rng = np.random.default_rng(3)
    n = 30 * 44100
    refs = (rng.standard_normal((4, n, 2)) * 0.1).astype(np.float32)
    mixing = np.eye(4) + 0.1 * rng.uniform(size=(4, 4))     # each estimate leaks the other stems
    ests = (np.einsum("ij,jnc->inc", mixing, refs) + 0.02 * rng.standard_normal(refs.shape)).astype(np.float32)
    eng = DeviceBssEval(device=dev)
    t0 = time.time()
    host = bss_eval_images(refs, ests)
    host_s = time.time() - t0
    card_scores = eng(refs, ests)
    err = max(float(np.abs(card_scores[m] - host[m]).max()) for m in host)
    refs_i16 = (refs * 32768.0).clip(-32768, 32767).astype(np.int16)
    a, b = eng(refs_i16, ests), eng(refs_i16.astype(np.float32) / 32768.0, ests)
    staging_err = max(float(np.abs(a[m] - b[m]).max()) for m in a)

    N = TRACK_SECONDS * 44100
    g = torch.Generator(device=dev).manual_seed(5)
    r = torch.randn((4, N, 2), generator=g, device=dev) * 0.1
    e = torch.einsum("ij,jnc->inc", torch.from_numpy(mixing).float().to(dev), r)
    e += 0.02 * torch.randn(e.shape, generator=g, device=dev)
    eng(r, e)                                                  # cuFFT plans, cuSOLVER workspaces
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = []
    for _ in range(3):
        t0 = time.time()
        scores = eng(r, e)                                     # returns host arrays: the track is done
        times.append((time.time() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() - base
    targets = ["bass", "vocals", "other", "drums"]
    ts = eval_track_device({t: r[i] for i, t in enumerate(targets)}, {t: e[i] for i, t in enumerate(targets)}, eng)
    sdr = float(np.median([np.median(ts.targets[t]["SDR"]) for t in targets]))
    phase("bsseval_device", card=card, samples_30s=n, max_abs_db_diff_30s=err, tol_db=BSS_TOL_DB,
          host_engine_s_30s=host_s, int16_vs_float_staging_db=staging_err, staging_tol_db=BSS_STAGING_TOL_DB,
          samples_236s=N, ms_236s=times, ms_236s_median=float(np.median(times)),
          peak_memory_bytes_236s=peak, inputs_bytes_236s=2 * r.numel() * 4, windows_236s=int(scores["SDR"].shape[1]),
          median_sdr_236s=sdr, fallbacks=eng.fallbacks)
    check(err <= BSS_TOL_DB, f"BSS-eval on the card differs from the float64 host engine by {err} dB")
    check(staging_err <= BSS_STAGING_TOL_DB, f"int16 staging differs from float staging by {staging_err} dB")
    check(all(np.isfinite(v).all() for v in scores.values()) and scores["SDR"].shape == (4, N // 44100),
          "bad BSS-eval scores for the 236 s pair")
    check(eng.fallbacks == 0, f"{eng.fallbacks} host rescorings on separation-like signals")


def eval_pipeline(dev):
    """evaluation_main on the card over a synthetic MUSDB tree (two 30 s
    int16 tracks) with the canonical model (seed 0): host scoring,
    --bss-on-device and --device-resident agree on aggregate SDR."""
    import shutil

    from scipy.io import wavfile

    from xumx_slicq_torch.evaluation import evaluation_main
    from xumx_slicq_torch.models import Unmix
    from xumx_slicq_torch.models.convert import to_reference_state_dict
    from xumx_slicq_torch.ops.slicqt import SliCQT

    root = ROOT / "build" / "chip_smoke_eval"
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(6)
    for name in ("t1", "t2"):
        d = root / "musdb" / "test" / name
        d.mkdir(parents=True)
        stems = (rng.standard_normal((4, 30 * 44100, 2)) * 3000).astype(np.int16)
        for k, stem in enumerate(["bass", "vocals", "other", "drums"]):
            wavfile.write(d / f"{stem}.wav", 44100, stems[k])
        wavfile.write(d / "mixture.wav", 44100, stems.sum(0, dtype=np.int32).clip(-32768, 32767).astype(np.int16))
    md = root / "model"
    md.mkdir()
    args = dict(fscale="bark", fbins=262, fmin=32.9, sample_rate=44100.0, seq_dur=2.0, nb_channels=2,
                realtime=False, lstm=False)
    (md / "xumx_slicq_v2.json").write_text(json.dumps({"args": args}))
    slicqt = SliCQT(device="cpu")
    torch.save(to_reference_state_dict(Unmix(slicqt.block_shapes(1, 2, 2 * 44100), seed=0, device="cpu")),
               md / "xumx_slicq_v2.pth")
    base = ["--musdb-root", str(root / "musdb"), "--model-path", str(md)]
    res = {}
    for mode in ("host", "bss-on-device", "device-resident"):
        for c in k4_counters().values():
            c.launches = 0
        t0 = time.time()
        store = evaluation_main(base + ([] if mode == "host" else [f"--{mode}"]))
        wall = time.time() - t0
        agg = store.agg_frames_tracks_scores()
        res[mode] = dict(s_per_track=wall / 2, sdr={t: v["SDR"] for t, v in agg.items()}, tracks=len(store.tracks),
                         k4_launches={k: c.launches for k, c in k4_counters().items()})
    diff = max(abs(res["host"]["sdr"][t] - res[m]["sdr"][t]) for m in res for t in res["host"]["sdr"])
    phase("eval_pipeline", tracks=2, seconds=30, modes=res, max_sdr_diff_db=diff, tol_db=BSS_TOL_DB)
    check(all(r["tracks"] == 2 for r in res.values()), "eval_pipeline: a mode lost a track")
    for mode, r in res.items():          # every chunk batch of both tracks through K4's four layers
        n = r["k4_launches"]["cdae_enc1"]
        check(n >= 2 and set(r["k4_launches"].values()) == {n}, f"eval_pipeline {mode}: K4 launches "
              f"{r['k4_launches']}, expected the same count >= 2 for each layer")
    check(diff <= BSS_TOL_DB, f"eval_pipeline: modes disagree on aggregate SDR by {diff} dB")
    shutil.rmtree(root, ignore_errors=True)


def bench_torch_runs():
    """bench_torch.py as a user runs it, in a process of its own: the
    default mode and the device-resident evaluation throughput. Each prints
    exactly one JSON line on stdout."""
    res = {}
    for argv in ([], ["--eval-throughput", "--eval-tracks", "2", "--device-resident"]):
        t0 = time.time()
        out = subprocess.run([sys.executable, str(ROOT / "bench_torch.py"), *argv], cwd=ROOT, capture_output=True,
                             text=True, timeout=600)
        check(out.returncode == 0, f"bench_torch.py {' '.join(argv)} failed: {out.stderr[-3000:]}")
        lines = out.stdout.strip().splitlines()
        check(len(lines) == 1, f"bench_torch.py {' '.join(argv)} printed {len(lines)} lines: {lines}")
        line = json.loads(lines[0])
        check(np.isfinite(line["value"]) and line["value"] > 0, f"bench_torch.py: bad value {line}")
        res[" ".join(argv) or "default"] = dict(result=line, wall_s=time.time() - t0,
                                                details=[ln for ln in out.stderr.splitlines() if ln.startswith("# ")
                                                         and "supplementary" not in ln])
    phase("bench_torch", runs=res)
    check(res["default"]["result"]["metric"] == "inference_time_per_track_s", "bench_torch.py: wrong default metric")

def profile_stats_phase(prof, agg):
    """utils.profile_stats on the track_breakdown profile against
    torch.profiler's own key_averages of it: device self-time and device
    events within PROFILE_TOL, the stages' device time summing to the
    total, and each of the Separator's three chunk stages holding some."""
    events = prof.key_averages()
    # a record_function range also shows as a device annotation of its name: not a kernel
    host = {e.key for e in events if not str(e.device_type).endswith("CUDA")}
    rows = [e for e in events
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0 and e.key not in host]
    ka_ms = sum(e.self_device_time_total for e in rows) / 1e3
    ka_n = sum(e.count for e in rows)
    stages = agg["stages_device_ms"]
    stage_sum = sum(stages.values())
    phase("profile_stats", device_ms=agg["device_ms"], key_averages_device_ms=ka_ms,
          device_events=agg["device_events"], key_averages_events=ka_n, stages_device_ms=stages,
          stage_sum_ms=stage_sum, tol=PROFILE_TOL)
    check(ka_ms > 0 and abs(agg["device_ms"] - ka_ms) <= PROFILE_TOL * ka_ms,
          f"profile_stats: device ms {agg['device_ms']} against key_averages' {ka_ms}")
    check(abs(agg["device_events"] - ka_n) <= PROFILE_TOL * ka_n,
          f"profile_stats: {agg['device_events']} device events against key_averages' {ka_n}")
    check(abs(stage_sum - agg["device_ms"]) <= PROFILE_TOL * agg["device_ms"],
          f"profile_stats: stages sum to {stage_sum} ms of {agg['device_ms']}")
    for stage in ("slicqt_forward", "mask_model_and_wiener", "slicqt_backward"):
        check(stages.get(stage, 0.0) > 0, f"profile_stats: no device time in stage {stage}: {stages}")


def _write_model_dir(d: Path, lstm: bool) -> Path:
    """A canonical offline model directory (bark-262, weights from seed 0)
    in the reference's format, as the trainer writes it."""
    import shutil

    from xumx_slicq_torch.models import Unmix
    from xumx_slicq_torch.models.convert import to_reference_state_dict
    from xumx_slicq_torch.ops.slicqt import SliCQT

    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    args = dict(fscale="bark", fbins=262, fmin=32.9, sample_rate=44100.0, seq_dur=2.0, nb_channels=2,
                realtime=False, lstm=lstm)
    (d / "xumx_slicq_v2.json").write_text(json.dumps({"args": args}))
    shapes = SliCQT(device="cpu").block_shapes(1, 2, 2 * 44100)
    torch.save(to_reference_state_dict(Unmix(shapes, lstm=lstm, seed=0, device="cpu")), d / "xumx_slicq_v2.pth")
    return d


def export_phase(dev, lstm: bool):
    """export_model of the canonical offline model (CDAE, or with `lstm` the
    LSTM) on the card at one default chunk, batch 1; the artifact loaded in
    a fresh process (`exported_child`) runs one seeded 0.1-RMS chunk and is
    held to Separator._chunk_fn on it, with its launches per call and its
    time against the Separator's."""
    import shutil

    from xumx_slicq_torch.export import export_model

    name = "export_lstm" if lstm else "export_cdae"
    root = ROOT / "build" / f"chip_smoke_{name}"
    model_dir = _write_model_dir(root / "model", lstm)
    t0 = time.time()
    meta = export_model(model_dir, root / "artifact", chunk_lens=(EXPORT_CHUNK,), batch=1, device="cuda")
    export_s = time.time() - t0
    torch.cuda.empty_cache()
    out_json = root / "child.json"
    t0 = time.time()
    child = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--exported-child", str(root / "artifact"),
                            str(model_dir), str(out_json)], cwd=ROOT, capture_output=True, text=True, timeout=900)
    child_s = time.time() - t0
    check(child.returncode == 0, f"{name}: the fresh process failed: {child.stdout[-2000:]} {child.stderr[-3000:]}")
    res = json.loads(out_json.read_text())
    (chunk,) = meta["chunks"]
    want = dict(synth_assembly=1, analysis_gather=1, wiener_em=3, lstm_recurrence=3 if lstm else 0,
                **dict.fromkeys(k4_counters(), 0 if lstm else 1))
    phase(name, chunk_len=EXPORT_CHUNK, batch=1, export_s=export_s, export_trace_and_save_s=chunk["seconds"],
          artifact_bytes=chunk["bytes"], ops_exported=chunk["ops"], fresh_process_s=child_s, tol=EXPORT_TOL,
          expected_launches_per_call=want, **res)
    check(res["max_abs_diff"] <= EXPORT_TOL, f"{name}: artifact differs from Separator._chunk_fn by "
                                             f"{res['max_abs_diff']} > {EXPORT_TOL}")
    check(res["finite"] and res["shape"] == [4, 1, 2, EXPORT_CHUNK], f"{name}: bad artifact output {res}")
    for call in res["launches_per_call"]:
        check(call == want, f"{name}: an artifact call launched {call}, expected {want}")
    check(res["ops_loaded"] == chunk["ops"], f"{name}: the loaded graph holds {res['ops_loaded']}")
    check(chunk["ops"]["cdae_folded"] == (0 if lstm else 1), f"{name}: the graph holds {chunk['ops']}")
    shutil.rmtree(root, ignore_errors=True)


def exported_child(export_dir: str, model_dir: str, out_json: str):
    """The fresh process of `export_phase`: load the artifact (the port's
    ExportedSeparator imports the registered ops first), run a seeded
    0.1-RMS chunk through it twice, counting the kernels' launches per call,
    then through Separator._chunk_fn; times are host-clock medians of 3
    calls after a warm-up, each ending in a synchronize."""
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from xumx_slicq_torch.export import ExportedSeparator
    from xumx_slicq_torch.kernels.analysis_gather import analysis_gather
    from xumx_slicq_torch.kernels.lstm_recurrence import lstm_recurrence
    from xumx_slicq_torch.kernels.ops import graph_op_counts
    from xumx_slicq_torch.kernels.synth_assembly import synth_assembly
    from xumx_slicq_torch.kernels.wiener_em import wiener_em
    from xumx_slicq_torch.separator import Separator

    counters = dict(synth_assembly=synth_assembly, analysis_gather=analysis_gather, wiener_em=wiener_em,
                    lstm_recurrence=lstm_recurrence, **k4_counters())
    dev = torch.device("cuda")
    t0 = time.time()
    es = ExportedSeparator(export_dir)
    prog = es.program(EXPORT_CHUNK)
    fn = prog.module()
    load_s = time.time() - t0
    chunk = torch.from_numpy((np.random.default_rng(1).standard_normal((1, 2, EXPORT_CHUNK)) * 0.1)
                             .astype(np.float32)).to(dev)

    def timed(f):
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.time()
            f()
            torch.cuda.synchronize()
            times.append(time.time() - t)
        return float(np.median(times[1:])) * 1e3, times[0] * 1e3

    per_call = []
    with torch.no_grad():
        for _ in range(2):
            before = {k: c.launches for k, c in counters.items()}
            est = fn(chunk)
            torch.cuda.synchronize()
            per_call.append({k: c.launches - before[k] for k, c in counters.items()})
        artifact_ms, artifact_first_ms = timed(lambda: fn(chunk))
    sep = Separator.load(model_path=model_dir, device=dev, chunk_size=None)
    with torch.inference_mode():
        ref = sep._chunk_fn(chunk)
        separator_ms, _ = timed(lambda: sep._chunk_fn(chunk))
    res = dict(max_abs_diff=float((est - ref).abs().max()), stem_max=float(ref.abs().max()),
               shape=list(est.shape), finite=bool(torch.isfinite(est).all()), launches_per_call=per_call,
               ops_loaded=graph_op_counts(prog.graph), graph_nodes=len(prog.graph.nodes), load_s=load_s,
               artifact_ms=artifact_ms, artifact_timed_first_ms=artifact_first_ms, separator_ms=separator_ms,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    Path(out_json).write_text(json.dumps(res))


def slicqfinder_phase(dev):
    """slicqfinder_main on the card at the JAX defaults for segments (4 of
    5.0 s) over 6 seeded random configs on the synthetic dataset; per
    config: evaluated or skipped, its K1 and K2 launches, host seconds of
    plan building against the oracle's seconds on the device's timeline
    (CUDA events, launch gaps included) and, from one profiled segment, the
    device's busy share; the first evaluated config's oracle SDR against
    the port on the CPU."""
    import random

    from xumx_slicq_torch.data import SyntheticDataset
    from xumx_slicq_torch.slicqfinder import (build_transform, evaluate_config, oracle_separate, random_config,
                                              slicqfinder_main)

    out = ROOT / "build" / "chip_smoke_slicqfinder.json"
    n_iter, seed, n_seg, seq_dur = 6, 42, 4, 5.0
    t0 = time.time()
    best = slicqfinder_main(["--synthetic-dataset", "--n-iter", str(n_iter), "--seed", str(seed), "--n-segments",
                             str(n_seg), "--seq-dur", str(seq_dur), "--output-json", str(out)])
    wall = time.time() - t0
    history = json.loads(out.read_text())["history"]
    rng = random.Random(seed)
    configs, rows, h = [random_config(rng) for _ in range(n_iter)], [], iter(history)
    entry = next(h, None)
    for cfg in configs:
        if entry is not None and all(entry[k] == v for k, v in cfg.items()):
            rows.append(dict(config=cfg, evaluated=True, oracle_sdr=entry["oracle_sdr"],
                             **{k: entry[k] for k in ("launches", "plan_s", "oracle_s", "device_s", "score_s")}))
            entry = next(h, None)
        else:
            rows.append(dict(config=cfg, evaluated=False))
    check(entry is None and history, f"slicqfinder: history {history} does not follow the seeded configs")
    first = next(r for r in rows if r["evaluated"])
    segments = SyntheticDataset(n_tracks=n_seg, seq_duration=seq_dur, samples_per_track=1, seed=seed)
    segments = [segments[i] for i in range(n_seg)]
    t0 = time.time()
    sdr_cpu = evaluate_config(first["config"], segments, device="cpu")
    cpu_s = time.time() - t0
    diff = abs(sdr_cpu - first["oracle_sdr"])
    # one profiled oracle of each evaluated config on the first segment: the device's busy ms against the wall
    profiles = []
    with torch.inference_mode():
        for r in rows:
            if r["evaluated"]:
                t = build_transform(r["config"], dev)
                mix, stems = (torch.from_numpy(a).to(dev) for a in (segments[0][0], segments[0][1:]))
                oracle_separate(t, mix, stems)
                wall_ms, busy_ms, events = profiled(lambda: oracle_separate(t, mix, stems), "slicqfinder")[:3]
                profiles.append(dict(config=r["config"], wall_ms=wall_ms, device_busy_ms=busy_ms,
                                     device_events=events))
    phase("slicqfinder", n_iter=n_iter, segments=n_seg, seq_dur=seq_dur, wall_s=wall, configs=rows,
          best=best, first_oracle_sdr_cuda=first["oracle_sdr"], first_oracle_sdr_cpu=sdr_cpu,
          sdr_diff_db=diff, tol_db=ORACLE_SDR_TOL_DB, cpu_oracle_s=cpu_s, one_segment_profiles=profiles)
    for r in rows:
        if r["evaluated"]:
            check(r["launches"] == dict(synth_assembly=n_seg, wiener_em=3 * n_seg),
                  f"slicqfinder: {r['config']} launched {r['launches']}")
            check(np.isfinite(r["oracle_sdr"]), f"slicqfinder: non-finite oracle SDR for {r['config']}")
    check(diff <= ORACLE_SDR_TOL_DB, f"slicqfinder: oracle SDR on the card {first['oracle_sdr']} against "
                                     f"{sdr_cpu} on the CPU")


def tuning_phase(dev):
    """tuning_main on the card: 2 trials of 2 epochs, 2 batches of 16 at
    bark-262 on the synthetic dataset; study.json must hold 2 trials with
    finite values, and K1, K2 and K2's backward must have launched."""
    import shutil

    from xumx_slicq_torch.kernels.synth_assembly import synth_assembly
    from xumx_slicq_torch.kernels.wiener_em import wiener_em, wiener_em_backward
    from xumx_slicq_torch.tuning import tuning_main

    d = ROOT / "build" / "chip_smoke_tuning"
    shutil.rmtree(d, ignore_errors=True)
    counters = dict(synth_assembly=synth_assembly, wiener_em=wiener_em, wiener_em_backward=wiener_em_backward)
    before = {k: c.launches for k, c in counters.items()}
    t0 = time.time()
    best = tuning_main(["--study-dir", str(d), "--synthetic-dataset", "--n-trials", "2", "--trial-epochs", "2",
                        "--max-batches-per-epoch", "2", "--batch-size", "16"])
    wall = time.time() - t0
    launches = {k: c.launches - before[k] for k, c in counters.items()}
    trials = json.loads((d / "study.json").read_text())["trials"]
    phase("tuning", wall_s=wall, launches=launches, best_value=None if best is None else best["value"],
          trials=[{k: t.get(k) for k in ("id", "params", "value", "pruned", "intermediate", "seconds", "error")}
                  for t in trials])
    check(len(trials) == 2 and all("error" not in t and np.isfinite(t["value"]) for t in trials),
          f"tuning: study.json holds {trials}")
    check(all(n > 0 for n in launches.values()), f"tuning: a kernel was not launched: {launches}")
    shutil.rmtree(d, ignore_errors=True)


# -- slice 10: ranks, several devices, params.msgpack, entry, Cadenza ------------------------------------

MESH_STEPS = 4                  # dp_train / tp_train: train steps at the canonical batch (32 of 2.0 s)
MESH_LSTM_BATCH, MESH_LSTM_STEPS = 4, 2   # dp_train's LSTM run: the canonical LSTM at a small batch
# losses across ranks against one process (tests/test_training.py:297-303, 325): the first step, the trajectory
MESH_FIRST_TOL, MESH_TRAJ_TOL, TP_TOL = 2e-4, 1e-3, 2e-4
# the first step's gradients across ranks against one process, tensor by tensor (AdamW's update, and so the losses,
# cannot see a reduction that scales a gradient): |g - g1| <= rtol |g1| + floor |all of g1|. The faults it is for
# scale a gradient by 2, 1/2 or tp; the floor covers tensors whose gradient is rounding noise (BatchNorm cancels it)
MESH_GRAD_RTOL, MESH_GRAD_FLOOR = 1e-2, 1e-5
DEVICES_TOL = 2e-5              # separator_devices against one device (tests/test_separator.py:72)
# msgpack_weights: the same weights (checked bit-equal) in two model instances on the card; their stems differed by
# 3.0e-8 on 0.1-RMS input in the first run (the instances' cuDNN and K2 runs are not bit-reproducible)
MSGPACK_STEM_TOL = 1e-6
CADENZA_SECONDS, CADENZA_LISTENERS = 10, 2


def _mesh_batches(length: int, batch: int, steps: int):
    """The global batches of a mesh phase (each with every loss term's
    inputs: a silent stem), and one validation batch of 2 items."""
    return [_train_batch(20 + i, length, batch) for i in range(steps)], _train_batch(99, length, 2)


def _mesh_run(dev, lstm: bool, batch: int, steps: int, mesh=None) -> dict:
    """`steps` train steps of the canonical model (CDAE or LSTM, seed 0;
    every loss term: SD-SDR through K1) on the global batches of
    `_mesh_batches`, in one process or as one rank of `mesh` (its rows of
    each batch), then an eval-mode validation loss on one batch. Returns
    the losses, host ms a step (the step's loss read back), the collectives'
    calls, bytes and host ms a step, peak memory, the kernels' launches and
    the first step's gradients after the reduction, gathered into the
    one-process layout, on the host (rank 0 and one process; None on the
    other ranks)."""
    from xumx_slicq_torch.kernels.lstm_recurrence import lstm_recurrence, lstm_recurrence_backward
    from xumx_slicq_torch.kernels.synth_assembly import synth_assembly, synth_assembly_backward
    from xumx_slicq_torch.kernels.wiener_em import wiener_em, wiener_em_backward
    from xumx_slicq_torch.models import Unmix
    from xumx_slicq_torch.ops.slicqt import SliCQT
    from xumx_slicq_torch.parallel.mesh import shard_batch
    from xumx_slicq_torch.training import dropout_seed, make_train_step

    counters = {"synth_assembly": synth_assembly, "synth_assembly_backward": synth_assembly_backward,
                "wiener_em": wiener_em, "wiener_em_backward": wiener_em_backward,
                "lstm_recurrence": lstm_recurrence, "lstm_recurrence_backward": lstm_recurrence_backward}
    length = int(TRAIN_SECONDS * 44100)
    slicqt = SliCQT(device=dev)
    model = Unmix(slicqt.block_shapes(batch, 2, length), lstm=lstm, seed=0, device=dev, mesh=mesh)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-5)
    step, valid = make_train_step(slicqt, model, opt, sdr_mcoef=0.1, mesh=mesh)
    batches, vbatch = _mesh_batches(length, batch, steps)
    dropout = torch.Generator(device=dev) if lstm else None
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0
    losses, ms, coll_ms, coll_calls, coll_bytes, grads = [], [], [], [], 0, None
    for i, b in enumerate(batches):
        if dropout is not None:
            dropout.manual_seed(dropout_seed(42, 1, i))
        rows = torch.from_numpy(shard_batch(b, mesh) if mesh is not None else b).to(dev)
        before = dict(mesh.stats) if mesh is not None else None
        t0 = time.time()
        losses.append(float(step(rows, dropout)))
        ms.append((time.time() - t0) * 1e3)
        if mesh is not None:
            coll_ms.append((mesh.stats["seconds"] - before["seconds"]) * 1e3)
            coll_calls.append(mesh.stats["calls"] - before["calls"])
            coll_bytes += mesh.stats["bytes"] - before["bytes"]
        if i == 0:                     # the step leaves its reduced gradients in .grad
            grads = {n: p.grad for n, p in model.named_parameters()}
            grads = mesh.gather_state(grads) if mesh is not None else grads
            grads = {n: g.cpu() for n, g in grads.items()} if mesh is None or mesh.rank == 0 else None
    launches = {k: fn.launches for k, fn in counters.items()}
    vloss = float(valid(torch.from_numpy(vbatch).to(dev)))
    batch_norms = sum(isinstance(m, torch.nn.modules.batchnorm._BatchNorm) for m in model.modules())
    return dict(losses=losses, valid_loss=vloss, step_ms=ms, collective_ms=coll_ms, collective_calls=coll_calls,
                batch_norms=batch_norms,
                collective_bytes=coll_bytes, max_memory_allocated_bytes=torch.cuda.max_memory_allocated(dev),
                launches=launches, params=model.num_params(), grads=grads)


def _mesh_rank(rank: int, devices: list) -> dict:
    """One rank of the dp_train and tp_train phases: the CDAE over dp =
    len(devices), the LSTM likewise at a small batch, then the CDAE over
    tp = 2 (dp = len(devices) / 2), each in a mesh of its own over the same
    ranks."""
    from xumx_slicq_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False          # as the one-process runs: a fresh process has
    torch.backends.cudnn.allow_tf32 = False                # cuDNN's TF32 on
    dp = make_mesh(len(devices), 1, devices)
    out = {"cdae": _mesh_run(dp.device, False, TRAIN_BATCH, MESH_STEPS, dp)}
    torch.cuda.empty_cache()
    out["lstm"] = _mesh_run(dp.device, True, MESH_LSTM_BATCH, MESH_LSTM_STEPS, dp)
    torch.cuda.empty_cache()
    out["tp"] = _mesh_run(dp.device, False, TRAIN_BATCH, MESH_STEPS, make_mesh(len(devices), 2, devices))
    return out


def mesh_phases(dev, devices=None):
    """dp_train and tp_train: the trainer's step across ranks against the
    same steps in one process on the card. By default 2 ranks on this one
    card over gloo (NCCL refuses two ranks on one GPU); `devices`, one card
    a rank (NCCL), is the development phase `mesh_cards`."""
    from xumx_slicq_torch.parallel.mesh import backend_for, spawn

    one = {"cdae": _mesh_run(dev, False, TRAIN_BATCH, MESH_STEPS),
           "lstm": _mesh_run(dev, True, MESH_LSTM_BATCH, MESH_LSTM_STEPS)}
    torch.cuda.empty_cache()
    t0 = time.time()
    devices = devices or [f"cuda:{dev.index or 0}"] * 2
    ranks = spawn(_mesh_rank, devices, args=(devices,))
    spawn_s = time.time() - t0

    def grad_errors(got, ref):
        """The worst tensor's |g - g1| / (rtol |g1| + floor |all of g1|),
        and the largest |g - g1| / |g1| over the tensors above the floor."""
        whole = float(torch.sqrt(sum(g.double().norm() ** 2 for g in ref.values())))
        check(got.keys() == ref.keys(), f"gradients of {sorted(got)} against {sorted(ref)}")
        errs = {k: (float((got[k] - g).norm()), float(g.norm())) for k, g in ref.items()}
        ratio = {k: e / (MESH_GRAD_RTOL * n + MESH_GRAD_FLOOR * whole) for k, (e, n) in errs.items()}
        worst = max(ratio, key=ratio.get)
        rel = max((e / n for e, n in errs.values() if n > MESH_GRAD_FLOOR * whole), default=0.0)
        return dict(grad_worst_ratio=ratio[worst], grad_worst_tensor=worst, grad_max_rel=rel, grad_norm=whole,
                    grad_tensors=len(ref))

    def summary(name, runs, ref):
        r0 = runs[0]
        first = abs(r0["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
        traj = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"] + [r0["valid_loss"]],
                                                       ref["losses"] + [ref["valid_loss"]]))
        return dict(losses=r0["losses"], one_process_losses=ref["losses"], valid_loss=r0["valid_loss"],
                    one_process_valid_loss=ref["valid_loss"], first_step_rel=first, max_rel=traj,
                    rank_losses_equal=all(r["losses"] == r0["losses"] for r in runs),
                    step_ms=[r["step_ms"] for r in runs], one_process_step_ms=ref["step_ms"],
                    median_step_ms=float(np.median(r0["step_ms"][1:])),
                    one_process_median_step_ms=float(np.median(ref["step_ms"][1:])),
                    collective_ms=[r["collective_ms"] for r in runs], collective_calls=r0["collective_calls"],
                    batch_norms=r0["batch_norms"],
                    collective_mbytes=r0["collective_bytes"] / 1e6,
                    rank_max_memory_allocated_bytes=[r["max_memory_allocated_bytes"] for r in runs],
                    one_process_max_memory_allocated_bytes=ref["max_memory_allocated_bytes"],
                    rank_launches=[r["launches"] for r in runs], one_process_launches=ref["launches"],
                    **grad_errors(r0["grads"], ref["grads"]))

    res = {k: summary(k, [r[k] for r in ranks], one["cdae" if k == "tp" else k]) for k in ("cdae", "lstm", "tp")}
    # Mesh.stats times each collective call on the host: gloo returns once the reduce is done, NCCL once queued
    timing = "host wait" if backend_for(devices) == "gloo" else "host enqueue"
    phase("dp_train", ranks=len(devices), backend=backend_for(devices), collective_ms_is=timing, devices=devices,
          batch=TRAIN_BATCH,
          steps=MESH_STEPS, lstm_batch=MESH_LSTM_BATCH, lstm_steps=MESH_LSTM_STEPS, spawn_and_run_s=spawn_s,
          cdae=res["cdae"], lstm=res["lstm"], first_tol=MESH_FIRST_TOL, tol=MESH_TRAJ_TOL,
          grad_rtol=MESH_GRAD_RTOL, grad_floor=MESH_GRAD_FLOOR)
    phase("tp_train", ranks=len(devices), tp=2, dp=len(devices) // 2, backend=backend_for(devices),
          collective_ms_is=timing, batch=TRAIN_BATCH,
          steps=MESH_STEPS, tol=TP_TOL, grad_rtol=MESH_GRAD_RTOL, grad_floor=MESH_GRAD_FLOOR, **res["tp"])
    for name, r, first, tol in (("dp_train cdae", res["cdae"], MESH_FIRST_TOL, MESH_TRAJ_TOL),
                                ("dp_train lstm", res["lstm"], MESH_FIRST_TOL, MESH_TRAJ_TOL),
                                ("tp_train", res["tp"], TP_TOL, TP_TOL)):
        check(all(np.isfinite(r["losses"])) and r["rank_losses_equal"], f"{name}: rank losses {r['losses']}")
        check(r["first_step_rel"] <= first, f"{name}: first step {r['first_step_rel']} from one process > {first}")
        check(r["max_rel"] <= tol, f"{name}: losses {r['max_rel']} from one process > {tol}")
        check(r["grad_worst_ratio"] <= 1.0, f"{name}: the first step's gradient of {r['grad_worst_tensor']} is "
              f"{r['grad_worst_ratio']} times its bound from one process's")
        if name.startswith("dp_train"):
            # one collective per BatchNorm forward and one backward (its moments gathered), the LSTM's rows
            # gathered and their cotangents reduced, the gradients' reduction and the loss's mean: 422 for the CDAE
            calls = 2 * r["batch_norms"] + 2 + (2 if name == "dp_train lstm" else 0)
            check(all(c == calls for c in r["collective_calls"]),
                  f"{name}: {r['collective_calls']} collectives a step, expected {calls}")
        path = ["synth_assembly", "synth_assembly_backward", "wiener_em", "wiener_em_backward"]
        if name == "dp_train lstm":
            path += ["lstm_recurrence", "lstm_recurrence_backward"]
        for launches in r["rank_launches"]:
            for k in path:
                check(launches[k] > 0, f"{name}: {k} was not launched on a rank: {launches}")


def separator_devices(sep, track, devices=None):
    """The 236 s track through Separator(devices=[card, card]) (a replica a
    device, the chunks in waves: here one wave, a chunk batch of 2 a
    device) against the single-device Separator `sep`; `devices`, one
    replica a card, is the development phase `separator_devices_cards`."""
    from xumx_slicq_torch.kernels.synth_assembly import synth_assembly
    from xumx_slicq_torch.kernels.wiener_em import wiener_em

    devices = devices or [sep.device] * 2
    many = sep.__class__(sep.slicqt, sep.model, chunk_size=sep.chunk_size, devices=devices)
    # the chunk batches of one demix (JAX separator.py:164-185): waves of up to 8 n_dev chunks, each device
    # taking the smallest bucket b with b n_dev >= the wave's chunks
    calls, left = [], -(-track.shape[-1] // sep.chunk_size)
    while left > 0:
        take = min(left, 8 * len(devices))
        nb = next(b for b in (1, 2, 4, 8) if b * len(devices) >= take)
        calls += [nb] * -(-take // nb)
        left -= take
    ref = sep(track)
    many(track)                                                # warm-up: the chunk batch of 2
    torch.cuda.synchronize()
    synth_assembly.launches = wiener_em.launches = 0
    for c in k4_counters().values():
        c.launches = 0
    times = []
    for _ in range(3):
        t0 = time.time()
        est = many(track)
        times.append(time.time() - t0)
        if _ == 0:
            launches = {"synth_assembly": synth_assembly.launches, "wiener_em": wiener_em.launches,
                        **{k: c.launches for k, c in k4_counters().items()}}
    diff = float(np.abs(est - ref).max())
    phase("separator_devices", devices=[str(d) for d in devices], samples=track.shape[-1], chunk_batches=calls,
          max_abs_diff=diff, tol=DEVICES_TOL, s_per_track=times, launches=launches)
    check(est.shape == ref.shape and np.isfinite(est).all(), "separator_devices: bad stems")
    check(diff <= DEVICES_TOL, f"separator_devices: {diff} from the single-device Separator > {DEVICES_TOL}")
    check(launches == {"synth_assembly": len(calls), "wiener_em": 3 * len(calls),
                       **dict.fromkeys(k4_counters(), len(calls))},
          f"separator_devices: one demix launched {launches}, expected K1 and each K4 layer once and K2 3 times "
          f"for each of its {len(calls)} chunk batches")


def msgpack_weights(dev, clip):
    """The canonical CDAE's directory written with the port's
    save_model_weights (the JAX package's params.msgpack only), loaded on
    the card, against the reference-named .pth route of the same weights."""
    import shutil

    from xumx_slicq_torch.separator import Separator, save_model_weights

    pth = _write_model_dir(ROOT / "build" / "chip_smoke_pth", lstm=False)
    msg = ROOT / "build" / "chip_smoke_msgpack"
    shutil.rmtree(msg, ignore_errors=True)
    msg.mkdir(parents=True)
    shutil.copy(pth / "xumx_slicq_v2.json", msg)
    ref = Separator.load(model_path=pth, device=dev)
    t0 = time.time()
    path = save_model_weights(msg, ref.model)
    write_s = time.time() - t0
    t0 = time.time()
    ours = Separator.load(model_path=msg, device=dev)
    load_s = time.time() - t0
    sd, ref_sd = ours.model.state_dict(), ref.model.state_dict()
    same = sorted(sd) == sorted(ref_sd) and all(torch.equal(sd[k], ref_sd[k]) for k in ref_sd)
    a, b, b2 = ours(clip), ref(clip), ref(clip)
    diff, repeat = float(np.abs(a - b).max()), float(np.abs(b2 - b).max())
    phase("msgpack_weights", files=sorted(p.name for p in msg.iterdir()), bytes=path.stat().st_size,
          write_s=write_s, load_s=load_s, weights_bit_equal=same, max_abs_diff=diff,
          pth_route_repeat_max_abs_diff=repeat, tol=MSGPACK_STEM_TOL)
    check(same, "msgpack_weights: the weights read from params.msgpack differ from the .pth route's")
    check(diff <= MSGPACK_STEM_TOL, f"msgpack_weights: stems differ from the .pth route's by {diff}")
    shutil.rmtree(msg, ignore_errors=True)
    shutil.rmtree(pth, ignore_errors=True)


def entry_phase():
    """xumx_slicq_torch.entry.entry(): its forward step once on the card."""
    from xumx_slicq_torch.entry import entry
    from xumx_slicq_torch.kernels.synth_assembly import synth_assembly
    from xumx_slicq_torch.kernels.wiener_em import wiener_em

    fn, args = entry()
    synth_assembly.launches = wiener_em.launches = 0
    for c in k4_counters().values():
        c.launches = 0
    t0 = time.time()
    out = fn(*args)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = {"synth_assembly": synth_assembly.launches, "wiener_em": wiener_em.launches,
                **{k: c.launches for k, c in k4_counters().items()}}
    phase("entry", shape=list(out.shape), device=str(out.device), finite=bool(torch.isfinite(out).all()),
          first_call_s=first_s, launches=launches)
    check(tuple(out.shape) == (4, 1, 2, 88200) and out.is_cuda and bool(torch.isfinite(out).all()),
          "entry: bad output")
    check(launches == {"synth_assembly": 1, "wiener_em": 3, **dict.fromkeys(k4_counters(), 1)},
          f"entry: launches {launches}")


def _cadenza_evaluate(config_overrides: dict, batch: int, batch_size: int):
    """One shard of the recipe's evaluation, in a process of its own (the
    recipe's own sharding, cadenza/final_evaluation.sh)."""
    from xumx_slicq_torch.cadenza.config import load_config
    from xumx_slicq_torch.cadenza.evaluate import evaluate

    overrides = dict(config_overrides, evaluate={"batch": batch, "batch_size": batch_size})
    t0 = time.time()
    evaluate(load_config(overrides=overrides))
    return time.time() - t0


def cadenza_phase(dev):
    """The Cadenza runner end to end with the canonical CDAE on the card:
    enhance (demix, NAL-R per listener, 24 kHz stems and a 32 kHz remix)
    one seeded 10 s song for 2 listeners, evaluate HAAQI in 2 shards in
    processes of their own, merge. Separation seconds on the card against
    NAL-R and HAAQI seconds on the host."""
    import shutil
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    import xumx_slicq_torch.cadenza.enhance as enhance_mod
    from xumx_slicq_torch.audio import save_audio
    from xumx_slicq_torch.cadenza.config import load_config
    from xumx_slicq_torch.cadenza.merge_batches_results import merge

    root = ROOT / "build" / "chip_smoke_cadenza"
    shutil.rmtree(root, ignore_errors=True)
    song = "Seeded Song - Noise"
    d = root / "musdb" / "train" / song
    d.mkdir(parents=True)
    rng = np.random.default_rng(7)
    n = CADENZA_SECONDS * 44100
    t = np.arange(n) / 44100
    stems = {}
    for i, s in enumerate(("bass", "drums", "other", "vocals")):
        tone = np.sin(2 * np.pi * [80, 300, 1000, 2000][i] * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 0.5 * t + i))
        stems[s] = (0.05 * np.stack([tone, np.roll(tone, 50 * (i + 1))]) + 0.01 * rng.standard_normal((2, n)))
        stems[s] = stems[s].astype(np.float32)
    save_audio(d / "mixture.wav", sum(stems.values()), 44100)
    for s, a in stems.items():
        save_audio(d / f"{s}.wav", a, 44100)
    meta = root / "metadata"
    meta.mkdir()
    (meta / "musdb18.valid.json").write_text(json.dumps([{"Track Name": song, "Split": "train"}]))
    cfs = [250, 500, 1000, 2000, 4000, 6000]
    listeners = {f"L00{k}": {"name": f"L00{k}", "audiogram_cfs": cfs, "audiogram_levels_l": lv,
                             "audiogram_levels_r": lv[::-1]}
                 for k, lv in enumerate(([20, 20, 30, 40, 50, 55], [10, 15, 25, 45, 60, 70])[:CADENZA_LISTENERS], 1)}
    (meta / "listeners.valid.json").write_text(json.dumps(listeners))
    model = _write_model_dir(root / "model", lstm=False)
    overrides = {"path": {"music_dir": str(root / "musdb"), "metadata_dir": str(meta),
                          "music_valid_file": str(meta / "musdb18.valid.json"),
                          "listeners_valid_file": str(meta / "listeners.valid.json"),
                          "exp_folder": str(root / "exp")},
                 "separator": {"model_path": str(model), "device": str(dev)}}
    cfg = load_config(overrides=overrides)

    timed = {"separate": 0.0, "nalr": 0.0}

    def timer(key, fn):
        def wrapped(*a, **k):
            t0 = time.time()
            try:
                return fn(*a, **k)
            finally:
                timed[key] += time.time() - t0
        return wrapped

    orig = (enhance_mod.decompose_signal, enhance_mod.process_stems_for_listener)
    enhance_mod.decompose_signal = timer("separate", orig[0])
    enhance_mod.process_stems_for_listener = timer("nalr", orig[1])
    try:
        t0 = time.time()
        enhance_mod.enhance(cfg)
        enhance_s = time.time() - t0
    finally:
        enhance_mod.decompose_signal, enhance_mod.process_stems_for_listener = orig
    files = {k: len(list((root / "exp" / "enhanced_signals" / k / song).glob("*.wav"))) for k in listeners}
    t0 = time.time()
    with ProcessPoolExecutor(2, mp_context=get_context("spawn")) as pool:
        shard_s = list(pool.map(_cadenza_evaluate, [overrides] * 2, [0, 1], [2, 2]))
    evaluate_s = time.time() - t0
    rows = merge(str(root / "exp")).read_text().splitlines()[1:]
    scores = [float(r.split(",")[2]) for r in rows]
    phase("cadenza", song_seconds=CADENZA_SECONDS, listeners=len(listeners), wav_files_per_pair=files,
          haaqi=scores, enhance_s=enhance_s, separation_s_card=timed["separate"], nalr_s_host=timed["nalr"],
          evaluate_wall_s=evaluate_s, haaqi_s_host_per_shard=shard_s)
    check(all(v == 9 for v in files.values()), f"cadenza: wav files per pair {files}, expected 9")
    check(len(scores) == len(listeners) and all(0.0 <= s <= 1.0 for s in scores), f"cadenza: HAAQI {scores}")
    shutil.rmtree(root, ignore_errors=True)


# -- slice 11: the JAX package's chunk batches for the LSTM, silent training ------------------------------

FORWARD_DEVICE_CHUNKS = 9       # *_forward_device_waves: default chunks, so waves of 8 and 1
FORWARD_DEVICE_TOL = 1e-5       # ... against _chunk_fn on the same waves: the same programs on the same batches
DEVICES_CLIP_SECONDS = 30       # separator_devices_lstm: a one-chunk clip, padded to a chunk batch of n_dev
WIDEST_WAVE = 8 * 4             # ... and the widest wave of 4 devices, which the first card runs alone


def _wave_reference(sep, audio: torch.Tensor, n_dev: int) -> torch.Tensor:
    """(1, C, N) on the card -> (4, 1, C, N): the one-device `_chunk_fn` of
    `sep` on the chunk batches the JAX package forms over n_dev devices
    (xumx_slicq_tpu/separator.py:164-185): waves of at most 8 n_dev chunks,
    each zero-padded to b n_dev chunks, b the least of 1, 2, 4, 8 that holds
    them; reassembled here, apart from the Separator's own code."""
    _, C, N = audio.shape
    chunk = min(sep.chunk_size, max(N, sep.slicqt.sllen // 2 + 1))
    nchunks = -(-N // chunk)
    chunks = torch.nn.functional.pad(audio[0], (0, nchunks * chunk - N)).reshape(C, nchunks, chunk).transpose(0, 1)
    parts = []
    for ci in range(0, nchunks, 8 * n_dev):
        take = min(nchunks - ci, 8 * n_dev)
        batch = torch.zeros((next(b for b in (1, 2, 4, 8) if b * n_dev >= take) * n_dev, C, chunk),
                            device=audio.device)
        batch[:take] = chunks[ci: ci + take]
        with torch.inference_mode():
            parts.append(sep._chunk_fn(batch)[:, :take])
    est = torch.cat(parts, dim=1).transpose(1, 2).reshape(4, C, nchunks * chunk)
    return est[..., :N][:, None]


def _lstm_path_counters():
    from xumx_slicq_torch.kernels.analysis_gather import analysis_gather
    from xumx_slicq_torch.kernels.lstm_recurrence import lstm_recurrence
    from xumx_slicq_torch.kernels.synth_assembly import synth_assembly
    from xumx_slicq_torch.kernels.wiener_em import wiener_em

    return {"lstm_recurrence": lstm_recurrence, "wiener_em": wiener_em, "synth_assembly": synth_assembly,
            "analysis_gather": analysis_gather, **k4_counters()}


def separator_devices_lstm(sep, track, devices=None):
    """The canonical offline LSTM model over Separator(devices=[card, card])
    on the 236 s track (4 chunks: one wave, a chunk batch of 2 a replica, 4
    in all) and on a 30 s clip (one chunk, padded to a batch of 2), each
    against the one-device `_chunk_fn` on the same zero-padded wave batch
    (`_wave_reference`): the LSTM's sequences run through the wave's whole
    batch, as the JAX mesh's sharded program runs them, so the first
    replica runs the wave as one chunk batch: K5 and K2 3 launches and K1
    and K3 one a wave. Then that replica's load at 4 devices: `_chunk_fn` on the
    widest wave, 32 chunks of noise, its ms (host clock to a synchronise,
    the second of two calls) and peak memory."""
    counters = _lstm_path_counters()
    devices = devices or [sep.device] * 2
    n_dev = len(devices)
    many = sep.__class__(sep.slicqt, sep.model, chunk_size=sep.chunk_size, devices=devices)
    res = {}
    for name, x in (("track", track), ("clip", np.ascontiguousarray(track[..., : int(DEVICES_CLIP_SECONDS * 44100)]))):
        ref = _wave_reference(sep, torch.from_numpy(x).to(sep.device), n_dev).cpu().numpy()
        many(x)                                                    # warm-up
        torch.cuda.synchronize()
        times = []
        for i in range(3):
            if i == 0:
                torch.cuda.reset_peak_memory_stats()
                for fn in counters.values():
                    fn.launches = 0
            t0 = time.time()
            est = many(x)
            times.append(time.time() - t0)
            if i == 0:
                launches = {k: fn.launches for k, fn in counters.items()}
                peak = torch.cuda.max_memory_allocated()
                diff = float(np.abs(est - ref).max())
                check(est.shape == ref.shape == (4, 1, 2, x.shape[-1]) and np.isfinite(est).all(),
                      f"separator_devices_lstm {name}: bad stems")
        nchunks = -(-x.shape[-1] // sep.chunk_size)
        nb = next(b for b in (1, 2, 4, 8) if b * n_dev >= nchunks)
        res[name] = dict(samples=x.shape[-1], chunks=nchunks, chunk_batch=nb, global_batch=nb * n_dev,
                         max_abs_diff=diff, s_per_track=times, launches=launches, max_memory_allocated_bytes=peak,
                         expected_launches={"lstm_recurrence": 3, "wiener_em": 3, "synth_assembly": 1,
                                            "analysis_gather": 1, **dict.fromkeys(k4_counters(), 0)})
    del many
    wave = torch.randn((WIDEST_WAVE, 2, sep.chunk_size), generator=torch.Generator(sep.device).manual_seed(5),
                       device=sep.device) * 0.1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wave_ms, finite = [], True
    for _ in range(2):
        t0 = time.time()
        with torch.inference_mode():
            est = sep._chunk_fn(wave)
        torch.cuda.synchronize()
        wave_ms.append((time.time() - t0) * 1e3)
        finite = finite and bool(torch.isfinite(est).all())
        del est
    res["widest_wave"] = dict(chunks=WIDEST_WAVE, ms=wave_ms, finite=finite,
                              max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    del wave
    torch.cuda.empty_cache()
    phase("separator_devices_lstm", devices=[str(d) for d in devices], tol=DEVICES_TOL, **res)
    check(res.pop("widest_wave")["finite"], "separator_devices_lstm: stems of the widest wave not finite")
    for name, r in res.items():
        check(r["max_abs_diff"] <= DEVICES_TOL, f"separator_devices_lstm {name}: {r['max_abs_diff']} from "
              f"_chunk_fn on the wave's batch of {r['global_batch']} > {DEVICES_TOL}")
        check(r["launches"] == r["expected_launches"], f"separator_devices_lstm {name}: launches {r['launches']}, "
              f"expected {r['expected_launches']}")


def forward_device_waves(sep, name: str):
    """forward_device of a canonical offline model (`name`: cdae or lstm)
    on a track of 9 default chunks: the JAX package's waves of 8 and 1
    chunks on one device (xumx_slicq_tpu/separator.py:286), against
    `_chunk_fn` on the same two zero-padded chunk batches reassembled by
    hand; ms a track (host clock to the last result, stems left on the
    card) and peak memory. Phase `<name>_forward_device_waves`."""
    counters = _lstm_path_counters()
    n = FORWARD_DEVICE_CHUNKS * sep.chunk_size - 12345
    audio = torch.from_numpy((np.random.default_rng(11).standard_normal((1, 2, n)) * 0.1).astype(np.float32))
    audio = audio.to(sep.device)
    ref = _wave_reference(sep, audio, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.time()
    est = sep.forward_device(audio)
    torch.cuda.synchronize()
    times = [(time.time() - t0) * 1e3]
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    diff = float((est - ref).abs().max())
    check(est.shape == ref.shape == (4, 1, 2, n) and bool(torch.isfinite(est).all()),
          f"{name}_forward_device_waves: bad stems")
    del est, ref
    for _ in range(2):
        t0 = time.time()
        sep.forward_device(audio)
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
    # two chunk batches (8, then 1): K1 and K3 once, K2 3 times, K5 3 times (the LSTM) or K4's four layers once
    # (the CDAE) each
    expected = {"lstm_recurrence": 6 if sep.model.lstm else 0, "wiener_em": 6, "synth_assembly": 2,
                "analysis_gather": 2, **dict.fromkeys(k4_counters(), 0 if sep.model.lstm else 2)}
    phase(f"{name}_forward_device_waves", samples=n, chunks=FORWARD_DEVICE_CHUNKS, waves=[8, 1], max_abs_diff=diff,
          tol=FORWARD_DEVICE_TOL, ms_per_track=times, max_memory_allocated_bytes=peak, launches=launches)
    check(diff <= FORWARD_DEVICE_TOL, f"{name}_forward_device_waves: {diff} from _chunk_fn on its waves > "
          f"{FORWARD_DEVICE_TOL}")
    check(launches == expected, f"{name}_forward_device_waves: launches {launches}, expected {expected}")


def silent_train_step(dev, slicqt):
    """One train step of the canonical CDAE and LSTM models (AdamW, every
    loss term, SD-SDR on; the LSTM's dropout on) on an all-zero batch of
    32 items of 2 s: finite loss and finite parameters after AdamW
    (tests/test_grad_hardening.py:42-59 on the card), with K1b, K2b and
    K5b launched."""
    from xumx_slicq_torch.kernels.lstm_recurrence import lstm_recurrence_backward
    from xumx_slicq_torch.kernels.synth_assembly import synth_assembly_backward
    from xumx_slicq_torch.kernels.wiener_em import wiener_em_backward
    from xumx_slicq_torch.models import Unmix
    from xumx_slicq_torch.training import make_train_step

    counters = {"synth_assembly_backward": synth_assembly_backward, "wiener_em_backward": wiener_em_backward,
                "lstm_recurrence_backward": lstm_recurrence_backward}
    length = int(TRAIN_SECONDS * 44100)
    batch = torch.zeros((TRAIN_BATCH, 5, 2, length), device=dev)
    res = {}
    for lstm in (False, True):
        model = Unmix(slicqt.block_shapes(TRAIN_BATCH, 2, length), lstm=lstm, seed=0, device=dev)
        step, _ = make_train_step(slicqt, model, torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-5),
                                  sdr_mcoef=0.1)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        loss = float(step(batch, torch.Generator(device=dev).manual_seed(0) if lstm else None))
        ms = (time.time() - t0) * 1e3
        bad = [n for n, p in model.named_parameters() if not bool(torch.isfinite(p).all())]
        res["lstm" if lstm else "cdae"] = dict(loss=loss, step_ms=ms, non_finite_params=bad,
                                               launches={k: fn.launches for k, fn in counters.items()})
        del model, step
        torch.cuda.empty_cache()
    phase("silent_train_step", batch=TRAIN_BATCH, seconds=TRAIN_SECONDS, **res)
    for name, r in res.items():
        check(np.isfinite(r["loss"]) and not r["non_finite_params"],
              f"silent_train_step {name}: loss {r['loss']}, parameters not finite: {r['non_finite_params']}")
        path = ["synth_assembly_backward", "wiener_em_backward"] + (["lstm_recurrence_backward"] if name == "lstm"
                                                                     else [])
        check(all(r["launches"][k] > 0 for k in path), f"silent_train_step {name}: launches {r['launches']}")


def run_only(names, dev, slicqt):
    """A development run (python3 chip_smoke.py --phases a,b): the named
    tool and slice-10 phases alone after the build, with no result line."""
    from xumx_slicq_torch.models import Unmix
    from xumx_slicq_torch.separator import Separator

    def profile_only():
        sep = Separator(slicqt, Unmix(slicqt.block_shapes(1, 2, 2 * 44100), seed=0, device=dev), device=dev)
        track = (np.random.default_rng(0).standard_normal((1, 2, TRACK_SECONDS * 44100)) * 0.1).astype(np.float32)
        sep(track)
        chunk = sep.chunk_size
        profile_stats_phase(*breakdown(sep, slicqt, track, -(-track.shape[-1] // chunk), chunk))

    def devices_only(devices=None):
        sep = Separator(slicqt, Unmix(slicqt.block_shapes(1, 2, 2 * 44100), seed=0, device=dev), device=dev)
        separator_devices(sep, (np.random.default_rng(0).standard_normal((1, 2, TRACK_SECONDS * 44100)) * 0.1)
                          .astype(np.float32), devices)

    def lstm_only(fn):
        sep = Separator(slicqt, Unmix(slicqt.block_shapes(1, 2, 2 * 44100), lstm=True, seed=0, device=dev),
                        device=dev)
        track = (np.random.default_rng(0).standard_normal((1, 2, TRACK_SECONDS * 44100)) * 0.1).astype(np.float32)
        return lambda: fn(sep, track)

    def cards():
        n = torch.cuda.device_count()
        check(n >= 2, f"the *_cards phases need 2 or more cards, found {n}")
        return [f"cuda:{i}" for i in range(n)]

    clip = (np.random.default_rng(1).standard_normal((1, 2, 4 * 44100)) * 0.1).astype(np.float32)
    table = dict(export_cdae=lambda: export_phase(dev, False), export_lstm=lambda: export_phase(dev, True),
                 slicqfinder=lambda: slicqfinder_phase(dev), tuning=lambda: tuning_phase(dev),
                 profile_stats=profile_only, mesh=lambda: mesh_phases(dev), separator_devices=devices_only,
                 mesh_cards=lambda: mesh_phases(dev, cards()),
                 separator_devices_cards=lambda: devices_only([torch.device(d) for d in cards()]),
                 msgpack_weights=lambda: msgpack_weights(dev, clip), entry=entry_phase,
                 cadenza=lambda: cadenza_phase(dev), silent_train_step=lambda: silent_train_step(dev, slicqt),
                 separator_devices_lstm=lambda: lstm_only(separator_devices_lstm)(),
                 lstm_forward_device_waves=lambda: lstm_only(lambda sep, _: forward_device_waves(sep, "lstm"))(),
                 cdae_forward_device_waves=lambda: forward_device_waves(
                     Separator(slicqt, Unmix(slicqt.block_shapes(1, 2, 2 * 44100), seed=0, device=dev), device=dev),
                     "cdae"),
                 k3_analysis_gather=lambda: k3_analysis_gather(slicqt, torch.Generator(device=dev).manual_seed(3), {},
                                                               4, 2621440),
                 k4_cdae=lambda: k4_cdae(slicqt, torch.Generator(device=dev).manual_seed(4), {}, 4, 2621440))
    for name in names:
        table[name]()
    print("partial run (--phases): no result line")


def main(argv=()):
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
    from xumx_slicq_torch.kernels.analysis_gather import analysis_gather
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
    if "--phases" in argv:
        return run_only(argv[list(argv).index("--phases") + 1].split(","), dev, slicqt)
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

    # -- phase 3b: K3 against its plain version, inference and train layouts ---
    k3_analysis_gather(slicqt, g, kernels, batch, chunk)

    # -- phase 3c: K4 against its plain version, offline and realtime ----------
    k4_cdae(slicqt, g, kernels, batch, chunk)
    torch.cuda.empty_cache()

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
    sep = Separator(slicqt, perturbed(Unmix(shapes, seed=0, device=dev)), device=dev)
    n_params = sep.model.num_params()
    check(n_params == 15010446, f"canonical Unmix has {n_params} parameters, expected 15010446")
    clip = (rng.standard_normal((1, 2, 4 * 44100)) * 0.1).astype(np.float32)
    t0 = time.time()
    est_gpu = sep(clip)
    gpu_first_s = time.time() - t0
    slicqt_cpu = SliCQT(device="cpu")
    sep_cpu = Separator(slicqt_cpu, perturbed(Unmix(slicqt_cpu.block_shapes(1, 2, 2 * 44100), seed=0, device="cpu")),
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
    analysis_gather.launches = 0
    for c in k4_counters().values():
        c.launches = 0
    t0 = time.time()
    est = sep(track)                                           # the counted main-path run
    torch.cuda.synchronize()
    times = [time.time() - t0]
    launches = {"synth_assembly": synth_assembly.launches, "wiener_em": wiener_em.launches,
                "analysis_gather": analysis_gather.launches, **{k: c.launches for k, c in k4_counters().items()}}
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
    check(launches["analysis_gather"] == 1, f"K3 made {launches['analysis_gather']} launches for one chunk batch")
    for k in k4_counters():
        check(launches[k] == 1, f"K4's {k} made {launches[k]} launches for one chunk batch, expected 1")
    profile_stats_phase(*breakdown(sep, slicqt, track, batch, chunk))
    separator_devices(sep, track)
    forward_device_waves(sep, "cdae")

    # -- phase 8: realtime Separator, card against CPU, and the 236 s track ----
    sep_rt = Separator(slicqt, perturbed(Unmix(shapes, realtime=True, seed=0, device=dev)), device=dev)
    est_rt = sep_rt(clip)
    slicqt_cpu = SliCQT(device="cpu")
    sep_rt_cpu = Separator(slicqt_cpu, perturbed(Unmix(slicqt_cpu.block_shapes(1, 2, 2 * 44100), realtime=True,
                                                       seed=0, device="cpu")), device="cpu")
    diff_rt = float(np.abs(est_rt - sep_rt_cpu(clip)).max())
    del sep_rt_cpu, slicqt_cpu
    sep_rt(track)                                              # warm-up
    torch.cuda.synchronize()
    for c in k4_counters().values():
        c.launches = 0
    rt_times = []
    for i in range(3):
        t0 = time.time()
        est = sep_rt(track)
        torch.cuda.synchronize()
        rt_times.append(time.time() - t0)
        if i == 0:
            rt_launches = {k: c.launches for k, c in k4_counters().items()}
            rt_finite = bool(np.isfinite(est).all())
        del est
    phase("separator_realtime", shape=list(est_rt.shape), finite=bool(np.isfinite(est_rt).all()),
          max_abs_diff_cuda_vs_cpu=diff_rt, tol=STEM_TOL, track_s_per_track=rt_times,
          track_s_per_track_median=float(np.median(rt_times)), track_k4_launches=rt_launches)
    check(est_rt.shape == (4, 1, 2, clip.shape[-1]) and np.isfinite(est_rt).all(), "bad realtime stems")
    check(diff_rt <= STEM_TOL, f"realtime stems on the card differ from the CPU's by {diff_rt} > {STEM_TOL}")
    check(rt_finite and rt_launches == dict.fromkeys(k4_counters(), 1),
          f"realtime 236 s track: finite {rt_finite}, K4 launches {rt_launches} (expected 1 each)")
    del sep, sep_rt

    # -- phases 9-14: the LSTM variant, K5 --------------------------------------
    k5_lstm_recurrence(slicqt, g, kernels, batch, S)
    torch.cuda.empty_cache()
    sep_lstm = lstm_separator_cuda_vs_cpu(slicqt, dev, rng)
    lstm_track_236s(sep_lstm, track, kernels, batch)
    separator_devices_lstm(sep_lstm, track)
    forward_device_waves(sep_lstm, "lstm")
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
    torch.cuda.empty_cache()
    silent_train_step(dev, slicqt)

    # -- phases 24-26: evaluation and the bench --------------------------------
    torch.cuda.empty_cache()
    bsseval_device(dev, card)
    torch.cuda.empty_cache()
    eval_pipeline(dev)
    torch.cuda.empty_cache()
    bench_torch_runs()

    # -- phases 27-30: the tools ------------------------------------------------
    torch.cuda.empty_cache()
    export_phase(dev, lstm=False)
    export_phase(dev, lstm=True)
    slicqfinder_phase(dev)
    torch.cuda.empty_cache()
    tuning_phase(dev)

    # -- phases 31-36: ranks, params.msgpack, entry, the Cadenza runner --------
    torch.cuda.empty_cache()
    msgpack_weights(dev, clip)
    entry_phase()
    torch.cuda.empty_cache()
    mesh_phases(dev)
    torch.cuda.empty_cache()
    cadenza_phase(dev)

    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms"]
    print(card)
    print(json.dumps({"kernels": [{k: kern[k] for k in order} for kern in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--exported-child"]:
        exported_child(*sys.argv[2:5])
    else:
        main(sys.argv[1:])
