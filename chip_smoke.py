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
training path: K1's and K2's backward kernels against their plain versions
at the training shapes, one train step on the card against the CPU at
mel-12, 13 full-width train steps (batch 32 of 2.0 s) with launch counts,
memory and a profile, and the trainer's CLI with a resume and a reload.
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


def _train_batch(seed: int, length: int, batch: int) -> np.ndarray:
    stems = (np.random.default_rng(seed).standard_normal((batch, 4, 2, length)) * 0.1).astype(np.float32)
    stems[0, 1] = 0.0                                          # a silent stem: exact zeros
    return np.concatenate([stems.sum(1, keepdims=True), stems], axis=1)


def train_cuda_vs_cpu(dev):
    """One train step with every loss term (so through K2's and K1's
    backward kernels) at mel-12, batch 2 of 0.3 s, on the card and on the
    CPU from the same weights and batch; and the card's step with bf16
    conv operands (--bf16) against the CPU's fp32 loss."""
    from xumx_slicq_torch.models import Unmix
    from xumx_slicq_torch.ops.slicqt import SliCQT
    from xumx_slicq_torch.training import make_train_step

    length = int(0.3 * 44100)
    batch = _train_batch(1, length, 2)
    res = []
    for d, amp in ((dev, False), (torch.device("cpu"), False), (dev, True)):
        t = SliCQT(scale="mel", fbins=12, fmin=200.0, device=d)
        model = Unmix(t.block_shapes(2, 2, length), amp=amp, seed=1, device=d)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-5)
        step, _ = make_train_step(t, model, opt, sdr_mcoef=0.1)
        loss = float(step(torch.from_numpy(batch).to(d)))
        res.append((loss, {n: p.grad.cpu().double() for n, p in model.named_parameters()}))
    (lg, gg), (lc, gc), (lb, _) = res
    bf16_rel = abs(lb - lc) / abs(lc)
    loss_rel = abs(lg - lc) / abs(lc)
    norms = {n: float(torch.linalg.vector_norm(a)) for n, a in gc.items()}
    floor = 1e-3 * max(norms.values())          # gradients that train-mode BatchNorm cancels: rounding noise
    grad_rel = max(float(torch.linalg.vector_norm(gg[n] - gc[n])) / max(norms[n], floor) for n in gc)
    phase("train_cuda_vs_cpu", loss_cuda=lg, loss_cpu=lc, loss_rel=loss_rel, loss_tol=TRAIN_LOSS_TOL,
          max_grad_rel=grad_rel, grad_tol=TRAIN_GRAD_TOL, tensors=len(gc), loss_cuda_bf16=lb,
          bf16_loss_rel=bf16_rel, bf16_tol=BF16_LOSS_TOL)
    check(np.isfinite(lg) and loss_rel <= TRAIN_LOSS_TOL, f"train loss on the card {lg} vs CPU {lc}")
    check(grad_rel <= TRAIN_GRAD_TOL, f"train gradients on the card differ from the CPU: {grad_rel}")
    check(bf16_rel <= BF16_LOSS_TOL, f"bf16 train loss on the card {lb} vs fp32 on the CPU {lc}")


def train_steps(dev, slicqt, kernels):
    """The training path at full width: the canonical model, batch 32 of
    2.0 s from a seeded SyntheticDataset, AdamW at the JAX trainer's
    defaults. 10 steps on one fixed batch, then 3 steps with SD-SDR on
    fresh batches from the loader, then one valid step; launches of every
    kernel counted per step."""
    from xumx_slicq_torch.data import DataLoader, SyntheticDataset
    from xumx_slicq_torch.kernels.synth_assembly import synth_assembly, synth_assembly_backward
    from xumx_slicq_torch.kernels.wiener_em import wiener_em, wiener_em_backward
    from xumx_slicq_torch.models import Unmix
    from xumx_slicq_torch.training import make_train_step

    counters = {"synth_assembly": synth_assembly, "synth_assembly_backward": synth_assembly_backward,
                "wiener_em": wiener_em, "wiener_em_backward": wiener_em_backward}
    loader = DataLoader(SyntheticDataset(n_tracks=8, seq_duration=TRAIN_SECONDS, samples_per_track=4, seed=0),
                        TRAIN_BATCH, shuffle=True, seed=0, drop_last=True, workers=4)

    def next_batch():                  # 32 items: each epoch of the loader is one batch
        it = iter(loader)
        batch = torch.from_numpy(next(it)).to(dev)
        it.close()
        return batch

    fixed = next_batch()
    model = Unmix(slicqt.block_shapes(TRAIN_BATCH, 2, int(TRAIN_SECONDS * 44100)), seed=0, device=dev)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-5)
    step, valid = make_train_step(slicqt, model, opt)
    step_sdr, _ = make_train_step(slicqt, model, opt, sdr_mcoef=0.1)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    losses, times, per_step = [], [], []
    for i in range(13):
        before = {k: fn.launches for k, fn in counters.items()}
        t0 = time.time()
        if i < 10:
            loss = step(fixed)
        else:
            loss = step_sdr(next_batch())
        losses.append(float(loss))                             # waits for the step
        times.append(time.time() - t0)
        per_step.append({k: fn.launches - before[k] for k, fn in counters.items()})
    vloss = float(valid(fixed))
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    wall, busy, n_launches, top, host_top = profiled(lambda: step(fixed))
    phase("train_steps", batch=TRAIN_BATCH, seconds=TRAIN_SECONDS, params=model.num_params(), losses=losses,
          valid_loss=vloss, first_step_s=times[0], step_s=times, median_ms_steps_3_10=float(np.median(times[2:10])) * 1e3,
          median_ms_sdr_steps=float(np.median(times[10:])) * 1e3, max_memory_allocated_bytes=peak,
          launches=launches, launches_per_step=per_step, profiled_step_wall_ms=wall,
          device_busy_ms=busy if busy is not None else "not measured",
          device_busy_share=busy / wall if busy is not None else "not measured", kernel_launches=n_launches,
          top_kernels=top, top_host_ops_ms=host_top)
    check(all(np.isfinite(losses)) and np.isfinite(vloss), f"non-finite training loss: {losses}, valid {vloss}")
    check(losses[9] < losses[0], f"the loss on the fixed batch did not fall: {losses[0]} -> {losses[9]}")
    for i, n in enumerate(per_step):
        check(n["wiener_em"] == 3 and n["wiener_em_backward"] == 2, f"step {i + 1}: K2 launches {n}")
        sdr = i >= 10
        check((n["synth_assembly_backward"] > 0) == sdr and (n["synth_assembly"] > 0) == sdr,
              f"step {i + 1}: K1 launches {n} (SD-SDR {sdr})")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the training path")
        if name.endswith("_backward"):
            kernels[name]["launches"] = n


def trainer_cli(dev, clip):
    """training_main on the card with its defaults (bark-262, AdamW,
    plateau schedule), one short epoch, a resume for a second, then
    Separator.load of the directory it wrote and a demix."""
    import shutil

    from xumx_slicq_torch.separator import Separator
    from xumx_slicq_torch.training import training_main

    d = ROOT / "build" / "chip_smoke_model"
    shutil.rmtree(d, ignore_errors=True)
    args = ["--synthetic-dataset", "--batch-size", "8", "--epochs", "1", "--max-batches-per-epoch", "3",
            "--debug", "--model-path", str(d), "--quiet"]
    t0 = time.time()
    train1, valid1 = training_main(args)
    args[args.index("--epochs") + 1] = "2"
    train2, valid2 = training_main(args)
    train_s = time.time() - t0
    est = Separator.load(model_path=d, device=dev)(clip)
    phase("trainer_cli", train_loss=train2, valid_loss=valid2, seconds=train_s,
          files=sorted(p.name for p in d.iterdir()), stems_shape=list(est.shape))
    check(len(train2) == 2 and train2[:1] == train1 and valid2[:1] == valid1, "resume lost the history")
    check(all(np.isfinite(train2 + valid2)), f"non-finite trainer losses {train2} {valid2}")
    check(est.shape == (4, 1, 2, clip.shape[-1]) and np.isfinite(est).all(), "bad stems from the trained model")
    shutil.rmtree(d, ignore_errors=True)


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
    del sep, sep_rt, track

    # -- phases 9-13: the backward kernels and the training path -------------
    k1_backward(slicqt, g, kernels)
    k2_backward(slicqt, g, kernels)
    torch.cuda.empty_cache()
    train_cuda_vs_cpu(dev)
    train_steps(dev, slicqt, kernels)
    torch.cuda.empty_cache()
    trainer_cli(dev, clip)

    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms"]
    print(card)
    print(json.dumps({"kernels": [{k: kern[k] for k in order} for kern in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
