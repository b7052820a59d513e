#!/usr/bin/env python3
"""K5 and K5b (csrc/lstm_recurrence.cu) of this checkout against another
checkout's on one NVIDIA GPU, and the dependent-chain latencies behind
chip_smoke.py's STEP_CHAIN_CYCLES.

    python3 tools/k5_ab.py [--parent DIR] [--batch N ...] [--backward] [--track] [--latency] [--sass DIR]

chip_smoke.py times this checkout alone; a kernel's gain is read against
its parent's in one call, since the card's clock and power limit may
differ from call to call. So each turn here is a process that puts one
checkout's package first on its path (this one, or --parent DIR: another
commit unpacked with `git archive` into a directory that git ignores) and
runs this checkout's chip_smoke.py measurements on it, in the turns
parent, change, change, parent:
  * K5 for one layer at the main path's layout (bark-262, the canonical
    LSTM model, the default chunk at chunk batch N, default 4), offline
    and realtime, with the ns per step of each hidden-size group alone
    (chip_smoke.k5_per_hidden);
  * --backward: chip_smoke's phase k5_backward (K5's train-mode forward
    and K5b at batch 32 of 2 s, against their plain versions);
  * --track: its phases lstm_track_236s and lstm_realtime_track_236s (the
    LSTM demix of a seeded 236 s track).
--sass DIR writes `cuobjdump -sass` of each version's K5 library there.
--latency times dependent chains on the card in SM cycles (clock64, one
warp): one instruction each (FFMA, MUFU.EX2, MUFU.RCP, libm's tanhf,
SHFL), one H = 1 LSTM step with libm's activations, with ex2/rcp ones and
with the kernel's own row_sum and cell_, eight independent MUFU.EX2, and
the kernel's own group walk at H = 1, 2 and 4 timed inside.
Prints one JSON object per result, each tagged with its version and turn;
--out also writes them all to a file.
"""

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
CHUNK = 2621440                 # the Separator's default chunk (samples)


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


cs = load_chip_smoke()
RESULTS = []


def emit(**fields):
    print(json.dumps(fields), flush=True)
    RESULTS.append(fields)


LATENCY_CU = r"""
#include <math.h>
#include "lstm_recurrence.cu"

__device__ __forceinline__ float sig_libm(float x) { return fmaf(0.5f, tanhf(0.5f * x), 0.5f); }
__device__ __forceinline__ float sig_sfu(float x) { return rcp_(1.f + ex2_(x * -1.4426950408889634f)); }
__device__ __forceinline__ float tanh_sfu(float x) { return fmaf(2.f, rcp_(1.f + ex2_(x * -2.8853900817779268f)), -1.f); }

template <int OP>
__global__ void chain(float* out, long long* cycles, float x0, int n) {
    float x = x0 + threadIdx.x * 1e-7f, c = 0.f;
    long long t0 = clock64();
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
        if (OP == 0) x = fmaf(x, 0.999f, 1e-3f);
        if (OP == 1) x = ex2_(fmaf(x, -0.5f, 0.1f));
        if (OP == 2) x = rcp_(fmaf(x, 0.5f, 0.75f));
        if (OP == 3) x = tanhf(fmaf(x, 0.9f, 0.3f));
        if (OP == 4) x = __shfl_sync(0xffffffffu, fmaf(x, 0.999f, 1e-3f), (threadIdx.x + 1) & 31);
        if (OP == 5 || OP == 6) {          // x is h: one H = 1 step, gates from fixed projections and weights
            const bool s = OP == 6;
            const float i_ = s ? sig_sfu(fmaf(x, 0.7f, 0.3f)) : sig_libm(fmaf(x, 0.7f, 0.3f));
            const float f_ = s ? sig_sfu(fmaf(x, -0.4f, 1.1f)) : sig_libm(fmaf(x, -0.4f, 1.1f));
            const float g_ = s ? tanh_sfu(fmaf(x, 0.9f, -0.2f)) : tanhf(fmaf(x, 0.9f, -0.2f));
            const float o_ = s ? sig_sfu(fmaf(x, 0.5f, 0.6f)) : sig_libm(fmaf(x, 0.5f, 0.6f));
            c = fmaf(f_, c, i_ * g_);
            x = o_ * (s ? tanh_sfu(c) : tanhf(c));
        }
        if (OP == 8) {                     // eight independent MUFU.EX2 chains: the SFU's dispatch rate
            float y[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) y[k] = ex2_(x + k * 1e-3f) * 0.5f;
            x = ((y[0] + y[1]) + (y[2] + y[3])) + ((y[4] + y[5]) + (y[6] + y[7]));
        }
        if (OP == 7) {                     // the kernel's own step at H = 1 (row_sum and cell_), c as zc
            const float hk[1] = {x};
            const float w[4][1] = {{0.7f * S_SIG}, {-0.4f * S_SIG}, {0.9f * S_TANH}, {0.5f * S_SIG}};
            const float z[4] = {row_sum<1>(0.3f, S_SIG, hk, w[0]), row_sum<1>(1.1f, S_SIG, hk, w[1]),
                                row_sum<1>(-0.2f, S_TANH, hk, w[2]), row_sum<1>(0.6f, S_SIG, hk, w[3])};
            x = cell_(z, c);
        }
    }
    long long t1 = clock64();
    out[threadIdx.x] = x + c;
    if (threadIdx.x == 0) *cycles = t1 - t0;
}

// The kernel's own group walk of one sequence batch (H = GS), timed inside with clock64
template <int GS>
__global__ void __launch_bounds__(THREADS) timed_walk(const float* xp, const float* wT, float* out, int frames, int B,
                                                      int dirs, int n, long long* cycles) {
    long long t0 = clock64();
    group_sequence<GS, false, GS != 1>(xp, wT, out, nullptr, GS, frames, B, dirs, 0, n);
    long long t1 = clock64();
    if (threadIdx.x == 0) *cycles = t1 - t0;
}

extern "C" int walk_cycles(int H, const void* xp, const void* wT, void* out, int frames, int B, int dirs, int n,
                           void* cycles) {
    const float* x = (const float*)xp;
    const float* w = (const float*)wT;
    float* o = (float*)out;
    long long* c = (long long*)cycles;
    switch (H) {
        case 1: timed_walk<1><<<1, THREADS>>>(x, w, o, frames, B, dirs, n, c); break;
        case 2: timed_walk<2><<<1, THREADS>>>(x, w, o, frames, B, dirs, n, c); break;
        default: timed_walk<4><<<1, THREADS>>>(x, w, o, frames, B, dirs, n, c); break;
    }
    return (int)cudaGetLastError();
}

extern "C" int chain_latency(int op, int n, void* out, void* cycles) {
    float* o = (float*)out;
    long long* c = (long long*)cycles;
    switch (op) {
        case 0: chain<0><<<1, 32>>>(o, c, 0.5f, n); break;
        case 1: chain<1><<<1, 32>>>(o, c, 0.5f, n); break;
        case 2: chain<2><<<1, 32>>>(o, c, 0.5f, n); break;
        case 3: chain<3><<<1, 32>>>(o, c, 0.5f, n); break;
        case 4: chain<4><<<1, 32>>>(o, c, 0.5f, n); break;
        case 5: chain<5><<<1, 32>>>(o, c, 0.5f, n); break;
        case 6: chain<6><<<1, 32>>>(o, c, 0.5f, n); break;
        case 7: chain<7><<<1, 32>>>(o, c, 0.5f, n); break;
        default: chain<8><<<1, 32>>>(o, c, 0.5f, n); break;
    }
    return (int)cudaGetLastError();
}
"""
LATENCY_OPS = ["ffma", "ffma+ex2", "ffma+rcp", "ffma+tanhf", "ffma+shfl", "lstm_step_h1_libm", "lstm_step_h1_ex2_rcp",
               "lstm_step_h1_kernel", "ex2_x8_independent"]


def latency(build):
    """Dependent-chain cycles per iteration of LATENCY_OPS, one warp."""
    src = build.BUILD_DIR / "chain_latency.cu"
    lib = build.BUILD_DIR / "libchain_latency.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(LATENCY_CU)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).chain_latency
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    out = torch.empty(32, device="cuda")
    cyc = torch.empty(1, dtype=torch.int64, device="cuda")
    n = 4096
    row = {}
    for op, name in enumerate(LATENCY_OPS):
        for _ in range(2):                               # the second run is timed warm
            assert fn(op, n, out.data_ptr(), cyc.data_ptr()) == 0
            torch.cuda.synchronize()
        row[name] = int(cyc.item()) / n
    emit(phase="chain_latency_cycles", iterations=n, **row)
    # the kernel's own walk of 32 sequences (4 targets x 2 directions x B = 4), H lanes each: cycles per step
    # from clock64 inside, and the SM clock that the same launch's CUDA-event time implies
    walk = ctypes.CDLL(str(lib)).walk_cycles
    walk.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    frames, B, dirs = 20000, 4, 2
    rows = {}
    for H in (1, 2, 4):
        xp = torch.randn(4 * dirs * frames * B * 4 * H, device="cuda")
        w = (torch.rand(4 * dirs * H * 4 * H, device="cuda") * 2 - 1) / H ** 0.5
        o = torch.empty(4 * frames * B * dirs * H, device="cuda")
        run = lambda: walk(H, xp.data_ptr(), w.data_ptr(), o.data_ptr(), frames, B, dirs, 4 * dirs * B, cyc.data_ptr())
        ms = cs.cuda_ms(run, reps=3, warm=1)
        rows[f"H{H}"] = dict(cycles_per_step=int(cyc.item()) / frames, ns_per_step=ms * 1e6 / frames,
                            implied_mhz=int(cyc.item()) / (ms * 1e3))
    emit(phase="walk_cycles_one_lane", frames=frames, **rows)


def turn(root: Path, batches, backward: bool, track: bool):
    """One version's measurements, in this process: the package under root
    first on the path, chip_smoke's phases printing one JSON line each."""
    import numpy as np

    sys.path.insert(0, str(root))
    import xumx_slicq_torch
    from xumx_slicq_torch.kernels import build
    from xumx_slicq_torch.kernels.lstm_recurrence import lstm_recurrence
    from xumx_slicq_torch.models import Unmix
    from xumx_slicq_torch.ops.slicqt import SliCQT
    from xumx_slicq_torch.separator import Separator

    cs.check(Path(xumx_slicq_torch.__file__).resolve().parent.parent == root.resolve(),
             f"xumx_slicq_torch imported from {xumx_slicq_torch.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all(["lstm_recurrence"])
    dev = torch.device("cuda")
    slicqt = SliCQT(device=dev)
    S, clock = slicqt.n_slices(CHUNK), cs.max_sm_clock_mhz()
    for batch in batches:
        for realtime in (False, True):
            layout, xp, w = cs.k5_inputs(slicqt, batch, S, realtime, torch.Generator(device=dev).manual_seed(0))
            cs.phase("k5_layer", mode="realtime" if realtime else "offline", chunk_batch=batch,
                     ms=cs.cuda_ms(lambda: lstm_recurrence(xp, w, layout), reps=3, warm=1), max_sm_clock_mhz=clock,
                     per_hidden=cs.k5_per_hidden(layout, xp, w, clock))
            del xp, w
            torch.cuda.empty_cache()
    if backward:
        cs.k5_backward(slicqt, torch.Generator(device=dev).manual_seed(1), {})
    if track:
        audio = (np.random.default_rng(0).standard_normal((1, 2, cs.TRACK_SECONDS * 44100)) * 0.1).astype(np.float32)
        batch = next(b for b in Separator._CHUNK_BATCH_BUCKETS if b * CHUNK >= audio.shape[-1])
        sep = Separator(slicqt, Unmix(slicqt.block_shapes(1, 2, 2 * 44100), lstm=True, seed=0, device=dev),
                        device=dev)
        cs.lstm_track_236s(sep, audio, {"lstm_recurrence": {}}, batch)
        del sep
        cs.lstm_realtime_track_236s(slicqt, dev, audio, batch)


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--parent", help="root of another checkout whose K5 runs against this one's")
    ap.add_argument("--batch", type=int, nargs="+", default=[4], help="chunk batches of the K5 layouts")
    ap.add_argument("--backward", action="store_true", help="also chip_smoke's phase k5_backward")
    ap.add_argument("--track", action="store_true", help="also the LSTM demix of a seeded 236 s track")
    ap.add_argument("--latency", action="store_true", help="time dependent chains of instructions")
    ap.add_argument("--sass", help="directory for cuobjdump -sass of each version's K5 library")
    ap.add_argument("--out", help="write every result to this JSON file too")
    ap.add_argument("--turn", help=argparse.SUPPRESS)        # the root of the version one turn runs
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    if args.turn:
        return turn(Path(args.turn), args.batch, args.backward, args.track)
    sys.path.insert(0, str(ROOT))
    from xumx_slicq_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit(phase="card", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    if args.latency:
        latency(build)
    roots = {"change": ROOT}
    if args.parent:
        roots["parent"] = Path(args.parent).resolve()
    order = ["parent", "change", "change", "parent"] if args.parent else ["change", "change"]
    flags = [*(["--backward"] if args.backward else []), *(["--track"] if args.track else []),
             "--batch", *map(str, args.batch)]
    for n, version in enumerate(order):
        run = subprocess.run([sys.executable, __file__, "--turn", str(roots[version]), *flags],
                             capture_output=True, text=True)
        lines = [json.loads(x) for x in run.stdout.splitlines() if x.startswith("{")]
        for fields in lines:
            emit(version=version, turn=n, **fields)
        if run.returncode:
            cs.fail(f"turn {n} ({version}) exited {run.returncode}: {run.stdout[-2000:]} {run.stderr[-4000:]}")
        if args.sass and version not in order[:n]:
            lib = roots[version] / "build" / "xumx_slicq_torch" / "liblstm_recurrence.so"
            cuobjdump = str(Path(build._nvcc()).parent / "cuobjdump")
            sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
            Path(args.sass).mkdir(parents=True, exist_ok=True)
            (Path(args.sass) / f"k5_sass_{version}.txt").write_text(sass)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(RESULTS, indent=1))


if __name__ == "__main__":
    main()
