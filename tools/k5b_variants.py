#!/usr/bin/env python3
"""K5b (csrc/lstm_recurrence.cu's backward entry) built from several
sources and launch bounds, timed in one process on one NVIDIA GPU.

    python3 tools/k5b_variants.py LABEL=SOURCE.cu [...] [--min-blocks N ...] [--out FILE]

Each SOURCE is a whole lstm_recurrence.cu (this checkout's, or an earlier
design kept under a directory git ignores); --min-blocks N also builds it
with __launch_bounds__(THREADS, N) on the backward kernel (ptxas then holds
it to 65,536 / (128 N) registers; a source that picks its bounds per table
gets N for both of its builds). Every build is timed at the training
layout (batch 32 of 2 s, bark-262, chip_smoke.k5_inputs), offline and
realtime, with two work tables: this checkout's (W_hh held in shared memory
wherever it fits) and one that holds it only where two blocks still fit an
SM (else from L2). Each result is checked against this checkout's K5b
(max |a - b| / max |b| <= chip_smoke.K5B_TOL on d(xp) and d(W_hh)) and
printed as one JSON line with ptxas's registers and spills.
"""

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
# the backward kernel's launch bounds as the sources write them: fixed, or chosen by the host per table
BOUNDS = ("__launch_bounds__(THREADS)\nlstm_recurrence_backward_kernel(", "__launch_bounds__(THREADS, MIN_BLOCKS)")


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("sources", nargs="+", help="LABEL=path of an lstm_recurrence.cu")
    ap.add_argument("--min-blocks", type=int, nargs="*", default=[], help="also build with these launch bounds")
    ap.add_argument("--out", help="write every result to this JSON file too")
    args = ap.parse_args()
    cs = load_chip_smoke()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    from xumx_slicq_torch.kernels import build
    from xumx_slicq_torch.kernels import lstm_recurrence as k5
    from xumx_slicq_torch.ops.slicqt import SliCQT

    results = []

    def emit(**fields):
        print(json.dumps(fields), flush=True)
        results.append(fields)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit(phase="card", nvidia_smi=smi, torch=torch.__version__)
    out_dir = build.BUILD_DIR / "k5b_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = {}
    procs = []
    for spec in args.sources:
        label, path = spec.split("=", 1)
        src = Path(path).read_text()
        bounds = [b for b in BOUNDS if b in src]
        cs.check(len(bounds) == 1, f"{path}: no backward kernel declaration to bound")
        for mb in [None, *args.min_blocks]:
            name = label if mb is None else f"{label}_mb{mb}"
            cu = out_dir / f"{name}.cu"
            fixed = bounds[0].replace("(THREADS)", f"(THREADS, {mb})").replace("MIN_BLOCKS)", f"{mb})")
            cu.write_text(src if mb is None else src.replace(bounds[0], fixed))
            lib = out_dir / f"lib{name}.so"
            procs.append((name, lib, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc failed for {name}: {log[-3000:]}")
        kernels = {}                                  # each backward kernel's (registers, spill store bytes)
        for part in log.split("Compiling entry function")[1:]:
            fn_name = re.search(r"'(\S+)'", part).group(1)
            if "backward_kernel" in fn_name:
                regs, spill = re.search(r"Used (\d+) registers", part), re.search(r"(\d+) bytes spill stores", part)
                kernels[fn_name] = (int(regs.group(1)) if regs else None, int(spill.group(1)) if spill else None)
        fn = ctypes.CDLL(str(lib)).lstm_recurrence_backward
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        builds[name] = fn
        emit(phase="build", variant=name, registers_spill_store_bytes=kernels)

    dev = torch.device("cuda")
    slicqt = SliCQT(device=dev)
    S2 = slicqt.n_slices(int(cs.TRAIN_SECONDS * 44100))
    limit = build.function("lstm_recurrence", "lstm_recurrence_smem_limit", ())()
    two_an_sm = 113 * 1024                     # two blocks of this much dynamic shared memory fit an H100's SM
    for realtime in (False, True):
        mode = "realtime" if realtime else "offline"
        g = torch.Generator(device=dev).manual_seed(1)
        layout, xp, w = cs.k5_inputs(slicqt, cs.TRAIN_BATCH, S2, realtime, g)
        dh = torch.randn(layout.h_size, generator=g, device=dev)
        h, c = k5.lstm_recurrence_with_cell(xp, w, layout)
        dxp_ref, dw_ref = k5.lstm_recurrence_backward(xp, w, h, c, dh, layout)
        dxp = torch.empty_like(xp)
        parts = torch.empty((layout.batch, layout.w_size), device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (xp, w, h, c, dh, dxp, parts)]
        for table, lim in (("held_where_it_fits", limit), ("held_where_two_fit_an_sm", two_an_sm)):
            items_np = k5.work_items(layout, True, lim)
            items = torch.from_numpy(items_np).to(dev)
            smem = k5.smem_bytes(items_np, True)
            for name, fn in builds.items():
                run = lambda: cs.check(fn(*ptrs, layout.w_size, items.data_ptr(), items.shape[0], smem, stream) == 0,
                                       f"{name}: launch failed")
                run()
                torch.cuda.synchronize()
                dxp_rel = float((dxp - dxp_ref).abs().max() / dxp_ref.abs().max())
                dw_rel = float((parts.sum(0) - dw_ref).abs().max() / dw_ref.abs().max())
                ms = cs.cuda_ms(run, reps=5, warm=1)
                emit(phase="k5b_variant", mode=mode, table=table, smem_bytes=smem, blocks=items_np.shape[0],
                     variant=name, ms=ms, dxp_rel_err=dxp_rel, dw_rel_err=dw_rel,
                     ok=dxp_rel <= cs.K5B_TOL and dw_rel <= cs.K5B_TOL)
        del xp, w, h, c, dh, dxp, parts, dxp_ref, dw_ref
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
