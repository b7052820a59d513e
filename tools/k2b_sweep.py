#!/usr/bin/env python3
"""K2's backward passes (kernels/triton_wiener_em.py) at the training layout
on one NVIDIA GPU, over tile shapes and warp counts.

    python3 tools/k2b_sweep.py [--out FILE]

The layout is chip_smoke.py's k2_backward phase: bark-262, batch 32 of
2.0 s, inputs from chip_smoke.k2_inputs. For each pass and each setting
the script launches the kernel itself (the package's launchers keep their
own fixed settings), checks its output against the package's default
launch (max |a - b| / max |b| <= chip_smoke.K2B_TOL) and prints one JSON
line: ms from CUDA events, TB/s of the pass's bytes (x, v and the
cotangent read, 112 B a position; pass 2 also writes dL/dv, 32 B),
registers and spills from Triton's compiled kernel. Settings: pass 1 tiles
of BLOCK frames over its CHUNK; pass 2 its SUB-frame tiles of the BLOCK a
work item holds, where the kernel takes SUB; num_warps 2-8.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", help="write every result to this JSON file too")
    args = ap.parse_args()
    cs = load_chip_smoke()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    from xumx_slicq_torch.kernels import triton_wiener_em as tw
    from xumx_slicq_torch.kernels.wiener_em import BLOCK, CHUNK, EPS, _device_tables, launch_forward
    from xumx_slicq_torch.ops.slicqt import SliCQT

    results = []

    def emit(**fields):
        print(json.dumps(fields), flush=True)
        results.append(fields)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit(phase="card", nvidia_smi=smi, torch=torch.__version__)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    slicqt = SliCQT(device=dev)
    layout = slicqt.layout(cs.TRAIN_BATCH, 2, slicqt.n_slices(int(cs.TRAIN_SECONDS * 44100)))
    x, v = cs.k2_inputs(layout, g)
    gy = torch.randn(4 * layout.size, generator=g, device=dev, dtype=torch.complex64)
    _, parts, maxima = launch_forward(x, v, layout)
    tables = _device_tables(layout, dev)
    positions = layout.size // 2
    xr, gyr = torch.view_as_real(x), torch.view_as_real(gy)
    items1, items2 = tables["items1"], tables["items2"]
    gpart_ref, gv_ref = torch.empty_like(parts), torch.empty_like(v)
    tw.backward_pass1(x, v, gy, tables, parts, maxima, gpart_ref)
    tw.backward_pass2(x, v, gy, tables, parts, maxima, gpart_ref, gv_ref)
    torch.cuda.synchronize()
    emit(phase="layout", buckets=len(layout.shapes), positions=positions, items1=items1.shape[0],
         items2=items2.shape[0], chunk=CHUNK, block=BLOCK)

    def run(name, launch, out, ref, nbytes, **knobs):
        try:
            compiled = launch()
            torch.cuda.synchronize()
        except Exception as e:                       # a setting Triton refuses (too many registers, ...)
            emit(phase=name, **knobs, error=str(e)[:300])
            return
        rel = float((out - ref).abs().max() / ref.abs().max())
        ms = cs.cuda_ms(launch, reps=20)
        emit(phase=name, **knobs, ms=ms, tbytes_per_s=positions * nbytes / (ms * 1e-3) / 1e12,
             n_regs=getattr(compiled, "n_regs", None), n_spills=getattr(compiled, "n_spills", None),
             rel_err_vs_default=rel, ok=rel <= cs.K2B_TOL)

    gpart = torch.empty_like(parts)
    for block in (64, 128, 256):
        for warps in (2, 4, 8):
            run("bwd_pass1", lambda: tw._em_bwd_pass1[(items1.shape[0],)](
                xr, v, gyr, tables["buckets"], items1, parts, maxima, gpart, EPS, EPS ** 0.5,
                CHUNK=CHUNK, BLOCK=block, num_warps=warps), gpart, gpart_ref, 112, block=block, num_warps=warps)
    gv = torch.empty_like(v)
    subs = (64, 128, 256) if "SUB" in tw._em_bwd_pass2.arg_names else (None,)
    for sub in subs:
        for warps in (2, 4, 8):
            extra = {} if sub is None else {"SUB": sub}
            run("bwd_pass2", lambda: tw._em_bwd_pass2[(items2.shape[0],)](
                xr, v, gyr, tables["buckets"], items2, parts, maxima, gpart_ref, gv, EPS, EPS ** 0.5,
                BLOCK=BLOCK, num_warps=warps, **extra), gv, gv_ref, 144, sub=sub, num_warps=warps)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
