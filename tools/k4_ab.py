#!/usr/bin/env python3
"""K4 (the folded CDAE's four launches), the `cdae` stage and the offline
demix of this checkout against another checkout's on one NVIDIA GPU.

    python3 tools/k4_ab.py --parent DIR [--sass DIR] [--out FILE]

Each turn is a process that puts one checkout's package first on its path
(this one, or --parent DIR: another commit unpacked with `git archive` into
a directory that git ignores) and measures, in the turns parent, change,
change, parent (the card's clock and power limit may differ from call to
call, so versions are compared within one call):
  * `k4_layers`: K4's four launches at the main path's layout (bark-262, a
    chunk batch of 4 default chunks from SliCQT.forward of 0.1-RMS noise),
    offline and realtime, BatchNorm and whitening drawn off their defaults:
    each launch's ms between CUDA events (median of 10 calls after 2), the
    four together, the masks' max abs error against the plain version
    (cuDNN, TF32 off) and whether two calls are bit-equal;
  * `cdae_stage`: `Unmix.magnitudes` with the folded weights on that chunk
    batch (what `track_breakdown` calls the `cdae` stage), ms between CUDA
    events (mean of 10 calls after 2);
  * `track_236s`: the canonical offline CDAE Separator on a seeded 236 s
    stereo track (one chunk batch of 4), s/track of 5 runs after a warm-up,
    each ending in a synchronize.
--sass DIR, after each version's first turn: registers and spills of each
K4 kernel (`nvcc -Xptxas -v` on its source), and the count
of HMMA (tensor-core mma) and LDGSTS (cp.async) instructions in each
kernel's SASS (`cuobjdump -sass` of the library the turn built); the
listings go to DIR. Prints one JSON object per result, tagged with its
version and turn; --out also writes them all to a file.
"""

import argparse
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
CHUNK = 2621440                 # the Separator's default chunk (samples)
BATCH = 4                       # a 236 s track's chunk batch
LAYERS = ("enc1", "enc2", "dec1", "dec2")


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


def turn(root: Path):
    """One version's measurements, in this process."""
    sys.path.insert(0, str(root))
    import xumx_slicq_torch
    from xumx_slicq_torch.kernels import cdae_conv
    from xumx_slicq_torch.models import Unmix
    from xumx_slicq_torch.ops.slicqt import SliCQT
    from xumx_slicq_torch.separator import Separator

    cs.check(Path(xumx_slicq_torch.__file__).resolve().parent.parent == root.resolve(),
             f"xumx_slicq_torch imported from {xumx_slicq_torch.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    slicqt = SliCQT(device=dev)
    shapes = slicqt.block_shapes(1, 2, 2 * 44100)
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((BATCH, 2, CHUNK), generator=g, device=dev) * 0.1
    with torch.inference_mode():
        X = slicqt.forward(a)
    del a
    layout = X.layout
    for realtime in (False, True):
        model = cs.perturbed(Unmix(shapes, realtime=realtime, seed=0, device=dev))
        weights = model.inference_weights()
        plan, items, rtab, sizes = cdae_conv._device_tables(layout, weights.arch, realtime, dev)
        with torch.inference_mode():
            mags, masks = cdae_conv.cdae_folded(X.packed, weights, layout, realtime)
            mags2, masks2 = cdae_conv.cdae_folded(X.packed, weights, layout, realtime)
            torch.cuda.synchronize()
            bit_equal = bool(torch.equal(masks, masks2) and torch.equal(mags, mags2))
            _, ref = cdae_conv.cdae_folded_plain(X.packed, weights.w, layout, weights.arch, realtime)
            err = float((masks - ref).abs().max())
            del mags, masks, mags2, masks2, ref
            events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            per_layer, total = {k: [] for k in LAYERS}, []
            for _ in range(12):
                cdae_conv.launch(X.packed, weights.w, plan, items, rtab, layout, weights.arch.targets, sizes, events)
                torch.cuda.synchronize()
                for i, k in enumerate(LAYERS):
                    per_layer[k].append(events[i].elapsed_time(events[i + 1]))
                total.append(events[0].elapsed_time(events[4]))
        cs.phase("k4_layers", mode="realtime" if realtime else "offline", items=sizes[:4],
                 ms={k: float(np.median(v[2:])) for k, v in per_layer.items()},
                 four_launches_ms=float(np.median(total[2:])), four_launches_runs_ms=total[2:],
                 max_abs_err=err, bit_equal=bit_equal)
        if not realtime:
            with torch.inference_mode():
                ms = cs.cuda_ms(lambda: model.magnitudes(X, weights), reps=10)
            cs.phase("cdae_stage", chunk_batch=BATCH, ms=ms)
        del model, weights
        torch.cuda.empty_cache()
    del X

    track = (np.random.default_rng(0).standard_normal((1, 2, cs.TRACK_SECONDS * 44100)) * 0.1).astype(np.float32)
    sep = Separator(slicqt, Unmix(shapes, seed=0, device=dev), device=dev)
    sep(track)                                                 # warm-up
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.time()
        sep(track)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    cs.phase("track_236s", s_per_track=times, s_per_track_median=float(np.median(times)))


def kernel_name(mangled: str) -> str:
    """A K4 kernel's mangled name -> cdae_layer_kernel<template arguments>."""
    m = re.search(r"cdae_layer_kernelI((?:Li\d+E)+)E", mangled)
    if not m:
        return mangled
    return "cdae_layer_kernel<" + ",".join(re.findall(r"Li(\d+)E", m.group(1))) + ">"


def sass_report(root: Path, version: str, out_dir: Path):
    """Registers and spills (ptxas) and HMMA / LDGSTS counts
    (SASS) of each K4 kernel of one version's source and built library."""
    sys.path.insert(0, str(ROOT))
    from xumx_slicq_torch.kernels import build

    out_dir.mkdir(parents=True, exist_ok=True)
    src = root / "xumx_slicq_torch" / "csrc" / "cdae_conv.cu"
    ptxas = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", "/dev/null", str(src)],
                           capture_output=True, text=True)
    usage, name = {}, None
    for line in (ptxas.stdout + ptxas.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line) or re.search(r"Function properties for (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            usage.setdefault(name, {}).update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage.setdefault(name, {}).update(registers=int(m.group(1)))
    lib = root / "build" / "xumx_slicq_torch" / "libcdae_conv.so"
    cuobjdump = str(Path(build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    (out_dir / f"k4_sass_{version}.txt").write_text(sass)
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            counts[name] = dict(instructions=0, HMMA=0, LDGSTS=0, FFMA=0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if name and m:
            counts[name]["instructions"] += 1
            op = m.group(1)
            if op in counts[name]:
                counts[name][op] += 1
    emit(version=version, phase="k4_resources", ptxas=usage, sass=counts)


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--parent", help="root of another checkout to run against this one (required)")
    ap.add_argument("--sass", help="directory for each version's K4 SASS listing; also print its counts")
    ap.add_argument("--out", help="write every result to this JSON file too")
    ap.add_argument("--turn", help=argparse.SUPPRESS)        # the root of the version one turn runs
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    if args.turn:
        return turn(Path(args.turn))
    if not args.parent:
        cs.fail("--parent DIR is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit(phase="card", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    roots = {"change": ROOT, "parent": Path(args.parent).resolve()}
    order = ["parent", "change", "change", "parent"]
    for n, version in enumerate(order):
        run = subprocess.run([sys.executable, __file__, "--turn", str(roots[version])], capture_output=True, text=True)
        for fields in (json.loads(x) for x in run.stdout.splitlines() if x.startswith("{")):
            emit(version=version, turn=n, **fields)
        if run.returncode:
            cs.fail(f"turn {n} ({version}) exited {run.returncode}: {run.stdout[-2000:]} {run.stderr[-4000:]}")
        if args.sass and version not in order[:n]:
            sass_report(roots[version], version, Path(args.sass))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(RESULTS, indent=1))


if __name__ == "__main__":
    main()
