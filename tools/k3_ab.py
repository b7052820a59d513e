#!/usr/bin/env python3
"""SliCQT.forward, the offline demix and the CDAE train step of this
checkout against another checkout's on one NVIDIA GPU: what K3 (the
analysis gather and weight of every bucket in one launch) moves end to end.

    python3 tools/k3_ab.py --parent DIR [--out FILE]

Each turn is a process that puts one checkout's package first on its path
(this one, or --parent DIR: another commit unpacked with `git archive` into
a directory that git ignores) and measures, in the turns parent, change,
change, parent (the card's clock and power limit may differ from call to
call, so versions are compared within one call):
  * `slicqt_forward`: SliCQT.forward at the main path's layout (bark-262, a
    chunk batch of 4 default chunks, stereo), ms between CUDA events (mean
    of 10 calls after 2) and the device launches of one profiled call;
    K3's launches a call where the version has K3;
  * `track_236s`: the canonical offline CDAE Separator on a seeded 236 s
    stereo track (one chunk batch of 4), s/track of 5 runs after a warm-up,
    each ending in a synchronize;
  * `train_steps`: the canonical CDAE's train step at batch 32 of 2.0 s
    (AdamW, one fixed seeded batch), ms of 10 steps whose loss is read
    back, the median of steps 3-10.
Prints one JSON object per result, tagged with its version and turn; --out
also writes them all to a file.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
CHUNK = 2621440                 # the Separator's default chunk (samples)
BATCH = 4                       # a 236 s track's chunk batch


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
    from xumx_slicq_torch.models import Unmix
    from xumx_slicq_torch.ops.slicqt import SliCQT
    from xumx_slicq_torch.separator import Separator
    from xumx_slicq_torch.training import make_train_step

    cs.check(Path(xumx_slicq_torch.__file__).resolve().parent.parent == root.resolve(),
             f"xumx_slicq_torch imported from {xumx_slicq_torch.__file__}, not from {root}")
    try:
        from xumx_slicq_torch.kernels.analysis_gather import analysis_gather
    except ImportError:                 # a version without K3
        analysis_gather = None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    slicqt = SliCQT(device=dev)
    g = torch.Generator(device=dev).manual_seed(0)

    a = torch.randn((BATCH, 2, CHUNK), generator=g, device=dev) * 0.1
    with torch.inference_mode():
        before = analysis_gather.launches if analysis_gather else 0
        slicqt.forward(a)
        torch.cuda.synchronize()
        k3 = analysis_gather.launches - before if analysis_gather else None
        ms = cs.cuda_ms(lambda: slicqt.forward(a), reps=10)
        wall, busy, n_launches, top, _ = cs.profiled(lambda: slicqt.forward(a), f"k3_ab_forward_{root.name}")
    cs.phase("slicqt_forward", chunk_batch=BATCH, ms=ms, device_launches=n_launches, profiled_wall_ms=wall,
             device_busy_ms=busy if busy is not None else "not measured", k3_launches_per_call=k3, top_kernels=top)
    del a

    track = (np.random.default_rng(0).standard_normal((1, 2, cs.TRACK_SECONDS * 44100)) * 0.1).astype(np.float32)
    sep = Separator(slicqt, Unmix(slicqt.block_shapes(1, 2, 2 * 44100), seed=0, device=dev), device=dev)
    sep(track)                                                 # warm-up
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.time()
        sep(track)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    cs.phase("track_236s", s_per_track=times, s_per_track_median=float(np.median(times)))
    del sep
    torch.cuda.empty_cache()

    length = int(cs.TRAIN_SECONDS * 44100)
    batch = (torch.randn((cs.TRAIN_BATCH, 5, 2, length), generator=g, device=dev) * 0.1)
    batch[:, 0] = batch[:, 1:].sum(1)
    model = Unmix(slicqt.block_shapes(cs.TRAIN_BATCH, 2, length), seed=0, device=dev)
    step, _ = make_train_step(slicqt, model, torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-5))
    times = []
    for _ in range(10):
        t0 = time.time()
        float(step(batch))                                     # waits for the step
        times.append(time.time() - t0)
    cs.phase("train_steps", batch=cs.TRAIN_BATCH, seconds=cs.TRAIN_SECONDS, step_s=times,
             median_ms_steps_3_10=float(np.median(times[2:])) * 1e3)


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--parent", help="root of another checkout to run against this one (required)")
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
    for n, version in enumerate(["parent", "change", "change", "parent"]):
        run = subprocess.run([sys.executable, __file__, "--turn", str(roots[version])], capture_output=True, text=True)
        for fields in (json.loads(x) for x in run.stdout.splitlines() if x.startswith("{")):
            emit(version=version, turn=n, **fields)
        if run.returncode:
            cs.fail(f"turn {n} ({version}) exited {run.returncode}: {run.stdout[-2000:]} {run.stderr[-4000:]}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(RESULTS, indent=1))


if __name__ == "__main__":
    main()
