"""Entry points for a quick check of the port: one forward step on one
device, and one train step across ranks.

The counterpart of __graft_entry__.py (`entry`, `dryrun_multichip`), which
builds the JAX package's. `entry()` gives the offline chunk pipeline of the
canonical model on the card; `dryrun_multichip(n)` runs one full train step
of a tiny model on n CPU ranks over gloo (parallel/mesh.py).

    python -m xumx_slicq_torch.entry --dryrun 4
"""

import argparse

import numpy as np
import torch

from .device import resolve_device
from .models import Unmix
from .ops.slicqt import SliCQT
from .parallel import mesh as meshlib
from .separator import Separator

SR = 44100
TINY = dict(scale="mel", fbins=12, fmin=200.0)      # __graft_entry__.py's dry-run geometry
TINY_SECONDS = 0.3


def entry(device="cuda"):
    """(fn, example_args): the offline forward step of the canonical
    bark-262 CDAE (random weights, seed 0) on one 2 s stereo chunk:
    sliCQT analysis -> the 70-bucket CDAE masks -> the embedded Wiener-EM
    (K2) -> the inverse sliCQT (K1). fn(audio) takes (1, 2, 88200) audio
    on `device` and returns the (4, 1, 2, 88200) stems there."""
    dev = resolve_device(device)
    chunk_len = 2 * SR
    slicqt = SliCQT(device=dev)
    sep = Separator(slicqt, Unmix(slicqt.block_shapes(1, 2, chunk_len), seed=0, device=dev), device=dev)

    def forward_step(audio: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return sep._chunk_fn(audio)

    return forward_step, (torch.zeros((1, 2, chunk_len), dtype=torch.float32, device=dev),)


def _dryrun_rank(rank: int, n_devices: int, tp: int, batch: int) -> float:
    from .training import make_train_step

    mesh = meshlib.make_mesh(n_devices, tp)
    seq_len = int(TINY_SECONDS * SR)
    slicqt = SliCQT(device="cpu", **TINY)
    model = Unmix(slicqt.block_shapes(batch, 2, seq_len), seed=0, device="cpu", mesh=mesh)
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-5)
    train_step, _ = make_train_step(slicqt, model, optimizer, sdr_mcoef=-1.0, mesh=mesh)
    data = (np.random.default_rng(0).standard_normal((batch, 5, 2, seq_len)) * 0.1).astype(np.float32)
    return float(train_step(torch.from_numpy(meshlib.shard_batch(data, mesh))))


def dryrun_multichip(n_devices: int) -> float:
    """One full train step (forward, backward, gradient reduction, AdamW)
    of a mel-12 CDAE on n_devices CPU ranks over gloo, one 0.3 s item per
    dp group; the mesh is hybrid dp x tp (tp = 2) when n_devices is even,
    as __graft_entry__.dryrun_multichip's. Returns the loss, finite."""
    tp = 2 if n_devices % 2 == 0 else 1
    batch = max(1, n_devices // tp)
    losses = meshlib.spawn(_dryrun_rank, ["cpu"] * n_devices, args=(n_devices, tp, batch))
    loss = losses[0]
    if not np.isfinite(loss) or any(l != loss for l in losses):
        raise RuntimeError(f"dry run: rank losses {losses}")
    print(f"dryrun_multichip OK: {n_devices} ranks, dp={n_devices // tp} x tp={tp}, loss={loss:.5f}")
    return loss


def main(argv=None):
    p = argparse.ArgumentParser(description="xumx-sliCQ PyTorch entry points")
    p.add_argument("--dryrun", type=int, default=0, help="run dryrun_multichip on this many CPU ranks")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help="entry()'s device")
    args = p.parse_args(argv)
    if args.dryrun:
        dryrun_multichip(args.dryrun)
        return
    fn, example = entry(args.device)
    out = fn(*example)
    print(f"entry OK: {tuple(out.shape)} on {out.device}, finite={bool(torch.isfinite(out).all())}")


if __name__ == "__main__":
    main()
