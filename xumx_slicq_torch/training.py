"""Trainer: train step through the embedded Wiener-EM, X-UMX losses, AdamW
with the plateau schedule, early stopping, whitening statistics,
checkpoints and the JSON manifest.

Port of xumx_slicq_tpu/training.py for one card. A step transforms the
mixture and the four targets, runs `Unmix` in train mode (BatchNorm on
batch statistics), Wiener-EM through kernel K2, the 14-combination complex
MSE plus the mask-sum prior and, with --sdr-mcoef > 0, SD-SDR on the
inverse transform through kernel K1; then the backward (K2's and K1's
backward kernels, cuDNN) and one AdamW step. The JAX package's
ReduceLROnPlateau mirrors torch's, so the port uses torch's.

Outputs in --model-path, as the JAX trainer writes them: the manifest
`xumx_slicq_tpu.json` (same schema), the best weights `xumx_slicq_tpu.pth`
under the reference's names (both packages' Separator.load read it) and
the full state (model, optimizer, scheduler) in `xumx_slicq_torch.chkpnt`.

    python -m xumx_slicq_torch.training --synthetic-dataset --model-path model
"""

import argparse
import copy
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import loss as losses
from .data import DataLoader, MUSDBDataset, PeripheryDataset, SyntheticDataset
from .device import resolve_device
from .models import Unmix
from .models.convert import to_reference_state_dict
from .ops.slicqt import SliCQT

MANIFEST = "xumx_slicq_tpu.json"
WEIGHTS = "xumx_slicq_tpu.pth"
CHECKPOINT = "xumx_slicq_torch.chkpnt"


class EarlyStopping:
    """Early stopping monitor (reference training.py:590-630). A NaN
    metric stops at once, before it could become `best`."""

    def __init__(self, patience: int = 10, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = None
        self.num_bad_epochs = 0

    def step(self, metric: float) -> bool:
        if np.isnan(metric):
            return True
        if self.best is None:
            self.best = metric
            return False
        if metric < self.best - self.min_delta:
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        return self.num_bad_epochs >= self.patience


class AverageMeter:
    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)


def get_statistics(slicqt: SliCQT, dataset, quiet: bool = True, max_tracks: Optional[int] = None,
                   window_s: float = 60.0):
    """Per-bucket, per-frequency mean and std of the mixture's magnitude
    sliCQT over the dataset (xumx_slicq_tpu/training.py:148-228): whole
    tracks without crops, augmentations or track mixing, in fixed windows
    of `window_s` seconds; a short last window is zero-padded and its
    slices past the audio are left out."""
    dataset = copy.copy(dataset)
    for attr, val in (("seq_duration", None), ("samples_per_track", 1),
                      ("random_track_mix", False), ("fixed_start", 0)):
        if hasattr(dataset, attr):
            setattr(dataset, attr, val)
    if hasattr(dataset, "source_augmentations"):
        dataset.source_augmentations = lambda a, rng: a

    n_blocks = len(slicqt.buckets)
    count = [0.0] * n_blocks
    s1 = [None] * n_blocks
    s2 = [None] * n_blocks
    n_tracks = len(dataset.tracks) if hasattr(dataset, "tracks") else len(dataset)
    if max_tracks:
        n_tracks = min(n_tracks, max_tracks)
    win = int(window_s * getattr(dataset, "sample_rate", 44100.0))
    hop = max(slicqt.sllen // 2, 1)

    def windows(x):
        L = x.shape[-1]
        if L <= win:
            yield np.pad(x, ((0, 0), (0, 0), (0, win - L))), L
            return
        pos = 0
        while pos < L:
            if pos + win > L:
                pos = L - win                    # the last window ends at the track's end
            yield x[..., pos: pos + win], win
            pos += win

    for ti in range(n_tracks):
        x = np.asarray(dataset[ti][0], np.float32)[None]         # (1, C, L) mixture
        for w, real_len in windows(x):
            with torch.inference_mode():
                mags = [torch.abs(c).cpu().numpy() for c in slicqt.forward(torch.from_numpy(w).to(slicqt.device))]
            for i, m in enumerate(mags):                           # (1, C, F, S, T)
                if real_len < win:
                    m = m[:, :, :, : min(m.shape[3], -(-real_len // hop) + 1)]
                rows = np.moveaxis(m.reshape(m.shape[0], m.shape[1], m.shape[2], -1).mean(1), 1, 2)
                rows = rows.reshape(-1, m.shape[2])                # (frames, F)
                count[i] += rows.shape[0]
                if s1[i] is None:
                    s1[i], s2[i] = rows.sum(0), (rows ** 2).sum(0)
                else:
                    s1[i] += rows.sum(0)
                    s2[i] += (rows ** 2).sum(0)
        if not quiet:
            print(f"statistics: track {ti + 1}/{n_tracks}")

    means = [s1[i] / count[i] for i in range(n_blocks)]
    stds = []
    for i in range(n_blocks):
        std = np.sqrt(np.maximum(s2[i] / count[i] - means[i] ** 2, 0.0))
        stds.append(np.maximum(std, 1e-4 * np.max(std)))
    return means, stds


def make_train_step(slicqt: SliCQT, model: Unmix, optimizer, sdr_mcoef: float = -1.0,
                    mask_sum_coef: float = 1.0, valid_metric: str = "loss"):
    """The train and valid steps (xumx_slicq_tpu/training.py:236-301).

    batch: (B, 5, C, L) float32 on the model's device, stacked (mix, bass,
    vocals, other, drums). train_step(batch) runs one forward, backward and
    optimizer step in train mode and returns the loss as a 0-dim tensor
    (no host sync). valid_step(batch) scores in eval mode: the training
    criterion, or with valid_metric="sdr" the negative SD-SDR of the
    inverse-transformed estimates."""

    def waves(Y_est, B, C, L):
        return slicqt.backward([y.reshape((-1,) + y.shape[2:]) for y in Y_est], L).reshape(4, B, C, L)

    def criterion(batch):
        x, y = batch[:, 0], batch[:, 1:]
        B, _, C, L = y.shape
        with torch.no_grad():                                    # the transforms of data need no gradient
            X = slicqt.forward(x.contiguous())
            Yt = slicqt.forward(y.reshape(B * 4, C, L))
        Y_tgt = [c.reshape(B, 4, *c.shape[1:]).transpose(0, 1) for c in Yt]
        Y_est, Y_masks = model(X)
        total = losses.complex_mse_loss(Y_est, Y_tgt)
        if mask_sum_coef > 0.0:
            total = total + mask_sum_coef * losses.mask_sum_loss(Y_masks)
        if sdr_mcoef > 0.0:
            total = total + sdr_mcoef * losses.sdsdr_loss(waves(Y_est, B, C, L), y.transpose(0, 1))
        return total

    def train_step(batch: torch.Tensor) -> torch.Tensor:
        model.train()
        total = criterion(batch)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        optimizer.step()
        return total.detach()

    @torch.no_grad()
    def valid_step(batch: torch.Tensor) -> torch.Tensor:
        model.eval()
        if valid_metric != "sdr":
            return criterion(batch)
        y = batch[:, 1:]
        B, _, C, L = y.shape
        Y_est, _ = model(slicqt.forward(batch[:, 0].contiguous()))
        return losses.sdsdr_loss(waves(Y_est, B, C, L), y.transpose(0, 1))

    return train_step, valid_step


def save_checkpoint(path: Path, model: Unmix, optimizer, scheduler, is_best: bool):
    """The full state every epoch; the weights under the reference's names
    when the epoch is the best (reference training.py:563-568)."""
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "scheduler": scheduler.state_dict()}, path / CHECKPOINT)
    if is_best:
        torch.save(to_reference_state_dict(model), path / WEIGHTS)


def _scheduler_manifest(scheduler) -> dict:
    """The JAX manifest's scheduler entry, from torch's scheduler."""
    return dict(lr=scheduler.optimizer.param_groups[0]["lr"], best=float(scheduler.best),
                num_bad_epochs=scheduler.num_bad_epochs, cooldown_counter=scheduler.cooldown_counter,
                threshold=scheduler.threshold, eps=scheduler.eps)


def build_argparser():
    """The JAX trainer's flags (training.py:338-411), plus --device."""
    p = argparse.ArgumentParser(description="xumx-sliCQ PyTorch trainer")
    p.add_argument("--musdb-root", type=str, default="/MUSDB18-HQ")
    p.add_argument("--periphery-root", type=str, default="/Periphery")
    p.add_argument("--samples-per-track", type=int, default=64)
    p.add_argument("--periphery-dataset", action="store_true", default=False)
    p.add_argument("--synthetic-dataset", action="store_true", default=False,
                   help="train on the synthetic dataset (tests and smoke runs)")
    p.add_argument("--model-path", type=str, default="/model")
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--batch-size-valid", type=int, default=1)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--patience", type=int, default=1000)
    p.add_argument("--lr-decay-patience", type=int, default=80)
    p.add_argument("--lr-decay-gamma", type=float, default=0.3)
    p.add_argument("--weight-decay", type=float, default=0.00001)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--debug", action="store_true", default=False,
                   help="skip dataset statistics calculation")
    p.add_argument("--sdr-mcoef", type=float, default=-1.0)
    p.add_argument("--bf16", action="store_true", default=False,
                   help="bf16 conv operands with float32 results and master weights (models/nn.amp_op)")
    p.add_argument("--realtime", action="store_true", default=False)
    p.add_argument("--lstm", action="store_true", default=False,
                   help="the LSTM variant: not ported yet (slice 4)")
    p.add_argument("--grouped-wiener", action="store_true", default=False,
                   help="accepted for the JAX trainer's flag surface; no effect: K2 always runs "
                        "every bucket in one grouped call")
    p.add_argument("--seq-dur", type=float, default=2.0)
    p.add_argument("--hidden-size-1", type=int, default=50)
    p.add_argument("--hidden-size-2", type=int, default=51)
    p.add_argument("--time-filter-2", type=int, default=4)
    p.add_argument("--fscale", choices=("bark", "mel", "cqlog", "vqlog", "linear", "mrstft"), default="bark")
    p.add_argument("--fbins", type=int, default=262)
    p.add_argument("--fmin", type=float, default=32.9)
    p.add_argument("--fgamma", type=float, default=0.0)
    p.add_argument("--nb-workers", type=int, default=4,
                   help="loader threads per batch (deterministic: per-item seeds)")
    p.add_argument("--quiet", action="store_true", default=False)
    p.add_argument("--n-devices", type=int, default=-1,
                   help="devices: one card; more is not ported yet (ROADMAP.md item 10)")
    p.add_argument("--tp", type=int, default=1,
                   help="target parallelism: not ported yet (ROADMAP.md item 10)")
    p.add_argument("--valid-seq-dur", type=float, default=30.0,
                   help="validation window in seconds: tracks longer than it are scored in windows "
                        "of this size; <= 0 scores whole tracks padded to a slice count")
    p.add_argument("--max-batches-per-epoch", type=int, default=-1, help="cap batches per epoch (smoke runs)")
    p.add_argument("--max-valid-batches", type=int, default=-1, help="cap validation batches")
    p.add_argument("--mask-sum-coef", type=float, default=1.0,
                   help="weight of the mask-sum prior in the training loss")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler trace of steps 2-4 of the first epoch here")
    p.add_argument("--valid-metric", choices=("loss", "sdr"), default="loss",
                   help="validation score: training criterion, or negative SD-SDR")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def training_main(argv=None, epoch_callback=None):
    """Train. epoch_callback(epoch, train_loss, valid_loss), if given, runs
    after each epoch's checkpoint; a truthy return stops training.
    Returns the train and valid loss histories."""
    args = build_argparser().parse_args(argv)
    if args.lstm:
        raise NotImplementedError("--lstm: the LSTM variant is not ported yet (slice 4 of the port)")
    if args.n_devices > 1 or args.tp > 1:
        raise NotImplementedError("--n-devices/--tp > 1: multi-card training is ROADMAP.md item 10, not ported yet")
    device = resolve_device(args.device)
    t0_all = time.time()

    if args.synthetic_dataset:
        train_dataset = SyntheticDataset(seq_duration=args.seq_dur, seed=args.seed)
        valid_dataset = SyntheticDataset(n_tracks=2, seq_duration=args.seq_dur, samples_per_track=1,
                                         seed=args.seed + 1)
    elif args.periphery_dataset:
        train_dataset, valid_dataset = PeripheryDataset.load_datasets(
            args.seed, args.seq_dur, args.samples_per_track, args.periphery_root)
    else:
        train_dataset, valid_dataset = MUSDBDataset.load_datasets(
            args.seed, args.seq_dur, args.samples_per_track, args.musdb_root)

    target_path = Path(args.model_path)
    target_path.mkdir(parents=True, exist_ok=True)
    model_exists = (target_path / CHECKPOINT).exists()

    slicqt = SliCQT(scale=args.fscale, fbins=args.fbins, fmin=args.fmin, fgamma=args.fgamma,
                    fs=train_dataset.sample_rate, device=device)
    shapes = slicqt.block_shapes(args.batch_size, 2, int(args.seq_dur * train_dataset.sample_rate))
    if model_exists or args.debug:
        scaler_mean = scaler_std = None
    else:
        if not args.quiet:
            print("Computing dataset whitening statistics...")
        scaler_mean, scaler_std = get_statistics(slicqt, train_dataset, quiet=args.quiet)

    model = Unmix(shapes, realtime=args.realtime, input_means=scaler_mean, input_scales=scaler_std,
                  hidden_size_1=args.hidden_size_1, hidden_size_2=args.hidden_size_2,
                  time_filter_2=args.time_filter_2, amp=args.bf16, seed=args.seed, device=device)
    if not args.quiet:
        print(f"model parameters: {model.num_params():,} on {device}")
    optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=args.weight_decay)
    scheduler = torch.optim.lr_scheduler.ReduceLROnPlateau(
        optimizer, factor=args.lr_decay_gamma, patience=args.lr_decay_patience, cooldown=10)
    train_step, valid_step = make_train_step(slicqt, model, optimizer, args.sdr_mcoef,
                                             mask_sum_coef=args.mask_sum_coef, valid_metric=args.valid_metric)

    es = EarlyStopping(patience=args.patience)
    train_losses, valid_losses, train_times = [], [], []
    best_epoch, start_epoch = 0, 1
    if model_exists:
        print("Model exists, resuming training...")
        with open(target_path / MANIFEST) as f:
            results = json.load(f)
        state = torch.load(target_path / CHECKPOINT, map_location=device, weights_only=True)
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        scheduler.load_state_dict(state["scheduler"])
        start_epoch = results["epochs_trained"] + 1
        train_losses = results["train_loss_history"]
        valid_losses = results["valid_loss_history"]
        train_times = results["train_time_history"]
        best_epoch = results["best_epoch"]
        es.best = results["best_loss"]
        es.num_bad_epochs = results["num_bad_epochs"]

    train_loader = DataLoader(train_dataset, args.batch_size, shuffle=True, seed=args.seed,
                              drop_last=True, workers=args.nb_workers)
    valid_loader = DataLoader(valid_dataset, args.batch_size_valid, shuffle=False)
    metrics_csv = target_path / "metrics.csv"
    if not metrics_csv.exists():
        metrics_csv.write_text("epoch,train_loss,valid_loss,lr,epoch_time_s\n")

    def to_device(batch: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(batch).to(device, non_blocking=True)

    prof = None
    for epoch in range(start_epoch, args.epochs + 1):
        end = time.time()
        meter = AverageMeter()
        pending = None
        for bi, batch in enumerate(train_loader):
            if args.max_batches_per_epoch > 0 and bi >= args.max_batches_per_epoch:
                break
            if args.profile_dir and epoch == start_epoch:   # steps 2-4: the first pays for builds
                if bi == 1 and prof is None:
                    from torch.profiler import ProfilerActivity, profile

                    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
                    prof = profile(activities=acts)
                    prof.__enter__()
                elif bi == 4 and prof is not None:
                    _stop_profile(prof, args.profile_dir)
                    prof = None
            loss = train_step(to_device(batch))
            # read the previous step's loss: a step stays queued while the host reads
            if pending is not None:
                meter.update(*pending)
            pending = (loss, batch.shape[0])
        if pending is not None:
            meter.update(*pending)
        if prof is not None:
            _stop_profile(prof, args.profile_dir)
            prof = None
        train_loss = meter.avg

        vmeter = AverageMeter()
        valid_win = int(args.valid_seq_dur * train_dataset.sample_rate)
        for bi, batch in enumerate(valid_loader):
            if args.max_batches_per_epoch > 0 and bi >= args.max_batches_per_epoch:
                break
            if args.max_valid_batches > 0 and bi >= args.max_valid_batches:
                break
            L = batch.shape[-1]
            if args.valid_seq_dur > 0 and L > valid_win:
                # windows of one shape cover the whole track, the last zero-padded
                for pos in range(0, L, valid_win):
                    seg = batch[..., pos: pos + valid_win]
                    if seg.shape[-1] < valid_win:
                        seg = np.pad(seg, [(0, 0)] * (seg.ndim - 1) + [(0, valid_win - seg.shape[-1])])
                    vmeter.update(valid_step(to_device(np.ascontiguousarray(seg))), batch.shape[0])
            else:
                Lpad = slicqt.max_length(slicqt.n_slices(L))
                batch = np.pad(batch, [(0, 0)] * (batch.ndim - 1) + [(0, max(0, Lpad - L))])
                vmeter.update(valid_step(to_device(batch)), batch.shape[0])
        valid_loss = vmeter.avg

        scheduler.step(valid_loss)
        train_losses.append(float(train_loss))
        valid_losses.append(float(valid_loss))
        train_times.append(time.time() - end)
        stop = es.step(valid_loss)
        if valid_loss == es.best:
            best_epoch = epoch
        save_checkpoint(target_path, model, optimizer, scheduler, is_best=valid_loss == es.best)
        lr = optimizer.param_groups[0]["lr"]
        manifest = {
            "epochs_trained": epoch,
            "args": {**vars(args), "sample_rate": train_dataset.sample_rate, "nb_channels": 2,
                     "seq_dur": args.seq_dur},
            "best_loss": float(es.best) if es.best is not None else None,
            "best_epoch": best_epoch,
            "train_loss_history": train_losses,
            "valid_loss_history": valid_losses,
            "train_time_history": train_times,
            "num_bad_epochs": es.num_bad_epochs,
            "scheduler": _scheduler_manifest(scheduler),
        }
        with open(target_path / MANIFEST, "w") as f:
            json.dump(manifest, f, indent=4, sort_keys=True)
        with open(metrics_csv, "a") as f:
            f.write(f"{epoch},{train_loss},{valid_loss},{lr},{train_times[-1]}\n")
        if not args.quiet:
            print(f"epoch {epoch}: train {train_loss:.5f} valid {valid_loss:.5f} lr {lr:.2e} "
                  f"({train_times[-1]:.1f}s)")
        if epoch_callback is not None and epoch_callback(epoch, float(train_loss), float(valid_loss)):
            break
        if stop:
            print("Apply Early Stopping")
            break

    if not args.quiet:
        print(f"total wall time {time.time() - t0_all:.1f}s")
    return train_losses, valid_losses


def _stop_profile(prof, profile_dir: str):
    prof.__exit__(None, None, None)
    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(profile_dir) / "train_steps.json"))


if __name__ == "__main__":
    training_main()
