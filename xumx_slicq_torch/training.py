"""Trainer: train step through the embedded Wiener-EM, X-UMX losses, AdamW
with the plateau schedule, early stopping, whitening statistics,
checkpoints and the JSON manifest.

Port of xumx_slicq_tpu/training.py. A step transforms the
mixture and the four targets, runs `Unmix` in train mode (BatchNorm on
batch statistics), Wiener-EM through kernel K2, the 14-combination complex
MSE plus the mask-sum prior and, with --sdr-mcoef > 0, SD-SDR on the
inverse transform through kernel K1; then the backward (K2's and K1's
backward kernels, cuDNN) and one AdamW step. With --lstm the mask model
is the LSTM variant: its recurrence runs through K5 and, backward, K5b,
with inter-layer dropout drawn from a generator reseeded every step. The
JAX package's ReduceLROnPlateau mirrors torch's, so the port uses torch's.

--n-devices N --tp T (the JAX trainer's mesh, training.py:473-494) runs N
ranks (parallel/mesh.py), rank r on cuda:r (or the CPU with --device cpu):
N / T dp groups split each global batch by rows, with BatchNorm on the
global batch; each of the T ranks of a tp group holds 4 / T targets'
weights, BatchNorm and AdamW moments. Every rank loads the same batches
from the same seed and keeps its rows. Gradients are reduced by hand after
the backward; the validation batches are shared out over the dp groups;
rank 0 prints and writes the files, with the target-split state gathered
first, so they have exactly a one-process run's layout and a resume reads
them into any layout.

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
from .parallel import mesh as meshlib

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
                    mask_sum_coef: float = 1.0, valid_metric: str = "loss", mesh=None):
    """The train and valid steps (xumx_slicq_tpu/training.py:236-301).

    batch: (B, 5, C, L) float32 on the model's device, stacked (mix, bass,
    vocals, other, drums). train_step(batch, generator=None) runs one
    forward, backward and optimizer step in train mode and returns the loss
    as a 0-dim tensor (no host sync); `generator` draws the LSTM's dropout
    (None: no dropout, as the JAX step's rng=None). valid_step(batch)
    scores in eval mode: the training
    criterion, or with valid_metric="sdr" the negative SD-SDR of the
    inverse-transformed estimates.

    mesh: this rank's `parallel.mesh.Mesh` (the model's); batch is then the
    rank's rows, the gradients are reduced over the ranks before the
    optimizer step, and the returned loss is the global batch's."""

    def waves(Y_est, B, C, L):
        return slicqt.backward([y.reshape((-1,) + y.shape[2:]) for y in Y_est], L).reshape(4, B, C, L)

    def criterion(batch, generator=None):
        x, y = batch[:, 0], batch[:, 1:]
        B, _, C, L = y.shape
        with torch.no_grad():                                    # the transforms of data need no gradient
            X = slicqt.forward(x.contiguous())
            Yt = slicqt.forward(y.reshape(B * 4, C, L))
        Y_tgt = [c.reshape(B, 4, *c.shape[1:]).transpose(0, 1) for c in Yt]
        Y_est, Y_masks = model(X, generator=generator)
        total = losses.complex_mse_loss(Y_est, Y_tgt)
        if mask_sum_coef > 0.0:
            total = total + mask_sum_coef * losses.mask_sum_loss(Y_masks)
        if sdr_mcoef > 0.0:
            total = total + sdr_mcoef * losses.sdsdr_loss(waves(Y_est, B, C, L), y.transpose(0, 1))
        return total

    def train_step(batch: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        model.train()
        total = criterion(batch, generator)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        if mesh is not None:
            mesh.reduce_gradients(model.named_parameters())
            total = mesh.mean_dp(total.detach())
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


def dropout_seed(seed: int, epoch: int, batch_index: int) -> int:
    """The LSTM's dropout seed of one step, from (seed ^ 0x5EED, epoch *
    100003 + batch index) as the JAX trainer folds its key
    (xumx_slicq_tpu/training.py:545, 566), so that a resumed run draws
    the masks the uninterrupted run drew. The bits differ from JAX's."""
    state = np.random.SeedSequence([seed ^ 0x5EED, epoch * 100003 + batch_index]).generate_state(2)
    return int(state[0]) << 31 | int(state[1]) >> 1


def _map_optimizer_state(sd: dict, model: Unmix, convert) -> dict:
    """An optimizer state_dict with each parameter's moments passed through
    convert({name: tensor}) -> {name: tensor}, by the parameter's name (the
    tp rule reads names)."""
    names = [n for n, _ in model.named_parameters()]
    state = {}
    for idx, st in sd["state"].items():
        state[idx] = {k: (convert({names[idx]: v})[names[idx]] if isinstance(v, torch.Tensor) and v.ndim else v)
                      for k, v in st.items()}
    return {**sd, "state": state}


def save_checkpoint(path: Path, model: Unmix, optimizer, scheduler, is_best: bool, full_model=None):
    """The full state every epoch; the weights under the reference's names
    when the epoch is the best (reference training.py:563-568).

    Across ranks (model.mesh) every rank calls it: the target-split state is
    gathered into a one-process run's layout (`full_model`, a 4-target
    Unmix on the CPU, takes the weights for the reference names when
    tp > 1) and rank 0 writes."""
    mesh = model.mesh
    model_sd, opt_sd = model.state_dict(), optimizer.state_dict()
    if mesh is not None:
        model_sd = mesh.gather_state(model_sd)
        opt_sd = _map_optimizer_state(opt_sd, model, mesh.gather_state)
        if mesh.rank != 0:
            return
    torch.save({"model": model_sd, "optimizer": opt_sd, "scheduler": scheduler.state_dict()}, path / CHECKPOINT)
    if is_best:
        if mesh is not None and mesh.tp > 1:
            full_model.load_state_dict(model_sd)
            model = full_model
        torch.save(to_reference_state_dict(model), path / WEIGHTS)


def load_checkpoint(path: Path, model: Unmix, optimizer, scheduler) -> None:
    """A checkpoint of any layout into this run's: on a tp rank the
    target-stacked tensors are cut to the rank's targets."""
    state = torch.load(path / CHECKPOINT, map_location=next(model.parameters()).device, weights_only=True)
    targets = model.mesh.targets if model.mesh is not None else range(meshlib.NB_TARGETS)
    model.load_state_dict(meshlib.take_targets(state["model"], targets))
    optimizer.load_state_dict(_map_optimizer_state(state["optimizer"], model,
                                                   lambda d: meshlib.take_targets(d, targets)))
    scheduler.load_state_dict(state["scheduler"])


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
                   help="the LSTM mask model (3-layer LSTM per bucket) in place of the CDAE")
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
                   help="ranks, one a device (cuda:0..N-1, or the CPU with --device cpu); -1 = every card")
    p.add_argument("--tp", type=int, default=1, choices=meshlib.TP_SIZES,
                   help="target-parallel ranks: split the 4-target weight stack over this many ranks "
                        "(hybrid dp x tp; must divide --n-devices)")
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


def rank_devices(args) -> list:
    """The device of each rank, the JAX trainer's mesh size rules
    (training.py:473-491): --n-devices -1 takes every card (the CPU is one
    device) and shrinks until --tp and the batch divide it; an explicit
    count that the cards, --tp or the batch cannot hold raises."""
    tp = args.tp
    if args.n_devices < 0:
        n = 1 if args.device == "cpu" else max(torch.cuda.device_count(), 1)
        if n < tp:
            raise ValueError(f"--tp {tp} exceeds the usable device count ({n} available)")
        while n % tp or args.batch_size % (n // tp):
            n -= 1
    else:
        n = args.n_devices
        if args.device == "cuda" and n > torch.cuda.device_count():
            raise ValueError(f"--n-devices {n}: only {torch.cuda.device_count()} card(s) here")
    if n % tp:
        raise ValueError(f"--n-devices {n} not divisible by --tp {tp}")
    if args.batch_size % (n // tp):
        raise ValueError(f"batch size {args.batch_size} not divisible by dp={n // tp} devices")
    if n == 1:
        return [args.device]
    return ["cpu"] * n if args.device == "cpu" else [f"cuda:{r}" for r in range(n)]


def training_main(argv=None, epoch_callback=None):
    """Train. epoch_callback(epoch, train_loss, valid_loss), if given, runs
    after each epoch's checkpoint; a truthy return stops training.
    Returns the train and valid loss histories (rank 0's across ranks,
    which are every rank's)."""
    args = build_argparser().parse_args(argv)
    devices = rank_devices(args)
    if len(devices) == 1:
        return _train(args, None, resolve_device(devices[0]), epoch_callback)
    if epoch_callback is not None:
        raise ValueError("epoch_callback runs in one process: it cannot follow a run across ranks")
    return meshlib.spawn(_train_rank, devices, args=(args, devices))[0]


def _train_rank(rank: int, args, devices: list):
    mesh = meshlib.make_mesh(len(devices), args.tp, devices)
    return _train(args, mesh, mesh.device)


def _train(args, mesh, device, epoch_callback=None):
    """One process's training: the whole run, or one rank's (mesh)."""
    lead = mesh is None or mesh.rank == 0
    quiet = args.quiet or not lead
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
        if not quiet:
            print("Computing dataset whitening statistics...")
        if lead:
            scaler_mean, scaler_std = get_statistics(slicqt, train_dataset, quiet=quiet)
        else:
            scaler_mean = scaler_std = [np.zeros(shape[2], np.float32) for shape in shapes]
        if mesh is not None:                                 # computed once, broadcast
            n_b = len(shapes)
            both = meshlib.replicate_arrays(list(scaler_mean) + list(scaler_std), mesh)
            scaler_mean, scaler_std = both[:n_b], both[n_b:]

    model = Unmix(shapes, realtime=args.realtime, lstm=args.lstm, input_means=scaler_mean, input_scales=scaler_std,
                  hidden_size_1=args.hidden_size_1, hidden_size_2=args.hidden_size_2,
                  time_filter_2=args.time_filter_2, amp=args.bf16, seed=args.seed, device=device, mesh=mesh)
    # rank 0's 4-target copy on the CPU, for the reference-named weights of a target-split run
    full_model = None
    if lead and mesh is not None and mesh.tp > 1:
        full_model = Unmix(shapes, realtime=args.realtime, lstm=args.lstm, hidden_size_1=args.hidden_size_1,
                           hidden_size_2=args.hidden_size_2, time_filter_2=args.time_filter_2, device="cpu")
    if not quiet:
        where = device if mesh is None else f"{mesh.size} ranks, dp={mesh.dp} x tp={mesh.tp}, rank 0 on {device}"
        print(f"model parameters: {model.num_params():,} on {where}")
    optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=args.weight_decay)
    scheduler = torch.optim.lr_scheduler.ReduceLROnPlateau(
        optimizer, factor=args.lr_decay_gamma, patience=args.lr_decay_patience, cooldown=10)
    train_step, valid_step = make_train_step(slicqt, model, optimizer, args.sdr_mcoef,
                                             mask_sum_coef=args.mask_sum_coef, valid_metric=args.valid_metric,
                                             mesh=mesh)

    es = EarlyStopping(patience=args.patience)
    train_losses, valid_losses, train_times = [], [], []
    best_epoch, start_epoch = 0, 1
    if model_exists:
        if lead:
            print("Model exists, resuming training...")
        with open(target_path / MANIFEST) as f:
            results = json.load(f)
        load_checkpoint(target_path, model, optimizer, scheduler)
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
    if lead and not metrics_csv.exists():
        metrics_csv.write_text("epoch,train_loss,valid_loss,lr,epoch_time_s\n")

    def to_device(batch: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(batch).to(device, non_blocking=True)

    # the LSTM's dropout: reseeded every step, so a resumed run draws what the uninterrupted one drew
    dropout = torch.Generator(device=device) if args.lstm else None

    prof = None
    for epoch in range(start_epoch, args.epochs + 1):
        end = time.time()
        meter = AverageMeter()
        pending = None
        for bi, batch in enumerate(train_loader):
            if args.max_batches_per_epoch > 0 and bi >= args.max_batches_per_epoch:
                break
            if lead and args.profile_dir and epoch == start_epoch:   # steps 2-4: the first pays for builds
                if bi == 1 and prof is None:
                    from torch.profiler import ProfilerActivity, profile

                    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
                    prof = profile(activities=acts)
                    prof.__enter__()
                elif bi == 4 and prof is not None:
                    _stop_profile(prof, args.profile_dir)
                    prof = None
            if dropout is not None:
                dropout.manual_seed(dropout_seed(args.seed, epoch, bi))
            if mesh is not None:
                batch = meshlib.shard_batch(batch, mesh)
            loss = train_step(to_device(batch), dropout)
            # read the previous step's loss: a step stays queued while the host reads
            if pending is not None:
                meter.update(*pending)
            pending = (loss, batch.shape[0] * (mesh.dp if mesh is not None else 1))
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
            if mesh is not None and bi % mesh.dp != mesh.dp_rank:     # the dp groups share the batches out
                continue
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
        if mesh is not None:
            tot = mesh.all_reduce_(torch.tensor([vmeter.sum, float(vmeter.count)], dtype=torch.float64,
                                                device=device), "dp").tolist()
            vmeter.sum, vmeter.count = tot[0], int(tot[1])
        valid_loss = vmeter.avg

        scheduler.step(valid_loss)
        train_losses.append(float(train_loss))
        valid_losses.append(float(valid_loss))
        train_times.append(time.time() - end)
        stop = es.step(valid_loss)
        if valid_loss == es.best:
            best_epoch = epoch
        save_checkpoint(target_path, model, optimizer, scheduler, is_best=valid_loss == es.best,
                        full_model=full_model)
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
        if lead:
            with open(target_path / MANIFEST, "w") as f:
                json.dump(manifest, f, indent=4, sort_keys=True)
            with open(metrics_csv, "a") as f:
                f.write(f"{epoch},{train_loss},{valid_loss},{lr},{train_times[-1]}\n")
        if not quiet:
            print(f"epoch {epoch}: train {train_loss:.5f} valid {valid_loss:.5f} lr {lr:.2e} "
                  f"({train_times[-1]:.1f}s)")
        if epoch_callback is not None and epoch_callback(epoch, float(train_loss), float(valid_loss)):
            break
        if stop:
            if lead:
                print("Apply Early Stopping")
            break

    if not quiet:
        print(f"total wall time {time.time() - t0_all:.1f}s")
    return train_losses, valid_losses


def _stop_profile(prof, profile_dir: str):
    prof.__exit__(None, None, None)
    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(profile_dir) / "train_steps.json"))


if __name__ == "__main__":
    training_main()
