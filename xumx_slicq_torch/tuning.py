"""Hyperparameter tuning: random search with median pruning.

Port of xumx_slicq_tpu/tuning.py (the reference's Optuna loop,
optuna.py:42-236: trials over hidden_size_1/2 in [4, 256] and
time_filter_2 in [1, 9], cut-down epochs per trial, a median pruner,
objective = SDR on validation tracks) with the same trial argv and the
same `study.json` schema, training each trial with the port's trainer on
the card by default (`--device cpu` for the host). Optional flags of the
study's arguments are read with defaults, so an argument namespace without
them (a caller's own) still builds a trial.
"""

import argparse
import json
import random
import time
from pathlib import Path

import numpy as np


class MedianPruner:
    """Prune a trial at epoch e if its intermediate value is worse than the
    median of completed trials' values at the same epoch (optuna's default
    pruner semantics)."""

    def __init__(self, n_startup_trials: int = 5, n_warmup_steps: int = 2):
        self.n_startup_trials = n_startup_trials
        self.n_warmup_steps = n_warmup_steps
        self.history = []  # list of per-trial dicts {epoch: value}

    def report_trial(self, intermediate: dict):
        self.history.append(dict(intermediate))

    def should_prune(self, epoch: int, value: float) -> bool:
        if epoch < self.n_warmup_steps or len(self.history) < self.n_startup_trials:
            return False
        peers = [h[epoch] for h in self.history if epoch in h]
        if len(peers) < self.n_startup_trials:
            return False
        return value > float(np.median(peers))  # minimizing


def sample_params(rng: random.Random) -> dict:
    """The reference search space (optuna.py:60-80)."""
    return {
        "hidden_size_1": rng.randint(4, 256),
        "hidden_size_2": rng.randint(4, 256),
        "time_filter_2": rng.randint(1, 9),
    }


def objective(trial_params: dict, args, pruner: MedianPruner, trial_id: int):
    """Train a cut-down model and return the reference's tuning objective:
    negative 14-combination SD-SDR on (up to) 2 validation items, scored on
    inverse-transformed time-domain estimates (optuna.py:130-183: trials
    train with the complex MSE only, valid batch 1; lower is better), with
    per-epoch median pruning through the trainer's epoch callback: one
    training_main call per trial. Returns (last valid value, pruned,
    {epoch: value})."""
    from . import training

    model_path = Path(args.study_dir) / f"trial_{trial_id}"
    argv = [
        "--model-path", str(model_path),
        "--epochs", str(args.trial_epochs),
        "--batch-size", str(args.batch_size),
        "--seq-dur", str(args.seq_dur),
        "--fscale", args.fscale, "--fbins", str(args.fbins), "--fmin", str(args.fmin),
        "--hidden-size-1", str(trial_params["hidden_size_1"]),
        "--hidden-size-2", str(trial_params["hidden_size_2"]),
        "--time-filter-2", str(trial_params["time_filter_2"]),
        "--samples-per-track", str(args.samples_per_track),
        "--batch-size-valid", "1",
        "--max-valid-batches", str(args.max_valid_samples),
        "--valid-metric", "sdr",
        "--mask-sum-coef", "0.0",
        "--debug", "--quiet",
        "--device", getattr(args, "device", "cuda"),
        "--n-devices", "1",              # one process: the pruning callback cannot follow ranks
    ]
    if args.synthetic_dataset:
        argv.append("--synthetic-dataset")
    else:
        argv += ["--musdb-root", args.musdb_root]
    if getattr(args, "max_batches_per_epoch", -1) > 0:
        argv += ["--max-batches-per-epoch", str(args.max_batches_per_epoch)]
    if getattr(args, "grouped_wiener", False):
        argv.append("--grouped-wiener")
    intermediate = {}
    pruned = [False]

    def on_epoch(epoch, train_loss, valid_loss):
        intermediate[epoch] = float(valid_loss)
        if pruner.should_prune(epoch, float(valid_loss)):
            pruned[0] = True
            return True
        return False

    _, valid_losses = training.training_main(argv, epoch_callback=on_epoch)
    # a checkpoint-resumed trial only fires the callback for new epochs;
    # backfill the earlier history so the pruner sees the whole trajectory
    for e, v in enumerate(valid_losses, start=1):
        intermediate.setdefault(e, float(v))
    # only COMPLETED trials join the pruning history (optuna MedianPruner
    # semantics): a pruned trial's values were worse than the then-median,
    # so folding them back in would make pruning progressively laxer
    if not pruned[0]:
        pruner.report_trial(intermediate)
    return float(valid_losses[-1]), pruned[0], intermediate


def tuning_main(argv=None):
    from .ops.fscale import make_scale
    from .utils import enable_host_malloc_reuse

    enable_host_malloc_reuse()
    p = argparse.ArgumentParser(description="xumx-sliCQ PyTorch hyperparameter search")
    p.add_argument("--study-dir", type=str, default="/tuning-study")
    p.add_argument("--n-trials", type=int, default=100)
    p.add_argument("--trial-epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--seq-dur", type=float, default=2.0)
    p.add_argument("--fscale", type=str, default="bark")
    p.add_argument("--fbins", type=int, default=262)
    p.add_argument("--fmin", type=float, default=32.9)
    p.add_argument("--musdb-root", type=str, default="/MUSDB18-HQ")
    p.add_argument("--samples-per-track", type=int, default=16,
                   help="cut-down samples per track per trial (optuna.py:30)")
    p.add_argument("--max-valid-samples", type=int, default=2,
                   help="validation items scored per epoch (optuna.py:31-33)")
    p.add_argument("--synthetic-dataset", action="store_true", default=False)
    p.add_argument("--max-batches-per-epoch", type=int, default=-1)
    p.add_argument("--grouped-wiener", action="store_true", default=False,
                   help="accepted for the JAX tuner's flag surface and passed to each trial, where it has "
                        "no effect: K2 always runs every bucket in one grouped call")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    from .device import resolve_device

    resolve_device(args.device)
    # the reference guards sllen <= 44100 (optuna.py): transform params are
    # fixed per study here, so validate once
    sllen, _ = make_scale(args.fscale, args.fbins, args.fmin).suggested_sllen_trlen(44100.0)
    if sllen > 44100:
        raise ValueError(f"sllen {sllen} > 44100: pick a smaller transform")

    Path(args.study_dir).mkdir(parents=True, exist_ok=True)
    study_file = Path(args.study_dir) / "study.json"
    trials = []
    if study_file.exists():
        trials = json.loads(study_file.read_text())["trials"]

    rng = random.Random(args.seed + len(trials))
    pruner = MedianPruner()
    for t in trials:
        # resume: rebuild the history from COMPLETED trials only
        if t.get("intermediate") and not t.get("pruned"):
            pruner.report_trial({int(k): v for k, v in t["intermediate"].items()})

    best = min(
        (t for t in trials if not t.get("pruned") and "value" in t),
        key=lambda t: t["value"], default=None,
    )
    for i in range(len(trials), args.n_trials):
        params = sample_params(rng)
        t0 = time.time()
        try:
            value, pruned, intermediate = objective(params, args, pruner, i)
        except (RuntimeError, ValueError) as e:  # mirror optuna.py:215-218
            print(f"trial {i} failed: {e}")
            trials.append({"id": i, "params": params, "error": str(e)})
            study_file.write_text(json.dumps({"trials": trials, "best": best}, indent=2))
            continue
        rec = {"id": i, "params": params, "value": value, "pruned": pruned,
               "intermediate": intermediate, "seconds": time.time() - t0}
        trials.append(rec)
        if not pruned and (best is None or value < best["value"]):
            best = rec
        study_file.write_text(json.dumps({"trials": trials, "best": best}, indent=2))
        status = "PRUNED" if pruned else "done"
        best_str = (f"best={best['value']:.5f} @ {best['params']}"
                    if best is not None else "best=n/a (all trials pruned)")
        print(f"trial {i} {status}: value={value:.5f} params={params} ({best_str})")

    print_study(study_file)
    return best


def print_study(study_file):
    d = json.loads(Path(study_file).read_text())
    print(f"\n{len(d['trials'])} trials; best: {d.get('best')}")


if __name__ == "__main__":
    tuning_main()
