"""sliCQT parameter search: random search over (fscale, fbins, fmin)
maximizing ORACLE separation quality.

Port of xumx_slicq_tpu/slicqfinder.py (the reference's slicqfinder.py:43-453):
for each candidate transform config, build ideal-ratio-mask estimates from
the ground-truth stems (magnitude masks through Wiener-EM, or mix-phase with
--phasemix), invert, and score with the fast energy-ratio SDR
(slicqfinder.py:20-40). The transform with the best oracle SDR bounds what
any mask network on it can achieve.

On the card the oracle runs the port's kernels: Wiener-EM is one grouped
K2 call over every bucket (the oracle is stereo with one iteration) and
synthesis runs K1. Each config's plan is built on the host (NumPy) first.

    python -m xumx_slicq_torch.slicqfinder --synthetic-dataset --n-iter 6
"""

import argparse
import json
import random
import time
from typing import List

import numpy as np
import torch

from .data import SyntheticDataset, TrackTreeDataset
from .device import resolve_device
from .kernels.synth_assembly import synth_assembly
from .kernels.wiener_em import wiener_em
from .ops import wiener as W
from .ops.bsseval import fast_sdr
from .ops.slicqt import SliCQT, design_plan

TARGETS = ["bass", "vocals", "other", "drums"]


def oracle_separate(slicqt: SliCQT, mix: torch.Tensor, stems: torch.Tensor, phasemix: bool = False):
    """Ideal-mask separation on slicqt's device: mix (C, L) and the ground
    truth stems (4, C, L); returns (4, C, L)."""
    L = mix.shape[-1]
    X = slicqt.forward(mix[None])
    mags = [torch.abs(t)[:, None] for t in slicqt.forward(stems)]    # (4, 1, C, F, S, M) each
    Y = W.phasemix_blocks(X, mags) if phasemix else W.wiener_blocks(X, mags)
    return slicqt.backward([y.reshape((-1,) + y.shape[2:]) for y in Y], L)


def build_transform(config: dict, device="cuda"):
    """The port's SliCQT of a config, or None where the JAX search skips it:
    a plan that cannot be designed, or sllen > 44100 (the reference tuner's
    cap). A config whose plan designs but that the port's transform refuses
    raises instead of being skipped."""
    try:
        plan = design_plan(config["fscale"], config["fbins"], config["fmin"], fgamma=config.get("fgamma", 0.0))
    except (AssertionError, ValueError):
        return None
    if plan[1] > 44100:
        return None
    return SliCQT(scale=config["fscale"], fbins=config["fbins"], fmin=config["fmin"],
                  fgamma=config.get("fgamma", 0.0), device=device, plan=plan)


@torch.inference_mode()
def evaluate_config(config: dict, segments: List[np.ndarray], phasemix: bool = False, per_target: bool = False,
                    device="cuda", stats: dict = None):
    """Mean oracle SDR of one transform config over (5, C, L) segments, or
    per stem with `per_target`; None for a skipped config (`build_transform`).
    `stats`, if given, receives the config's host seconds of plan building
    and table upload (`plan_s`), wall seconds of oracle separation with the
    stems back on the host (`oracle_s`), on the card also the seconds on the
    device's timeline between CUDA events around each separation, gaps while
    the host launches included (`device_s`), seconds of
    host scoring (`score_s`), and the launches of K1 and K2 its separations
    made (`launches`)."""
    t0 = time.time()
    slicqt = build_transform(config, device)
    if slicqt is None:
        return None
    t1 = time.time()
    on_card = slicqt.device.type == "cuda"
    before = (synth_assembly.launches, wiener_em.launches)
    scores, oracle_s, device_s, score_s = [], 0.0, 0.0, 0.0
    for seg in segments:
        t = time.time()
        if on_card:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        est = oracle_separate(slicqt, torch.from_numpy(seg[0]).to(slicqt.device),
                              torch.from_numpy(seg[1:]).to(slicqt.device), phasemix)
        if on_card:
            ev[1].record()
        est = est.cpu().numpy()
        oracle_s += time.time() - t
        if on_card:
            device_s += ev[0].elapsed_time(ev[1]) / 1e3
        t = time.time()
        sdrs = [fast_sdr(est[i], seg[1 + i]) for i in range(4)]
        scores.append(sdrs if per_target else np.mean(sdrs))
        score_s += time.time() - t
    if stats is not None:
        stats.update(plan_s=t1 - t0, oracle_s=oracle_s, score_s=score_s,
                     launches=dict(synth_assembly=synth_assembly.launches - before[0],
                                   wiener_em=wiener_em.launches - before[1]))
        if on_card:
            stats["device_s"] = device_s
    return float(np.mean(scores)) if not per_target else np.mean(scores, axis=0)


def random_config(rng: random.Random) -> dict:
    fscale = rng.choice(["bark", "mel", "cqlog", "vqlog"])
    cfg = {
        "fscale": fscale,
        "fbins": rng.randint(10, 300),
        "fmin": rng.uniform(10.0, 130.0),
    }
    if fscale == "vqlog":
        cfg["fgamma"] = rng.uniform(1.0, 50.0)
    return cfg


def slicqfinder_main(argv=None):
    parser = argparse.ArgumentParser(description="sliCQT oracle param search")
    parser.add_argument("--musdb-root", type=str, default="/MUSDB18-HQ")
    parser.add_argument("--synthetic-dataset", action="store_true", default=False)
    parser.add_argument("--n-iter", type=int, default=100)
    parser.add_argument("--n-segments", type=int, default=4)
    parser.add_argument("--seq-dur", type=float, default=5.0)
    parser.add_argument("--phasemix", action="store_true", default=False,
                        help="oracle with mix-phase instead of Wiener-EM")
    parser.add_argument("--per-target", action="store_true", default=False,
                        help="optimize each stem independently: report 4 per-stem "
                        "oracle SDRs per config and track a best config per target "
                        "(reference slicqfinder.py:357-411 single-target mode)")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--output-json", type=str, default=None)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    rng = random.Random(args.seed)
    if args.synthetic_dataset:
        ds = SyntheticDataset(n_tracks=args.n_segments, seq_duration=args.seq_dur, samples_per_track=1, seed=args.seed)
    else:
        ds = TrackTreeDataset(args.musdb_root, split="train", seq_duration=args.seq_dur,
                              samples_per_track=1, seed=args.seed)
    segments = [ds[i] for i in range(min(args.n_segments, len(ds)))]

    best = None
    best_per_target = {t: None for t in TARGETS}
    history = []
    for it in range(args.n_iter):
        cfg = random_config(rng)
        stats = {}
        score = evaluate_config(cfg, segments, phasemix=args.phasemix, per_target=args.per_target,
                                device=device, stats=stats)
        if score is None:
            continue
        timing = f"(plan {stats['plan_s']:.2f} s, oracle {stats['oracle_s']:.2f} s)"
        if args.per_target:
            per_stem = {t: float(s) for t, s in zip(TARGETS, score)}
            mean_score = float(np.mean(score))
            history.append({**cfg, "oracle_sdr": mean_score, "per_target": per_stem, **stats})
            new_best_stems = []
            for t in TARGETS:
                if best_per_target[t] is None or per_stem[t] > best_per_target[t]["oracle_sdr"]:
                    best_per_target[t] = {**cfg, "oracle_sdr": per_stem[t]}
                    new_best_stems.append(t)
            stems_str = " ".join(f"{t}={per_stem[t]:.3f}" for t in TARGETS)
            tag = f" NEW BEST[{','.join(new_best_stems)}]" if new_best_stems else ""
            print(f"[{it}]{tag} oracle SDR mean {mean_score:.3f} dB ({stems_str}): {cfg} {timing}")
            score = mean_score
        else:
            history.append({**cfg, "oracle_sdr": score, **stats})
        if best is None or score > best["oracle_sdr"]:
            best = history[-1]
            if not args.per_target:
                print(f"[{it}] NEW BEST oracle SDR {score:.3f} dB: {cfg} {timing}")
        elif not args.per_target:
            print(f"[{it}] oracle SDR {score:.3f} dB: {cfg} {timing}")
        if args.output_json:
            out = {"best": best, "history": history}
            if args.per_target:
                out["best_per_target"] = best_per_target
            with open(args.output_json, "w") as f:
                json.dump(out, f, indent=2)

    print(f"\nbest config: {best}")
    if args.per_target:
        for t in TARGETS:
            print(f"best[{t}]: {best_per_target[t]}")
        return {"best": best, "best_per_target": best_per_target}
    return best


if __name__ == "__main__":
    slicqfinder_main()
