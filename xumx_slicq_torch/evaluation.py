"""Evaluation CLI: BSS-eval v4 over the MUSDB18-HQ test set.

Port of xumx_slicq_tpu/evaluation.py: demix every test track with the
Separator, score SDR/ISR/SIR/SAR (ops/bsseval.py), aggregate
median-over-frames / median-over-tracks.

Tracks are sharded two ways:
  * `--shard i --num-shards n` splits the track list across processes or
    hosts (results merged from their JSON shards by `merge_results`);
  * within a process, one separation thread per card pulls tracks from a
    shared queue while a scoring pool overlaps BSS-eval with the next
    separation (`run_parallel_evaluation`).

Three scoring modes:
  * default: stems come back to the host and are scored by the float64
    host engine;
  * `--bss-on-device`: the same host stems are scored by the float32 card
    engine (`DeviceBssEval`), staged back to the card;
  * `--device-resident`: the whole track stays on the card. References
    cross the link in the wav's own dtype (int16 for MUSDB18-HQ) and are
    scaled there; the stems never leave the card.

`--device {cuda,cpu}` takes the place of the JAX package's
`--runtime-backend`. Its JAX-only helpers (the host allocator switch
`utils.enable_host_malloc_reuse`, the persistent compilation cache) have no
counterpart here.

    python -m xumx_slicq_torch.evaluation --musdb-root /MUSDB18-HQ --model-path model --device-resident
"""

import argparse
import json
import os
import queue
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .audio import apply_pcm_scale, load_audio, load_audio_raw, pcm_scale_info, preprocess_audio
from .device import use_device
from .ops.bsseval import DeviceBssEval, EvalStore, TrackScores, eval_track, eval_track_device
from .separator import Separator

def list_tracks(musdb_root: str, subset: str):
    base = Path(musdb_root) / subset
    if not base.exists():
        raise FileNotFoundError(f"no {subset} subset at {base}")
    return sorted(d for d in base.iterdir() if (d / "mixture.wav").exists())


def separate_track(separator: Separator, track_dir: Path):
    """Load and demix one track on the host path: returns (refs,
    estimates), {target: (nsampl, nchan)} numpy arrays."""
    use_device(separator.device)
    audio, rate = load_audio(track_dir / "mixture.wav")
    audio = preprocess_audio(audio, rate, separator.sample_rate)

    estimates = separator(audio)
    est_dict = separator.to_dict(estimates)
    est_np = {k: np.asarray(v)[0].T for k, v in est_dict.items()}  # (nsampl, nchan)

    refs = {}
    for t in separator.sources:
        a, _ = load_audio(track_dir / f"{t}.wav")
        refs[t] = a.T
    return refs, est_np


def score_track(refs, est_np, track_dir: Path) -> TrackScores:
    return eval_track(refs, est_np, track_name=track_dir.name)


def stage_raw(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A raw wav array (read-only, memory-mapped) -> a tensor on `device`
    in the same dtype: through a page-locked copy on the way to a card, so
    that the copy to the device can run asynchronously."""
    pcm_scale_info(a.dtype)      # on the host array: staging must not carry an unsupported dtype
    t = torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype, pin_memory=device.type == "cuda")
    t.numpy()[...] = a
    return t.to(device, non_blocking=True)


def separate_track_device(separator: Separator, track_dir: Path):
    """Load and demix one track with the whole track on the device: the
    mixture and references cross the link in the wav's own dtype and are
    scaled there, the estimates never leave the device. Returns (refs,
    estimates), {target: (nsampl, nchan)} tensors on the Separator's device
    (refs in the wav's dtype). A track at another sample rate takes the
    host path, which resamples."""
    use_device(separator.device)
    mix_raw, sr = load_audio_raw(track_dir / "mixture.wav")
    if sr != separator.sample_rate:
        return separate_track(separator, track_dir)

    mix = apply_pcm_scale(stage_raw(mix_raw, separator.device), src_dtype=mix_raw.dtype)
    if mix.shape[0] == 1:
        mix = mix.repeat(2, 1)
    est = separator.forward_device(mix[None, :2])                   # (4, 1, C, N)
    ests = {t: est[i, 0].transpose(0, 1) for i, t in enumerate(separator.sources)}

    refs = {}
    for t in separator.sources:
        a, _ = load_audio_raw(track_dir / f"{t}.wav")
        refs[t] = stage_raw(a, separator.device).transpose(0, 1)  # (N, C), wav dtype
    return refs, ests


def separate_and_evaluate(separator: Separator, track_dir: Path) -> TrackScores:
    refs, est_np = separate_track(separator, track_dir)
    return score_track(refs, est_np, track_dir)


def run_parallel_evaluation(
    tracks,
    separators,
    eval_workers: int = 0,
    separate_fn=None,
    score_fn=None,
    on_result=None,
):
    """Pipelined evaluation over local devices.

    One separation thread per separator (device) pulls track dirs from a
    shared queue; each finished separation is scored by a pool of scoring
    threads, so scoring of track i overlaps separation of track i+1.

    separate_fn(sep, track_dir) -> payload and score_fn(payload, track_dir)
    -> TrackScores can be injected (tests, benches).

    Stems on a card: a separation thread and the scoring threads all issue
    their work on the device's default stream (neither sets a stream), so
    scoring work queued after the separation has returned runs after the
    kernels that write the stems. A caller that separates on a stream of
    its own must make the scoring stream wait on it.

    on_result fires on the caller's thread as each track's score completes
    (completion order, not track order), while separations are still in
    flight: a long run streams results, and a crash loses only unscored
    tracks.

    Returns the list of TrackScores in track order.
    """
    separate_fn = separate_fn or separate_track
    score_fn = score_fn or (lambda payload, td: score_track(payload[0], payload[1], td))
    eval_workers = eval_workers or max(1, len(separators))

    work = queue.Queue()
    for item in enumerate(tracks):
        work.put(item)
    results = [None] * len(tracks)
    errors = []
    done_q = queue.Queue()
    submitted = [0]
    lock = threading.Lock()

    with ThreadPoolExecutor(max_workers=eval_workers) as eval_pool:

        def sep_worker(sep):
            while not errors:
                try:
                    i, td = work.get_nowait()
                except queue.Empty:
                    return
                try:
                    payload = separate_fn(sep, td)
                    fut = eval_pool.submit(score_fn, payload, td)
                    with lock:
                        submitted[0] += 1
                    fut.add_done_callback(
                        lambda f, i=i, td=td: done_q.put((i, td, f))
                    )
                except Exception as e:  # surface, don't hang the pipeline
                    errors.append((td, e))
                    return

        threads = [
            threading.Thread(target=sep_worker, args=(s,), daemon=True)
            for s in separators
        ]
        for t in threads:
            t.start()

        # consume scores as they complete, concurrently with separation
        collected = 0
        while True:
            alive = any(t.is_alive() for t in threads)
            try:
                i, td, fut = done_q.get(timeout=0.05)
            except queue.Empty:
                if not alive and collected >= submitted[0]:
                    break
                continue
            collected += 1
            try:
                results[i] = fut.result()
                if on_result is not None:
                    on_result(results[i])
            except Exception as e:
                errors.append((td, e))
        for t in threads:
            t.join()

    if errors:
        td, e = errors[0]
        raise RuntimeError(f"evaluation failed on {td}") from e
    return results


def track_scores_to_json(ts: TrackScores) -> dict:
    return {
        "name": ts.name,
        "targets": {t: {m: list(map(float, v)) for m, v in ms.items()} for t, ms in ts.targets.items()},
    }


def track_scores_from_json(d: dict) -> TrackScores:
    return TrackScores(
        name=d["name"],
        targets={t: {m: np.asarray(v) for m, v in ms.items()} for t, ms in d["targets"].items()},
    )


def merge_results(shard_files) -> EvalStore:
    """Merge per-shard JSON results (the JAX package's shard format)."""
    store = EvalStore()
    for f in shard_files:
        with open(f) as fh:
            for d in json.load(fh):
                store.add_track(track_scores_from_json(d))
    return store


def build_argparser():
    p = argparse.ArgumentParser(description="MUSDB18 Evaluation (BSS-eval v4), PyTorch")
    p.add_argument("--track", type=str, default=None)
    p.add_argument("--realtime", action="store_true", default=False)
    p.add_argument("--model-path", type=str, default=None)
    p.add_argument("--musdb-root", type=str, default="/MUSDB18-HQ")
    p.add_argument("--subset", type=str, default="test")
    p.add_argument("--chunk-size", type=int, default=2621440)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--shard", type=int, default=0)
    p.add_argument("--num-shards", type=int, default=1)
    p.add_argument("--devices", type=int, default=1,
                   help="parallel separation workers, one per card (cuda:0..N-1, capped by the cards present)")
    p.add_argument("--eval-workers", type=int, default=0,
                   help="scoring threads overlapped with separation (0: one per device)")
    p.add_argument("--output-json", type=str, default=None,
                   help="write per-track scores JSON (shard merging)")
    p.add_argument("--bss-on-device", action="store_true", default=False,
                   help="score the stems with the float32 engine on the device (stems still come "
                        "back to the host and are staged again)")
    p.add_argument("--device-resident", action="store_true", default=False,
                   help="keep the whole track on the device: references staged in the wav's dtype, "
                        "estimates never fetched, BSS-eval on the device (float32; a track whose "
                        "scores come out non-finite is rescored on the float64 host engine)")
    return p


def evaluation_main(argv=None):
    args = build_argparser().parse_args(argv)

    tracks = list_tracks(args.musdb_root, args.subset)
    if args.track is not None:
        tracks = [t for t in tracks if t.name == args.track]
    tracks = tracks[args.shard:: args.num_shards]
    if not tracks:
        raise ValueError("dataset is empty")

    # one separation worker per card (weights loaded once, then copied
    # to each card); scoring overlaps separation
    sep0 = Separator.load(
        chunk_size=args.chunk_size,
        device=args.device,
        realtime=args.realtime,
        model_path=args.model_path,
    )
    n_dev = max(1, min(args.devices, torch.cuda.device_count())) if sep0.device.type == "cuda" else 1
    separators = [sep0] + [sep0.clone(f"cuda:{i}") for i in range(1, n_dev)]

    t0 = time.time()
    done = []

    def stream_result(ts):
        # incremental per-track output + write-through so a crash mid-run
        # keeps every scored track (completion order; merged stores sort).
        # Atomic replace: truncating the target in place would lose all
        # prior results if the process dies mid-write.
        print(ts, flush=True)
        done.append(ts)
        if args.output_json:
            tmp = args.output_json + ".tmp"
            with open(tmp, "w") as f:
                json.dump([track_scores_to_json(t) for t in done], f)
            os.replace(tmp, args.output_json)

    sep_fn = score_fn = engine = None
    if args.device_resident or args.bss_on_device:
        engine = DeviceBssEval(device=sep0.device)
        sep_fn = separate_track_device if args.device_resident else separate_track
        score_fn = lambda payload, td: eval_track_device(payload[0], payload[1], engine, track_name=td.name)
    elif sep0.device.type == "cuda":
        print("hint: --device-resident scores whole tracks on the card (float32; a track whose scores "
              "come out non-finite is rescored on the float64 host engine)", file=sys.stderr)

    track_scores = run_parallel_evaluation(
        tracks, separators,
        eval_workers=args.eval_workers,
        separate_fn=sep_fn,
        score_fn=score_fn,
        on_result=stream_result,
    )
    wall = time.time() - t0

    results = EvalStore()
    for ts in track_scores:
        results.add_track(ts)

    fell_back = f", {engine.fallbacks} host rescoring(s)" if engine is not None else ""
    print(f"[{len(tracks)} tracks in {wall:.1f}s, {n_dev} device(s){fell_back}]")
    print(results)
    return results


if __name__ == "__main__":
    evaluation_main()
