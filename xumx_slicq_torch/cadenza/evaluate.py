"""Cadenza CAD1 evaluate: HAAQI scoring of enhanced stems.

The port's copy of cadenza/evaluate.py, reading wavs with the port's reader.

Re-design of the reference's cadenza/evaluate.py: for each (song, listener)
pair, score each enhanced stem per ear with HAAQI against the NAL-R
processed reference stems, write per-pair rows to a CSV shard
(ResultsFile), batch-sharded `[batch::batch_size]` for embarrassingly
parallel evaluation (evaluate.py:254-256). Per-song RNG is md5-seeded from
the song name (evaluate.py semantics) for reproducible level roving.
"""

import argparse
import csv
import hashlib
import json
import logging
from pathlib import Path

import numpy as np

from ..audio import load_audio
from .config import load_config
from .enhance import make_song_listener_list
from .haaqi import compute_haaqi
from .signal_processing import resample

logger = logging.getLogger(__name__)


class ResultsFile:
    """CSV results writer (reference evaluate.py:33-106)."""

    HEADER = ["song", "listener", "score",
              "left_bass", "right_bass", "left_vocals", "right_vocals",
              "left_other", "right_other", "left_drums", "right_drums"]

    def __init__(self, path: Path):
        self.path = Path(path)
        if not self.path.exists():
            with open(self.path, "w", newline="") as f:
                csv.writer(f).writerow(self.HEADER)

    def add_result(self, listener, song, score, instruments_scores: dict):
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow(
                [song, listener, score] + [instruments_scores[k] for k in self.HEADER[3:]]
            )


def set_song_seed(song: str) -> None:
    """Deterministic per-song RNG (reference evaluate.py md5 convention).

    Kept for recipe parity and user extensions: clarity's HAAQI draws
    np.random internally, this re-implementation is fully deterministic,
    so the seed only affects downstream code that consumes np.random."""
    song_encoded = hashlib.md5(song.encode("utf-8")).hexdigest()
    np.random.seed(int(song_encoded, 16) % (10 ** 8))


def _read_wav_float(path: Path):
    """Read a wav in any PCM dtype -> (sr, float64 (samples,) or (samples, C))."""
    x, sr = load_audio(str(path))  # (C, samples) float32, full-scale correct
    x = x[0] if x.shape[0] == 1 else x.T
    return sr, np.asarray(x, np.float64)


def evaluate_stems_for_listener(
    enhanced_dir: Path,
    music_dir: Path,
    split_dir: str,
    song: str,
    listener_name: str,
    listener_info: dict,
    config,
) -> dict:
    """Score all 8 enhanced stems (left/right x 4 sources) with HAAQI."""
    cfs = np.array(listener_info["audiogram_cfs"])
    audiograms = {
        "left": np.array(listener_info["audiogram_levels_l"]),
        "right": np.array(listener_info["audiogram_levels_r"]),
    }
    scores = {}
    for source in ["bass", "vocals", "other", "drums"]:
        sr_ref, ref = _read_wav_float(music_dir / split_dir / song / f"{source}.wav")
        if ref.ndim == 1:  # mono stem: the same clean reference serves both ears
            ref = ref[:, None]
        for i, ear in enumerate(["left", "right"]):
            stem_path = (enhanced_dir / listener_name / song /
                         f"{listener_name}_{song}_{ear}_{source}.wav")
            sr_proc, proc = _read_wav_float(stem_path)
            # undo the stem scaling recorded at enhance time
            scale_file = stem_path.with_suffix(".txt")
            if scale_file.exists():
                proc = proc * float(scale_file.read_text())

            # reference for HAAQI: the RAW clean stem at stem rate — with
            # equalisation=1 the ear model applies NAL-R to the reference
            # internally (reference evaluate.py:171-212 passes the
            # unprocessed stem to clarity's compute_haaqi the same way)
            ref_ear = resample(
                ref[:, min(i, ref.shape[1] - 1)], sr_ref, config.stem_sample_rate, axis=0
            )

            scores[f"{ear}_{source}"] = compute_haaqi(
                proc, ref_ear, sr_proc, config.stem_sample_rate,
                audiograms[ear], cfs,
            )
    return scores


def evaluate(config) -> None:
    enhanced_dir = Path(config.path.exp_folder) / "enhanced_signals"
    results_dir = Path(config.path.exp_folder)
    results_dir.mkdir(parents=True, exist_ok=True)
    results = ResultsFile(
        results_dir / f"scores_{config.evaluate.batch}-{config.evaluate.batch_size}.csv"
    )

    with open(config.path.listeners_valid_file, encoding="utf-8") as f:
        listener_audiograms = json.load(f)
    with open(config.path.music_valid_file, encoding="utf-8") as f:
        song_data = json.load(f)
    songs_valid = {s["Track Name"]: s for s in song_data} if isinstance(song_data, list) else song_data

    pairs = make_song_listener_list(sorted(songs_valid), listener_audiograms,
                                    config.evaluate.small_test)
    pairs = pairs[config.evaluate.batch:: config.evaluate.batch_size]

    for idx, (song, listener_name) in enumerate(pairs, 1):
        logger.info("[%03d/%03d] evaluating %s / %s", idx, len(pairs), song, listener_name)
        if config.evaluate.set_random_seed:
            set_song_seed(song)
        split_dir = "test" if songs_valid[song].get("Split", "train") == "test" else "train"
        scores = evaluate_stems_for_listener(
            enhanced_dir, Path(config.path.music_dir), split_dir,
            song, listener_name, listener_audiograms[listener_name], config,
        )
        overall = float(np.mean(list(scores.values())))
        results.add_result(listener_name, song, overall, scores)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Cadenza CAD1 evaluate (HAAQI)")
    parser.add_argument("--config", type=str, default=None)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    evaluate(load_config(args.config))


if __name__ == "__main__":
    main()
