"""Cadenza CAD1 test-set run + submission packaging.

The port's copy of cadenza/test.py, with the port's Separator on
`config.separator.device`.

Re-design of the reference's cadenza/test.py:35-248: enhance the hidden
test split (same pipeline as enhance.py but reading the test metadata and
the per-song evaluation segments) and pack the outputs into a submission
zip."""

import argparse
import json
import logging
import zipfile
from pathlib import Path

import numpy as np

from ..audio import load_audio
from ..separator import Separator
from .config import load_config
from .enhance import (
    decompose_signal,
    process_stems_for_listener,
    remix_signal,
    save_wav_signal,
    make_song_listener_list,
)
from .signal_processing import NALR, Compressor

logger = logging.getLogger(__name__)


def pack_submission(team_id: str, root: Path, zip_name: str = "submission.zip"):
    out = root / f"{team_id}_{zip_name}"
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as z:
        for f in sorted((root / "enhanced_signals_test").rglob("*")):
            if f.is_file():
                z.write(f, f.relative_to(root))
    print(f"packed submission: {out}")
    return out


def run_test(config) -> None:
    enhanced_folder = Path(config.path.exp_folder) / "enhanced_signals_test"
    enhanced_folder.mkdir(parents=True, exist_ok=True)

    separator = Separator.load(model_path=config.separator.model_path, device=config.separator.device)

    with open(config.path.listeners_test_file, encoding="utf-8") as f:
        listener_audiograms = json.load(f)
    with open(config.path.music_test_file, encoding="utf-8") as f:
        song_data = json.load(f)
    songs = {s["Track Name"]: s for s in song_data} if isinstance(song_data, list) else song_data

    segments = {}
    seg_file = Path(config.path.music_segments_test_file)
    if seg_file.exists():
        with open(seg_file, encoding="utf-8") as f:
            segments = json.load(f)

    pairs = make_song_listener_list(sorted(songs), listener_audiograms, config.evaluate.small_test)
    pairs = pairs[config.evaluate.batch:: config.evaluate.batch_size]

    enhancer = NALR(nfir=config.nalr.nfir, fs=config.nalr.fs)
    compressor = Compressor(fs=config.sample_rate, **vars(config.compressor))

    prev_song, stems = None, None
    for idx, (song, listener_name) in enumerate(pairs, 1):
        logger.info("[%03d/%03d] %s for %s", idx, len(pairs), song, listener_name)
        info = listener_audiograms[listener_name]
        cfs = np.array(info["audiogram_cfs"])
        ag_l = np.array(info["audiogram_levels_l"])
        ag_r = np.array(info["audiogram_levels_r"])
        split_dir = "test"

        if prev_song != song:
            prev_song = song
            # load_audio handles every PCM dtype with the correct full-scale
            mixture, sr = load_audio(
                Path(config.path.music_dir) / split_dir / song / "mixture.wav"
            )
            # the test protocol scores a fixed segment per song
            if song in segments:
                lo = int(segments[song]["start"] * sr)
                hi = int(segments[song]["end"] * sr)
                mixture = mixture[:, lo:hi]
            stems = decompose_signal(separator, mixture, sr, separator.sources)

        processed = process_stems_for_listener(
            stems, enhancer, compressor, ag_l, ag_r, cfs, config.apply_compressor
        )
        for stem_str, sig in processed.items():
            fn = enhanced_folder / listener_name / song / f"{listener_name}_{song}_{stem_str}.flac"
            save_wav_signal(sig, fn, config.sample_rate, config.stem_sample_rate, do_scale_signal=True)
        remixed = remix_signal(processed)
        fn = enhanced_folder / listener_name / song / f"{listener_name}_{song}_remix.flac"
        save_wav_signal(remixed, fn, config.sample_rate, config.remix_sample_rate,
                        do_clip_signal=True, do_soft_clip=config.soft_clip)

    pack_submission(config.team_id, Path(config.path.exp_folder))


def main(argv=None):
    parser = argparse.ArgumentParser(description="Cadenza CAD1 test run")
    parser.add_argument("--config", type=str, default=None)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    run_test(load_config(args.config))


if __name__ == "__main__":
    main()
