"""Cadenza CAD1 enhance: demix + NAL-R per listener + stem/remix output.

The port's copy of cadenza/enhance.py: the same recipe with the port's
Separator on `config.separator.device` and the port's wav reader.

Re-design of the reference's cadenza/enhance.py (sevagh/xumx-sliCQ-V2):
segment-wise separation with linear cross-fades (10 s segments, 0.1
overlap, enhance.py:35-99), per-listener NAL-R prescription (+ optional
compressor) per stem (enhance.py:201-267), stem output at 24 kHz and a
stereo remix at 32 kHz (enhance.py:293-347, config.yaml:16-18).

Output format note: the reference writes FLAC via clarity's FlacEncoder;
no FLAC encoder ships in this environment, so stems/remixes are written as
16-bit PCM WAV with the same naming (documented deviation).

Stem order note: the reference recipe labels the xumx separator outputs
with sources_order = [vocals, drums, bass, other] (enhance.py:399-403)
although the separator emits [bass, vocals, other, drums]
(separator.py:48); this rebuild uses the separator's actual order, fixing
the stem mislabeling.
"""

import argparse
import json
import logging
from pathlib import Path

import numpy as np

from ..audio import load_audio
from ..separator import Separator
from .config import load_config
from .signal_processing import NALR, Compressor, clip_signal, resample, to_16bit

logger = logging.getLogger(__name__)


def separate_sources(separator, mix: np.ndarray, sample_rate: int, segment: float = 10.0, overlap: float = 0.1):
    """Segment-wise separation with linear cross-fades
    (reference enhance.py:35-99)."""
    if mix.ndim == 1:
        mix = mix[None, :]
    if mix.ndim == 2:
        mix = mix[None]
    batch, channels, length = mix.shape

    chunk_len = int(sample_rate * segment * (1 + overlap))
    overlap_frames = int(overlap * sample_rate)
    final = np.zeros((batch, 4, channels, length), np.float32)

    fade_in_len = 0
    start, end = 0, chunk_len
    while start < length - overlap_frames:
        chunk = mix[:, :, start:end]
        out = separator(chunk)                      # (4, B, C, n)
        out = np.transpose(out, (1, 0, 2, 3))       # (B, 4, C, n)
        n = out.shape[-1]
        fade_out_len = overlap_frames if end < length else 0
        w = np.ones(n, np.float32)
        if fade_in_len:
            w[:fade_in_len] = np.linspace(0, 1, fade_in_len, endpoint=False)
        if fade_out_len:
            w[n - fade_out_len:] = np.linspace(1, 0, fade_out_len, endpoint=False)
        final[:, :, :, start:start + n] += out * w

        if start == 0:
            fade_in_len = overlap_frames
            start += chunk_len - overlap_frames
        else:
            start += chunk_len
        end += chunk_len
    return final


def map_to_dict(sources: np.ndarray, sources_list) -> dict:
    """(4, C, N) -> {left_<src>: (N,), right_<src>: (N,)}
    (reference enhance.py:130-147)."""
    out = {}
    for name, audio in zip(sources_list, sources):
        out[f"left_{name}"] = audio[0]
        out[f"right_{name}"] = audio[1]
    return out


def decompose_signal(separator, signal: np.ndarray, sample_rate: int, sources_list) -> dict:
    sources = separate_sources(separator, signal, sample_rate)[0]
    return map_to_dict(sources, sources_list)


def apply_baseline_ha(enhancer: NALR, compressor, signal, audiogram, cfs, apply_compressor=False):
    fir, _ = enhancer.build(audiogram, cfs)
    out = enhancer.apply(fir, signal)
    if apply_compressor:
        out, _, _ = compressor.process(out)
    return out


def process_stems_for_listener(stems, enhancer, compressor, audiogram_left, audiogram_right, cfs, apply_compressor=False):
    processed = {}
    for stem_str, sig in stems.items():
        audiogram = audiogram_left if stem_str.startswith("l") else audiogram_right
        processed[stem_str] = apply_baseline_ha(enhancer, compressor, sig, audiogram, cfs, apply_compressor)
    return processed


def remix_signal(stems: dict) -> np.ndarray:
    n = stems[next(iter(stems))].shape[0]
    left = np.zeros(n)
    right = np.zeros(n)
    for k, v in stems.items():
        if k.startswith("l"):
            left += v
        else:
            right += v
    return np.stack([left, right], axis=1)


def save_wav_signal(signal, filename: Path, signal_sample_rate, output_sample_rate,
                    do_clip_signal=False, do_soft_clip=False, do_scale_signal=False):
    """Output conditioning + write (reference save_flac_signal,
    enhance.py:293-347; WAV instead of FLAC here)."""
    from scipy.io import wavfile

    filename.parent.mkdir(parents=True, exist_ok=True)
    signal = resample(signal, signal_sample_rate, output_sample_rate, axis=0)
    if do_scale_signal:
        max_value = np.max(np.abs(signal))
        if max_value > 0:
            signal = signal / max_value
        with open(filename.with_suffix(".txt"), "w") as f:
            f.write(f"{max_value}")
    elif do_clip_signal:
        signal, n_clipped = clip_signal(signal, do_soft_clip)
        if n_clipped > 0:
            logger.warning("Writing %s: %d samples clipped", filename, n_clipped)
    wavfile.write(str(filename.with_suffix(".wav")), int(output_sample_rate), to_16bit(signal))


def make_song_listener_list(songs, listeners, small_test=False):
    pairs = [(s, l) for s in songs for l in listeners]
    if small_test:
        pairs = pairs[:1]
    return pairs


def enhance(config) -> None:
    """Main enhancement loop (reference enhance.py:350-529)."""
    enhanced_folder = Path(config.path.exp_folder) / "enhanced_signals"
    enhanced_folder.mkdir(parents=True, exist_ok=True)

    separator = Separator.load(model_path=config.separator.model_path, device=config.separator.device)
    sources_order = separator.sources

    with open(config.path.listeners_valid_file, encoding="utf-8") as f:
        listener_audiograms = json.load(f)
    with open(config.path.music_valid_file, encoding="utf-8") as f:
        song_data = json.load(f)
    songs_valid = {s["Track Name"]: s for s in song_data} if isinstance(song_data, list) else song_data

    pairs = make_song_listener_list(sorted(songs_valid), listener_audiograms,
                                    config.evaluate.small_test)
    pairs = pairs[config.evaluate.batch:: config.evaluate.batch_size]

    enhancer = NALR(nfir=config.nalr.nfir, fs=config.nalr.fs)
    compressor = Compressor(fs=config.sample_rate, **vars(config.compressor))

    prev_song = None
    stems = None
    for idx, (song_name, listener_name) in enumerate(pairs, 1):
        logger.info("[%03d/%03d] %s for %s", idx, len(pairs), song_name, listener_name)
        info = listener_audiograms[listener_name]
        cfs = np.array(info["audiogram_cfs"])
        audiogram_left = np.array(info["audiogram_levels_l"])
        audiogram_right = np.array(info["audiogram_levels_r"])

        song_meta = songs_valid[song_name]
        split_dir = "test" if song_meta.get("Split", "train") == "test" else "train"

        if prev_song != song_name:
            prev_song = song_name
            # load_audio handles every PCM dtype (int16/int32/uint8/float)
            # with the correct full-scale, unlike a bare /32768
            mixture, sr = load_audio(
                Path(config.path.music_dir) / split_dir / song_name / "mixture.wav"
            )
            if sr != config.sample_rate:
                raise ValueError(f"{song_name}: mixture at {sr} Hz, the config says {config.sample_rate}")
            stems = decompose_signal(separator, mixture, sr, sources_order)

        processed = process_stems_for_listener(
            stems, enhancer, compressor, audiogram_left, audiogram_right, cfs,
            config.apply_compressor,
        )

        for stem_str, sig in processed.items():
            fn = enhanced_folder / listener_name / song_name / f"{listener_name}_{song_name}_{stem_str}.flac"
            save_wav_signal(sig, fn, config.sample_rate, config.stem_sample_rate, do_scale_signal=True)

        remixed = remix_signal(processed)
        fn = enhanced_folder / listener_name / song_name / f"{listener_name}_{song_name}_remix.flac"
        save_wav_signal(remixed, fn, config.sample_rate, config.remix_sample_rate,
                        do_clip_signal=True, do_soft_clip=config.soft_clip)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Cadenza CAD1 enhance")
    parser.add_argument("--config", type=str, default=None, help="YAML config path")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    enhance(load_config(args.config))


if __name__ == "__main__":
    main()
