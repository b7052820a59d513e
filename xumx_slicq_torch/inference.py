"""Inference CLI: demix a directory of wav files into per-stem wavs.

Port of xumx_slicq_tpu/inference.py with `--device {cuda,cpu}` in place of
`--runtime-backend`; `--n-devices N` fans each track's chunks over
cuda:0..N-1 (the JAX CLI's mesh, inference.py:46-71). Reports the average
per-track wall-clock, as the reference does (README.md:154-160).

    python -m xumx_slicq_torch.inference --input-dir wavs --output-dir out --model-path model
"""

import argparse
import os
import time
from pathlib import Path

import numpy as np

import torch

from . import audio as audio_io
from .separator import Separator


def separate(audio: np.ndarray, separator: Separator, rate: float = None):
    if rate is None:
        raise ValueError("rate must be provided")
    audio = audio_io.preprocess_audio(audio, rate, separator.sample_rate)
    start = time.time()
    estimates = separator(audio)
    return separator.to_dict(estimates), time.time() - start


def inference_main(argv=None):
    parser = argparse.ArgumentParser(description="xumx-sliCQ PyTorch inference")
    parser.add_argument("--input-dir", type=str, default="/input")
    parser.add_argument("--output-dir", type=str, default="/output")
    parser.add_argument("--ext", type=str, default=".wav")
    parser.add_argument("--start", type=float, default=0.0)
    parser.add_argument("--duration", type=float, default=None,
                        help="audio chunk duration in seconds, negative/None = full track")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--realtime", action="store_true", default=False)
    parser.add_argument("--warmup-iters", type=int, default=0)
    parser.add_argument("--model-path", type=str, default=None)
    parser.add_argument("--chunk-size", type=int, default=2621440)
    parser.add_argument("--n-devices", type=int, default=0,
                        help="fan each track's chunks over this many devices: cuda:0..N-1, or N copies on "
                             "the CPU with --device cpu (0 or 1 = one device)")
    parser.add_argument("--grouped-wiener", action="store_true", default=False,
                        help="accepted for the JAX CLI's flag surface; no effect: K2 always runs every "
                             "bucket in one grouped call")
    parser.add_argument("--synth-staging", choices=("f32", "bf16"), default="f32",
                        help="accepted for the JAX CLI's flag surface; no effect: synthesis always "
                             "stages in float32 (K1)")
    args = parser.parse_args(argv)

    devices = None
    if args.n_devices > 1:
        if args.device == "cuda" and args.n_devices > torch.cuda.device_count():
            raise ValueError(f"--n-devices {args.n_devices}: only {torch.cuda.device_count()} card(s) here")
        devices = [args.device if args.device == "cpu" else f"cuda:{i}" for i in range(args.n_devices)]
    separator = Separator.load(
        chunk_size=args.chunk_size,
        device=None if devices else args.device,
        devices=devices,
        realtime=args.realtime,
        warmup=args.warmup_iters,
        model_path=args.model_path,
    )

    dur = args.duration if args.duration is not None and args.duration > 0 else None
    tot_time = 0.0
    wavs = sorted(f for f in os.listdir(args.input_dir) if f.endswith(".wav"))
    for wav_file in wavs:
        audio, rate = audio_io.load_audio(os.path.join(args.input_dir, wav_file), start=args.start, dur=dur)
        estimates, dt = separate(audio, separator, rate)
        tot_time += dt
        outdir = Path(args.output_dir) / Path(wav_file).stem
        outdir.mkdir(exist_ok=True, parents=True)
        for target, est in estimates.items():
            audio_io.save_audio(outdir / f"{target}{args.ext}", np.squeeze(est, 0), separator.sample_rate)

    if wavs:
        print(f"Inference time in s (averaged across tracks): {tot_time / len(wavs):.2f}")
    else:
        print(f"No songs were demixed, are you sure {args.input_dir} contains .wav files?")


if __name__ == "__main__":
    inference_main()
