"""Spectrogram visualization: per-bucket magnitude sliCQT PNGs.

Port of xumx_slicq_tpu/visualization.py (the reference's
visualization.py): per bucket, flatten the slice axis by 50% overlap-add
(`overlap_add_slicq`, two strided adds) and render a dB pcolormesh. The
transform runs on the card by default (`--device cpu` for the host);
matplotlib is imported only to plot, with the Agg backend.

    python -m xumx_slicq_torch.visualization --input-wav song.wav --output-dir plots
"""

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from .audio import load_audio
from .ops.fscale import make_scale
from .ops.slicqt import SliCQT


def overlap_add_slicq(slicq: np.ndarray, flatten: bool = False) -> np.ndarray:
    """(C, F, S, M) -> (C, F, ncoefs) by 50% overlap-add over slices."""
    nb_channels, nb_f_bins, nb_slices, nb_m_bins = slicq.shape
    if flatten:
        return slicq.reshape(nb_channels, nb_f_bins, -1)
    hop = nb_m_bins // 2
    out = np.zeros((nb_channels, nb_f_bins, nb_slices * hop + hop), dtype=slicq.dtype)
    # slice i contributes its first half at offset i*hop, its second at (i+1)*hop
    halves = slicq.reshape(nb_channels, nb_f_bins, nb_slices, 2, hop)
    out[..., : nb_slices * hop] += halves[..., 0, :].reshape(nb_channels, nb_f_bins, -1)
    out[..., hop: nb_slices * hop + hop] += halves[..., 1, :].reshape(nb_channels, nb_f_bins, -1)
    return out


def blockwise_spectrogram(c, fs, coef_factor, freqs, frames, output_file, plot_title,
                          flatten=False, fontsize=14, cmap="inferno"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    chop = c.shape[-1]
    mag = np.abs(overlap_add_slicq(c, flatten=flatten))
    mls = 20.0 * np.log10(np.maximum(mag, 1e-12))
    mls = mls[:, :, int(chop / 2):]
    if int(chop / 2):
        mls = mls[:, :, : -int(chop / 2)]

    plt.rcParams.update({"font.size": fontsize})
    fig, axs = plt.subplots(1)

    mls = np.mean(mls, axis=0).T               # (coefs, F)
    fs_coef = fs * coef_factor
    ncoefs = int(coef_factor * frames)
    mls = mls[:ncoefs, :]
    mls_dur = len(mls) / fs_coef
    if flatten:
        mls_dur *= 2.0

    mls_max = np.quantile(mls, 0.999)
    im = axs.pcolormesh(
        np.linspace(0.0, mls_dur, num=mls.shape[0]),
        np.asarray(freqs) / 1000.0,
        mls.T,
        vmin=mls_max - 120.0,
        vmax=mls_max,
        cmap=cmap,
    )
    axs.set_title(plot_title)
    axs.set_xlabel("Time (s)")
    axs.set_ylabel("Frequency (kHz)")
    fig.colorbar(im, ax=axs, shrink=1.0, pad=0.006, label="dB")
    fig.set_size_inches(16, 9)
    fig.savefig(output_file, dpi=120, bbox_inches="tight")
    plt.close(fig)


def visualization_main(argv=None):
    parser = argparse.ArgumentParser(description="sliCQT spectrogram plots")
    parser.add_argument("--input-wav", type=str, required=True)
    parser.add_argument("--output-dir", type=str, default="/spectrogram-plots")
    parser.add_argument("--sr", type=int, default=44100)
    parser.add_argument("--cmap", type=str, default="hot")
    parser.add_argument("--fscale", choices=("mel", "bark"), default="bark")
    parser.add_argument("--fbins", type=int, default=262)
    parser.add_argument("--fmin", type=float, default=32.9)
    parser.add_argument("--fontsize", type=int, default=14)
    parser.add_argument("--flatten", action="store_true")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="device the transform runs on")
    args = parser.parse_args(argv)

    slicqt = SliCQT(scale=args.fscale, fbins=args.fbins, fmin=args.fmin, fs=float(args.sr), device=args.device)
    signal, rate = load_audio(args.input_wav)
    with torch.inference_mode():
        C = [c.cpu().numpy() for c in slicqt.forward(torch.from_numpy(signal[None]).to(slicqt.device))]

    scale_freqs, _ = make_scale(args.fscale, args.fbins, args.fmin)()
    freqs = np.r_[[0.0], np.asarray(scale_freqs)][: slicqt.nfreqs]

    Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    coef_factors = slicqt.coef_factors()
    params_str = f"{args.fscale} scale, {args.fbins} bins, {args.fmin:.1f}-22050 Hz"
    freq_idx = 0
    for i, c in enumerate(C):
        c = c[0]                                # (C, F, S, M)
        n_freqs = c.shape[1]
        out = os.path.join(args.output_dir,
                           f"spectrogram-{os.path.basename(args.input_wav)}-block-{i}.png")
        # coef_factors is per frequency bin; all bins of a bucket share M, so
        # the bucket's factor is its first bin's
        blockwise_spectrogram(
            c, args.sr, coef_factors[freq_idx], freqs[freq_idx: freq_idx + n_freqs],
            signal.shape[-1], out, f"Magnitude sliCQT, block {i} ({params_str})",
            flatten=args.flatten, fontsize=args.fontsize, cmap=args.cmap,
        )
        freq_idx += n_freqs
    print(f"wrote {len(C)} block spectrograms to {args.output_dir}")


if __name__ == "__main__":
    visualization_main()
