"""Hearing-aid signal processing: NAL-R prescription, compressor, clipping.

The port's copy of cadenza/signal_processing.py, unchanged (NumPy/SciPy
only: the port imports nothing of cadenza/).

Replaces the clarity-library components the reference recipe imports
(clarity.enhancer.{nalr,compressor}, used at cadenza/enhance.py:201-267):

* NAL-R (Byrne & Dillon 1986): per-frequency insertion gains from the
  listener's audiogram, realized as a linear-phase FIR via firwin2.
* Compressor: RMS-envelope automatic gain control with attack/release
  (clarity's Compressor semantics and the CAD1 config defaults).
* clip_signal / soft_clip / to_16bit: output conditioning
  (cadenza/enhance.py save_flac_signal path).
"""

from typing import Tuple

import numpy as np
import scipy.signal

# NAL-R standard audiometric frequencies and per-frequency corrections (dB)
NALR_FREQS = np.array([250.0, 500.0, 1000.0, 2000.0, 4000.0, 6000.0])
NALR_CORRECTIONS = np.array([-17.0, -8.0, 1.0, -1.0, -2.0, -2.0])


class NALR:
    """NAL-R linear prescription fitted as an FIR filter."""

    def __init__(self, nfir: int = 220, fs: float = 44100.0, sample_rate: float = None):
        self.nfir = nfir
        self.fs = sample_rate or fs

    def build(self, audiogram: np.ndarray, cfs: np.ndarray = None) -> Tuple[np.ndarray, float]:
        """Build the FIR for a listener audiogram (hearing levels in dB HL).

        Returns (fir, delay_samples)."""
        audiogram = np.asarray(audiogram, np.float64)
        cfs = NALR_FREQS if cfs is None else np.asarray(cfs, np.float64)

        # interpolate HL onto the NAL-R frequencies if needed
        hl = np.interp(NALR_FREQS, cfs, audiogram)
        three_fa = np.mean(hl[1:4])  # 500/1k/2k average
        x = 0.15 * three_fa
        gains_db = np.maximum(x + 0.31 * hl + NALR_CORRECTIONS, 0.0)

        # design FIR over [0, nyquist] with interpolated gain curve
        freqs = np.concatenate([[0.0], NALR_FREQS, [self.fs / 2]])
        gains = np.concatenate([[gains_db[0]], gains_db, [gains_db[-1]]])
        lin = 10.0 ** (gains / 20.0)
        fir = scipy.signal.firwin2(self.nfir + 1, freqs, lin, fs=self.fs)
        return fir, self.nfir // 2

    def apply(self, fir: np.ndarray, signal: np.ndarray) -> np.ndarray:
        return np.convolve(signal, fir, mode="full")


def _gain_switched_one_pole(target: np.ndarray, a_att: float, a_rel: float,
                            g0: float = 1.0) -> np.ndarray:
    """Exact vectorization of the gain-direction switched smoother

        coef_i = a_att if target[i] < g[i-1] else a_rel
        g[i]   = (1 - coef_i) * g[i-1] + coef_i * target[i]

    (clarity Compressor dynamics: attack speed while the gain is being
    pulled DOWN, release speed while it recovers toward unity — the
    switch depends on the smoothed state itself, not on the threshold
    test, so a decaying-but-still-loud passage recovers at release
    speed). Each constant-mode run solves in closed form (with
    P = cumprod(1-c), g = P * (g0 + cumsum(c*target/P))); the first
    sample whose direction disagrees with the assumed mode ends the run
    and flips it. The one-pole never overshoots its target (c < 1), so
    mode flips only happen where the smoothed RMS envelope crosses the
    gain — a handful of events per track, keeping this ~100x faster
    than the per-sample Python loop it matches to float64 precision."""
    n = len(target)
    out = np.empty_like(target)
    g = g0
    i = 0
    # cap run length so cumprod(1-c) stays far from float64 under/overflow
    def _cap(c):
        l1 = np.log1p(-c)
        return 512 if l1 == 0.0 else max(1, min(512, int(-250.0 / l1)))

    osc = 0  # consecutive vectorized runs that died after a single sample
    while i < n:
        if osc >= 4:
            # worst case: the RMS envelope hovers around the gain (e.g.
            # tremolo at the threshold), every vectorized run terminates at
            # length 1, and the per-run numpy setup makes this SLOWER than a
            # plain loop. Fall back to the scalar recurrence (numerically
            # identical) until one direction persists, then resume vectorized.
            same, last = 0, target[i] < g
            while i < n and same < 8:
                att = target[i] < g
                same = same + 1 if att == last else 0
                last = att
                c = a_att if att else a_rel
                g = (1.0 - c) * g + c * target[i]
                out[i] = g
                i += 1
            osc = 0
            continue
        att = target[i] < g
        c = a_att if att else a_rel
        j = min(i + _cap(c), n)
        t = target[i:j]
        decay = np.cumprod(np.full(j - i, 1.0 - c))
        traj = decay * (g + np.cumsum(c * t / decay))
        prev = np.concatenate(([g], traj[:-1]))
        bad = np.flatnonzero((t < prev) != att)
        k = int(bad[0]) if bad.size else (j - i)  # bad[0] > 0 by construction
        out[i:i + k] = traj[:k]
        g = out[i + k - 1]
        i += k
        osc = osc + 1 if k == 1 else 0
    return out


class Compressor:
    """RMS-envelope compressor (clarity Compressor semantics)."""

    def __init__(
        self,
        fs: float = 44100.0,
        attack: float = 5.0,
        release: float = 20.0,
        threshold: float = 1.0,
        attenuation: float = 0.0001,
        rms_buffer_size: float = 0.2,
        makeup_gain: float = 1.0,
        **_,
    ):
        self.fs = fs
        self.attack = attack / 1000.0 * fs
        self.release = release / 1000.0 * fs
        self.threshold = threshold
        self.attenuation = attenuation
        self.eps = 1e-8
        self.rms_buffer_size = rms_buffer_size
        self.makeup_gain = makeup_gain
        self.win_len = max(int(rms_buffer_size * fs), 1)

    def process(self, signal: np.ndarray):
        """Returns (compressed_signal, rms_envelope, gains).

        Above threshold the gain target lets an `attenuation` fraction of
        the level through and pins the rest to the threshold:
        target_level = attenuation*rms + (1-attenuation)*threshold, i.e.
        a compressor of slope ~attenuation that degenerates to a hard
        limiter as attenuation -> 0. The gain follows the target with
        one-pole attack dynamics while being pulled down and recovers
        with release dynamics — switched on the gain's direction (the
        clarity Compressor rule), not on the threshold test."""
        signal = np.asarray(signal, np.float64)
        padded = np.concatenate([np.zeros(self.win_len - 1), signal ** 2])
        mean_sq = scipy.signal.lfilter(np.ones(self.win_len) / self.win_len, [1.0], padded)[self.win_len - 1:]
        rms = np.sqrt(mean_sq) + self.eps

        over = rms > self.threshold
        target = np.where(
            over,
            (self.attenuation * rms + (1.0 - self.attenuation) * self.threshold) / rms,
            1.0,
        )
        a_att = 1.0 - np.exp(-1.0 / max(self.attack, 1.0))
        a_rel = 1.0 - np.exp(-1.0 / max(self.release, 1.0))
        comp_ratios = _gain_switched_one_pole(target, a_att, a_rel)
        out = signal * comp_ratios * self.makeup_gain
        return out, rms, comp_ratios


def clip_signal(signal: np.ndarray, soft_clip: bool = False) -> Tuple[np.ndarray, int]:
    """Hard/soft clip to [-1, 1]; returns (clipped, n_clipped)."""
    if soft_clip:
        out = np.tanh(signal)
        n = int(np.sum(np.abs(signal) > 1.0))
        return out, n
    n = int(np.sum(np.abs(signal) > 1.0))
    return np.clip(signal, -1.0, 1.0), n


def to_16bit(signal: np.ndarray) -> np.ndarray:
    return (np.clip(signal, -1.0, 1.0) * 32767.0).astype(np.int16)


def resample(signal: np.ndarray, sr_in: int, sr_out: int, axis: int = 0) -> np.ndarray:
    if sr_in == sr_out:
        return signal
    from math import gcd

    g = gcd(int(sr_in), int(sr_out))
    return scipy.signal.resample_poly(signal, int(sr_out) // g, int(sr_in) // g, axis=axis)
