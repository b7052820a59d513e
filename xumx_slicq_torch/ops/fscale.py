"""Frequency scales for the NSGT filterbank (host-side plan code, NumPy).

Maps bin index -> center frequency (Hz) and Q-factor, and derives the
suggested slice/transition lengths for the sliced transform. Behavioral
parity with the reference implementation (xumx_slicq_v2/nsgt/fscale.py in
sevagh/xumx-sliCQ-V2); the per-bin values are computed with Python floats
and then rounded to float32, matching the reference's tensor dtype, so the
downstream integer window lengths come out bit-identical.

This is pure plan-time code: it runs once on the host when a transform is
configured, never on the GPU. It is a copy of xumx_slicq_tpu/ops/fscale.py
(the port imports nothing of the JAX package); the CPU tests hold the two
bit-equal.
"""

import math

import numpy as np


class Scale:
    """Base frequency scale: subclasses define F(bnd) -> Hz.

    Q factors default to numerical differentiation of F
    (reference: fscale.py:15-23).
    """

    dbnd = 1.0e-8

    def __init__(self, bnds: int):
        self.bnds = int(bnds)

    def __len__(self) -> int:
        return self.bnds

    def F(self, bnd):
        raise NotImplementedError

    def Q(self, bnd=None):
        if bnd is None:
            return np.asarray([self.Q(b) for b in range(self.bnds)], dtype=np.float64)
        # numerical differentiation
        return self.F(bnd) * self.dbnd / (self.F(bnd + self.dbnd) - self.F(bnd - self.dbnd))

    def __call__(self):
        """Return (freqs, q_factors) as float32 arrays of length bnds."""
        f = np.asarray([self.F(b) for b in range(self.bnds)], dtype=np.float32)
        q = np.asarray([self.Q(b) for b in range(self.bnds)], dtype=np.float32)
        return f, q

    def suggested_sllen_trlen(self, sr: float):
        """Suggested (slice length, transition length) in samples.

        sllen = ceil(max(q * 8 * sr / f)) rounded up to a multiple of 4;
        trlen = sllen/4 rounded up to a multiple of 2
        (reference: fscale.py:40-53).
        """
        f, q = self()
        # float32 arithmetic to match the reference's torch tensors
        ratio = (q * np.float32(8.0) * np.float32(sr)) / f
        Ls = int(math.ceil(float(ratio.max())))
        Ls = Ls + (-Ls) % 4
        sllen = Ls
        trlen = sllen // 4
        trlen = trlen + (-trlen) % 2
        return sllen, trlen


class BarkScale(Scale):
    """Bark scale: b = 6*asinh(f/600) (reference: fscale.py:56-89)."""

    @staticmethod
    def hz2bark(f):
        return 6.0 * math.asinh(f / 600.0)

    @staticmethod
    def bark2hz(b):
        return 600.0 * math.sinh(b / 6.0)

    def __init__(self, fmin: float, fmax: float, bnds: int, beyond: int = 0):
        bmin = self.hz2bark(fmin)
        bmax = self.hz2bark(fmax)
        super().__init__(bnds + beyond * 2)
        self.fmin = float(fmin)
        self.fmax = float(fmax)
        self.bbnd = (bmax - bmin) / (bnds - 1)
        self.bmin = bmin - self.bbnd * beyond
        self.bmax = bmax + self.bbnd * beyond

    def F(self, bnd):
        return self.bark2hz(bnd * self.bbnd + self.bmin)


class LogScale(Scale):
    """Logarithmic (constant-Q / variable-Q with gamma offset) scale
    (reference: fscale.py:92-128)."""

    def __init__(self, fmin: float, fmax: float, bnds: int, beyond: int = 0, gamma: float = 0.0):
        super().__init__(bnds + beyond * 2)
        lfmin = math.log2(fmin)
        lfmax = math.log2(fmax)
        odiv = (lfmax - lfmin) / (bnds - 1)
        lfmin_ = lfmin - odiv * beyond
        lfmax_ = lfmax + odiv * beyond
        self.fmin = 2 ** lfmin_
        self.fmax = 2 ** lfmax_
        self.pow2n = 2 ** odiv
        self.q = math.sqrt(self.pow2n) / (self.pow2n - 1.0) / 2.0
        self.gamma = gamma

    def F(self, bnd):
        return self.fmin * self.pow2n ** bnd + self.gamma

    def Q(self, bnd=None):
        if bnd is None:
            return np.full(self.bnds, self.q, dtype=np.float64)
        return self.q


class MelScale(Scale):
    """Mel scale (reference: fscale.py:131-170)."""

    @staticmethod
    def hz2mel(f):
        return math.log10(f / 700.0 + 1.0) * 2595.0

    @staticmethod
    def mel2hz(m):
        return (math.pow(10.0, m / 2595.0) - 1.0) * 700.0

    def __init__(self, fmin: float, fmax: float, bnds: int, beyond: int = 0):
        mmin = self.hz2mel(fmin)
        mmax = self.hz2mel(fmax)
        super().__init__(bnds + beyond * 2)
        self.fmin = float(fmin)
        self.fmax = float(fmax)
        self.mbnd = (mmax - mmin) / (bnds - 1)
        self.mmin = mmin - self.mbnd * beyond
        self.mmax = mmax + self.mbnd * beyond

    def F(self, bnd):
        return self.mel2hz(bnd * self.mbnd + self.mmin)


class LinScale(Scale):
    """Linear (STFT-like) scale (reference: fscale.py:173-192)."""

    def __init__(self, fmin: float, fmax: float, bnds: int, beyond: int = 0):
        self.df = float(fmax - fmin) / (bnds - 1)
        super().__init__(bnds + beyond * 2)
        self.fmin = float(fmin) - self.df * beyond
        if self.fmin <= 0:
            raise ValueError("Frequencies must be > 0.")
        self.fmax = float(fmax) + self.df * beyond

    def F(self, bnd):
        return bnd * self.df + self.fmin

    def Q(self, bnd=None):
        if bnd is None:
            return np.asarray([self.Q(b) for b in range(self.bnds)], dtype=np.float64)
        return self.F(bnd) / (self.df * 2)


class MRSTFTScale(Scale):
    """Multi-resolution linear scale: 5 linear segments
    (reference: fscale.py:195-226)."""

    def __init__(self):
        self.mr_scales = [
            (1.0, 400.0, 128),
            (401.0, 1200.0, 128),
            (1201.0, 4000.0, 128),
            (4001.0, 12000.0, 128),
            (12001.0, 22050.0, 64),
        ]
        freqs = [
            np.linspace(lo, hi, n, dtype=np.float64) for (lo, hi, n) in self.mr_scales
        ]
        dfs = [
            np.full(n, (hi - lo) / n, dtype=np.float64) for (lo, hi, n) in self.mr_scales
        ]
        self.Fs = np.concatenate(freqs)
        self.dfs = np.concatenate(dfs)
        self.Qs = self.Fs / self.dfs * 2
        super().__init__(len(self.Fs))

    def F(self, bnd):
        return float(self.Fs[int(bnd)])

    def Q(self, bnd=None):
        if bnd is None:
            return self.Qs.copy()
        return float(self.Qs[int(bnd)])

    def __call__(self):
        return self.Fs.astype(np.float32), self.Qs.astype(np.float32)


_SCALES = {
    "bark": BarkScale,
    "mel": MelScale,
    "cqlog": LogScale,
    "vqlog": LogScale,
    "linear": LinScale,
    "mrstft": MRSTFTScale,
}


def make_scale(name: str, fbins: int, fmin: float, fmax: float = 22050.0, fgamma: float = 15.0) -> Scale:
    """Build a Scale by name, matching the reference's config strings
    ("bark"/"mel"/"cqlog"/"vqlog"/"linear"/"mrstft", reference:
    transforms.py:30-48)."""
    if name == "bark":
        return BarkScale(fmin, fmax, fbins)
    if name == "mel":
        return MelScale(fmin, fmax, fbins)
    if name == "cqlog":
        return LogScale(fmin, fmax, fbins)
    if name == "vqlog":
        return LogScale(fmin, fmax, fbins, gamma=fgamma)
    if name == "linear":
        return LinScale(fmin, fmax, fbins)
    if name == "mrstft":
        return MRSTFTScale()
    raise ValueError(f"unknown scale {name!r}; choose from {sorted(_SCALES)}")
