"""The sliCQT's filterbank plan for the reference: frequency scales,
window design, the dual frame and the buckets, in NumPy.

A frozen copy of the plan code of the measured package (its `ops/fscale.py`
for the bark and mel scales and `ops/filterbank.py`), which follows
sevagh/xumx-sliCQ-V2's nsgt (fscale.py, nsgfwin_sl.py, util.py). The
reference builds its own plan from it and takes no table from the program.
"""

import math
from dataclasses import dataclass, field
from typing import List

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



def hannwin(length: int) -> np.ndarray:
    """Periodic Hann window, peak at index 0 (reference: nsgt/util.py:5-11)."""
    r = np.arange(length, dtype=np.float64)
    r *= np.pi * 2.0 / length
    return 0.5 * (np.cos(r) + 1.0)


def blackharr(n: int, length: int = None, mod: bool = True) -> np.ndarray:
    """Modified Blackman-Harris window, fftshifted so the peak is at index 0
    (reference: nsgt/util.py:14-46)."""
    if length is None:
        length = n
    nn = (n // 2) * 2
    k = np.arange(n, dtype=np.float64)
    if not mod:
        bh = (
            0.35875
            - 0.48829 * np.cos(k * (2 * np.pi / nn))
            + 0.14128 * np.cos(k * (4 * np.pi / nn))
            - 0.01168 * np.cos(k * (6 * np.pi / nn))
        )
    else:
        bh = (
            0.35872
            - 0.48832 * np.cos(k * (2 * np.pi / nn))
            + 0.14128 * np.cos(k * (4 * np.pi / nn))
            - 0.01168 * np.cos(k * (6 * np.pi / nn))
        )
    bh = np.concatenate([bh, np.zeros(length - n, dtype=bh.dtype)])
    return np.concatenate([bh[-(n // 2):], bh[: -(n // 2)]])


def nsgfwin(f: np.ndarray, q: np.ndarray, sr: float, Ls: int, min_win: int = 4, Qvar: float = 1.0):
    """Design the sliced-NSGT analysis filterbank for one slice of length Ls.

    Returns (g, rfbas, M): per-bin windows (list of float32 arrays), rounded
    even center bins (int array), and frequency supports (int array, multiples
    of 4 clipped at min_win). The bank is mirrored to cover negative
    frequencies (conjugate-symmetric layout), and the DC/Nyquist "lowpass"
    windows are special-cased with an embedded Hann when wider than their
    neighbor (reference: nsgt/nsgfwin_sl.py:8-111, sliced=True path only).
    """
    f = np.asarray(f, dtype=np.float32)
    q = np.asarray(q, dtype=np.float32)
    nf = sr / 2.0

    # trim non-positive and >= nyquist frequencies
    pos = np.flatnonzero(f > 0)
    if len(pos) and pos[0] != 0:
        f = f[pos[0]:]
        q = q[pos[0]:]
    hi = np.flatnonzero(f >= nf)
    if len(hi) and hi[0] != 0:
        f = f[: hi[0]]
        q = q[: hi[0]]

    assert len(f) == len(q)
    assert np.all(np.diff(f) > 0)
    assert np.all(q > 0)

    fbas = f
    lbas = len(fbas)

    frqs = np.zeros(lbas + 2, dtype=np.float32)
    frqs[1:-1] = fbas
    frqs[-1] = nf

    # mirror: [0, f_1..f_lbas, nf, sr-f_lbas, ..., sr-f_1]
    fbas_full = np.concatenate([frqs, (np.float32(sr) - frqs[::-1][1:-1]).astype(np.float32)])
    fbas_full = (fbas_full * np.float32(float(Ls) / sr)).astype(np.float32)

    M = np.zeros(fbas_full.shape, dtype=np.float32)
    M[0] = 2 * fbas_full[1]
    M[1] = fbas_full[1] / q[0]
    for k in list(range(2, lbas)) + [lbas + 1]:
        M[k] = fbas_full[k + 1] - fbas_full[k - 1]
    M[lbas] = fbas_full[lbas] / q[lbas - 1]
    M[lbas + 2: 2 * (lbas + 1)] = M[1: lbas + 1][::-1]
    M = M * np.float32(Qvar / 4.0)
    # round-half-to-even to match torch.round on float32
    M = np.round(M).astype(np.int64) * 4
    M = np.clip(M, min_win, None)

    g = [blackharr(int(m)).astype(np.float32) for m in M]

    # DC / Nyquist lowpass windows: flat with embedded Hann transition
    for kk in (1, lbas + 2):
        if M[kk - 1] > M[kk]:
            m_wide = int(M[kk - 1])
            m_narrow = int(M[kk])
            gg = np.ones(m_wide, dtype=np.float32)
            gg[m_wide // 2 - m_narrow // 2: m_wide // 2 + int(np.ceil(m_narrow / 2.0))] = hannwin(m_narrow)
            g[kk - 1] = gg

    rfbas = (np.round(fbas_full / 2.0).astype(np.int64) * 2).astype(np.int64)

    return g, rfbas, M.astype(np.int64)


def calcwinrange(g: List[np.ndarray], rfbas: np.ndarray, Ls: int):
    """Per-bin circular index ranges into the length-`nn` spectrum
    (reference: nsgt/util.py:72-100)."""
    shift = np.empty(len(rfbas), dtype=np.int64)
    shift[0] = (-rfbas[-1]) % Ls
    shift[1:] = np.diff(rfbas)

    timepos = np.cumsum(shift)
    nn = int(timepos[-1])
    timepos = timepos - shift[0]  # positions, starting at 0

    wins = []
    for gii, tpii in zip(g, timepos):
        Lg = len(gii)
        win_range = np.arange(-(Lg // 2) + tpii, Lg - (Lg // 2) + tpii, dtype=np.int64)
        win_range %= nn
        wins.append(win_range)
    return wins, nn


def nsdual(g: List[np.ndarray], wins: List[np.ndarray], nn: int, M: np.ndarray):
    """Canonical dual frame via the diagonal frame operator
    (reference: nsgt/util.py:103-116)."""
    x = np.zeros(nn, dtype=np.float64)
    for gi, mii, sl in zip(g, M, wins):
        xa = np.square(np.fft.fftshift(gi).astype(np.float64)) * float(mii)
        x[sl] += xa
    gd = [gi / np.fft.ifftshift(x[wi]).astype(np.float32) for gi, wi in zip(g, wins)]
    return [gdi.astype(np.float32) for gdi in gd]


@dataclass
class Bucket:
    """A run of contiguous frequency bins sharing one time resolution M."""

    f_start: int  # first bin index (within the reduced [0, nfreqs) set)
    f_count: int  # number of contiguous bins
    M: int        # time resolution (coefficients per slice for these bins)


@dataclass
class FilterbankPlan:
    """Static design artifacts for one sliced-NSGT configuration.

    Covers the full mirrored bank (2*(lbas+1) bins) plus the reduced
    positive-frequency view [0, nfreqs) actually used with real signals
    (real=True, reducedform=0 -- the only configuration the reference
    exercises, transforms.py:60-68).
    """

    sr: float
    Ls: int                      # slice length (sllen)
    nn: int                      # spectral accumulator length (== Ls)
    g: List[np.ndarray]          # analysis windows, one per bin (full bank)
    gd: List[np.ndarray]         # dual (synthesis) windows
    rfbas: np.ndarray            # center bins
    M: np.ndarray                # frequency supports == window lengths
    wins: List[np.ndarray]       # circular index ranges per bin
    nfreqs: int                  # reduced set size == lbas + 2
    buckets: List[Bucket] = field(default_factory=list)

    @property
    def ncoefs(self) -> int:
        """Max coefficients per slice across the reduced set
        (reference: slicq.py:134-137; col==1 always, so this is max M)."""
        return int(max(self.M[: self.nfreqs]))

    def coef_factors(self) -> List[float]:
        return [float(self.M[i]) / self.Ls for i in range(self.nfreqs)]


def derive_buckets(M: np.ndarray, nfreqs: int) -> List[Bucket]:
    """Group contiguous reduced-set bins with identical M into buckets.

    This reproduces the reference's runtime bucketing (nsgtf.py:66-84) as a
    static table: the transform runs one gather+iFFT per bucket."""
    buckets: List[Bucket] = []
    start = 0
    for j in range(1, nfreqs + 1):
        if j == nfreqs or M[j] != M[start]:
            buckets.append(Bucket(f_start=start, f_count=j - start, M=int(M[start])))
            start = j
    return buckets


def design_filterbank(scale, sllen: int, trlen: int, fs: float, min_win: int = 16, Qvar: float = 1.0) -> FilterbankPlan:
    """Full design: scale -> windows -> index ranges -> dual frame -> buckets.

    Mirrors NSGT_sliced.__init__ (reference: slicq.py:71-151) with
    real=True, reducedform=0, multichannel=True."""
    assert fs > 0 and sllen > 0 and trlen >= 0
    assert sllen > trlen * 2
    assert sllen % 4 == 0 and trlen % 2 == 0

    frqs, q = scale()
    g, rfbas, M = nsgfwin(frqs, q, fs, sllen, min_win=min_win, Qvar=Qvar)
    wins, nn = calcwinrange(g, rfbas, sllen)
    assert nn == sllen, f"winrange total {nn} != sllen {sllen}"
    gd = nsdual(g, wins, nn, M)

    nfreqs = len(g) // 2 + 1
    # mirror-symmetry invariant used by the inverse transform
    nbins_full = len(g)
    for j in range(1, nfreqs - 1):
        assert M[nbins_full - j] == M[j], "mirror bins must share time resolution"

    plan = FilterbankPlan(
        sr=fs, Ls=sllen, nn=nn, g=g, gd=gd, rfbas=rfbas, M=M, wins=wins, nfreqs=nfreqs,
    )
    plan.buckets = derive_buckets(M, nfreqs)
    return plan


def make_scale(name: str, fbins: int, fmin: float, fmax: float = 22050.0):
    """A Scale by the reference's config string (bark or mel)."""
    if name == "bark":
        return BarkScale(fmin, fmax, fbins)
    if name == "mel":
        return MelScale(fmin, fmax, fbins)
    raise ValueError(f"the reference plans bark and mel scales only, not {name!r}")
