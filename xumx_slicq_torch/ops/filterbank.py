"""NSGT filterbank design for the sliced transform (host-side NumPy plan code).

Designs the analysis windows `g`, their center bins `rfbas`, frequency supports
`M`, circular index ranges `wins`, and the canonical dual frame `gd`; then
derives the static *bucket table* (runs of contiguous bins sharing one time
resolution) that the transform is planned against. A copy of
xumx_slicq_tpu/ops/filterbank.py; the CPU tests hold the two bit-equal.

Numerical parity with the reference design path
(sevagh/xumx-sliCQ-V2: nsgt/nsgfwin_sl.py:8-111, nsgt/util.py:5-116) is kept
by doing the critical arithmetic in float32 before rounding, as the reference
does with torch float32 tensors. Everything here runs once on the host at
plan-construction time.
"""

from dataclasses import dataclass, field
from typing import List

import numpy as np

from .fscale import Scale


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


def design_filterbank(scale: Scale, sllen: int, trlen: int, fs: float, min_win: int = 16, Qvar: float = 1.0) -> FilterbankPlan:
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
