"""Sliced Constant-Q Transform (sliCQT / sliced NSGT) in PyTorch.

Port of xumx_slicq_tpu/ops/slicqt.py. The plan (windows, index tables,
weights) is built once in NumPy, exactly as the JAX package builds it, and
held as device tensors. The compute differs where the TPU forced a shape:

* the slice FFT is `torch.fft.rfft` / `irfft` (cuFFT), not the mixed-radix
  DFT-matmul plan the TPU needed for nn = 18060 = 2^2*3*5*7*43;
* the per-bucket M-point (i)DFTs are `torch.fft.fft` / `ifft` over M (the
  JAX package's `dft_inv` / `dft_fwd` matrices are exactly those);
* synthesis assembles the nh half spectrum straight from the flat raw
  bucket spectra (no 128-lane padding, no (n2, h1) remap) with kernel K1
  (kernels/synth_assembly.py), then calls `irfft`.

Analysis: temporal slicing -> rfft over nn -> K3 (kernels/analysis_gather.py):
for every bucket at once, a gather from the half spectrum (positions past
nh read the Hermitian mirror, as `_build_forward_half` does with nh in
place of Lh) and the parity-indexed fused weight, written in each bucket's
(B, C, F, S, M) order into one packed buffer -> ifft over M of each bucket
view into the output's view of another packed buffer
(ops/packed.BucketLayout), which Wiener-EM reads whole.
Synthesis: fft over M -> arrange ramp, written into the flat raw buffer ->
K1 (weights, mirror conjugation, un-rotation) -> irfft -> overlap-add.
Transform math stays in full fp32 (cuFFT has no TF32 path; nothing here
enables TF32 matmuls).

Under `no_grad`/`inference_mode`, synthesis writes each bucket's ramped
spectrum into its window of a preallocated flat buffer (`out=`). With
autograd on and a block that needs a gradient (the train step's SD-SDR
term), it builds the same flat buffer with one `torch.cat`, and K1's
backward kernel carries the gradient back through the assembly.
"""

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.analysis_gather import analysis_gather, build_table
from ..kernels.synth_assembly import SynthTable, synth_assembly
from .filterbank import FilterbankPlan, design_filterbank, hannwin
from .fscale import make_scale
from .packed import BucketLayout, PackedBlocks


def _make_slice_window(sl_len: int, tr_area: int) -> np.ndarray:
    """Tukey-like slice window from two half-Hanns
    (reference: nsgt/slicing.py:7-18)."""
    hhop = sl_len // 4
    htr = tr_area // 2
    w = hannwin(2 * tr_area)
    tw = np.zeros(sl_len, dtype=np.float64)
    tw[hhop - htr: hhop + htr] = w[tr_area:]
    tw[hhop + htr: 3 * hhop - htr] = 1
    tw[3 * hhop - htr: 3 * hhop + htr] = w[:tr_area]
    return tw.astype(np.float32)


def design_plan(scale: str = "bark", fbins: int = 262, fmin: float = 32.9, fmax: float = 22050.0,
                fgamma: float = 15.0, fs: float = 44100.0, sllen: Optional[int] = None,
                trlen: Optional[int] = None, min_win: int = 16):
    """(plan, sllen, trlen): the NumPy filterbank plan of a transform, with
    the scale's suggested slice and transition lengths unless given, as the
    JAX package designs it."""
    scl = make_scale(scale, fbins, fmin, fmax, fgamma)
    if sllen is None:
        sllen, trlen = scl.suggested_sllen_trlen(fs)
    return design_filterbank(scl, int(sllen), int(trlen), fs, min_win=min_win), int(sllen), int(trlen)


@dataclass(frozen=True)
class _BucketPlan:
    """Static NumPy tables of one bucket (same values as the JAX package's
    _BucketTables, without the DFT matrices)."""

    f_start: int
    f_count: int
    M: int
    starts: np.ndarray       # (F,) first spectrum position of each bin's window
    fwd_w: np.ndarray        # (2, F, M) complex64 fused analysis weights by parity
    inv_ramp: np.ndarray     # (2, M) complex64 synthesis arrange ramp by parity
    w_pos: np.ndarray        # (F, M) float32 synthesis weights gd * M
    neg_lo: int              # local bins [neg_lo, neg_hi) have a mirror partner
    neg_hi: int
    w_neg: Optional[np.ndarray]  # (neg_hi - neg_lo, M) float32 or None


class SliCQT:
    """Sliced NSGT over a fixed filterbank plan, on one device.

    forward: (B, C, L) float32 -> list of (B, C, F_b, S, M_b) complex64,
    views of one packed buffer (`PackedBlocks`).
    backward: that list -> (B, C, length). Coefficients are the JAX
    package's block for block (same plan, same slice-parity rotation)."""

    def __init__(
        self,
        scale: str = "bark",
        fbins: int = 262,
        fmin: float = 32.9,
        fmax: float = 22050.0,
        fgamma: float = 15.0,
        fs: float = 44100.0,
        sllen: Optional[int] = None,
        trlen: Optional[int] = None,
        min_win: int = 16,
        device="cuda",
        plan=None,
    ):
        """plan: what `design_plan` returns for these arguments, when the
        caller has built it already (the oracle search does, to tell a
        transform the plan refuses from one the port refuses)."""
        self.device = resolve_device(device)
        self.scale_name = scale
        self.fbins = fbins
        self.fmin = fmin
        self.fmax = fmax
        self.fgamma = fgamma
        self.fs = fs
        self.min_win = min_win

        if plan is None:
            plan = design_plan(scale, fbins, fmin, fmax, fgamma, fs, sllen, trlen, min_win)
        self.plan: FilterbankPlan = plan[0]
        self.sllen, self.trlen = plan[1], plan[2]

        self.hhop = self.sllen // 4
        self.nn = self.plan.nn
        self.nh = self.nn // 2 + 1
        self.nfreqs = self.plan.nfreqs

        self._build_bucket_plans()
        self._build_synth_table()
        self._to_device()

    # -- plan construction (NumPy, once) --------------------------------------

    def _build_bucket_plans(self):
        """Per-bucket analysis/synthesis weights: the JAX package's
        _build_bucket_tables (slicqt.py:177-256) value for value."""
        plan, nn, hhop = self.plan, self.nn, self.hhop
        buckets: List[_BucketPlan] = []
        for b in plan.buckets:
            M = b.M
            rolled = (np.arange(M) + M // 2) % M   # coefficient roll (nsgtf.py:55-63)
            k = np.arange(M)
            r_even, r_odd = 3 * M // 4, M // 4
            fwd_ramp = np.stack([
                np.exp(2j * np.pi * k * r_even / M),
                np.exp(2j * np.pi * k * r_odd / M),
            ])
            starts, ws, wpos = [], [], []
            for j in range(b.f_start, b.f_start + b.f_count):
                win = plan.wins[j]
                gs = np.fft.fftshift(plan.g[j]).astype(np.float64)
                starts.append(int(win[0]))
                idx_full = win[rolled]
                # slices stay in temporal order; the reference's rotated
                # layout is a per-parity spectral phase (slicing.py:53-58)
                rot = np.stack([
                    np.exp(-2j * np.pi * idx_full * (3 * hhop) / nn),
                    np.exp(-2j * np.pi * idx_full * (1 * hhop) / nn),
                ])
                ws.append(gs[rolled][None, :] * fwd_ramp * rot)
                wpos.append((plan.gd[j] * np.float32(M)).astype(np.float32))
            inv_ramp = np.stack([
                np.exp(2j * np.pi * k * r_odd / M),
                np.exp(2j * np.pi * k * r_even / M),
            ]).astype(np.complex64)
            lo_bin = max(b.f_start, 1)
            hi_bin = min(b.f_start + b.f_count, self.nfreqs - 1)
            if hi_bin > lo_bin:
                w_neg = np.stack([
                    (plan.gd[2 * (self.nfreqs - 1) - j] * np.float32(M)).astype(np.float32)
                    for j in range(lo_bin, hi_bin)
                ])
                neg_lo, neg_hi = lo_bin - b.f_start, hi_bin - b.f_start
            else:
                w_neg, neg_lo, neg_hi = None, 0, 0
            buckets.append(_BucketPlan(
                f_start=b.f_start, f_count=b.f_count, M=M,
                starts=np.asarray(starts, np.int64),
                fwd_w=np.ascontiguousarray(np.stack(ws).transpose(1, 0, 2), dtype=np.complex64),
                inv_ramp=inv_ramp,
                w_pos=np.stack(wpos),
                neg_lo=neg_lo, neg_hi=neg_hi, w_neg=w_neg,
            ))
        self.buckets = buckets
        # analysis gather over the rfft half spectrum: p < nh reads X[p],
        # nh <= p < nn reads conj(X[nn - p]), p >= nn wraps to X[p - nn]
        self._fwd_src = []
        for b in buckets:
            p = b.starts[:, None] + ((np.arange(b.M) + b.M // 2) % b.M)[None, :]
            src = np.where(p < self.nh, p, np.where(p < nn, nn - p, p - nn))
            sgn = np.where((p >= self.nh) & (p < nn), -1.0, 1.0)
            assert 0 <= src.min() and src.max() < self.nh
            self._fwd_src.append((src.astype(np.int64), sgn.astype(np.float32)))
        p = np.arange(self.nh)
        self._unrot = np.stack([
            np.exp(2j * np.pi * p * (3 * hhop) / nn),
            np.exp(2j * np.pi * p * (1 * hhop) / nn),
        ]).astype(np.complex64)

    def _build_synth_table(self):
        """Synthesis scatter-add (nsigtf.py:88-95) as a gather table over
        the flat raw layout: bucket b's (F_b, M_b) spectrum at raw_starts[b],
        unpadded. Value u of bin j lands at wins[j][(M/2 + u) % M] with
        weight gd*M; a mirror bin reads conj(spec[j, min(u+1, M-1)]) with its
        partner's weight (w_im = -w). Entries per position keep the JAX
        package's order (positive pieces, then mirror pieces)."""
        plan, nh = self.plan, self.nh
        pos, raw, wr, wi = [], [], [], []
        raw_starts, off = [], 0
        for b in self.buckets:
            raw_starts.append(off)
            tgt = (b.M // 2 + np.arange(b.M)) % b.M
            for jl, j in enumerate(range(b.f_start, b.f_start + b.f_count)):
                pos.append(plan.wins[j][tgt])
                raw.append(off + jl * b.M + np.arange(b.M))
                wr.append(b.w_pos[jl])
                wi.append(b.w_pos[jl])
            off += b.f_count * b.M
        for bi, b in enumerate(self.buckets):
            if b.w_neg is None:
                continue
            tgt = (b.M // 2 + np.arange(b.M)) % b.M
            mu = np.minimum(np.arange(b.M) + 1, b.M - 1)
            for row, j in enumerate(range(b.f_start + b.neg_lo, b.f_start + b.neg_hi)):
                pos.append(plan.wins[2 * (self.nfreqs - 1) - j][tgt])
                raw.append(raw_starts[bi] + (j - b.f_start) * b.M + mu)
                wr.append(b.w_neg[row])
                wi.append(-b.w_neg[row])
        pos, raw = np.concatenate(pos), np.concatenate(raw)
        wr, wi = np.concatenate(wr), np.concatenate(wi)
        keep = pos < nh
        pos, raw, wr, wi = pos[keep], raw[keep], wr[keep], wi[keep]
        order = np.argsort(pos, kind="stable")          # keeps appearance order per row
        pos, raw, wr, wi = pos[order], raw[order], wr[order], wi[order]
        counts = np.bincount(pos, minlength=nh)
        col = np.arange(pos.size) - np.repeat(np.cumsum(counts) - counts, counts)
        O = int(counts.max())
        self.raw_starts = raw_starts
        self.raw_len = off
        self.inv_overlap = O
        self._synth_np = dict(
            idx=np.full((nh, O), off, np.int32),
            w_re=np.zeros((nh, O), np.float32),
            w_im=np.zeros((nh, O), np.float32),
        )
        self._synth_np["idx"][pos, col] = raw
        self._synth_np["w_re"][pos, col] = wr
        self._synth_np["w_im"][pos, col] = wi
        # the transposed table for K1's backward: per raw value, the
        # positions that read it (one positive piece, at most two mirror
        # pieces as mu clamps at M - 1), sentinel nh after them
        order = np.argsort(raw, kind="stable")
        traw, tpos, twr, twi = raw[order], pos[order], wr[order], wi[order]
        tcounts = np.bincount(traw, minlength=off)
        W = int(tcounts.max())
        assert W <= 3, f"a raw synthesis value is read {W} times, expected at most 3"
        tcol = np.arange(traw.size) - np.repeat(np.cumsum(tcounts) - tcounts, tcounts)
        self._synth_np.update(
            tidx=np.full((off, W), nh, np.int32),
            tw_re=np.zeros((off, W), np.float32),
            tw_im=np.zeros((off, W), np.float32),
        )
        self._synth_np["tidx"][traw, tcol] = tpos
        self._synth_np["tw_re"][traw, tcol] = twr
        self._synth_np["tw_im"][traw, tcol] = twi

    def _to_device(self):
        dev = self.device
        self._window = torch.from_numpy(_make_slice_window(self.sllen, self.trlen)).to(dev)
        # per bucket (src, sgn, fwd_w): the tables of K3's plain version
        self.forward_tables = [
            (torch.from_numpy(src).to(dev), torch.from_numpy(sgn).to(dev), torch.from_numpy(b.fwd_w).to(dev))
            for b, (src, sgn) in zip(self.buckets, self._fwd_src)
        ]
        self.analysis_table = build_table([src for src, _ in self._fwd_src], [sgn for _, sgn in self._fwd_src],
                                          [b.fwd_w for b in self.buckets], self.nh, dev)
        self._inv_ramp = [torch.from_numpy(b.inv_ramp).to(dev) for b in self.buckets]
        self.synth_table = SynthTable(
            unrot=torch.from_numpy(self._unrot).to(dev),
            raw_len=self.raw_len,
            **{k: torch.from_numpy(a).to(dev) for k, a in self._synth_np.items()},
        )

    # -- shape helpers ---------------------------------------------------------

    def n_slices(self, length: int) -> int:
        """Number of slices for a signal of `length` samples
        (slicing.py:49-73)."""
        nb = -(-length // self.hhop)
        return (nb + 1) // 2 + 1

    def max_length(self, n_slices: int) -> int:
        """Largest signal length that still yields `n_slices` slices."""
        return 2 * (n_slices - 1) * self.hhop

    def block_shapes(self, batch: int, channels: int, length: int):
        S = self.n_slices(length)
        return [(batch, channels, b.f_count, S, b.M) for b in self.buckets]

    def _parity(self, S: int) -> torch.Tensor:
        return torch.arange(S, device=self.device) % 2

    # -- analysis --------------------------------------------------------------

    def _slice_temporal(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, L) -> windowed slices (B, C, S, sllen) in temporal order."""
        B, C, L = x.shape
        hhop = self.hhop
        nb = -(-L // hhop)
        S = (nb + 1) // 2 + 1
        total = (2 * S + 2) * hhop                 # blocks 0..2S+1 (2 lead zeros)
        xb = torch.nn.functional.pad(x, (2 * hhop, total - 2 * hhop - L))
        Y = xb.reshape(B, C, S + 1, 2 * hhop)
        raw = torch.cat([Y[:, :, :-1], Y[:, :, 1:]], dim=-1)
        return raw * self._window

    def layout(self, batch: int, channels: int, n_slices: int) -> BucketLayout:
        """The packed layout of the blocks for (B, C, S)."""
        return BucketLayout([(batch, channels, b.f_count, n_slices, b.M) for b in self.buckets])

    def half_spectrum(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, L) -> the rfft half spectrum of every slice, (B, C, S, nh)
        complex64: K3's input."""
        return torch.fft.rfft(self._slice_temporal(x), dim=-1)

    def forward(self, x: torch.Tensor) -> PackedBlocks:
        """Analysis: (B, C, L) float32 -> list of (B, C, F_b, S, M_b) complex64.

        The blocks are contiguous views of one packed buffer (the list's
        `packed`, at the offsets of its `layout`), which Wiener-EM reads as
        one tensor."""
        X = self.half_spectrum(x)
        B, C, S, _ = X.shape
        layout = self.layout(B, C, S)
        weighted = PackedBlocks(analysis_gather(X, self.analysis_table), layout)   # K3
        out = PackedBlocks(torch.empty(layout.size, dtype=torch.complex64, device=self.device), layout)
        for t, dst in zip(weighted, out):
            torch.fft.ifft(t, dim=-1, out=dst)                          # (B,C,F,S,M)
        return out

    # -- synthesis -------------------------------------------------------------

    def backward(self, blocks: Sequence[torch.Tensor], length: int) -> torch.Tensor:
        """Synthesis: list of (B, C, F_b, S, M_b) complex -> (B, C, length)."""
        B, C, _, S, _ = blocks[0].shape
        sig = torch.fft.irfft(self.synth_spectrum(blocks), n=self.nn, dim=-1)   # (B*C,S,nn)
        return self.unslice_signal(sig.reshape(B, C, S, self.nn), length)

    def synth_spectrum(self, blocks: Sequence[torch.Tensor]) -> torch.Tensor:
        """The half spectrum of every synthesis slice, (B*C, S, nh) complex64:
        per-bucket FFT over M and arrange ramp into the flat raw buffer,
        then K1."""
        B, C, _, S, _ = blocks[0].shape
        N = B * C
        parity = self._parity(S)
        specs = (torch.fft.fft(cb.to(torch.complex64), dim=-1).reshape(N, b.f_count, S, b.M)
                 for b, cb in zip(self.buckets, blocks))
        if torch.is_grad_enabled() and any(cb.requires_grad for cb in blocks):
            # out= writes do not differentiate: concatenate the (S, F*M) pieces
            flat = torch.cat([(spec * ramp[parity]).transpose(1, 2).reshape(N, S, -1)
                              for spec, ramp in zip(specs, self._inv_ramp)], dim=-1)
            return synth_assembly(flat, self.synth_table)
        flat = torch.empty((N, S, self.raw_len), dtype=torch.complex64, device=self.device)
        for b, off, ramp, spec in zip(self.buckets, self.raw_starts, self._inv_ramp, specs):
            F, M = b.f_count, b.M
            # the ramp multiply writes straight into this bucket's (S, F, M)
            # window of the flat buffer: no per-bucket copy, no concat
            dst = flat[:, :, off: off + F * M].unflatten(-1, (F, M)).transpose(1, 2)
            torch.mul(spec, ramp[parity], out=dst)
        return synth_assembly(flat, self.synth_table)

    def unslice_signal(self, sig_slices: torch.Tensor, length: int) -> torch.Tensor:
        """Overlap-add of temporal-order slices: two strided adds, the
        2-block head drop (slicq.py:218) and truncation."""
        B, C, S, _ = sig_slices.shape
        hhop = self.hhop
        quads = sig_slices.reshape(B, C, S, 4, hhop)
        P1 = quads[:, :, :, 2:4].reshape(B, C, 2 * S * hhop)
        P2 = quads[:, :, 1:, 0:2].reshape(B, C, 2 * (S - 1) * hhop)
        out = P1 + torch.nn.functional.pad(P2, (0, 2 * hhop))
        return out[..., :length]

    # -- misc ------------------------------------------------------------------

    def coef_factors(self) -> List[float]:
        """Per frequency bin, coefficients per input sample (M / Ls of the plan)."""
        return self.plan.coef_factors()

    @property
    def fbins_actual(self) -> int:
        """Frequency bins of the transform, the DC bin included."""
        return self.nfreqs

    def config_dict(self):
        return dict(
            scale=self.scale_name, fbins=self.fbins, fmin=self.fmin,
            fmax=self.fmax, fgamma=self.fgamma, fs=self.fs,
            sllen=self.sllen, trlen=self.trlen,
        )


def make_slicqt(scale: str = "bark", fbins: int = 262, fmin: float = 32.9, **kw) -> SliCQT:
    """The canonical transform by default (bark-262 from 32.9 Hz); keywords as SliCQT's."""
    return SliCQT(scale=scale, fbins=fbins, fmin=fmin, **kw)
