"""The sliced constant-Q transform in plain PyTorch: the reference's analysis
and synthesis, bucket by bucket.

Analysis: temporal slicing with the Tukey-like slice window, an rFFT over
the slice, then for each bucket a gather of its bins' windows from the half
spectrum (the Hermitian mirror past nh), the parity-dependent fused weight
and an iFFT over M. Synthesis: an FFT over M and the arrange ramp per
bucket, the weighted assembly of the half spectrum from every bin that
covers a position (each bin's dual window, and the mirror bins'
conjugates), an irFFT and the overlap-add. The tables are worked out here
from the plan (`plan.py`), as sevagh/xumx-sliCQ-V2's nsgt sets them up
(slicing.py, nsgtf.py, nsigtf.py); they are a frozen copy of the measured
package's plain transform, built anew from this file's own plan.
"""

from typing import List, Sequence

import numpy as np
import torch

from .plan import design_filterbank, hannwin, make_scale


def slice_window(sl_len: int, tr_area: int) -> np.ndarray:
    """Tukey-like slice window from two half-Hanns (nsgt/slicing.py:7-18)."""
    hhop, htr = sl_len // 4, tr_area // 2
    w = hannwin(2 * tr_area)
    tw = np.zeros(sl_len, dtype=np.float64)
    tw[hhop - htr: hhop + htr] = w[tr_area:]
    tw[hhop + htr: 3 * hhop - htr] = 1
    tw[3 * hhop - htr: 3 * hhop + htr] = w[:tr_area]
    return tw.astype(np.float32)


class PlainSliCQT:
    """The transform of a configuration's `transform` entry on one device.

    forward: (B, C, L) float32 -> list of (B, C, F_b, S, M_b) complex64.
    backward: that list -> (B, C, length)."""

    def __init__(self, scale: str, fbins: int, fmin: float, fmax: float = 22050.0, fs: float = 44100.0,
                 device="cpu"):
        scl = make_scale(scale, fbins, fmin, fmax)
        sllen, trlen = scl.suggested_sllen_trlen(fs)
        self.plan = plan = design_filterbank(scl, sllen, trlen, fs)
        self.device = torch.device(device)
        self.sllen, self.trlen = sllen, trlen
        self.hhop = sllen // 4
        self.nn = plan.nn
        self.nh = self.nn // 2 + 1
        self.nfreqs = plan.nfreqs
        self.buckets = plan.buckets
        self._tables()

    def n_slices(self, length: int) -> int:
        return (-(-length // self.hhop) + 1) // 2 + 1

    def block_shapes(self, batch: int, channels: int, length: int):
        S = self.n_slices(length)
        return [(batch, channels, b.f_count, S, b.M) for b in self.buckets]

    def _tables(self):
        plan, nn, nh, hhop, dev = self.plan, self.nn, self.nh, self.hhop, self.device
        self.window = torch.from_numpy(slice_window(self.sllen, self.trlen)).to(dev)
        fwd, inv_ramp, w_pos, w_neg = [], [], [], []
        for b in self.buckets:
            M = b.M
            rolled = (np.arange(M) + M // 2) % M
            k = np.arange(M)
            ramp = np.stack([np.exp(2j * np.pi * k * (3 * M // 4) / M), np.exp(2j * np.pi * k * (M // 4) / M)])
            src, sgn, ws, wp = [], [], [], []
            for j in range(b.f_start, b.f_start + b.f_count):
                win = plan.wins[j]
                gs = np.fft.fftshift(plan.g[j]).astype(np.float64)
                idx = win[rolled]
                rot = np.stack([np.exp(-2j * np.pi * idx * (3 * hhop) / nn), np.exp(-2j * np.pi * idx * hhop / nn)])
                ws.append(gs[rolled][None, :] * ramp * rot)
                p = win[0] + rolled
                src.append(np.where(p < nh, p, np.where(p < nn, nn - p, p - nn)))
                sgn.append(np.where((p >= nh) & (p < nn), -1.0, 1.0))
                wp.append(plan.gd[j] * np.float32(M))
            fwd.append((torch.from_numpy(np.stack(src).astype(np.int64)).to(dev),
                        torch.from_numpy(np.stack(sgn).astype(np.float32)).to(dev),
                        torch.from_numpy(np.stack(ws).transpose(1, 0, 2).astype(np.complex64)).to(dev)))
            inv_ramp.append(np.stack([np.exp(2j * np.pi * k * (M // 4) / M),
                                      np.exp(2j * np.pi * k * (3 * M // 4) / M)]).astype(np.complex64))
            w_pos.append(np.stack(wp).astype(np.float32))
            lo, hi = max(b.f_start, 1), min(b.f_start + b.f_count, self.nfreqs - 1)
            w_neg.append((lo, hi, [plan.gd[2 * (self.nfreqs - 1) - j] * np.float32(M) for j in range(lo, hi)]))
        self.fwd = fwd
        self.inv_ramp = [torch.from_numpy(r).to(dev) for r in inv_ramp]
        # synthesis: for every half-spectrum position, the (raw entry, weight) pairs that land on it
        pos, raw, wr, wi, starts, off = [], [], [], [], [], 0
        for b, wp in zip(self.buckets, w_pos):
            starts.append(off)
            tgt = (b.M // 2 + np.arange(b.M)) % b.M
            for jl, j in enumerate(range(b.f_start, b.f_start + b.f_count)):
                pos.append(plan.wins[j][tgt])
                raw.append(off + jl * b.M + np.arange(b.M))
                wr.append(wp[jl])
                wi.append(wp[jl])
            off += b.f_count * b.M
        for b, start, (lo, hi, wn) in zip(self.buckets, starts, w_neg):
            tgt = (b.M // 2 + np.arange(b.M)) % b.M
            mu = np.minimum(np.arange(b.M) + 1, b.M - 1)
            for row, j in enumerate(range(lo, hi)):
                pos.append(plan.wins[2 * (self.nfreqs - 1) - j][tgt])
                raw.append(start + (j - b.f_start) * b.M + mu)
                wr.append(wn[row])
                wi.append(-wn[row])
        pos, raw = np.concatenate(pos), np.concatenate(raw)
        wr, wi = np.concatenate(wr), np.concatenate(wi)
        keep = pos < nh
        self.raw_starts, self.raw_len = starts, off
        self.syn_pos = torch.from_numpy(pos[keep]).to(dev)
        self.syn_raw = torch.from_numpy(raw[keep]).to(dev)
        self.syn_wr = torch.from_numpy(wr[keep].astype(np.float32)).to(dev)
        self.syn_wi = torch.from_numpy(wi[keep].astype(np.float32)).to(dev)
        p = np.arange(nh)
        self.unrot = torch.from_numpy(np.stack([np.exp(2j * np.pi * p * (3 * hhop) / nn),
                                                np.exp(2j * np.pi * p * hhop / nn)]).astype(np.complex64)).to(dev)

    # -- analysis ----------------------------------------------------------------

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        B, C, L = x.shape
        hhop = self.hhop
        S = self.n_slices(L)
        xb = torch.nn.functional.pad(x, (2 * hhop, (2 * S + 2) * hhop - 2 * hhop - L))
        Y = xb.reshape(B, C, S + 1, 2 * hhop)
        X = torch.fft.rfft(torch.cat([Y[:, :, :-1], Y[:, :, 1:]], dim=-1) * self.window, dim=-1)
        parity = torch.arange(S, device=x.device) % 2
        out = []
        for src, sgn, w in self.fwd:
            t = X[..., src]                                              # (B, C, S, F, M)
            t = torch.complex(t.real, t.imag * sgn) * w[parity]
            out.append(torch.fft.ifft(t.movedim(3, 2), dim=-1))           # (B, C, F, S, M)
        return out

    # -- synthesis ---------------------------------------------------------------

    def backward(self, blocks: Sequence[torch.Tensor], length: int) -> torch.Tensor:
        B, C, _, S, _ = blocks[0].shape
        N = B * C
        parity = torch.arange(S, device=blocks[0].device) % 2
        flat = torch.cat([(torch.fft.fft(cb, dim=-1).reshape(N, b.f_count, S, b.M) * ramp[parity])
                          .transpose(1, 2).reshape(N, S, -1)
                          for b, cb, ramp in zip(self.buckets, blocks, self.inv_ramp)], dim=-1)
        g = flat[:, :, self.syn_raw]                                     # (N, S, entries)
        re = torch.zeros((N, S, self.nh), dtype=torch.float32, device=flat.device)
        im = torch.zeros_like(re)
        re.index_add_(2, self.syn_pos, g.real * self.syn_wr)
        im.index_add_(2, self.syn_pos, g.imag * self.syn_wi)
        spec = torch.complex(re, im) * self.unrot[parity][None]
        sig = torch.fft.irfft(spec, n=self.nn, dim=-1).reshape(B, C, S, 4, self.hhop)
        hhop = self.hhop
        P1 = sig[:, :, :, 2:4].reshape(B, C, 2 * S * hhop)
        P2 = sig[:, :, 1:, 0:2].reshape(B, C, 2 * (S - 1) * hhop)
        return (P1 + torch.nn.functional.pad(P2, (0, 2 * hhop)))[..., :length]
