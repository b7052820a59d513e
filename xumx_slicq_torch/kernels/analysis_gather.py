"""K3: sliCQT analysis gather and weight of every bucket, in one launch.

Replaces the half-spectrum path of the JAX package's SliCQT.forward
(xumx_slicq_tpu/ops/slicqt.py:678-689; tables from `_build_forward_half`,
594-619, and each bucket's `fwd_w`). Given the rFFT half spectrum X
(B, C, S, nh) complex64, it computes for every bucket b, row n, frequency
row f, slice s and coefficient m

    t_b[n, f, s, m] = X[n, s, src_b[f, m]] (conjugated where sgn_b[f, m] = -1)
                      * fwd_w_b[s % 2, f, m]

into one packed buffer in each bucket's (B, C, F_b, S, M_b) order, at the
offsets of `SliCQT.layout`; `SliCQT.forward` then runs the M-point iFFT of
each bucket view (cuFFT). The CUDA kernel is csrc/analysis_gather.cu; its
source note gives the bound and the design.

`analysis_gather_plain` is the per-bucket loop that `SliCQT.forward` ran
before K3 (gather, conjugate, weight, one copy into the packed view per
bucket); `gather_flat_plain` is the same function over K3's flat table
(one gather and one multiply for all buckets, then each bucket's view),
the registered op `xumx_slicq::analysis_gather`'s CPU implementation
(kernels/ops.py). K3 needs no gradient: every caller passes data, and the
wrapper refuses an input that requires one.
"""

import ctypes
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import build


@dataclass(frozen=True)
class AnalysisTable:
    """Static K3 tables on one device, over the flat coefficient index k of
    all buckets (bucket b's (F_b, M_b) block at kstart_b, unpadded)."""

    entries: torch.Tensor    # (K, 4) int32: src (~src where conjugated), kstart_b, M_b, F_b * M_b
    w: torch.Tensor          # (2, K) complex64 weight by slice parity
    nh: int

    @property
    def K(self) -> int:
        return self.entries.shape[0]


def build_table(srcs: Sequence[np.ndarray], sgns: Sequence[np.ndarray], fwd_ws: Sequence[np.ndarray], nh: int,
                device) -> AnalysisTable:
    """K3's table from each bucket's (F, M) gather positions and signs and
    its (2, F, M) weights."""
    entries, ws, kstart = [], [], 0
    for src, sgn, fwd_w in zip(srcs, sgns, fwd_ws):
        F, M = src.shape
        e = np.empty((F * M, 4), np.int32)
        e[:, 0] = np.where(sgn.reshape(-1) < 0, ~src.reshape(-1), src.reshape(-1))
        e[:, 1], e[:, 2], e[:, 3] = kstart, M, F * M
        entries.append(e)
        ws.append(fwd_w.reshape(2, F * M))
        kstart += F * M
    return AnalysisTable(
        entries=torch.from_numpy(np.concatenate(entries)).to(device),
        w=torch.from_numpy(np.ascontiguousarray(np.concatenate(ws, axis=1), dtype=np.complex64)).to(device),
        nh=nh,
    )


def _buckets(entries: torch.Tensor) -> List[Tuple[int, int, int]]:
    """(kstart, F, M) of each bucket, read back from the table."""
    e = entries.cpu()
    starts = torch.unique_consecutive(e[:, 1]).tolist()
    out = []
    for ks in starts:
        M, FM = int(e[ks, 2]), int(e[ks, 3])
        out.append((ks, FM // M, M))
    return out


def gather_flat_plain(X: torch.Tensor, entries: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K3's function in plain PyTorch over its flat table: X (N, S, nh)
    complex64 -> the packed 1-D buffer (N * S * K)."""
    N, S, _ = X.shape
    src = entries[:, 0].long()
    conj = src < 0
    t = X[:, :, torch.where(conj, ~src, src)]                       # (N, S, K)
    t = torch.complex(t.real, torch.where(conj, -t.imag, t.imag))
    parity = torch.arange(S, device=X.device) % 2
    t = t * w[parity]
    out = torch.empty(N * S * entries.shape[0], dtype=torch.complex64, device=X.device)
    for ks, F, M in _buckets(entries):
        dst = out[N * S * ks: N * S * (ks + F * M)].view(N, F, S, M)
        dst.copy_(t[:, :, ks: ks + F * M].unflatten(-1, (F, M)).transpose(1, 2))
    return out


def analysis_gather_plain(X: torch.Tensor, tables: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
                          out_blocks: Sequence[torch.Tensor]) -> None:
    """The per-bucket loop: X (B, C, S, nh) complex64 and each bucket's
    (src, sgn, fwd_w) -> each (B, C, F, S, M) block of `out_blocks`."""
    S = X.shape[2]
    parity = torch.arange(S, device=X.device) % 2
    for (src, sgn, fwd_w), dst in zip(tables, out_blocks):
        t = X[..., src]                                             # (B,C,S,F,M)
        t = torch.complex(t.real, t.imag * sgn)                     # Hermitian mirror
        dst.copy_((t * fwd_w[parity]).movedim(3, 2))                # (B,C,F,S,M)


def launch(X: torch.Tensor, entries: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K3's launch on checked CUDA tensors (the registered op's CUDA
    implementation, kernels/ops.py), counted in `analysis_gather.launches`."""
    N, S, nh = X.shape
    K = entries.shape[0]
    if S > 65535 or N > 65535:
        raise ValueError(f"analysis_gather: (rows, slices) = ({N}, {S}) past the grid's 65535")
    out = torch.empty(N * S * K, dtype=torch.complex64, device=X.device)
    fn = build.function("analysis_gather", "analysis_gather", (
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
    ))
    stream = torch.cuda.current_stream(X.device).cuda_stream
    rc = fn(X.data_ptr(), nh, entries.data_ptr(), w.data_ptr(), K, out.data_ptr(), N, S, stream)
    if rc != 0:
        raise RuntimeError(f"analysis_gather: kernel launch failed with cudaError {rc}")
    analysis_gather.launches += 1
    return out


def analysis_gather(X: torch.Tensor, table: AnalysisTable) -> torch.Tensor:
    """K3 on a CUDA tensor, its plain version on a CPU tensor.

    X: (B, C, S, nh) complex64, contiguous, not requiring a gradient.
    Returns the packed 1-D buffer (B * C * S * K) complex64 in the layout
    of `SliCQT.layout(B, C, S)`. `analysis_gather.launches` counts kernel
    launches."""
    from . import ops

    if X.dtype != torch.complex64 or X.dim() != 4 or X.shape[-1] != table.nh or not X.is_contiguous():
        raise ValueError(f"analysis_gather: need contiguous complex64 (B, C, S, {table.nh}), "
                         f"got {X.dtype} {tuple(X.shape)}")
    if X.requires_grad:
        raise ValueError("analysis_gather: K3 takes no gradient; its input must not require one")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"analysis_gather: unsupported device {X.device}")
    for name in ("entries", "w"):
        t = getattr(table, name)
        if t.device != X.device or not t.is_contiguous():
            raise ValueError(f"analysis_gather: table.{name} must be contiguous on {X.device}")
    B, C, S, nh = X.shape
    return ops.analysis_gather(X.view(B * C, S, nh), table.entries, table.w)


analysis_gather.launches = 0
