"""K1: synthesis gather-assembly of the sliCQT half spectrum.

Replaces the XLA-fused assembly of the JAX package's SliCQT.backward
(xumx_slicq_tpu/ops/slicqt.py:727-785, 807-809). Given the flat raw synthesis
spectra V (N, S, raw_len) -- every bucket's per-slice FFT, weighted by its
arrange ramp, at a static offset -- it computes for each position p < nh

    fr[n, s, p] = (sum_j w_re[p, j] Re V[n, s, idx[p, j]]
                   + i sum_j w_im[p, j] Im V[n, s, idx[p, j]]) * unrot[s % 2, p]

over the at most O static entries of row p (sentinel idx == raw_len reads
zero). The CUDA kernel is csrc/synth_assembly.cu; its source note gives the
bound and the design. `synth_assembly_plain` is the same function in plain
PyTorch: the wrapper uses it for CPU tensors only.

K1's backward replaces XLA's autodiff of the same assembly in the train
step (xumx_slicq_tpu/training.py:261-264, 274). With h = g conj(unrot) the
cotangent of the spectra is

    gV[n, s, k] = sum over the entries (p, j) with idx[p, j] = k of
                  w_re[p, j] Re h[n, s, p] + i w_im[p, j] Im h[n, s, p]

a gather through the transposed table (`SynthTable.tidx`, at most W = 3
entries per raw value, sentinel nh), so every output is written once and
the result is deterministic (no atomics). csrc/synth_assembly.cu holds that
kernel too; `synth_assembly_backward_plain` is its plain version.
"""

import ctypes
from dataclasses import dataclass

import torch

from . import build


@dataclass(frozen=True)
class SynthTable:
    """Static assembly table on one device."""

    idx: torch.Tensor    # (nh, O) int32, raw-layout entry or raw_len (sentinel)
    w_re: torch.Tensor   # (nh, O) float32 weight on the real part
    w_im: torch.Tensor   # (nh, O) float32 weight on the imaginary part
    unrot: torch.Tensor  # (2, nh) complex64 per-parity un-rotation phase
    raw_len: int
    tidx: torch.Tensor   # (raw_len, W) int32, position p < nh that reads the entry, or nh (sentinel)
    tw_re: torch.Tensor  # (raw_len, W) float32 that entry's w_re
    tw_im: torch.Tensor  # (raw_len, W) float32 that entry's w_im

    @property
    def nh(self) -> int:
        return self.idx.shape[0]


def synth_assembly_plain(flat: torch.Tensor, table: SynthTable) -> torch.Tensor:
    """Plain PyTorch version: (N, S, raw_len) complex64 -> (N, S, nh)."""
    N, S, _ = flat.shape
    padded = torch.nn.functional.pad(flat, (0, 1))                 # zero sentinel slot
    g = padded[:, :, table.idx.long()]                             # (N, S, nh, O)
    re = (g.real * table.w_re).sum(-1)
    im = (g.imag * table.w_im).sum(-1)
    parity = torch.arange(S, device=flat.device) % 2
    return torch.complex(re, im) * table.unrot[parity][None]


def _check(flat: torch.Tensor, table: SynthTable):
    if flat.dtype != torch.complex64:
        raise TypeError(f"synth_assembly: spectra must be complex64, got {flat.dtype}")
    if flat.dim() != 3 or flat.shape[-1] != table.raw_len:
        raise ValueError(f"synth_assembly: spectra must be (N, S, {table.raw_len}), got {tuple(flat.shape)}")
    if not flat.is_contiguous():
        raise ValueError("synth_assembly: spectra must be contiguous")
    _check_table(table, flat.device)


def _check_table(table: SynthTable, device: torch.device):
    for name in ("idx", "w_re", "w_im", "unrot", "tidx", "tw_re", "tw_im"):
        t = getattr(table, name)
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"synth_assembly: table.{name} must be contiguous on {device}")


def synth_assembly_backward_plain(g: torch.Tensor, table: SynthTable) -> torch.Tensor:
    """Plain PyTorch version of K1's backward: the cotangent g of the half
    spectrum (N, S, nh) complex64 -> the cotangent of the spectra
    (N, S, raw_len) complex64, gathered through the transposed table."""
    S = g.shape[1]
    parity = torch.arange(S, device=g.device) % 2
    h = torch.nn.functional.pad(g * torch.conj(table.unrot[parity])[None], (0, 1))   # zero sentinel slot
    gg = h[:, :, table.tidx.long()]                                # (N, S, raw_len, W)
    return torch.complex((gg.real * table.tw_re).sum(-1), (gg.imag * table.tw_im).sum(-1))


def _launch_forward(flat: torch.Tensor, table: SynthTable) -> torch.Tensor:
    N, S, raw_len = flat.shape
    nh, O = table.idx.shape
    out = torch.empty((N, S, nh), dtype=torch.complex64, device=flat.device)
    fn = build.function("synth_assembly", "synth_assembly", (
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_void_p,
    ))
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    rc = fn(
        flat.data_ptr(), raw_len, table.idx.data_ptr(), table.w_re.data_ptr(),
        table.w_im.data_ptr(), table.unrot.data_ptr(), out.data_ptr(),
        N * S, S, nh, O, stream,
    )
    if rc != 0:
        raise RuntimeError(f"synth_assembly: kernel launch failed with cudaError {rc}")
    synth_assembly.launches += 1
    return out


def synth_assembly_backward(g: torch.Tensor, table: SynthTable) -> torch.Tensor:
    """K1's backward on a CUDA tensor, its plain version on a CPU tensor.

    g: (N, S, nh) complex64, contiguous, the cotangent of K1's output.
    Returns (N, S, raw_len) complex64. `synth_assembly_backward.launches`
    counts kernel launches."""
    if g.dtype != torch.complex64 or g.dim() != 3 or g.shape[-1] != table.nh or not g.is_contiguous():
        raise ValueError(f"synth_assembly_backward: need contiguous complex64 (N, S, {table.nh}), "
                         f"got {g.dtype} {tuple(g.shape)}")
    _check_table(table, g.device)
    if g.device.type == "cpu":
        return synth_assembly_backward_plain(g, table)
    if g.device.type != "cuda":
        raise ValueError(f"synth_assembly_backward: unsupported device {g.device}")
    N, S, nh = g.shape
    W = table.tidx.shape[1]
    out = torch.empty((N, S, table.raw_len), dtype=torch.complex64, device=g.device)
    fn = build.function("synth_assembly", "synth_assembly_backward", (
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_void_p,
    ))
    stream = torch.cuda.current_stream(g.device).cuda_stream
    rc = fn(
        g.data_ptr(), nh, table.tidx.data_ptr(), table.tw_re.data_ptr(), table.tw_im.data_ptr(),
        table.unrot.data_ptr(), out.data_ptr(), N * S, S, table.raw_len, W, stream,
    )
    if rc != 0:
        raise RuntimeError(f"synth_assembly_backward: kernel launch failed with cudaError {rc}")
    synth_assembly_backward.launches += 1
    return out


synth_assembly_backward.launches = 0


class _SynthAssembly(torch.autograd.Function):
    """K1 with its backward kernel; the table is static and takes no gradient."""

    @staticmethod
    def forward(ctx, flat, table):
        ctx.table = table
        if flat.device.type == "cpu":
            return synth_assembly_plain(flat, table)
        return _launch_forward(flat, table)

    @staticmethod
    def backward(ctx, g):
        return synth_assembly_backward(g.contiguous(), ctx.table), None


def synth_assembly(flat: torch.Tensor, table: SynthTable) -> torch.Tensor:
    """K1 on a CUDA tensor, its plain version on a CPU tensor;
    differentiable in `flat` through K1's backward.

    flat: (N, S, raw_len) complex64, contiguous. Returns (N, S, nh)
    complex64. `synth_assembly.launches` counts forward kernel launches."""
    _check(flat, table)
    if flat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"synth_assembly: unsupported device {flat.device}")
    return _SynthAssembly.apply(flat, table)


synth_assembly.launches = 0
