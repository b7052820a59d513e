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
    for name in ("idx", "w_re", "w_im", "unrot"):
        t = getattr(table, name)
        if t.device != flat.device or not t.is_contiguous():
            raise ValueError(f"synth_assembly: table.{name} must be contiguous on {flat.device}")


def synth_assembly(flat: torch.Tensor, table: SynthTable) -> torch.Tensor:
    """K1 on a CUDA tensor, its plain version on a CPU tensor.

    flat: (N, S, raw_len) complex64, contiguous. Returns (N, S, nh)
    complex64. `synth_assembly.launches` counts kernel launches."""
    _check(flat, table)
    if flat.device.type == "cpu":
        return synth_assembly_plain(flat, table)
    if flat.device.type != "cuda":
        raise ValueError(f"synth_assembly: unsupported device {flat.device}")
    N, S, raw_len = flat.shape
    nh, O = table.idx.shape
    out = torch.empty((N, S, nh), dtype=torch.complex64, device=flat.device)
    lib = build.load("synth_assembly")
    fn = lib.synth_assembly
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
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


synth_assembly.launches = 0
