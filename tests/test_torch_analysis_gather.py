"""K3 (the sliCQT analysis gather and weight) on the CPU.

The registered op `xumx_slicq::analysis_gather`'s CPU implementation (one
gather and one multiply over K3's flat table, then each bucket's view) is
held to the per-bucket plain loop that `SliCQT.forward` ran before K3, at
mel-12 and at bark-262 on a short signal, to 1e-6 of each bucket's largest
value: both run the same fp32 products, so they agree exactly here; the
card holds the kernel to the same bound (tests/test_torch_kernels.py,
chip_smoke.py). `tests/test_torch_slicqt.py` holds `SliCQT.forward`, which
runs K3, to the JAX package. No JAX program is compiled here.
"""

import pytest
import torch

from torch_port_utils import DEVICE, MEL12, noise

from xumx_slicq_torch.kernels import ops as kernel_ops
from xumx_slicq_torch.kernels.analysis_gather import analysis_gather, analysis_gather_plain, gather_flat_plain
from xumx_slicq_torch.ops.packed import PackedBlocks
from xumx_slicq_torch.ops.slicqt import SliCQT

REL_TOL = 1e-6


def _plain_blocks(t, X):
    B, C, S, _ = X.shape
    layout = t.layout(B, C, S)
    out = PackedBlocks(torch.empty(layout.size, dtype=torch.complex64), layout)
    analysis_gather_plain(X, t.forward_tables, out)
    return out


@pytest.mark.parametrize("cfg,length", [(MEL12, 22050), ({}, 44100)], ids=["mel-12", "bark-262-1s"])
def test_op_on_cpu_matches_per_bucket_loop(cfg, length):
    t = SliCQT(device=DEVICE, **cfg)
    X = t.half_spectrum(torch.from_numpy(noise(0, (2, 2, length))))
    B, C, S, nh = X.shape
    tab = t.analysis_table
    assert tab.K == t.raw_len and tab.entries.shape == (t.raw_len, 4) and tab.w.shape == (2, t.raw_len)
    ref = _plain_blocks(t, X)
    got = kernel_ops.analysis_gather(X.view(B * C, S, nh), tab.entries, tab.w)
    assert got.shape == (ref.layout.size,) and got.dtype == torch.complex64
    for a, b in zip(PackedBlocks(got, ref.layout), ref):
        assert float((a - b).abs().max()) <= REL_TOL * float(b.abs().max())


def test_forward_runs_k3_then_the_ifft():
    """`SliCQT.forward` is the M-point iFFT of each bucket view of K3's
    packed output, and equals the per-bucket loop it replaced (gather,
    weight, iFFT, transposing copy) bit for bit."""
    t = SliCQT(device=DEVICE, **MEL12)
    x = torch.from_numpy(noise(1, (1, 2, 22050)))
    X = t.half_spectrum(x)
    S = X.shape[2]
    parity = torch.arange(S) % 2
    out = t.forward(x)
    for (src, sgn, fwd_w), o, w in zip(t.forward_tables, out, _plain_blocks(t, X)):
        tt = X[..., src]
        old = torch.fft.ifft(torch.complex(tt.real, tt.imag * sgn) * fwd_w[parity], dim=-1).movedim(3, 2)
        assert torch.equal(o, old)
        assert torch.equal(o, torch.fft.ifft(w, dim=-1))


def test_wrapper_on_cpu_is_the_plain_version():
    t = SliCQT(device=DEVICE, **MEL12)
    X = t.half_spectrum(torch.from_numpy(noise(2, (1, 2, 9000))))
    tab = t.analysis_table
    before = analysis_gather.launches
    out = analysis_gather(X, tab)
    assert analysis_gather.launches == before                       # no kernel on the CPU
    B, C, S, nh = X.shape
    assert torch.equal(out, gather_flat_plain(X.view(B * C, S, nh), tab.entries, tab.w))
    with pytest.raises(ValueError, match="gradient"):
        analysis_gather(X.clone().requires_grad_(), tab)
    with pytest.raises(ValueError):
        analysis_gather(X[..., :-1].contiguous(), tab)
    with pytest.raises(ValueError):
        analysis_gather(X.to(torch.complex128), tab)
