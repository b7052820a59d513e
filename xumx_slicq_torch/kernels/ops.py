"""K1, K2, K3, K4 and K5's forwards as registered ops (torch.library.custom_op).

Each op has two device implementations and a fake one:

* CPU: the kernel's plain PyTorch version;
* CUDA: the kernel's launch, counted in its wrapper's `.launches` as
  before (no fallback: a library that cannot be built or loaded raises);
* fake (`register_fake`): the output shapes, which is all torch.export
  needs, so a trace never reaches a `data_ptr()` or a Triton launch.

An op on a device other than these two raises. The autograd Functions of
the kernel modules (`_SynthAssembly`, `_WienerEM`, `_Recurrence`) stay the
public entry points and call these ops in their forward, so training,
serving and an exported artifact run the same op; the backward kernels are
not ops (an artifact serves, it does not train). An exported graph holds
one `xumx_slicq::...` node per kernel call, and an artifact that
`torch.export.load` reads in a fresh process runs the kernels of this
checkout once this module is imported (`export.ExportedSeparator` does).

The ops take tensors and ints only: the kernels' tables are tensor
arguments (K1's `SynthTable` fields, K2's, K4's and K5's work tables, K4's
packed weights),
which torch.export keeps as constants of the artifact (K3's `AnalysisTable`
fields), and the layouts are int lists (K2 and K4: five ints a bucket, (B, C, F, S, M); K4 also
its architecture, `CdaeArch.ints`; K5: hidden sizes, lengths, batch and directions).

    xumx_slicq::synth_assembly(flat, idx, w_re, w_im, unrot) -> half spectrum
    xumx_slicq::analysis_gather(X, entries, w) -> packed weighted coefficients
    xumx_slicq::cdae_folded(X, w, plan, items, rtab, shapes, arch, realtime, sizes)
        -> (packed magnitudes, packed masks)
    xumx_slicq::wiener_em_grouped(x, v, buckets, items1, items2, shapes)
        -> (estimates, pass-1 partial sums, max slots)
    xumx_slicq::lstm_recurrence(xp, w, items, smem, hidden, frames, batch, dirs) -> h
    xumx_slicq::lstm_recurrence_cell(...the same) -> (h, c)

K2's second and third outputs are the state its backward kernel reads; on
the CPU, whose plain backward recomputes from x and v, they are zeros.
"""

from typing import List, Tuple

import torch
from torch import Tensor

from . import analysis_gather as _k3
from . import cdae_conv as _k4
from . import lstm_recurrence as _k5
from . import synth_assembly as _k1
from . import wiener_em as _k2

NAMESPACE = "xumx_slicq"
OPS = ("synth_assembly", "analysis_gather", "cdae_folded", "wiener_em_grouped", "lstm_recurrence",
       "lstm_recurrence_cell")


# -- K1 --------------------------------------------------------------------------


@torch.library.custom_op(f"{NAMESPACE}::synth_assembly", mutates_args=(), device_types="cpu")
def synth_assembly(flat: Tensor, idx: Tensor, w_re: Tensor, w_im: Tensor, unrot: Tensor) -> Tensor:
    return _k1.assemble_plain(flat, idx, w_re, w_im, unrot)


@synth_assembly.register_kernel("cuda")
def _(flat, idx, w_re, w_im, unrot):
    return _k1.launch_forward(flat, idx, w_re, w_im, unrot)


@synth_assembly.register_fake
def _(flat, idx, w_re, w_im, unrot):
    return flat.new_empty((flat.shape[0], flat.shape[1], idx.shape[0]))


# -- K3 --------------------------------------------------------------------------


@torch.library.custom_op(f"{NAMESPACE}::analysis_gather", mutates_args=(), device_types="cpu")
def analysis_gather(X: Tensor, entries: Tensor, w: Tensor) -> Tensor:
    return _k3.gather_flat_plain(X, entries, w)


@analysis_gather.register_kernel("cuda")
def _(X, entries, w):
    return _k3.launch(X, entries, w)


@analysis_gather.register_fake
def _(X, entries, w):
    return X.new_empty((X.shape[0] * X.shape[1] * entries.shape[0],))


# -- K4 --------------------------------------------------------------------------


@torch.library.custom_op(f"{NAMESPACE}::cdae_folded", mutates_args=(), device_types="cpu")
def cdae_folded(X: Tensor, w: Tensor, plan: Tensor, items: Tensor, rtab: Tensor, shapes: List[int],
                arch: List[int], realtime: int, sizes: List[int]) -> Tuple[Tensor, Tensor]:
    return _k4.cdae_folded_plain(X, w, _k2.layout_of_ints(shapes), _k4.CdaeArch.of_ints(arch), bool(realtime))


@cdae_folded.register_kernel("cuda")
def _(X, w, plan, items, rtab, shapes, arch, realtime, sizes):
    return _k4.launch(X, w, plan, items, rtab, _k2.layout_of_ints(shapes), arch[0], sizes)


@cdae_folded.register_fake
def _(X, w, plan, items, rtab, shapes, arch, realtime, sizes):
    n = arch[0] * sum(a * b * c * d * e for a, b, c, d, e in zip(*[iter(shapes)] * 5))
    return w.new_empty((n,)), w.new_empty((n,))


# -- K2 --------------------------------------------------------------------------


def _k2_state(x: Tensor, buckets: Tensor, items1: Tensor) -> Tuple[Tensor, Tensor]:
    return (x.new_zeros((items1.shape[0], 16), dtype=torch.float32),
            x.new_zeros((buckets.shape[0],), dtype=torch.float32))


@torch.library.custom_op(f"{NAMESPACE}::wiener_em_grouped", mutates_args=(), device_types="cpu")
def wiener_em_grouped(x: Tensor, v: Tensor, buckets: Tensor, items1: Tensor, items2: Tensor,
                      shapes: List[int]) -> Tuple[Tensor, Tensor, Tensor]:
    y = _k2.wiener_em_grouped_plain(x, v, _k2.layout_of_ints(shapes))
    return (y, *_k2_state(x, buckets, items1))


@wiener_em_grouped.register_kernel("cuda")
def _(x, v, buckets, items1, items2, shapes):
    return _k2.launch(x, v, dict(buckets=buckets, items1=items1, items2=items2))


@wiener_em_grouped.register_fake
def _(x, v, buckets, items1, items2, shapes):
    y = v.new_empty(v.shape, dtype=torch.complex64)
    partials, maxima = (t.new_empty(t.shape) for t in _k2_state(x, buckets, items1))
    return y, partials, maxima


# -- K5 --------------------------------------------------------------------------


def _h_size(hidden: List[int], frames: List[int], batch: int, dirs: int, targets: int) -> int:
    return sum(targets * f * batch * dirs * h for h, f in zip(hidden, frames))


def _k5_plain(xp, w, hidden, frames, batch, dirs, targets, cell):
    return _k5.lstm_recurrence_grouped_plain(xp, w, _k5.RecurrenceLayout(hidden, frames, batch, dirs, targets),
                                             cell)


@torch.library.custom_op(f"{NAMESPACE}::lstm_recurrence", mutates_args=(), device_types="cpu")
def lstm_recurrence(xp: Tensor, w: Tensor, items: Tensor, smem: int, hidden: List[int], frames: List[int],
                    batch: int, dirs: int, targets: int) -> Tensor:
    return _k5_plain(xp, w, hidden, frames, batch, dirs, targets, cell=False)


@lstm_recurrence.register_kernel("cuda")
def _(xp, w, items, smem, hidden, frames, batch, dirs, targets):
    return _k5.launch(xp, w, items, smem, _h_size(hidden, frames, batch, dirs, targets), cell=False)[0]


@lstm_recurrence.register_fake
def _(xp, w, items, smem, hidden, frames, batch, dirs, targets):
    return xp.new_empty((_h_size(hidden, frames, batch, dirs, targets),))


@torch.library.custom_op(f"{NAMESPACE}::lstm_recurrence_cell", mutates_args=(), device_types="cpu")
def lstm_recurrence_cell(xp: Tensor, w: Tensor, items: Tensor, smem: int, hidden: List[int], frames: List[int],
                         batch: int, dirs: int, targets: int) -> Tuple[Tensor, Tensor]:
    return _k5_plain(xp, w, hidden, frames, batch, dirs, targets, cell=True)


@lstm_recurrence_cell.register_kernel("cuda")
def _(xp, w, items, smem, hidden, frames, batch, dirs, targets):
    return _k5.launch(xp, w, items, smem, _h_size(hidden, frames, batch, dirs, targets), cell=True)


@lstm_recurrence_cell.register_fake
def _(xp, w, items, smem, hidden, frames, batch, dirs, targets):
    n = _h_size(hidden, frames, batch, dirs, targets)
    return xp.new_empty((n,)), xp.new_empty((n,))


def graph_op_counts(graph) -> dict:
    """How many nodes of each xumx_slicq op an FX graph (an ExportedProgram's
    `graph`) holds, keyed by op name; zero for an op it lacks."""
    counts = dict.fromkeys(OPS, 0)
    for node in graph.nodes:
        target = node.target
        if node.op == "call_function" and getattr(target, "namespace", None) == NAMESPACE:
            counts[target._opname] += 1
    return counts
