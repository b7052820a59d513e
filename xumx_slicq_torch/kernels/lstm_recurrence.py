"""K5: the LSTM recurrence of every bucket, target and direction at once.

Replaces the `lax.scan` of the JAX package's LSTM variant
(xumx_slicq_tpu/models/lstm.py::_lstm_cell_scan, lstm.py:145-164), which
XLA runs step by step. For one layer, every (bucket k, target t, direction
d, sequence-batch row b) is an independent sequence of frames_k steps with
hidden size H_k; with the input projection xp = x W_ih^T + b_ih + b_hh
computed beforehand (by matmuls, outside the kernel, lstm.py:150):

    gates = xp[s] + W_hh h;  i, f, o = sigmoid;  g = tanh
    c = f c + i g;  h = o tanh(c)                    (torch's gate order i, f, g, o)

from h = c = 0. The reverse direction walks s from the last step down and
writes h at its own position s (lax.scan(reverse=True), lstm.py:163).

Layouts (`RecurrenceLayout`), one packed 1-D float32 buffer each:
* xp: per bucket (4, dirs, frames, B, 4H), the stacked targets' and
  directions' projections;
* h: per bucket (4, frames, B, dirs * H): each target's layer output with
  the directions concatenated, as lstm.py:177 concatenates them, so a
  bucket's view is the next layer's input as it is;
* W_hh^T: per bucket (4, dirs, H, 4H), built once per model and device by
  `pack_recurrent_weights` (read only).

`lstm_recurrence_plain` is one bucket's layer in plain PyTorch, a loop over
steps with the arithmetic of _lstm_cell_scan; `lstm_recurrence_grouped_plain`
runs it over a whole layout, walking the buckets of one hidden size
together. The wrapper `lstm_recurrence` runs that for CPU tensors and
launches the CUDA kernel
(csrc/lstm_recurrence.cu, one launch per layer for all buckets) for CUDA
tensors; `lstm_recurrence.launches` counts those launches.
"""

import ctypes
import functools
import itertools
from typing import List, Sequence

import numpy as np
import torch

from . import build

NB_TARGETS = 4
GROUP_H = 16          # hidden sizes up to this run a group of lanes per sequence; larger ones a block each
THREADS = 128         # threads per block (csrc/lstm_recurrence.cu)
MAX_H = 128           # the block path holds at most 4 gate rows per thread: 4H <= 4 * THREADS
ITEM_FIELDS = 9       # H, frames, B, dirs, xp offset, h offset, W offset, first sequence, sequences


class RecurrenceLayout:
    """Where each bucket's xp, h and W_hh^T lie in their packed buffers.

    hidden, frames: one H and one sequence length per bucket; batch: the
    sequence batch B (the chunk batch); dirs: 2 offline, 1 realtime.
    Layouts of the same sizes are equal."""

    def __init__(self, hidden: Sequence[int], frames: Sequence[int], batch: int, dirs: int):
        self.hidden = tuple(int(h) for h in hidden)
        self.frames = tuple(int(f) for f in frames)
        if len(self.hidden) != len(self.frames):
            raise ValueError("RecurrenceLayout: one hidden size and one length per bucket")
        self.batch, self.dirs = int(batch), int(dirs)
        n = NB_TARGETS
        self.xp_sizes = tuple(n * dirs * f * batch * 4 * h for h, f in zip(self.hidden, self.frames))
        self.h_sizes = tuple(n * f * batch * dirs * h for h, f in zip(self.hidden, self.frames))
        self.w_sizes = tuple(n * dirs * h * 4 * h for h in self.hidden)
        self.xp_offsets, self.xp_size = _offsets(self.xp_sizes)
        self.h_offsets, self.h_size = _offsets(self.h_sizes)
        self.w_offsets, self.w_size = _offsets(self.w_sizes)
        self._key = (self.hidden, self.frames, self.batch, self.dirs)

    def __eq__(self, other) -> bool:
        return isinstance(other, RecurrenceLayout) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def xp_blocks(self, xp: torch.Tensor) -> List[torch.Tensor]:
        """(4, dirs, frames, B, 4H) views of a packed xp buffer."""
        return [xp[o: o + z].view(NB_TARGETS, self.dirs, f, self.batch, 4 * h)
                for h, f, o, z in zip(self.hidden, self.frames, self.xp_offsets, self.xp_sizes)]

    def h_blocks(self, out: torch.Tensor) -> List[torch.Tensor]:
        """(4, frames, B, dirs * H) views of a packed h buffer."""
        return [out[o: o + z].view(NB_TARGETS, f, self.batch, self.dirs * h)
                for h, f, o, z in zip(self.hidden, self.frames, self.h_offsets, self.h_sizes)]

    def w_blocks(self, w: torch.Tensor) -> List[torch.Tensor]:
        """(4, dirs, H, 4H) views (W_hh^T) of packed recurrent weights."""
        return [w[o: o + z].view(NB_TARGETS, self.dirs, h, 4 * h)
                for h, o, z in zip(self.hidden, self.w_offsets, self.w_sizes)]


def _offsets(sizes):
    return tuple(itertools.accumulate(sizes, initial=0))[:-1], sum(sizes)


def pack_recurrent_weights(w_hh: Sequence[torch.Tensor]) -> torch.Tensor:
    """Every bucket's W_hh, (4, dirs, 4H, H) each, as one packed buffer of
    W_hh^T in the layout's w order: the read-only table K5 walks."""
    return torch.cat([w.detach().transpose(-1, -2).contiguous().reshape(-1) for w in w_hh])


def _walk(walk: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """The steps of lstm.py:152-160 over sequences in walk order: walk
    (n, dirs, steps, B, 4H), w_hh (n, dirs, 4H, H) -> h (n, dirs, steps, B, H)."""
    n, dirs, _, B, G = walk.shape
    H = G // 4
    w_t = w_hh.transpose(-1, -2)                                       # (n, dirs, H, 4H)
    h = walk.new_zeros((n, dirs, B, H))
    c = walk.new_zeros((n, dirs, B, H))
    steps = []
    for xt in walk.unbind(2):
        gates = xt + torch.matmul(h, w_t)
        sig = torch.sigmoid(gates)                   # i, f and o; g's slot is unused (fewer ops a step)
        c = torch.addcmul(sig[..., H:2 * H] * c, sig[..., :H], torch.tanh(gates[..., 2 * H:3 * H]))
        h = sig[..., 3 * H:] * torch.tanh(c)
        steps.append(h)
    return torch.stack(steps, dim=2)


def _walk_order(xp: torch.Tensor) -> torch.Tensor:
    """xp (n, dirs, frames, B, 4H) with the reverse direction's steps in
    the order it walks them (from the last position down)."""
    return xp if xp.shape[1] == 1 else torch.stack([xp[:, 0], xp[:, 1].flip(1)], dim=1)


def _positions(hs: torch.Tensor, frames: int) -> torch.Tensor:
    """h (n, dirs, >= frames, B, H) in walk order -> (n, frames, B, dirs H)
    with each direction's h at its own position (lstm.py:163, 177)."""
    n, dirs, _, B, H = hs.shape
    hs = hs[:, :, :frames]
    if dirs == 2:
        hs = torch.stack([hs[:, 0], hs[:, 1].flip(1)], dim=1)
    return hs.permute(0, 2, 3, 1, 4).reshape(n, frames, B, dirs * H)


def lstm_recurrence_plain(xp: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """One layer of one bucket in plain PyTorch, every target and direction
    at once, one loop iteration per step (lstm.py:145-164).

    xp: (4, dirs, frames, B, 4H) input projections with both biases added;
    w_hh: (4, dirs, 4H, H). Returns h (4, frames, B, dirs * H): direction 0
    in columns [0, H), direction 1 (the reverse one) in [H, 2H), each at
    its own step's position."""
    return _positions(_walk(_walk_order(xp), w_hh), xp.shape[2])


def lstm_recurrence_grouped_plain(xp: torch.Tensor, w: torch.Tensor, layout: RecurrenceLayout) -> torch.Tensor:
    """lstm_recurrence_plain over every bucket of a packed layout, with the
    buckets of one hidden size walked together (shorter sequences padded
    at the end of their walk, whose extra steps are dropped): the CPU's
    version of K5's one launch, far fewer Python steps than bucket by
    bucket. Returns the packed h."""
    out = torch.empty(layout.h_size, dtype=xp.dtype, device=xp.device)
    xs, ws, hs = layout.xp_blocks(xp), layout.w_blocks(w), layout.h_blocks(out)
    for H in sorted(set(layout.hidden)):
        ks = [k for k, h in enumerate(layout.hidden) if h == H]
        steps = max(layout.frames[k] for k in ks)
        walk = torch.cat([torch.nn.functional.pad(_walk_order(xs[k]), (0, 0, 0, 0, 0, steps - layout.frames[k]))
                          for k in ks])
        h = _walk(walk, torch.cat([ws[k].transpose(-1, -2) for k in ks]))
        for i, k in enumerate(ks):
            hs[k].copy_(_positions(h[NB_TARGETS * i: NB_TARGETS * (i + 1)], layout.frames[k]))
    return out


def work_items(layout: RecurrenceLayout) -> np.ndarray:
    """K5's work table: one row of ITEM_FIELDS int64 per block. A bucket
    with H <= GROUP_H runs a group of lanes per sequence (the power of two
    >= H), THREADS / group sequences a block; a larger one a block per
    sequence. Sequence q of a bucket is (t, d, b) with q = (t dirs + d) B + b."""
    rows = []
    for k, (H, frames) in enumerate(zip(layout.hidden, layout.frames)):
        base = [H, frames, layout.batch, layout.dirs, layout.xp_offsets[k], layout.h_offsets[k], layout.w_offsets[k]]
        nseq = NB_TARGETS * layout.dirs * layout.batch
        per_block = THREADS // (1 << (H - 1).bit_length()) if H <= GROUP_H else 1
        rows += [base + [q, min(per_block, nseq - q)] for q in range(0, nseq, per_block)]
    return np.asarray(rows, dtype=np.int64).reshape(-1, ITEM_FIELDS)


@functools.lru_cache(maxsize=64)
def _device_items(layout: RecurrenceLayout, device: torch.device) -> torch.Tensor:
    """The work table of one layout on one device, built once."""
    return torch.from_numpy(work_items(layout)).to(device)


def _check(xp: torch.Tensor, w: torch.Tensor, layout: RecurrenceLayout):
    if xp.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"lstm_recurrence: need float32 xp and weights, got {xp.dtype}, {w.dtype}")
    if xp.shape != (layout.xp_size,) or w.shape != (layout.w_size,):
        raise ValueError(f"lstm_recurrence: need packed xp ({layout.xp_size},) and weights ({layout.w_size},), "
                         f"got {tuple(xp.shape)}, {tuple(w.shape)}")
    if not (xp.is_contiguous() and w.is_contiguous()):
        raise ValueError("lstm_recurrence: xp and weights must be contiguous")
    if xp.device != w.device or xp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lstm_recurrence: xp on {xp.device}, weights on {w.device}")
    if layout.dirs not in (1, 2) or max(layout.hidden) > MAX_H:
        raise ValueError(f"lstm_recurrence: dirs must be 1 or 2 and H <= {MAX_H}")


def lstm_recurrence(xp: torch.Tensor, w: torch.Tensor, layout: RecurrenceLayout) -> torch.Tensor:
    """One LSTM layer over every bucket, target and direction of `layout`:
    K5 on CUDA tensors (one launch, counted in `lstm_recurrence.launches`),
    `lstm_recurrence_grouped_plain` on CPU tensors.

    xp: packed projections (layout.xp_size,) float32; w: packed W_hh^T
    (layout.w_size,) from pack_recurrent_weights. Returns the packed h
    (layout.h_size,) float32 (`layout.h_blocks` views it per bucket)."""
    _check(xp, w, layout)
    if xp.device.type == "cpu":
        return lstm_recurrence_grouped_plain(xp, w, layout)
    out = torch.empty(layout.h_size, dtype=torch.float32, device=xp.device)
    items = _device_items(layout, xp.device)
    fn = build.function("lstm_recurrence", "lstm_recurrence", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p))
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    rc = fn(xp.data_ptr(), w.data_ptr(), out.data_ptr(), items.data_ptr(), items.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"lstm_recurrence: kernel launch failed with cudaError {rc}")
    lstm_recurrence.launches += 1
    return out


lstm_recurrence.launches = 0
