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
(csrc/lstm_recurrence.cu, one launch per layer for all buckets, any hidden
size: `work_items` is its table of blocks) for CUDA tensors;
`lstm_recurrence.launches` counts those launches.

Training (the JAX package differentiates through the scan,
xumx_slicq_tpu/training.py:273-274): when xp or W_hh^T needs a gradient,
`lstm_recurrence` is an autograd Function. Its forward also writes the
cell state c, packed like h; its backward is K5b, `lstm_recurrence_backward`
(a second entry point of the same .cu, one launch a layer, counted in
`lstm_recurrence_backward.launches`): the reverse walk of every sequence,
which recomputes the gates from xp and the saved h and writes d(xp), then
sums that sequence's d(W_hh^T) = sum over steps of h_prev (x) d(xp) into
its row of a buffer of partials, which one reduction sums over the
sequence rows in a fixed order. No float atomics: two runs give bit-equal
gradients. `lstm_recurrence_backward_plain` is the
closed-form reverse walk of one bucket, `lstm_recurrence_backward_grouped_plain`
the same over a layout (the CPU's version of K5b, and its reference).
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
# H, frames, B, dirs, xp offset, h offset, W offset, first sequence, sequences, lanes per sequence (a group
# of lanes; or a block per sequence: 0 with W_hh held in shared memory, -1 with W_hh read from L2 each step)
ITEM_FIELDS = 10
SMEM_LIMIT = 232448   # an H100's dynamic shared memory per block (bytes); the wrapper asks the card


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
    W_hh^T in the layout's w order: the table K5 walks. Differentiable, so
    that the gradient of the packed buffer reaches each W_hh; build it
    under torch.no_grad() for a detached serving copy."""
    return torch.cat([w.transpose(-1, -2).contiguous().reshape(-1) for w in w_hh])


def _walk(walk: torch.Tensor, w_hh: torch.Tensor, cell: bool = False):
    """The steps of lstm.py:152-160 over sequences in walk order: walk
    (n, dirs, steps, B, 4H), w_hh (n, dirs, 4H, H) -> h (n, dirs, steps, B, H),
    and with `cell` also c of the same shape."""
    n, dirs, _, B, G = walk.shape
    H = G // 4
    w_t = w_hh.transpose(-1, -2)                                       # (n, dirs, H, 4H)
    h = walk.new_zeros((n, dirs, B, H))
    c = walk.new_zeros((n, dirs, B, H))
    steps, cells = [], []
    for xt in walk.unbind(2):
        gates = xt + torch.matmul(h, w_t)
        sig = torch.sigmoid(gates)                   # i, f and o; g's slot is unused (fewer ops a step)
        c = torch.addcmul(sig[..., H:2 * H] * c, sig[..., :H], torch.tanh(gates[..., 2 * H:3 * H]))
        h = sig[..., 3 * H:] * torch.tanh(c)
        steps.append(h)
        cells.append(c)
    if cell:
        return torch.stack(steps, dim=2), torch.stack(cells, dim=2)
    return torch.stack(steps, dim=2)


def _walk_backward(walk, w_hh, hs, cs, dhs):
    """The reverse of _walk, in closed form: walk (n, dirs, steps, B, 4H)
    projections, w_hh (n, dirs, 4H, H), and the forward's h, c and the
    cotangent dh (n, dirs, steps, B, H), all in walk order. The gates are
    recomputed from xp and h_prev for all steps at once (they depend only
    on saved values); then per step, from the last: dh = dh_out + dh_rec,
    dc = dc_rec + dh o (1 - tanh(c)^2); d(xp) = (dc g i(1-i), dc c_prev
    f(1-f), dc i (1-g^2), dh tanh(c) o(1-o)); dh_rec = W_hh^T d(xp),
    dc_rec = dc f. Last, dW_hh = sum over steps and rows of d(xp)^T h_prev.
    Returns (d walk, dW_hh)."""
    n, dirs, steps, B, G = walk.shape
    H = G // 4
    first = walk.new_zeros((n, dirs, 1, B, H))
    h_prev = torch.cat([first, hs[:, :, :-1]], dim=2)
    c_prev = torch.cat([first, cs[:, :, :-1]], dim=2)
    gates = walk + torch.matmul(h_prev, w_hh.transpose(-1, -2).unsqueeze(2))
    i, f, o = (torch.sigmoid(gates[..., k * H:(k + 1) * H]) for k in (0, 1, 3))
    g = torch.tanh(gates[..., 2 * H:3 * H])
    tc = torch.tanh(cs)
    dc_dh = o * (1 - tc * tc)
    scale = torch.cat([g * i * (1 - i), c_prev * f * (1 - f), i * (1 - g * g), tc * o * (1 - o)], dim=-1)
    out = torch.empty_like(walk)
    dh_rec = dc_rec = walk.new_zeros((n, dirs, B, H))
    for u in range(steps - 1, -1, -1):
        dh = dhs[:, :, u] + dh_rec
        dc = torch.addcmul(dc_rec, dh, dc_dh[:, :, u])
        dgates = torch.cat([dc, dc, dc, dh], dim=-1).mul_(scale[:, :, u])
        out[:, :, u] = dgates
        dh_rec = torch.matmul(dgates, w_hh)
        dc_rec = dc * f[:, :, u]
    dw = torch.matmul(out.reshape(n, dirs, steps * B, G).transpose(-1, -2), h_prev.reshape(n, dirs, steps * B, H))
    return out, dw


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


def _walk_of(hs: torch.Tensor, dirs: int) -> torch.Tensor:
    """The inverse of _positions: (n, frames, B, dirs H) -> (n, dirs,
    frames, B, H) in walk order."""
    n, frames, B, _ = hs.shape
    return _walk_order(hs.view(n, frames, B, dirs, -1).permute(0, 3, 1, 2, 4))


def lstm_recurrence_plain(xp: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """One layer of one bucket in plain PyTorch, every target and direction
    at once, one loop iteration per step (lstm.py:145-164).

    xp: (4, dirs, frames, B, 4H) input projections with both biases added;
    w_hh: (4, dirs, 4H, H). Returns h (4, frames, B, dirs * H): direction 0
    in columns [0, H), direction 1 (the reverse one) in [H, 2H), each at
    its own step's position."""
    return _positions(_walk(_walk_order(xp), w_hh), xp.shape[2])


def _hidden_groups(layout: RecurrenceLayout):
    """(H, the buckets of that H, their longest length) for each hidden size."""
    for H in sorted(set(layout.hidden)):
        ks = [k for k, h in enumerate(layout.hidden) if h == H]
        yield H, ks, max(layout.frames[k] for k in ks)


def _pad_walk(a: torch.Tensor, steps: int) -> torch.Tensor:
    """(n, dirs, frames, B, X) padded with zeros at the end of the walk to `steps`."""
    return torch.nn.functional.pad(a, (0, 0, 0, 0, 0, steps - a.shape[2]))


def lstm_recurrence_grouped_plain(xp: torch.Tensor, w: torch.Tensor, layout: RecurrenceLayout, cell: bool = False):
    """lstm_recurrence_plain over every bucket of a packed layout, with the
    buckets of one hidden size walked together (shorter sequences padded
    at the end of their walk, whose extra steps are dropped): the CPU's
    version of K5's one launch, far fewer Python steps than bucket by
    bucket. Returns the packed h, and with `cell` (h, c), c packed like h.
    Differentiable (the buckets are packed by concatenation)."""
    xs, ws = layout.xp_blocks(xp), layout.w_blocks(w)
    hs, cs = [None] * len(layout.hidden), [None] * len(layout.hidden)
    for H, ks, steps in _hidden_groups(layout):
        walk = torch.cat([_pad_walk(_walk_order(xs[k]), steps) for k in ks])
        res = _walk(walk, torch.cat([ws[k].transpose(-1, -2) for k in ks]), cell)
        h, c = res if cell else (res, None)
        for i, k in enumerate(ks):
            part = slice(NB_TARGETS * i, NB_TARGETS * (i + 1))
            hs[k] = _positions(h[part], layout.frames[k]).reshape(-1)
            if cell:
                cs[k] = _positions(c[part], layout.frames[k]).reshape(-1)
    return (torch.cat(hs), torch.cat(cs)) if cell else torch.cat(hs)


def lstm_recurrence_backward_plain(xp: torch.Tensor, w_hh: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                                   dh: torch.Tensor):
    """The backward of lstm_recurrence_plain for one bucket, the closed-form
    reverse walk of every sequence (_walk_backward).

    xp: (4, dirs, frames, B, 4H); w_hh: (4, dirs, 4H, H); h and c (the
    forward's) and the cotangent dh: (4, frames, B, dirs * H). Returns
    d(xp) (4, dirs, frames, B, 4H) and d(W_hh) (4, dirs, 4H, H)."""
    dirs = xp.shape[1]
    dwalk, dw = _walk_backward(_walk_order(xp), w_hh, _walk_of(h, dirs), _walk_of(c, dirs), _walk_of(dh, dirs))
    return _walk_order(dwalk), dw


def lstm_recurrence_backward_grouped_plain(xp: torch.Tensor, w: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                                           dh: torch.Tensor, layout: RecurrenceLayout):
    """lstm_recurrence_backward_plain over every bucket of a packed layout,
    the buckets of one hidden size walked together (padded at the end of
    the walk, where the zero cotangent keeps every padded step's gradient
    zero): the CPU's version of K5b and its reference on the card.

    All arguments packed (w: W_hh^T from pack_recurrent_weights; h, c, dh
    like the forward's h). Returns (d(xp), d(w)), packed like xp and w."""
    dxp, dw = torch.empty_like(xp), torch.empty_like(w)
    xs, ws, dxs, dws = layout.xp_blocks(xp), layout.w_blocks(w), layout.xp_blocks(dxp), layout.w_blocks(dw)
    hs, cs, dhs = layout.h_blocks(h), layout.h_blocks(c), layout.h_blocks(dh)
    dirs = layout.dirs
    for H, ks, steps in _hidden_groups(layout):
        def walked(blocks):
            return torch.cat([_pad_walk(_walk_of(blocks[k], dirs), steps) for k in ks])

        walk = torch.cat([_pad_walk(_walk_order(xs[k]), steps) for k in ks])
        dwalk, dW = _walk_backward(walk, torch.cat([ws[k].transpose(-1, -2) for k in ks]),
                                   walked(hs), walked(cs), walked(dhs))
        for i, k in enumerate(ks):
            part = slice(NB_TARGETS * i, NB_TARGETS * (i + 1))
            dxs[k].copy_(_walk_order(dwalk[part, :, :layout.frames[k]]))
            dws[k].copy_(dW[part].transpose(-1, -2))
    return dxp, dw


def _lanes(H: int) -> int:
    """Lanes per sequence: a group of the power of two >= H (H <= GROUP_H), or 0 for a block."""
    return 1 << (H - 1).bit_length() if H <= GROUP_H else 0


def _block_smem(H: int, backward: bool, w_held: bool = False) -> int:
    """Bytes of dynamic shared memory of a block per sequence (csrc/lstm_recurrence.cu): K5's h twice and
    its cells (3 Hp floats, Hp = H rounded up to 4), with W_hh held H (4 Hp + 4) more; K5b's gates and
    their gradients, dh_rec and dc_rec (10 H floats)."""
    if backward:
        return 10 * H * 4
    Hp = -(-H // 4) * 4
    return (3 * Hp + (H * (4 * Hp + 4) if w_held else 0)) * 4


def work_items(layout: RecurrenceLayout, backward: bool = False, smem_limit: int = SMEM_LIMIT) -> np.ndarray:
    """K5's (or with `backward` K5b's) work table: one row of ITEM_FIELDS int64 per block.
    A bucket with H <= GROUP_H runs a group of lanes per sequence (the power of two >= H), THREADS / lanes
    sequences a block; a larger one a block per sequence, in K5 with its W_hh in shared memory when that
    fits smem_limit bytes. Sequence q of a bucket is (t, d, b) with q = (t dirs + d) B + b. K5's blocks are
    ordered longest sequence first, so that the longest chains start at once whatever the card holds.
    Raises if a block needs more shared memory than smem_limit."""
    rows = []
    for k, (H, frames) in enumerate(zip(layout.hidden, layout.frames)):
        base = [H, frames, layout.batch, layout.dirs, layout.xp_offsets[k], layout.h_offsets[k], layout.w_offsets[k]]
        nseq = NB_TARGETS * layout.dirs * layout.batch
        lanes = _lanes(H)
        if lanes > 0 and not backward and frames * layout.batch * 4 * H >= 2 ** 31:
            raise ValueError(f"lstm_recurrence: a sequence batch of {frames} steps at B = {layout.batch}, H = {H} "
                             "exceeds K5's 32-bit step offsets")
        if lanes == 0:
            need = _block_smem(H, backward)
            if need > smem_limit:
                raise ValueError(f"lstm_recurrence: H = {H} needs {need} bytes of shared memory a block, "
                                 f"the card holds {smem_limit}")
            if not backward:
                lanes = 0 if _block_smem(H, False, w_held=True) <= smem_limit else -1
        per_block = THREADS // lanes if lanes > 0 else 1
        rows += [base + [q, min(per_block, nseq - q), lanes] for q in range(0, nseq, per_block)]
    if not backward:
        rows.sort(key=lambda r: -r[1])
    return np.asarray(rows, dtype=np.int64).reshape(-1, ITEM_FIELDS)


def smem_bytes(items: np.ndarray, backward: bool = False) -> int:
    """The dynamic shared memory a launch of this work table gives every block: its largest block's.
    With W_hh held (123.5 KB at H = 86) that leaves one block an SM; the table runs the longest chains
    first, so the blocks that queue past the SM count (realtime chunk batch 8: 169) are the shortest."""
    wide = items[items[:, 9] <= 0]
    return max((_block_smem(int(H), backward, w_held=mode == 0) for H, mode in zip(wide[:, 0], wide[:, 9])),
               default=0)


@functools.lru_cache(maxsize=64)
def _device_plan(layout: RecurrenceLayout, device: torch.device, backward: bool = False):
    """(work table on the device, dynamic shared memory bytes) of one layout, built once."""
    limit = build.function("lstm_recurrence", "lstm_recurrence_smem_limit", ())()
    items = work_items(layout, backward, limit)
    return torch.from_numpy(items).to(device), smem_bytes(items, backward)


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
    if layout.dirs not in (1, 2):
        raise ValueError("lstm_recurrence: dirs must be 1 or 2")
    if xp.device.type == "cuda" and xp.data_ptr() % 16:
        raise ValueError("lstm_recurrence: xp must start on a 16-byte boundary (the kernel reads 16 bytes at once)")


def _forward(xp: torch.Tensor, w: torch.Tensor, layout: RecurrenceLayout, cell: bool = False):
    """K5 on checked tensors: (h, c) with c packed like h when `cell`, else (h, None)."""
    if xp.device.type == "cpu":
        res = lstm_recurrence_grouped_plain(xp, w, layout, cell)
        return res if cell else (res, None)
    out = torch.empty(layout.h_size, dtype=torch.float32, device=xp.device)
    c = torch.empty_like(out) if cell else None
    items, smem = _device_plan(layout, xp.device)
    fn = build.function("lstm_recurrence", "lstm_recurrence", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p))
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    rc = fn(xp.data_ptr(), w.data_ptr(), out.data_ptr(), c.data_ptr() if cell else None, items.data_ptr(),
            items.shape[0], smem, stream)
    if rc != 0:
        raise RuntimeError(f"lstm_recurrence: kernel launch failed with cudaError {rc}")
    lstm_recurrence.launches += 1
    return out, c


def lstm_recurrence_backward(xp: torch.Tensor, w: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                             dh: torch.Tensor, layout: RecurrenceLayout):
    """The backward of one `lstm_recurrence` layer: K5b on CUDA tensors (one
    launch, counted in `lstm_recurrence_backward.launches`, for d(xp) and
    each sequence row's d(w), then their sum over rows),
    `lstm_recurrence_backward_grouped_plain` on CPU tensors.

    xp, w: the forward's packed inputs; h, c: its packed output and cell
    state; dh: the packed cotangent of h. Returns (d(xp), d(w)), packed."""
    _check(xp, w, layout)
    for name, t in (("h", h), ("c", c), ("dh", dh)):
        if t.dtype != torch.float32 or t.shape != (layout.h_size,) or not t.is_contiguous() or t.device != xp.device:
            raise ValueError(f"lstm_recurrence_backward: {name} must be contiguous float32 ({layout.h_size},) "
                             f"on {xp.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if xp.device.type == "cpu":
        return lstm_recurrence_backward_grouped_plain(xp, w, h, c, dh, layout)
    dxp = torch.empty_like(xp)
    partials = torch.empty((layout.batch, layout.w_size), dtype=torch.float32, device=xp.device)
    items, smem = _device_plan(layout, xp.device, backward=True)
    fn = build.function("lstm_recurrence", "lstm_recurrence_backward", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p))
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    rc = fn(xp.data_ptr(), w.data_ptr(), h.data_ptr(), c.data_ptr(), dh.data_ptr(), dxp.data_ptr(),
            partials.data_ptr(), layout.w_size, items.data_ptr(), items.shape[0], smem, stream)
    if rc != 0:
        raise RuntimeError(f"lstm_recurrence_backward: kernel launch failed with cudaError {rc}")
    lstm_recurrence_backward.launches += 1
    return dxp, partials.sum(0)


lstm_recurrence_backward.launches = 0


def lstm_recurrence_with_cell(xp: torch.Tensor, w: torch.Tensor, layout: RecurrenceLayout):
    """K5's train-mode forward, not differentiable: (h, c), c packed like h,
    what the autograd Function keeps for K5b. One launch, counted in
    `lstm_recurrence.launches`; the grouped plain version on CPU tensors."""
    _check(xp, w, layout)
    return _forward(xp, w, layout, cell=True)


class _Recurrence(torch.autograd.Function):
    """K5 with K5b as its backward: the forward keeps c beside h."""

    @staticmethod
    def forward(ctx, xp, w, layout):
        h, c = _forward(xp, w, layout, cell=True)
        ctx.layout = layout
        ctx.save_for_backward(xp, w, h, c)
        return h

    @staticmethod
    def backward(ctx, dh):
        xp, w, h, c = ctx.saved_tensors
        dxp, dw = lstm_recurrence_backward(xp, w, h, c, dh.contiguous(), ctx.layout)
        return dxp, dw, None


def lstm_recurrence(xp: torch.Tensor, w: torch.Tensor, layout: RecurrenceLayout) -> torch.Tensor:
    """One LSTM layer over every bucket, target and direction of `layout`:
    K5 on CUDA tensors (one launch, counted in `lstm_recurrence.launches`),
    `lstm_recurrence_grouped_plain` on CPU tensors. Differentiable when xp
    or w needs a gradient (the forward then also keeps c; the backward is
    `lstm_recurrence_backward`).

    xp: packed projections (layout.xp_size,) float32; w: packed W_hh^T
    (layout.w_size,) from pack_recurrent_weights. Returns the packed h
    (layout.h_size,) float32 (`layout.h_blocks` views it per bucket)."""
    _check(xp, w, layout)
    if torch.is_grad_enabled() and (xp.requires_grad or w.requires_grad):
        return _Recurrence.apply(xp, w, layout)
    return _forward(xp, w, layout)[0]


lstm_recurrence.launches = 0
