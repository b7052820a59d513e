"""Per-bucket LSTM mask network, the alternative to the CDAE.

Port of xumx_slicq_tpu/models/lstm.py: an optional Linear
down-projection (when F > 10), a 3-layer LSTM (bidirectional offline,
unidirectional realtime), a skip concat and two Linear layers, for the 4
targets of one bucket stacked on a leading axis, then a sigmoid mask.

The reference's row-major reshapes between (B, C, F, frames), (rows, F C)
and (frames, B, h1) are kept literally (lstm.py:191-237): a sequence's
"batch" axis cuts across the chunk batch, so the masks depend on how chunks
are batched, and any permute before these reshapes would change them.

`Unmix` runs the buckets together: `encode` every bucket, then per layer
`project` every bucket into one packed xp buffer and one K5 launch for the
recurrence of all of them (kernels/lstm_recurrence.py), then `decode`.
In training (gradients enabled) each layer's xp is its own buffer, kept
for K5's backward (K5b), and in train mode BatchNorm1d runs on batch
statistics and, given a generator, dropout runs between the layers. With
amp the input projection and the three Linear layers take bf16 operands;
the recurrence stays float32 (lstm.py:150, 204-205).

Across ranks (parallel/mesh.py): `targets` < 4 builds a target-parallel
rank's module, and K5 walks only its targets. Data parallelism cannot split
the recurrence by batch rows: the literal reshape makes every sequence run
through the whole global batch, item after item. So in training each dp
rank encodes its rows, the encoded rows of the dp group are gathered, every
rank runs the global batch's recurrence (as the one-process run does, with
the same dropout draws), and each decodes its own rows again.
"""

import torch
from torch import nn

from ..kernels.lstm_recurrence import RecurrenceLayout, lstm_recurrence, pack_recurrent_weights
from .nn import amp_op, batch_norm1d

NB_TARGETS = 4
NB_LAYERS = 3
DROPOUT = 0.4           # between the layers, as torch's nn.LSTM(dropout=0.4) (lstm.py:167-184)


class SlicedLSTM(nn.Module):
    """All 4 targets' LSTM mask model for one bucket of shape (B, C, F, S, T)."""

    def __init__(self, nb_channels: int, nb_f_bins: int, nb_t_bins: int, realtime: bool = False,
                 amp: bool = False, targets: int = NB_TARGETS):
        super().__init__()
        self.nb_channels, self.nb_f_bins, self.nb_t_bins = nb_channels, nb_f_bins, nb_t_bins
        self.realtime = realtime
        self.amp = amp                 # bf16 operands for the projections and Linear layers
        self.targets = targets
        n, fc, h1, H, dirs = targets, self.fc, self.hidden_size_1, self.lstm_hidden, self.dirs
        if self.downsample:
            self.fc1_w = nn.Parameter(torch.empty(n, h1, fc))
            self.bn1 = nn.BatchNorm1d(n * h1)
        for layer in range(NB_LAYERS):
            in_size = h1 if layer == 0 else H * dirs
            self.register_parameter(f"w_ih_l{layer}", nn.Parameter(torch.empty(n, dirs, 4 * H, in_size)))
            self.register_parameter(f"w_hh_l{layer}", nn.Parameter(torch.empty(n, dirs, 4 * H, H)))
            self.register_parameter(f"b_ih_l{layer}", nn.Parameter(torch.empty(n, dirs, 4 * H)))
            self.register_parameter(f"b_hh_l{layer}", nn.Parameter(torch.empty(n, dirs, 4 * H)))
        self.fc2_w = nn.Parameter(torch.empty(n, h1, 2 * h1))
        self.bn2 = nn.BatchNorm1d(n * h1)
        self.fc3_w = nn.Parameter(torch.empty(n, fc, h1))
        self.fc3_b = nn.Parameter(torch.empty(n, fc))
        # whitening: per-frequency learned shift and scale
        self.input_mean = nn.Parameter(torch.zeros(nb_f_bins))
        self.input_scale = nn.Parameter(torch.ones(nb_f_bins))

    # -- the spec of lstm.py:30-60 ---------------------------------------------

    @property
    def fc(self) -> int:
        return self.nb_f_bins * self.nb_channels

    @property
    def downsample(self) -> bool:
        return self.nb_f_bins > 10

    @property
    def hidden_size_1(self) -> int:
        return self.fc // 2 if self.downsample else self.fc

    @property
    def lstm_hidden(self) -> int:
        h1 = self.hidden_size_1
        return h1 if self.realtime else h1 // 2 + (h1 % 2)

    @property
    def odd_lstm(self) -> bool:
        return self.hidden_size_1 % 2 != 0

    @property
    def bidirectional(self) -> bool:
        return not self.realtime

    @property
    def dirs(self) -> int:
        return 2 if self.bidirectional else 1

    # -- weights ----------------------------------------------------------------

    def reset_parameters(self, generator: torch.Generator):
        """torch's Linear and LSTM init bounds, as init_lstm_params
        (lstm.py:63-110), drawn from `generator`."""

        def uniform_(p, fan):
            bound = (1.0 / fan) ** 0.5
            p.uniform_(-bound, bound, generator=generator)

        with torch.no_grad():
            if self.downsample:
                uniform_(self.fc1_w, self.fc)
                self.bn1.reset_parameters()
            for layer in range(NB_LAYERS):
                for p in self.lstm_weights(layer):
                    uniform_(p, self.lstm_hidden)
            uniform_(self.fc2_w, 2 * self.hidden_size_1)
            uniform_(self.fc3_w, self.hidden_size_1)
            uniform_(self.fc3_b, self.hidden_size_1)
            self.bn2.reset_parameters()
            self.input_mean.zero_()
            self.input_scale.fill_(1.0)

    def lstm_weights(self, layer: int):
        """(w_ih, w_hh, b_ih, b_hh) of one layer, each with leading
        (target, direction) axes in torch's LSTM layout."""
        return tuple(getattr(self, f"{name}_l{layer}") for name in ("w_ih", "w_hh", "b_ih", "b_hh"))

    # -- the three stages around the recurrence ------------------------------

    def _bn(self, h, bn, mesh=None):
        n = self.targets
        return batch_norm1d(h, bn.weight.view(n, 1, -1), bn.bias.view(n, 1, -1),
                            bn.running_mean.view(n, 1, -1), bn.running_var.view(n, 1, -1), bn.eps,
                            train=self.training, mesh=mesh)

    def _mm(self, a, b):
        return amp_op(torch.matmul, a, b, amp=self.amp)

    def encode(self, x_mag: torch.Tensor, mesh=None) -> torch.Tensor:
        """(B, C, F, S, T) magnitude -> the LSTM's input rows
        (targets, B frames, h1), item after item, through whitening, the
        down-projection and the literal reshape (lstm.py:196-214); the
        caller's reshape to (targets, frames, B, h1) makes the sequences.
        mesh: in train mode, BatchNorm's rows are the dp group's."""
        B, C, F, S, T = x_mag.shape
        frames = S * T
        x = x_mag.reshape(B, C, F, frames)
        x = (x + self.input_mean[None, None, :, None]) * self.input_scale[None, None, :, None]
        h = x.reshape(-1, self.fc)
        if self.downsample:
            h = torch.tanh(self._bn(self._mm(h, self.fc1_w.transpose(-1, -2)), self.bn1, mesh))
        else:
            h = h.expand(self.targets, *h.shape)
        return h.reshape(self.targets, B * frames, self.hidden_size_1)

    def project(self, layer: int, x_seq: torch.Tensor, out: torch.Tensor):
        """The input projection of one layer, x W_ih^T + b_ih + b_hh in that
        order (lstm.py:150), for every target and direction, written into
        `out` (4, dirs, frames, B, 4H): a view of K5's packed xp buffer.
        Serving only (out= writes take no gradient): training calls
        `projection`."""
        w_ih, _, b_ih, b_hh = self.lstm_weights(layer)
        n, dirs, frames, B, G = out.shape
        flat = out.view(n, dirs, frames * B, G)
        x = x_seq.reshape(n, 1, frames * B, -1)
        if self.amp:
            flat.copy_(self._mm(x, w_ih.transpose(-1, -2)))
        else:
            torch.matmul(x, w_ih.transpose(-1, -2), out=flat)
        flat += b_ih[:, :, None]
        flat += b_hh[:, :, None]

    def projection(self, layer: int, x_seq: torch.Tensor) -> torch.Tensor:
        """`project` as a differentiable value: (4, dirs, frames * B, 4H)."""
        w_ih, _, b_ih, b_hh = self.lstm_weights(layer)
        n, frames, B, _ = x_seq.shape
        xp = self._mm(x_seq.reshape(n, 1, frames * B, -1), w_ih.transpose(-1, -2))
        return xp + b_ih[:, :, None] + b_hh[:, :, None]

    def decode(self, h_seq: torch.Tensor, lstm_out: torch.Tensor, shape, rows: slice = slice(None),
               mesh=None) -> torch.Tensor:
        """The skip concat and the two Linear layers (lstm.py:216-236):
        (targets, frames, B, h1) and (targets, frames, B, dirs H) -> masks
        (targets, *shape) of the rows `rows` of the literal reshape back
        (a dp rank's own items); mesh as in `encode`."""
        h_cat = torch.cat([h_seq, lstm_out], dim=-1)
        h2 = h_cat.reshape(self.targets, -1, h_cat.shape[-1])[:, rows]
        if self.odd_lstm:
            h2 = h2[..., : self.fc]
        h2 = torch.relu(self._bn(self._mm(h2, self.fc2_w.transpose(-1, -2)), self.bn2, mesh))
        h3 = torch.sigmoid(self._mm(h2, self.fc3_w.transpose(-1, -2)) + self.fc3_b[:, None])
        return h3.reshape(self.targets, *shape)

    def forward(self, x_mag: torch.Tensor) -> torch.Tensor:
        """x_mag: (B, C, F, S, T) -> masks (targets, B, C, F, S, T), this bucket
        alone (Unmix runs all buckets' recurrences in one launch a layer)."""
        return lstm_masks([self], [x_mag])[0]


def _dropout(h: torch.Tensor, generator: torch.Generator, layout: RecurrenceLayout = None,
             targets=None) -> torch.Tensor:
    """Inter-layer dropout over a packed h buffer, one draw for every
    bucket, target, row and direction: kept with probability 1 - DROPOUT
    and scaled by 1 / (1 - DROPOUT) (lstm.py:181-184). On a target-parallel
    rank (`targets`, a range of fewer than 4) the draw is the 4-target
    buffer's, cut to the rank's targets, so that the ranks together drop
    what one process drops."""
    if targets is None:
        keep = torch.rand(h.shape, generator=generator, device=h.device) >= DROPOUT
    else:
        full = RecurrenceLayout(layout.hidden, layout.frames, layout.batch, layout.dirs, NB_TARGETS)
        drawn = torch.rand(full.h_size, generator=generator, device=h.device) >= DROPOUT
        keep = torch.cat([blk[targets.start: targets.stop].reshape(-1) for blk in full.h_blocks(drawn)])
    return torch.where(keep, h / (1.0 - DROPOUT), h.new_zeros(()))


def _gather_rows(rows, mesh):
    """Every bucket's encoded rows (targets, B_local frames, h1) of the dp
    group, in one differentiable gather: (targets, B frames, h1) each, the
    ranks' items in rank order, as the one-process batch holds them."""
    g = mesh.gather_rows(torch.cat([r.reshape(-1) for r in rows]))      # (dp, total)
    out, off = [], 0
    for r in rows:
        n, m, h1 = r.shape
        out.append(g[:, off: off + r.numel()].reshape(mesh.dp, n, m, h1).transpose(0, 1).reshape(n, mesh.dp * m, h1))
        off += r.numel()
    return out


def lstm_masks(blocks, x_mags, weights=None, generator=None, mesh=None):
    """The masks of every bucket: encode each, then for each layer one
    packed projection and one `lstm_recurrence` call (K5 on the card) over
    all buckets, then decode each. weights: per layer the packed W_hh^T of
    `recurrent_weights(blocks)`, built once by the caller, or None to build
    them here (differentiably).

    With gradients enabled (training) each layer's projections are
    concatenated into a buffer of their own, which K5's backward keeps; in
    train mode with a `generator` (on the blocks' device), dropout follows
    layers 0 and 1 (lstm.py:167-184), independent per bucket and target
    (unmix.py:147-149, lstm.py:226-231). Without gradients (serving) one
    xp buffer serves the three layers.

    mesh (training across ranks): BatchNorm over the dp group's rows, and
    with dp > 1 the recurrence of the dp group's global batch, each rank
    decoding its own rows (the module docstring says why)."""
    if weights is None:
        weights = recurrent_weights(blocks)
    n = blocks[0].targets
    dp = mesh.dp if mesh is not None else 1
    B_local = x_mags[0].shape[0]
    B = B_local * dp
    frames = [x.shape[3] * x.shape[4] for x in x_mags]
    layout = RecurrenceLayout([blk.lstm_hidden for blk in blocks], frames, B, blocks[0].dirs, n)
    rows = [blk.encode(x, mesh) for blk, x in zip(blocks, x_mags)]
    if dp > 1:
        rows = _gather_rows(rows, mesh)
    h_seq = [r.reshape(n, f, B, r.shape[-1]) for r, f in zip(rows, frames)]
    seq = h_seq
    grad = torch.is_grad_enabled()
    # serving: one xp buffer for all layers, each layer's projections overwrite the last's after its K5 launch
    # on the same stream has read them
    xp = None if grad else torch.empty(layout.xp_size, dtype=torch.float32, device=x_mags[0].device)
    for layer in range(NB_LAYERS):
        if grad:
            xp = torch.cat([blk.projection(layer, x).reshape(-1) for blk, x in zip(blocks, seq)])
        else:
            for blk, x, view in zip(blocks, seq, layout.xp_blocks(xp)):
                blk.project(layer, x, view)
        h = lstm_recurrence(xp, weights[layer], layout)
        if generator is not None and blocks[0].training and layer < NB_LAYERS - 1:
            h = _dropout(h, generator) if n == NB_TARGETS else _dropout(h, generator, layout, mesh.targets)
        seq = layout.h_blocks(h)
    own = [slice(mesh.dp_rank * B_local * f, (mesh.dp_rank + 1) * B_local * f) if dp > 1 else slice(None)
           for f in frames]
    return [blk.decode(h, out, x.shape, r, mesh) for blk, h, out, x, r in zip(blocks, h_seq, seq, x_mags, own)]


def recurrent_weights(blocks):
    """Per layer, every bucket's W_hh packed for K5 (pack_recurrent_weights)."""
    return [pack_recurrent_weights([blk.lstm_weights(layer)[1] for blk in blocks]) for layer in range(NB_LAYERS)]
