"""Unmix: the 4-target mask network over all sliCQT buckets.

Port of xumx_slicq_tpu/models/unmix.py: one SlicedCDAE (or, with
lstm=True, one SlicedLSTM) per bucket, the sigmoid masks multiplied into
the mixture magnitude, then the embedded Wiener-EM (offline) or mix-phase
(realtime) reconstruction (model.py:263-269). The model is built in eval
mode, where BatchNorm runs from its running statistics or folded into the
convs; with folded weights (`inference_weights`, the serving path) the
CDAE of every bucket runs as K4, four launches for all buckets and
targets that also write the packed magnitudes (kernels/cdae_conv.py);
the trainer calls `.train()`, where BatchNorm runs on batch
statistics and updates its running buffers (unmix.py:121-165), and
gradients flow through K2's backward kernel to the masks. The LSTM
model's buckets' recurrences run together, one K5 launch per layer, and
in training one K5b launch per layer backward (models/lstm.py); its
inter-layer dropout draws from the generator given to `forward`.

Built with a `mesh` (parallel/mesh.py), the model is one rank's: it holds
the weights and BatchNorm of the rank's targets only (the 4-target model
drawn from `seed`, cut to them), its train-mode BatchNorm runs on the dp
group's global batch, and the masks of all 4 targets are gathered over the
tp group before the Wiener-EM, which couples the targets.
"""

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..device import resolve_device
from ..ops import wiener as wiener_ops
from ..kernels import cdae_conv
from ..ops.packed import PackedBlocks, layout_of, pack
from ..parallel.mesh import NB_TARGETS, take_targets
from .cdae import SlicedCDAE
from .lstm import SlicedLSTM, lstm_masks, recurrent_weights


class Unmix(nn.Module):
    """block_shapes: the (B, C, F, S, T) list of SliCQT.block_shapes; it
    fixes the architecture (B and S do not matter). Weights are drawn from
    `seed` with torch's default conv init; `input_means` / `input_scales`
    are the dataset whitening statistics (stored as -mean and 1/scale)."""

    def __init__(
        self,
        block_shapes: Sequence[Tuple[int, ...]],
        realtime: bool = False,
        lstm: bool = False,
        input_means: Optional[Sequence] = None,
        input_scales: Optional[Sequence] = None,
        wiener_iterations: int = 1,
        hidden_size_1: int = 50,
        hidden_size_2: int = 51,
        time_filter_2: int = 4,
        amp: bool = False,
        seed: int = 0,
        device="cuda",
        mesh=None,
    ):
        """amp: bf16 operands with float32 results (`nn.amp_op`), the JAX
        package's mixed-precision training (unmix.py:44-48): the CDAE's
        convs, or the LSTM's projections and Linear layers.
        lstm: SlicedLSTM blocks (unmix.py:65-78); the hidden sizes and time
        filter are the CDAE's and do not apply.
        mesh: this rank's `parallel.mesh.Mesh` in a run across ranks."""
        super().__init__()
        dev = resolve_device(device)
        self.realtime = realtime
        self.lstm = lstm
        self.amp = amp
        self.wiener_iterations = wiener_iterations
        self.mesh = mesh

        def make_blocks(targets):
            if lstm:
                return nn.ModuleList([SlicedLSTM(C, F, T, realtime=realtime, amp=amp, targets=targets)
                                      for (_, C, F, _, T) in block_shapes])
            return nn.ModuleList([SlicedCDAE(C, F, T, hidden_size_1, hidden_size_2, time_filter_2, realtime=realtime,
                                             amp=amp, targets=targets) for (_, C, F, _, T) in block_shapes])

        self.blocks = make_blocks(NB_TARGETS)
        gen = torch.Generator().manual_seed(seed)
        for i, blk in enumerate(self.blocks):
            blk.reset_parameters(gen)
            with torch.no_grad():
                if input_means is not None:
                    blk.input_mean.copy_(-torch.as_tensor(input_means[i], dtype=torch.float32))
                if input_scales is not None:
                    blk.input_scale.copy_(1.0 / torch.as_tensor(input_scales[i], dtype=torch.float32))
        if mesh is not None and mesh.tp > 1:
            full = self.blocks.state_dict()
            self.blocks = make_blocks(len(mesh.targets))
            self.blocks.load_state_dict(take_targets(full, mesh.targets))
        self.to(dev)
        self.eval()

    def fold_batchnorm(self) -> List[dict]:
        """Per-bucket folded conv weights (cdae.fold_cdae_batchnorm), for
        apply(prepared=...). The LSTM's BatchNorm is not folded
        (unmix.py:171-172)."""
        if self.lstm:
            raise ValueError("BN folding applies to the CDAE variant only")
        return [blk.fold_batchnorm() for blk in self.blocks]

    def cdae_arch(self) -> cdae_conv.CdaeArch:
        """The CDAE's architecture as K4's packed weights record it."""
        b = self.blocks[0]
        return cdae_conv.CdaeArch(tuple((k.nb_channels, k.nb_f_bins, k.nb_t_bins, k.fphi) for k in self.blocks),
                                  b.targets, b.hidden_size_1, b.hidden_size_2, b.time_filter_2)

    def inference_weights(self):
        """What apply(prepared=...) reads on the inference path, built once
        per model on its device: the CDAE's BatchNorm folded into its convs
        and packed for K4 (`cdae_conv.CdaeWeights`), or the LSTM's
        per-layer packed recurrent weights for K5."""
        with torch.no_grad():
            if self.lstm:
                return recurrent_weights(self.blocks)
            return cdae_conv.pack_weights(self.fold_batchnorm(), self.cdae_arch())

    def magnitudes(self, Xcomplex: Sequence[torch.Tensor], prepared: Optional[list] = None,
                   generator: Optional[torch.Generator] = None):
        """The masks and the target magnitude estimates masks * |X|.
        prepared: `inference_weights()`, or None to run from the modules'
        own weights. For the CDAE, folded weights (`inference_weights()`,
        or `fold_batchnorm()`'s list, packed here) run K4: the masks and
        magnitudes of every bucket in four launches, fp32; an amp model's
        folded weights are refused. generator: the LSTM's dropout draws in
        train mode (None: no dropout, as the JAX package's rng=None).

        Returns (Ymags, Ymasks): Ymags is a `PackedBlocks` of
        (4, B, C, F, S, T) views of one float32 buffer, in the layout of
        Xcomplex when that is packed; Ymasks a list of per-bucket masks."""
        layout = layout_of(Xcomplex)
        tp = self.mesh is not None and self.mesh.tp > 1
        folded = prepared is not None and not self.lstm
        if folded:
            if self.training:
                raise ValueError("BN-folded weights cannot train (fold_batchnorm is eval-only)")
            if self.amp:
                raise ValueError("K4 runs fp32: an amp model's folded weights are not served")
            weights = prepared if isinstance(prepared, cdae_conv.CdaeWeights) else \
                cdae_conv.pack_weights(prepared, self.cdae_arch())
            mags, masks = cdae_conv.cdae_folded(pack(Xcomplex).packed, weights, layout, self.realtime)
            Ymasks = layout.split(masks, weights.arch.targets)
            if not tp:
                return PackedBlocks(mags, layout, NB_TARGETS), Ymasks
            # K4's magnitudes hold this rank's targets only: those of all 4
            # come from the gathered masks below, as on the unfolded path
        Xmags = [torch.abs(x) for x in Xcomplex]
        if not folded:
            mesh = self.mesh if self.training else None       # eval BatchNorm reads the running statistics
            if self.lstm:
                Ymasks = lstm_masks(self.blocks, Xmags, prepared, generator, mesh)
            else:
                Ymasks = [blk(xm, None, mesh) for blk, xm in zip(self.blocks, Xmags)]
        if tp:
            Ymasks = self._gather_targets(Ymasks)
        if torch.is_grad_enabled() and any(m.requires_grad for m in Ymasks):
            # out= writes do not support autograd: concatenate instead
            packed = torch.cat([(m * xm[None]).reshape(-1) for m, xm in zip(Ymasks, Xmags)])
            return PackedBlocks(packed, layout, 4), Ymasks
        Ymags = PackedBlocks(torch.empty(4 * layout.size, dtype=torch.float32, device=Xmags[0].device), layout, 4)
        for m, xm, dst in zip(Ymasks, Xmags, Ymags):
            torch.mul(m, xm[None], out=dst)           # multiplicative skip connection
        return Ymags, Ymasks

    def _gather_targets(self, masks: List[torch.Tensor]) -> List[torch.Tensor]:
        """Every bucket's masks of this rank's targets -> of all 4, in one
        differentiable gather over the tp group (ranks hold contiguous
        target ranges in tp order)."""
        g = self.mesh.gather_targets(torch.cat([m.reshape(-1) for m in masks]))     # (tp, total)
        out, off = [], 0
        for m in masks:
            out.append(g[:, off: off + m.numel()].reshape(NB_TARGETS, *m.shape[1:]))
            off += m.numel()
        return out

    def forward(self, Xcomplex: Sequence[torch.Tensor], prepared: Optional[list] = None,
                generator: Optional[torch.Generator] = None):
        """Xcomplex: list of (B, C, F, S, T) complex mixture blocks;
        generator: the LSTM's dropout draws in train mode (see magnitudes).
        Returns (Ycomplex, Ymasks): lists of (4, B, C, F, S, T) complex
        estimates and float masks, as the JAX package's Unmix.apply."""
        Ymags, Ymasks = self.magnitudes(Xcomplex, prepared, generator)
        if self.realtime:
            Ycomplex = wiener_ops.phasemix_blocks(Xcomplex, Ymags)
        else:
            Ycomplex = wiener_ops.wiener_blocks(Xcomplex, Ymags, self.wiener_iterations)
        return Ycomplex, Ymasks

    def apply(self, Xcomplex: Sequence[torch.Tensor], prepared: Optional[list] = None,
              generator: Optional[torch.Generator] = None):
        """The JAX package's name for the forward pass. It shadows
        nn.Module.apply(fn); walk submodules with `modules()` instead."""
        return self(Xcomplex, prepared, generator)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
