"""Unmix: the 4-target mask network over all sliCQT buckets.

Port of xumx_slicq_tpu/models/unmix.py: one SlicedCDAE (or, with
lstm=True, one SlicedLSTM) per bucket, the sigmoid masks multiplied into
the mixture magnitude, then the embedded Wiener-EM (offline) or mix-phase
(realtime) reconstruction (model.py:263-269). The model is built in eval
mode, where BatchNorm runs from its running statistics or folded into the
convs; the trainer calls `.train()`, where BatchNorm runs on batch
statistics and updates its running buffers (unmix.py:121-165), and
gradients flow through K2's backward kernel to the masks. The LSTM
model's buckets' recurrences run together, one K5 launch per layer, and
in training one K5b launch per layer backward (models/lstm.py); its
inter-layer dropout draws from the generator given to `forward`.
"""

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..device import resolve_device
from ..ops import wiener as wiener_ops
from ..ops.packed import PackedBlocks, layout_of
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
    ):
        """amp: bf16 operands with float32 results (`nn.amp_op`), the JAX
        package's mixed-precision training (unmix.py:44-48): the CDAE's
        convs, or the LSTM's projections and Linear layers.
        lstm: SlicedLSTM blocks (unmix.py:65-78); the hidden sizes and time
        filter are the CDAE's and do not apply."""
        super().__init__()
        dev = resolve_device(device)
        self.realtime = realtime
        self.lstm = lstm
        self.amp = amp
        self.wiener_iterations = wiener_iterations
        if lstm:
            blocks = [SlicedLSTM(C, F, T, realtime=realtime, amp=amp) for (_, C, F, _, T) in block_shapes]
        else:
            blocks = [SlicedCDAE(C, F, T, hidden_size_1, hidden_size_2, time_filter_2, realtime=realtime, amp=amp)
                      for (_, C, F, _, T) in block_shapes]
        self.blocks = nn.ModuleList(blocks)
        gen = torch.Generator().manual_seed(seed)
        for i, blk in enumerate(self.blocks):
            blk.reset_parameters(gen)
            with torch.no_grad():
                if input_means is not None:
                    blk.input_mean.copy_(-torch.as_tensor(input_means[i], dtype=torch.float32))
                if input_scales is not None:
                    blk.input_scale.copy_(1.0 / torch.as_tensor(input_scales[i], dtype=torch.float32))
        self.to(dev)
        self.eval()

    def fold_batchnorm(self) -> List[dict]:
        """Per-bucket folded conv weights (cdae.fold_cdae_batchnorm), for
        apply(prepared=...). The LSTM's BatchNorm is not folded
        (unmix.py:171-172)."""
        if self.lstm:
            raise ValueError("BN folding applies to the CDAE variant only")
        return [blk.fold_batchnorm() for blk in self.blocks]

    def inference_weights(self) -> list:
        """What apply(prepared=...) reads on the inference path, built once
        per model on its device: the CDAE's BatchNorm folded into its convs,
        or the LSTM's per-layer packed recurrent weights for K5."""
        with torch.no_grad():
            return recurrent_weights(self.blocks) if self.lstm else self.fold_batchnorm()

    def magnitudes(self, Xcomplex: Sequence[torch.Tensor], prepared: Optional[list] = None,
                   generator: Optional[torch.Generator] = None):
        """The masks and the target magnitude estimates masks * |X|.
        prepared: `inference_weights()`, or None to run from the modules'
        own weights. generator: the LSTM's dropout draws in train mode
        (None: no dropout, as the JAX package's rng=None).

        Returns (Ymags, Ymasks): Ymags is a `PackedBlocks` of
        (4, B, C, F, S, T) views of one float32 buffer, in the layout of
        Xcomplex when that is packed; Ymasks a list of per-bucket masks."""
        layout = layout_of(Xcomplex)
        Xmags = [torch.abs(x) for x in Xcomplex]
        if self.lstm:
            Ymasks = lstm_masks(self.blocks, Xmags, prepared, generator)
        else:
            Ymasks = [blk(xm, None if prepared is None else prepared[i])
                      for i, (blk, xm) in enumerate(zip(self.blocks, Xmags))]
        if torch.is_grad_enabled() and any(m.requires_grad for m in Ymasks):
            # out= writes do not support autograd: concatenate instead
            packed = torch.cat([(m * xm[None]).reshape(-1) for m, xm in zip(Ymasks, Xmags)])
            return PackedBlocks(packed, layout, 4), Ymasks
        Ymags = PackedBlocks(torch.empty(4 * layout.size, dtype=torch.float32, device=Xmags[0].device), layout, 4)
        for m, xm, dst in zip(Ymasks, Xmags, Ymags):
            torch.mul(m, xm[None], out=dst)           # multiplicative skip connection
        return Ymags, Ymasks

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
