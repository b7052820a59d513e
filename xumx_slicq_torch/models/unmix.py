"""Unmix: the 4-target mask network over all sliCQT buckets.

Port of xumx_slicq_tpu/models/unmix.py (CDAE variant): one SlicedCDAE per
bucket, the sigmoid masks multiplied into the mixture magnitude, then the
embedded Wiener-EM (offline) or mix-phase (realtime) reconstruction
(model.py:263-269). Eval only in this slice: BatchNorm runs from its
running statistics, or folded into the convs.
"""

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..device import resolve_device
from ..ops import wiener as wiener_ops
from .cdae import SlicedCDAE


class Unmix(nn.Module):
    """block_shapes: the (B, C, F, S, T) list of SliCQT.block_shapes; it
    fixes the architecture (B and S do not matter). Weights are drawn from
    `seed` with torch's default conv init; `input_means` / `input_scales`
    are the dataset whitening statistics (stored as -mean and 1/scale)."""

    def __init__(
        self,
        block_shapes: Sequence[Tuple[int, ...]],
        realtime: bool = False,
        input_means: Optional[Sequence] = None,
        input_scales: Optional[Sequence] = None,
        wiener_iterations: int = 1,
        hidden_size_1: int = 50,
        hidden_size_2: int = 51,
        time_filter_2: int = 4,
        seed: int = 0,
        device="cuda",
    ):
        super().__init__()
        dev = resolve_device(device)
        self.realtime = realtime
        self.wiener_iterations = wiener_iterations
        self.blocks = nn.ModuleList([
            SlicedCDAE(C, F, T, hidden_size_1, hidden_size_2, time_filter_2, realtime=realtime)
            for (_, C, F, _, T) in block_shapes
        ])
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
        apply(folded=...)."""
        return [blk.fold_batchnorm() for blk in self.blocks]

    def forward(self, Xcomplex: Sequence[torch.Tensor], folded: Optional[List[dict]] = None):
        """Xcomplex: list of (B, C, F, S, T) complex mixture blocks.
        Returns (Ycomplex, Ymasks): lists of (4, B, C, F, S, T) complex
        estimates and float masks, as the JAX package's Unmix.apply."""
        Ymags, Ymasks = [], []
        for i, (blk, Xb) in enumerate(zip(self.blocks, Xcomplex)):
            Xmag = torch.abs(Xb)
            masks = blk(Xmag, None if folded is None else folded[i])
            Ymags.append(masks * Xmag[None])        # multiplicative skip connection
            Ymasks.append(masks)
        if self.realtime:
            Ycomplex = wiener_ops.phasemix_blocks(Xcomplex, Ymags)
        else:
            Ycomplex = wiener_ops.wiener_blocks(Xcomplex, Ymags, self.wiener_iterations)
        return Ycomplex, Ymasks

    def apply(self, Xcomplex: Sequence[torch.Tensor], folded: Optional[List[dict]] = None):
        """The JAX package's name for the forward pass. It shadows
        nn.Module.apply(fn); walk submodules with `modules()` instead."""
        return self(Xcomplex, folded)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
