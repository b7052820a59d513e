"""The packed bucket layout: every bucket's block as a contiguous view of
one 1-D buffer.

`SliCQT.forward` writes its mixture blocks into one such buffer, `Unmix`
its target magnitudes into another, and Wiener-EM (kernel K2) reads both
whole and writes one packed estimate, so no stage copies a bucket at the
boundary between them. This module holds only shapes and offsets; K2
keeps its own tables per layout (kernels/wiener_em.py).
"""

import itertools
import math
from typing import List, Sequence, Tuple

import torch


class BucketLayout:
    """Where each bucket lies in a packed buffer.

    shapes: one (B, C, F, S, M) per bucket. Bucket k's mixture occupies
    elements [offsets[k], offsets[k] + sizes[k]) of a packed mixture buffer
    of `size` elements; its magnitudes and estimates, (4, B, C, F, S, M),
    occupy [4 offsets[k], 4 (offsets[k] + sizes[k])) of their buffers.
    Layouts of the same shapes are equal."""

    def __init__(self, shapes: Sequence[Sequence[int]]):
        self.shapes: Tuple[Tuple[int, ...], ...] = tuple(tuple(int(d) for d in s) for s in shapes)
        self.sizes = tuple(math.prod(s) for s in self.shapes)
        self.offsets = tuple(itertools.accumulate(self.sizes, initial=0))[:-1]
        self.size = sum(self.sizes)
        self._hash = hash(self.shapes)

    def __eq__(self, other) -> bool:
        return isinstance(other, BucketLayout) and self.shapes == other.shapes

    def __hash__(self) -> int:
        return self._hash

    def split(self, flat: torch.Tensor, targets: int = 0) -> List[torch.Tensor]:
        """Per-bucket views of a packed 1-D buffer: (B, C, F, S, M) blocks,
        or (targets, B, C, F, S, M) with targets > 0."""
        n = max(targets, 1)
        lead = (targets,) if targets else ()
        return [flat[n * o: n * (o + z)].view(lead + s) for s, o, z in zip(self.shapes, self.offsets, self.sizes)]


class PackedBlocks(list):
    """The per-bucket blocks of a packed buffer: a list of contiguous views
    of `packed` (1-D) at the offsets of `layout`, with a leading targets
    axis when targets > 0."""

    def __init__(self, packed: torch.Tensor, layout: BucketLayout, targets: int = 0):
        super().__init__(layout.split(packed, targets))
        self.packed = packed
        self.layout = layout


def layout_of(blocks: Sequence[torch.Tensor], targets: int = 0) -> BucketLayout:
    """The layout of a blocks list: its own when packed, else the one its
    shapes give. targets > 0 when each block has a leading targets axis,
    which the layout leaves out."""
    if isinstance(blocks, PackedBlocks):
        return blocks.layout
    return BucketLayout([b.shape[1:] if targets else b.shape for b in blocks])


def pack(blocks: Sequence[torch.Tensor], targets: int = 0) -> PackedBlocks:
    """`blocks` as `PackedBlocks`: themselves when already packed, else one
    copy into a new buffer in `layout_of(blocks, targets)`."""
    if isinstance(blocks, PackedBlocks):
        return blocks
    return PackedBlocks(torch.cat([b.reshape(-1) for b in blocks]), layout_of(blocks, targets), targets)
