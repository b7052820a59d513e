"""Numerical ops: frequency scales, NSGT filterbank design, the sliced
Constant-Q transform (sliCQT) and the Wiener-EM post-filter.

Plan construction is host-side NumPy (copied from the JAX package); the
transforms run as PyTorch on the chosen device.
"""

from .filterbank import FilterbankPlan, design_filterbank
from .fscale import BarkScale, LinScale, LogScale, MelScale, MRSTFTScale, Scale, make_scale
from .slicqt import SliCQT, make_slicqt

__all__ = [
    "Scale",
    "BarkScale",
    "MelScale",
    "LogScale",
    "LinScale",
    "MRSTFTScale",
    "make_scale",
    "design_filterbank",
    "FilterbankPlan",
    "SliCQT",
    "make_slicqt",
]
