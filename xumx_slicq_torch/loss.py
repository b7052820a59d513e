"""Training losses over the sliCQT domain, in PyTorch.

Port of xumx_slicq_tpu/loss.py:25-88: the complex MSE over the 14 X-UMX
target combinations (4C1 + 4C2 + 4C3) per block, then over blocks, in its
closed form; the mask-sum prior; and the negative scale-dependent SDR
over the same combinations. Squared magnitudes are re^2 + im^2, never
`abs`, so gradients stay finite where a difference is exactly zero
(padded or silent audio).
"""

from typing import Sequence

import torch

_C1 = [(0,), (1,), (2,), (3,)]
_C2 = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
_C3 = [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]
COMBINATIONS = _C1 + _C2 + _C3  # 14 X-UMX combinations


def _mean_abs2(d: torch.Tensor) -> torch.Tensor:
    return torch.mean(d.real ** 2 + d.imag ** 2)


def complex_mse_loss(pred_blocks: Sequence[torch.Tensor], target_blocks: Sequence[torch.Tensor]) -> torch.Tensor:
    """14-combination complex MSE (loss.py:33-54). Blocks are
    (4, B, C, F, S, T) complex. With D_i = pred_i - target_i, the sum over
    the combinations of mean|sum_{i in c} D_i|^2 is
    3 mean|sum_i D_i|^2 + 4 sum_i mean|D_i|^2 (each target is in 7
    combinations, each pair in 3); the reference's stacked-real mean
    divides by 2."""
    if pred_blocks[0].shape[0] != 4:
        raise ValueError("combination weights are derived for the 4-target X-UMX set")
    total = 0.0
    for pred, target in zip(pred_blocks, target_blocks):
        d = pred - target
        per = sum(_mean_abs2(d[i]) for i in range(4))
        full = _mean_abs2(d.sum(0))
        total = total + (3.0 * full + 4.0 * per) / (2.0 * len(COMBINATIONS))
    return total / len(pred_blocks)


def mask_sum_loss(mask_blocks: Sequence[torch.Tensor]) -> torch.Tensor:
    """The four target masks should sum to 1 everywhere (loss.py:57-63)."""
    total = 0.0
    for masks in mask_blocks:
        total = total + torch.mean((masks.sum(0) - 1.0) ** 2)
    return total / len(mask_blocks)


def sdsdr_loss(pred_wave: torch.Tensor, target_wave: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Negative scale-dependent SDR over the 14 combinations
    (loss.py:66-88). pred_wave, target_wave: (4, B, C, N) stems."""

    def one(p, t):
        alpha = (p * t).sum(-1, keepdim=True) / ((t * t).sum(-1, keepdim=True) + eps)
        num = ((alpha * t) ** 2).sum(-1)
        den = ((p - t) ** 2).sum(-1)
        return -torch.mean(10.0 * torch.log10((num + eps) / (den + eps)))

    total = 0.0
    for combo in COMBINATIONS:
        total = total + one(sum(pred_wave[i] for i in combo), sum(target_wave[i] for i in combo))
    return total / len(COMBINATIONS)
