"""Training steps with the reference: the CDAE in train mode, the
Wiener-EM (offline) or the mixture's phase (realtime), the X-UMX losses,
autograd and AdamW, in plain PyTorch.

A step (xumx_slicq_v2's trainer at its defaults, as the measured package's
make_train_step keeps them): the sliCQT of the mixture and of the four
targets (data: no gradient), the masks with BatchNorm on the batch's
statistics, masks times |X|, the post-filter, the 14-combination
complex MSE plus the mask-sum loss (SD-SDR off), the backward, then AdamW
(torch's defaults: betas 0.9 / 0.999, eps 1e-8, decoupled weight decay)
written out here.
"""

from typing import Dict

import torch

from . import models
from .slicqt import PlainSliCQT

C1 = [(0,), (1,), (2,), (3,)]
C2 = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
C3 = [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]
COMBINATIONS = C1 + C2 + C3


def _mean_abs2(d):
    return torch.mean(d.real ** 2 + d.imag ** 2)


def complex_mse(pred, target) -> torch.Tensor:
    """The mean over buckets of the mean over the 14 combinations of
    mean |sum of the combination's (pred - target)|^2 / 2 (loss.py:33-54,
    written as the sum over combinations, not in closed form)."""
    total = 0.0
    for p, t in zip(pred, target):
        d = p - t
        total = total + sum(_mean_abs2(sum(d[i] for i in c)) for c in COMBINATIONS) / (2.0 * len(COMBINATIONS))
    return total / len(pred)


def mask_sum(masks) -> torch.Tensor:
    return sum(torch.mean((m.sum(0) - 1.0) ** 2) for m in masks) / len(masks)


class Trainer:
    """The reference's train steps from a copy of the initial weights."""

    def __init__(self, config: dict, weights: Dict[str, torch.Tensor], device, lr: float = 1e-3,
                 weight_decay: float = 1e-5, mask_sum_coef: float = 1.0):
        t = config["transform"]
        self.config = config
        self.slicqt = PlainSliCQT(t["scale"], t["fbins"], t["fmin"], t.get("fmax", 22050.0), t["fs"], device)
        self.w = {k: v.detach().clone() for k, v in weights.items()}
        self.params = [k for k in self.w if not k.endswith(("running_mean", "running_var"))]
        for k in self.params:
            self.w[k].requires_grad_(True)
        self.lr, self.wd, self.mask_sum_coef = lr, weight_decay, mask_sum_coef
        self.m = {k: torch.zeros_like(self.w[k]) for k in self.params}
        self.v = {k: torch.zeros_like(self.w[k]) for k in self.params}
        self.steps = 0

    def loss(self, batch: torch.Tensor) -> torch.Tensor:
        """batch (B, 5, C, L): mixture, bass, vocals, other, drums."""
        x, y = batch[:, 0], batch[:, 1:]
        B, _, C, L = y.shape
        with torch.no_grad():
            X = self.slicqt.forward(x.contiguous())
            Yt = [c.reshape(B, 4, *c.shape[1:]).transpose(0, 1) for c in self.slicqt.forward(y.reshape(B * 4, C, L))]
        masks = [models.cdae_masks(self.w, k, torch.abs(xb), self.config, train=True) for k, xb in enumerate(X)]
        est = [models.post_filter(self.config, xb, m * torch.abs(xb)[None]) for xb, m in zip(X, masks)]
        total = complex_mse(est, Yt)
        if self.mask_sum_coef > 0:
            total = total + self.mask_sum_coef * mask_sum(masks)
        return total

    def step(self, batch: torch.Tensor) -> Dict[str, object]:
        """One step: its loss, and each leaf's gradient as AdamW receives it."""
        total = self.loss(batch)
        grads = torch.autograd.grad(total, [self.w[k] for k in self.params])
        self.steps += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        bc1, bc2 = 1 - b1 ** self.steps, 1 - b2 ** self.steps
        with torch.no_grad():
            for k, g in zip(self.params, grads):
                p = self.w[k]
                p.mul_(1 - self.lr * self.wd)
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (self.v[k].sqrt() / bc2 ** 0.5).add_(eps)
                p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)
        return {"loss": float(total.detach()), "grads": dict(zip(self.params, grads))}

    def parameters(self) -> Dict[str, torch.Tensor]:
        return {k: self.w[k].detach() for k in self.params}
