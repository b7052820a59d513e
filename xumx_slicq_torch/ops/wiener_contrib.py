"""Auxiliary Wiener-filter utilities (norbert.contrib equivalents).

Port of xumx_slicq_tpu/ops/wiener_contrib.py (the residual
spectral-subtraction model, Gaussian smoothing, interference reduction,
logit filter compression), in PyTorch on the device of the tensor given.
`smooth` stays SciPy on the host, as in the JAX module; `reduce_interferences`
copies through it and back. Not used by the main separation path, but part
of the reference's public surface.
"""

import numpy as np
import scipy.ndimage
import torch

_EPS = float(np.finfo(np.float32).eps)


def _logit(w: torch.Tensor, threshold: float, slope: float) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-slope * (w - threshold)))


def residual_model(v: torch.Tensor, x: torch.Tensor, alpha: float = 1, autoscale: bool = False) -> torch.Tensor:
    """Residual source via spectral subtraction (norbert/contrib.py:11-77).

    v: (B, frames, bins, ch, srcs) source spectrograms;
    x: (B, frames, bins, ch) complex mixture.
    Returns v with an appended residual source."""
    vx = torch.clamp(torch.abs(x) ** alpha, min=_EPS)
    v_total = v.sum(-1)
    if autoscale:
        gain = torch.sum(vx * v_total, dim=1)
        weights = torch.sum(v_total * v_total, dim=1) + _EPS
        v = v * (gain / weights)[:, None, ..., None]
        v_total = v.sum(-1)
    vr = torch.clamp(vx - v_total, min=0.0)
    return torch.cat([v, vr[..., None]], dim=-1)


def smooth(v, width: float = 1, temporal: bool = False) -> np.ndarray:
    """Gaussian blur (host-side SciPy, norbert/contrib.py:80-105); takes a
    tensor on any device or an array, returns an array."""
    v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    if temporal:
        return scipy.ndimage.gaussian_filter1d(v, sigma=width, axis=0)
    return scipy.ndimage.gaussian_filter(v, sigma=width, truncate=width)


def reduce_interferences(v: torch.Tensor, thresh: float = 0.6, slope: float = 15) -> torch.Tensor:
    """Sparsify spectrograms along the source axis
    (norbert/contrib.py:108-151, after Pratzlich et al. 2015)."""
    eps = 1e-7
    vs = torch.as_tensor(smooth(v, 10), device=v.device)
    total = eps + vs.sum(-1, keepdim=True)
    return _logit(vs / total, thresh, slope) * v


def compress_filter(W: torch.Tensor, thresh: float = 0.6, slope: float = 15) -> torch.Tensor:
    """Logit 'binarization' of a separation filter
    (norbert/contrib.py:154-188)."""
    nb_channels = W.shape[-1]
    if nb_channels > 1:
        gains = torch.einsum("...ii", W)
        return W * (_logit(gains, thresh, slope) / (_EPS + gains))[..., None, None]
    return _logit(W, thresh, slope)
