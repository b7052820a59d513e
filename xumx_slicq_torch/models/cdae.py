"""Per-bucket convolutional denoising autoencoder (CDAE) mask network.

Port of xumx_slicq_tpu/models/cdae.py. The 4 per-target CDAEs of one
bucket are stacked into one module: enc1 is a single conv with 4*h1 output
channels (all targets read the same input), and enc2, dec1 and dec2 are
grouped convs with groups=4. Channels are target-major, so target t owns
channels [t*h, (t+1)*h) of every layer.

enc1 is the conv of kernel (fphi, T) at stride (1, T/2) over the slices laid
end to end (S*T time steps), and dec2 the transposed conv of the same
geometry. That is exactly what the JAX package's `_enc1_frames` and
`_dec2_ola` (cdae.py:112-173) rebuild by hand for XLA: frame 2s is slice s,
frame 2s+1 straddles slices s and s+1, and every output sample receives one
even-frame and one odd-frame contribution. The realtime variant left-pads
the time axis by T-1 (causal enc1, cdae.py:218-221) and keeps the first
S*T outputs of dec2.

`targets` < 4 builds the module of a target-parallel rank
(parallel/mesh.py): the same layers for its targets only, the groups=4
convs becoming groups=targets.
"""

from typing import Dict, Optional

import torch
import torch.nn.functional as Fn
from torch import nn

from ..kernels.cdae_conv import folded_bucket_plain
from .nn import amp_op, batch_norm, kaiming_uniform_

NB_TARGETS = 4


def freq_filter(nb_f_bins: int) -> int:
    """Frequency kernel 1/3/5 by block height thresholds 10/20 (model.py:112-117)."""
    if nb_f_bins < 10:
        return 1
    if nb_f_bins < 20:
        return 3
    return 5


class SlicedCDAE(nn.Module):
    """All 4 targets' CDAE for one bucket of shape (B, C, F, S, T)."""

    def __init__(self, nb_channels: int, nb_f_bins: int, nb_t_bins: int,
                 hidden_size_1: int = 50, hidden_size_2: int = 51, time_filter_2: int = 4,
                 realtime: bool = False, amp: bool = False, targets: int = NB_TARGETS):
        super().__init__()
        C, T = nb_channels, nb_t_bins
        h1, h2, tf2 = hidden_size_1, hidden_size_2, time_filter_2
        fphi = freq_filter(nb_f_bins)
        self.nb_channels, self.nb_f_bins, self.nb_t_bins = C, nb_f_bins, T
        self.hidden_size_1, self.hidden_size_2, self.time_filter_2 = h1, h2, tf2
        self.fphi = fphi
        self.realtime = realtime
        self.amp = amp                 # bf16 conv operands (mixed-precision training)
        self.targets = n = targets
        self.enc1_w = nn.Parameter(torch.empty(n * h1, C, fphi, T))      # conv OIHW
        self.enc2_w = nn.Parameter(torch.empty(n * h2, h1, fphi, tf2))   # grouped conv
        self.dec1_w = nn.Parameter(torch.empty(n * h2, h1, fphi, tf2))   # grouped conv_transpose IOHW
        self.dec2_w = nn.Parameter(torch.empty(n * h1, C, fphi, T))      # grouped conv_transpose IOHW
        self.dec2_b = nn.Parameter(torch.empty(n * C))
        # whitening: per-frequency learned shift and scale (model.py:239-242)
        self.input_mean = nn.Parameter(torch.zeros(nb_f_bins))
        self.input_scale = nn.Parameter(torch.ones(nb_f_bins))
        self.bn1 = nn.BatchNorm2d(n * h1)
        self.bn2 = nn.BatchNorm2d(n * h2)
        self.bn3 = nn.BatchNorm2d(n * h1)

    def reset_parameters(self, generator: torch.Generator):
        """torch's default conv init, as the JAX package's init_cdae_params."""
        C, T, fphi = self.nb_channels, self.nb_t_bins, self.fphi
        h1, tf2 = self.hidden_size_1, self.time_filter_2
        kaiming_uniform_(self.enc1_w, C * fphi * T, generator)
        kaiming_uniform_(self.enc2_w, h1 * fphi * tf2, generator)
        kaiming_uniform_(self.dec1_w, h1 * fphi * tf2, generator)
        kaiming_uniform_(self.dec2_w, C * fphi * T, generator)
        kaiming_uniform_(self.dec2_b, h1 * fphi * T, generator)
        with torch.no_grad():
            self.input_mean.zero_()
            self.input_scale.fill_(1.0)
        for bn in (self.bn1, self.bn2, self.bn3):
            bn.reset_parameters()

    def fold_batchnorm(self, eps: float = 1e-5) -> Dict[str, torch.Tensor]:
        """Eval-time BatchNorm folding (cdae.py:176-201). The convs have no
        bias, so BN(conv(x)) = conv(x) a + d with a = scale rsqrt(var+eps),
        d = bias - mean a: a scales the weight's output channels and d
        becomes the conv bias. Returns the tensors `forward(folded=...)`
        reads."""

        def affine(bn):
            a = bn.weight * torch.rsqrt(bn.running_var + eps)
            return a, bn.bias - bn.running_mean * a

        a1, b1 = affine(self.bn1)
        a2, b2 = affine(self.bn2)
        a3, b3 = affine(self.bn3)
        n, h1, h2 = self.targets, self.hidden_size_1, self.hidden_size_2
        dec1 = self.dec1_w.reshape(n, h2, h1, *self.dec1_w.shape[2:]) * a3.reshape(n, 1, h1, 1, 1)
        return {
            "enc1_w": self.enc1_w * a1[:, None, None, None], "enc1_b": b1,
            "enc2_w": self.enc2_w * a2[:, None, None, None], "enc2_b": b2,
            "dec1_w": dec1.reshape(self.dec1_w.shape), "dec1_b": b3,
            "dec2_w": self.dec2_w, "dec2_b": self.dec2_b,
            "input_mean": self.input_mean, "input_scale": self.input_scale,
        }

    def forward(self, x_mag: torch.Tensor, folded: Optional[Dict[str, torch.Tensor]] = None,
                mesh=None) -> torch.Tensor:
        """x_mag: (B, C, F, S, T) mixture magnitude -> masks (targets, B, C, F, S, T).

        folded=None runs BatchNorm as the module's mode says: in train mode
        on the batch statistics, updating the running buffers; in eval mode
        from the running statistics. A dict from fold_batchnorm runs the
        folded fast path (kernels/cdae_conv.py's plain version of K4), which
        is eval-only and fp32 (cdae.py:253-255). mesh: in train mode, the
        statistics are the dp group's (nn.batch_norm)."""
        if folded is not None:
            if self.training:
                raise ValueError("BN-folded weights cannot train (fold_batchnorm is eval-only)")
            if self.amp:
                raise ValueError("BN-folded weights run fp32: an amp model's folded forward is not served")
            return folded_bucket_plain(x_mag, folded, self.realtime, self.targets)
        B, C, F, S, T = x_mag.shape
        hop = T // 2

        def norm(h, bn):
            return batch_norm(h, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps,
                              train=self.training, mesh=mesh)

        def conv(fn, h, w, b=None, **kw):
            if not self.amp:
                return fn(h, w, b, **kw)
            y = amp_op(lambda a, c: fn(a, c, **kw), h, w, amp=True)      # the bias stays fp32
            return y if b is None else y + b[None, :, None, None]

        x = (x_mag + self.input_mean[None, None, :, None, None]) * self.input_scale[None, None, :, None, None]
        x = x.reshape(B, C, F, S * T)
        if self.realtime:
            x = Fn.pad(x, (T - 1, 0))
        h = torch.relu(norm(conv(Fn.conv2d, x, self.enc1_w, stride=(1, hop)), self.bn1))
        n = self.targets
        h = torch.relu(norm(conv(Fn.conv2d, h, self.enc2_w, groups=n), self.bn2))
        h = torch.relu(norm(conv(Fn.conv_transpose2d, h, self.dec1_w, groups=n), self.bn3))
        y = conv(Fn.conv_transpose2d, h, self.dec2_w, self.dec2_b, stride=(1, hop), groups=n)
        mask = torch.sigmoid(y[..., : S * T])
        return mask.reshape(B, n, C, F, S, T).transpose(0, 1)
