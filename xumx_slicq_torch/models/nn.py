"""Small NN helpers with the JAX package's semantics (xumx_slicq_tpu/models/nn.py).

Convolutions are torch's own (`F.conv2d`, `F.conv_transpose2d`, cuDNN on the
card): the JAX package's weights already use torch layouts (OIHW, and IOHW
for transposed convs). What stays here is BatchNorm in eval mode and the
default conv initialisation, written out so that both packages compute the
same thing.
"""

import torch


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode BatchNorm2d over NCHW with running statistics
    (nn.py:69-99, train=False)."""
    inv = torch.rsqrt(var + eps)
    y = (x - mean[None, :, None, None]) * (inv * scale)[None, :, None, None]
    return y + bias[None, :, None, None]


def kaiming_uniform_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """torch's Conv2d default init, kaiming_uniform(a=sqrt(5)):
    U(-sqrt(1/fan_in), sqrt(1/fan_in)). The caller passes the fan-in of
    the layer's own layout (for a transposed conv, out_ch * kh * kw)."""
    bound = (1.0 / fan_in) ** 0.5
    with torch.no_grad():
        return w.uniform_(-bound, bound, generator=generator)
