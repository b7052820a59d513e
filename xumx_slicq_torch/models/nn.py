"""Small NN helpers with the JAX package's semantics (xumx_slicq_tpu/models/nn.py).

Convolutions are torch's own (`F.conv2d`, `F.conv_transpose2d`, cuDNN on the
card): the JAX package's weights already use torch layouts (OIHW, and IOHW
for transposed convs). What stays here is BatchNorm, the bf16 operand
boundary of mixed-precision training, and the default conv initialisation,
written out so that both packages compute the same thing.
"""

import torch
import torch.nn.functional as Fn


def amp_op(op, *operands, amp: bool):
    """The bf16 boundary of mixed-precision training (nn.py:19-30): with
    amp, the operands are cast to bf16 and the result back to float32, so
    the convs run in bf16 on both passes while BatchNorm, Wiener-EM and the
    losses stay float32. Explicit casts, not torch.autocast, so that
    nothing else changes precision."""
    if not amp:
        return op(*operands)
    return op(*(o.to(torch.bfloat16) for o in operands)).to(torch.float32)


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5,
               train: bool = False, momentum: float = 0.1) -> torch.Tensor:
    """BatchNorm2d over NCHW (nn.py:69-99). Eval: normalise with the
    running statistics. Train: normalise with the batch's mean and biased
    variance, and update the running buffers `mean` and `var` in place with
    the unbiased variance at `momentum`, as torch and the JAX package do."""
    if train:
        return Fn.batch_norm(x, mean, var, scale, bias, training=True, momentum=momentum, eps=eps)
    inv = torch.rsqrt(var + eps)
    y = (x - mean[None, :, None, None]) * (inv * scale)[None, :, None, None]
    return y + bias[None, :, None, None]


def batch_norm1d(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5,
                 train: bool = False, momentum: float = 0.1) -> torch.Tensor:
    """BatchNorm1d over the last axis (features) of x (..., rows, features),
    statistics over the rows, in the JAX package's order of operations
    (lstm.py:127-142). Eval: the running statistics. Train: the batch's
    mean and biased variance, and the running buffers `mean` and `var`
    (broadcastable views of x's statistics) updated in place with the
    unbiased variance n / max(n - 1, 1) at `momentum`."""
    if train:
        n = x.shape[-2]
        batch_mean = x.mean(dim=-2, keepdim=True)
        batch_var = x.var(dim=-2, unbiased=False, keepdim=True)
        with torch.no_grad():
            mean.copy_((1 - momentum) * mean + momentum * batch_mean)
            var.copy_((1 - momentum) * var + momentum * (batch_var * (n / max(n - 1, 1))))
        mean, var = batch_mean, batch_var
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def kaiming_uniform_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """torch's Conv2d default init, kaiming_uniform(a=sqrt(5)):
    U(-sqrt(1/fan_in), sqrt(1/fan_in)). The caller passes the fan-in of
    the layer's own layout (for a transposed conv, out_ch * kh * kw)."""
    bound = (1.0 / fan_in) ** 0.5
    with torch.no_grad():
        return w.uniform_(-bound, bound, generator=generator)
