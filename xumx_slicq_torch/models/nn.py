"""Small NN helpers with the JAX package's semantics (xumx_slicq_tpu/models/nn.py).

Convolutions are torch's own (`F.conv2d`, `F.conv_transpose2d`, cuDNN on the
card): the JAX package's weights already use torch layouts (OIHW, and IOHW
for transposed convs). What stays here is BatchNorm, the bf16 operand
boundary of mixed-precision training, and the default conv initialisation,
written out so that both packages compute the same thing.

In training across ranks (parallel/mesh.py) BatchNorm's statistics are the
global batch's: each rank all-reduces its (sum, sum of squares, count) over
its dp group, differentiably, as the JAX package's sync-BN does over the
sharded batch (xumx_slicq_tpu/models/nn.py:79-95).
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


def _global_moments(x: torch.Tensor, dims, mean: torch.Tensor, var: torch.Tensor, momentum: float, mesh):
    """The mean and biased variance of x over `dims` and over the ranks of
    mesh's dp group (keepdim), from one differentiable all-reduce of
    (sum, sum of squares, count); the running buffers `mean` and `var`
    (views broadcastable to the statistics) updated in place with the
    unbiased variance by the global count."""
    s1 = x.sum(dims, keepdim=True)
    s2 = (x * x).sum(dims, keepdim=True)
    count = x.new_full((1,), x.numel() // s1.numel())
    tot = mesh.sync_sum(torch.cat([s1.reshape(-1), s2.reshape(-1), count]))
    n = tot[-1]                                    # a tensor: no host sync
    m = tot[: s1.numel()].view(s1.shape) / n
    v = torch.clamp(tot[s1.numel(): 2 * s1.numel()].view(s1.shape) / n - m * m, min=0.0)
    with torch.no_grad():
        mean.copy_((1 - momentum) * mean + momentum * m.view(mean.shape))
        var.copy_((1 - momentum) * var + momentum * (v * (n / torch.clamp(n - 1, min=1))).view(var.shape))
    return m, v


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5,
               train: bool = False, momentum: float = 0.1, mesh=None) -> torch.Tensor:
    """BatchNorm2d over NCHW (nn.py:69-99). Eval: normalise with the
    running statistics. Train: normalise with the batch's mean and biased
    variance, and update the running buffers `mean` and `var` in place with
    the unbiased variance at `momentum`, as torch and the JAX package do.
    With a `mesh` of dp > 1 the batch is the dp group's global batch."""
    if train and mesh is not None and mesh.dp > 1:
        m, v = _global_moments(x, (0, 2, 3), mean, var, momentum, mesh)
        inv = torch.rsqrt(v + eps)
        return (x - m) * (inv * scale[None, :, None, None]) + bias[None, :, None, None]
    if train:
        return Fn.batch_norm(x, mean, var, scale, bias, training=True, momentum=momentum, eps=eps)
    inv = torch.rsqrt(var + eps)
    y = (x - mean[None, :, None, None]) * (inv * scale)[None, :, None, None]
    return y + bias[None, :, None, None]


def batch_norm1d(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5,
                 train: bool = False, momentum: float = 0.1, mesh=None) -> torch.Tensor:
    """BatchNorm1d over the last axis (features) of x (..., rows, features),
    statistics over the rows, in the JAX package's order of operations
    (lstm.py:127-142). Eval: the running statistics. Train: the batch's
    mean and biased variance, and the running buffers `mean` and `var`
    (broadcastable views of x's statistics) updated in place with the
    unbiased variance n / max(n - 1, 1) at `momentum`. With a `mesh` of
    dp > 1 the rows are the dp group's."""
    if train and mesh is not None and mesh.dp > 1:
        mean, var = _global_moments(x, (-2,), mean, var, momentum, mesh)
    elif train:
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
