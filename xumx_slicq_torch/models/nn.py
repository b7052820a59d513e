"""Small NN helpers with the JAX package's semantics (xumx_slicq_tpu/models/nn.py).

Convolutions are torch's own (`F.conv2d`, `F.conv_transpose2d`, cuDNN on the
card): the JAX package's weights already use torch layouts (OIHW, and IOHW
for transposed convs). What stays here is BatchNorm, the bf16 operand
boundary of mixed-precision training, and the default conv initialisation,
written out so that both packages compute the same thing.

In training across ranks (parallel/mesh.py) BatchNorm's statistics are the
global batch's, as the JAX package's sync-BN computes them over the sharded
batch (xumx_slicq_tpu/models/nn.py:79-95, a two-pass `jnp.var`): each rank
forms its rows' count, mean and sum of squared deviations in two passes,
the dp group gathers them in one differentiable collective, and every rank
merges them (Chan et al.). A variance formed in one pass as E[x^2] - m^2
cancels in float32 when |mean| >> std.
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
    mesh's dp group (keepdim). Each rank's count n_i, mean m_i and sum of
    squared deviations M2_i (two passes over its rows) are gathered in one
    differentiable collective and merged as Chan et al.'s pairwise update:
    n = sum n_i, m = sum n_i m_i / n, M2 = sum M2_i + n_i (m_i - m)^2,
    v = M2 / n. The few numbers exchanged and merged are float64: a float32
    m_i carries ulp(m_i), which the merge's (m_i - m)^2 would turn into a
    relative error of the variance ~ |mean| / std * 1e-7. The running
    buffers `mean` and `var` (views broadcastable to the statistics) are
    updated in place with the unbiased variance by the global count."""
    m_i = x.mean(dims, keepdim=True, dtype=torch.float64)
    k = m_i.numel()
    m2_i = ((x - m_i.to(x.dtype)) ** 2).sum(dims, keepdim=True, dtype=torch.float64)
    count = m_i.new_full((1,), x.numel() // k)
    g = mesh.gather_rows(torch.cat([m_i.reshape(-1), m2_i.reshape(-1), count]))    # (dp, 2k + 1)
    ns, ms, m2s = g[:, -1:], g[:, :k], g[:, k: 2 * k]      # tensors: no host sync
    n = ns.sum()
    m = (ns * ms).sum(0) / n
    v = ((m2s + ns * (ms - m) ** 2).sum(0) / n).view(m_i.shape).to(x.dtype)
    m = m.view(m_i.shape).to(x.dtype)
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
