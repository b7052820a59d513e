"""Weight conversion between the port, the JAX package and reference checkpoints.

Counterpart of xumx_slicq_tpu/models/torch_import.py. Three layouts:

* the port's own `state_dict`: per bucket `blocks.{i}.enc1_w` etc. with the
  4 targets stacked along the output (or, for transposed convs, input)
  channel axis, and `blocks.{i}.bn{1,2,3}.*` BatchNorm2d entries;
* the JAX package's pytrees: {"blocks": [...]} with a leading target axis;
* the reference's torch checkpoint (sevagh/xumx-sliCQ-V2): per bucket
  `sliced_umx.{i}.cdaes.{t}.{layer}.*` with conv layers 0/3/6/9 and
  BatchNorms 1/4/7, plus `sliced_umx.{i}.input_mean` / `input_scale`.
  The JAX package's `load_torch_params` reads that layout, so a checkpoint
  written by `to_reference_state_dict` loads in both packages.
"""

import re
from typing import Dict, Mapping

import numpy as np
import torch

from .cdae import NB_TARGETS

_CONVS = {"enc1_w": 0, "enc2_w": 3, "dec1_w": 6, "dec2_w": 9}
_BNS = {"bn1": 1, "bn2": 4, "bn3": 7}


def _cat_targets(a) -> torch.Tensor:
    """(4, d0, ...) target-stacked array -> (4*d0, ...) float32 tensor."""
    a = torch.from_numpy(np.array(a, np.float32))
    return a.reshape(a.shape[0] * a.shape[1], *a.shape[2:])


def params_from_jax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """JAX CDAE pytrees (as numpy arrays) -> the port's state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for i, (p, bs) in enumerate(zip(params["blocks"], batch_stats["blocks"])):
        pre = f"blocks.{i}."
        for name in _CONVS:
            sd[pre + name] = _cat_targets(p[name])
        sd[pre + "dec2_b"] = _cat_targets(p["dec2_b"])
        sd[pre + "input_mean"] = torch.from_numpy(np.array(p["input_mean"], np.float32))
        sd[pre + "input_scale"] = torch.from_numpy(np.array(p["input_scale"], np.float32))
        for bn in _BNS:
            sd[pre + f"{bn}.weight"] = _cat_targets(p[bn]["scale"])
            sd[pre + f"{bn}.bias"] = _cat_targets(p[bn]["bias"])
            sd[pre + f"{bn}.running_mean"] = _cat_targets(bs[bn]["mean"])
            sd[pre + f"{bn}.running_var"] = _cat_targets(bs[bn]["var"])
            sd[pre + f"{bn}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def _n_blocks(sd: Mapping) -> int:
    ids = {int(m.group(1)) for k in sd for m in [re.match(r"sliced_umx\.(\d+)\.input_mean$", k)] if m}
    if not ids or ids != set(range(len(ids))):
        raise ValueError("not a reference CDAE state_dict: sliced_umx.{i}.input_mean entries missing")
    return len(ids)


def load_reference_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """Reference-named CDAE state_dict (values: tensors or arrays) -> the
    port's state_dict (the names import_cdae_state_dict reads,
    torch_import.py:33-70)."""

    def stack(key):
        return _cat_targets(np.stack([np.asarray(sd[key.format(t=t)]) for t in range(NB_TARGETS)]))

    out: Dict[str, torch.Tensor] = {}
    for i in range(_n_blocks(sd)):
        ref, pre = f"sliced_umx.{i}.", f"blocks.{i}."
        c = ref + "cdaes.{t}."
        for name, layer in _CONVS.items():
            out[pre + name] = stack(c + f"{layer}.weight")
        out[pre + "dec2_b"] = stack(c + "9.bias")
        out[pre + "input_mean"] = torch.from_numpy(np.array(sd[ref + "input_mean"], np.float32))
        out[pre + "input_scale"] = torch.from_numpy(np.array(sd[ref + "input_scale"], np.float32))
        for bn, layer in _BNS.items():
            out[pre + f"{bn}.weight"] = stack(c + f"{layer}.weight")
            out[pre + f"{bn}.bias"] = stack(c + f"{layer}.bias")
            out[pre + f"{bn}.running_mean"] = stack(c + f"{layer}.running_mean")
            out[pre + f"{bn}.running_var"] = stack(c + f"{layer}.running_var")
            out[pre + f"{bn}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return out


def to_reference_state_dict(model) -> Dict[str, torch.Tensor]:
    """The port's Unmix weights under the reference's names, as CPU
    tensors: `torch.save` it as `xumx_slicq_v2.pth` (or
    `xumx_slicq_tpu.pth`) and both packages' Separator.load read it."""
    out: Dict[str, torch.Tensor] = {}
    n = NB_TARGETS
    for i, blk in enumerate(model.blocks):
        ref = f"sliced_umx.{i}."

        def per_target(t):
            t = t.detach().to("cpu", torch.float32)
            return t.reshape(n, t.shape[0] // n, *t.shape[1:])

        for name, layer in _CONVS.items():
            w = per_target(getattr(blk, name))
            for t in range(n):
                out[ref + f"cdaes.{t}.{layer}.weight"] = w[t].clone()
        b = per_target(blk.dec2_b)
        for t in range(n):
            out[ref + f"cdaes.{t}.9.bias"] = b[t].clone()
        for bn_name, layer in _BNS.items():
            bn = getattr(blk, bn_name)
            parts = {k: per_target(getattr(bn, k)) for k in ("weight", "bias", "running_mean", "running_var")}
            for t in range(n):
                for k, v in parts.items():
                    out[ref + f"cdaes.{t}.{layer}.{k}"] = v[t].clone()
                out[ref + f"cdaes.{t}.{layer}.num_batches_tracked"] = bn.num_batches_tracked.detach().cpu().clone()
        out[ref + "input_mean"] = blk.input_mean.detach().cpu().clone()
        out[ref + "input_scale"] = blk.input_scale.detach().cpu().clone()
    return out
