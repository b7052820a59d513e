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

The LSTM variant (port: models/lstm.SlicedLSTM, (target, direction) axes
leading each LSTM weight) uses the reference's `sliced_umx.{i}.layer1s.{t}`
(Linear 0 + BatchNorm1d 1, present only where F > 10), `lstms.{t}.
{weight,bias}_{ih,hh}_l{l}[_reverse]`, `layer2s.{t}` (Linear 0 +
BatchNorm1d 1) and `layer3s.{t}.0` names (torch_import.py:73-129).

The JAX package's own file, `params.msgpack` (flax's `to_bytes` of its
pytrees), is read and written by `load_params_msgpack` and
`params_msgpack_bytes`, through `flax_msgpack` (plain Python) and the
tree maps here.
"""

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from . import flax_msgpack
from .cdae import NB_TARGETS
from .lstm import NB_LAYERS

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


_LSTM_NAMES = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih", "b_hh": "bias_hh"}
_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def _np(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def lstm_params_from_jax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """JAX LSTM pytrees (as numpy arrays) -> the port's state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for i, (p, bs) in enumerate(zip(params["blocks"], batch_stats["blocks"])):
        pre = f"blocks.{i}."
        bns = ["bn2"] + (["bn1"] if "fc1_w" in p else [])
        if "fc1_w" in p:
            sd[pre + "fc1_w"] = _np(p["fc1_w"])
        for layer, lp in enumerate(p["lstm"]):
            sfxs = ["", "_reverse"] if "w_ih_reverse" in lp else [""]
            for name in _LSTM_NAMES:
                sd[pre + f"{name}_l{layer}"] = _np(np.stack([np.asarray(lp[name + sfx]) for sfx in sfxs], axis=1))
        for name in ("fc2_w", "fc3_w", "fc3_b", "input_mean", "input_scale"):
            sd[pre + name] = _np(p[name])
        for bn in bns:
            sd[pre + f"{bn}.weight"] = _cat_targets(p[bn]["scale"])
            sd[pre + f"{bn}.bias"] = _cat_targets(p[bn]["bias"])
            sd[pre + f"{bn}.running_mean"] = _cat_targets(bs[bn]["mean"])
            sd[pre + f"{bn}.running_var"] = _cat_targets(bs[bn]["var"])
            sd[pre + f"{bn}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def is_lstm_state_dict(sd: Mapping) -> bool:
    """Whether a reference-named state_dict holds the LSTM variant."""
    return "sliced_umx.0.lstms.0.weight_ih_l0" in sd


def _n_blocks(sd: Mapping) -> int:
    ids = {int(m.group(1)) for k in sd for m in [re.match(r"sliced_umx\.(\d+)\.input_mean$", k)] if m}
    if not ids or ids != set(range(len(ids))):
        raise ValueError("not a reference CDAE state_dict: sliced_umx.{i}.input_mean entries missing")
    return len(ids)


def load_reference_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """Reference-named CDAE or LSTM state_dict (values: tensors or arrays)
    -> the port's state_dict (the names import_cdae_state_dict and
    import_lstm_state_dict read, torch_import.py:33-129)."""

    def stack(key):
        return _cat_targets(np.stack([np.asarray(sd[key.format(t=t)]) for t in range(NB_TARGETS)]))

    if is_lstm_state_dict(sd):
        return _load_reference_lstm(sd)
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


def _load_reference_lstm(sd: Mapping) -> Dict[str, torch.Tensor]:
    """The LSTM branch of load_reference_state_dict. A bucket has the
    down-projection where `layer1s.{t}.0.weight` is present, which is
    F > 10 (lstm.py:41-43), whatever F * C is."""

    def stack(key, dirs=None):
        if dirs is None:                                   # (4, ...)
            return _np(np.stack([np.asarray(sd[key.format(t=t)]) for t in range(NB_TARGETS)]))
        return _np(np.stack([np.stack([np.asarray(sd[key.format(t=t, sfx=sfx)]) for sfx in dirs])
                             for t in range(NB_TARGETS)]))     # (4, dirs, ...)

    def bn(out, pre, ref):
        for k in _BN_KEYS:
            out[pre + k] = _cat_targets(np.stack([np.asarray(sd[ref.format(t=t) + k]) for t in range(NB_TARGETS)]))
        out[pre + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    out: Dict[str, torch.Tensor] = {}
    for i in range(_n_blocks(sd)):
        ref, pre = f"sliced_umx.{i}.", f"blocks.{i}."
        if ref + "layer1s.0.0.weight" in sd:
            out[pre + "fc1_w"] = stack(ref + "layer1s.{t}.0.weight")
            bn(out, pre + "bn1.", ref + "layer1s.{t}.1.")
        dirs = ("", "_reverse") if ref + "lstms.0.weight_ih_l0_reverse" in sd else ("",)
        layer = 0
        while ref + f"lstms.0.weight_ih_l{layer}" in sd:
            for name, ref_name in _LSTM_NAMES.items():
                out[pre + f"{name}_l{layer}"] = stack(ref + f"lstms.{{t}}.{ref_name}_l{layer}{{sfx}}", dirs)
            layer += 1
        out[pre + "fc2_w"] = stack(ref + "layer2s.{t}.0.weight")
        bn(out, pre + "bn2.", ref + "layer2s.{t}.1.")
        out[pre + "fc3_w"] = stack(ref + "layer3s.{t}.0.weight")
        out[pre + "fc3_b"] = stack(ref + "layer3s.{t}.0.bias")
        out[pre + "input_mean"] = _np(sd[ref + "input_mean"])
        out[pre + "input_scale"] = _np(sd[ref + "input_scale"])
    return out


def _to_reference_lstm(model) -> Dict[str, torch.Tensor]:
    """The LSTM branch of to_reference_state_dict."""
    out: Dict[str, torch.Tensor] = {}
    n = NB_TARGETS

    def cpu(t):
        return t.detach().to("cpu", torch.float32)

    def bn(ref, mod):
        parts = {k: cpu(getattr(mod, k)).reshape(n, -1) for k in _BN_KEYS}
        for t in range(n):
            for k, v in parts.items():
                out[ref.format(t=t) + k] = v[t].clone()
            out[ref.format(t=t) + "num_batches_tracked"] = mod.num_batches_tracked.detach().cpu().clone()

    for i, blk in enumerate(model.blocks):
        ref = f"sliced_umx.{i}."
        sfxs = ["", "_reverse"][: blk.dirs]
        for t in range(n):
            if blk.downsample:
                out[ref + f"layer1s.{t}.0.weight"] = cpu(blk.fc1_w[t]).clone()
            for layer in range(NB_LAYERS):
                for name, ref_name in _LSTM_NAMES.items():
                    w = cpu(getattr(blk, f"{name}_l{layer}"))
                    for d, sfx in enumerate(sfxs):
                        out[ref + f"lstms.{t}.{ref_name}_l{layer}{sfx}"] = w[t, d].clone()
            out[ref + f"layer2s.{t}.0.weight"] = cpu(blk.fc2_w[t]).clone()
            out[ref + f"layer3s.{t}.0.weight"] = cpu(blk.fc3_w[t]).clone()
            out[ref + f"layer3s.{t}.0.bias"] = cpu(blk.fc3_b[t]).clone()
        if blk.downsample:
            bn(ref + "layer1s.{t}.1.", blk.bn1)
        bn(ref + "layer2s.{t}.1.", blk.bn2)
        out[ref + "input_mean"] = cpu(blk.input_mean).clone()
        out[ref + "input_scale"] = cpu(blk.input_scale).clone()
    return out


def to_reference_state_dict(model) -> Dict[str, torch.Tensor]:
    """The port's Unmix weights under the reference's names, as CPU
    tensors: `torch.save` it as `xumx_slicq_v2.pth` (or
    `xumx_slicq_tpu.pth`) and both packages' Separator.load read it."""
    if getattr(model, "lstm", False):
        return _to_reference_lstm(model)
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


# -- the JAX package's own weights: params.msgpack ---------------------------------

PARAMS_FILE = "params.msgpack"


def _split_targets(t: torch.Tensor) -> np.ndarray:
    """(4*d0, ...) target-major tensor -> (4, d0, ...) float32 array."""
    a = t.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(a.reshape(NB_TARGETS, a.shape[0] // NB_TARGETS, *a.shape[1:]))


def _arr(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().to("cpu", torch.float32).numpy())


def jax_trees(model):
    """The inverse of params_from_jax / lstm_params_from_jax: a 4-target
    Unmix's weights as the JAX package's (params, batch_stats) pytrees of
    NumPy arrays ({"blocks": [...]}, the trees `Unmix.init` returns)."""
    blocks, stats = [], []
    for blk in model.blocks:
        if getattr(blk, "targets", NB_TARGETS) != NB_TARGETS:
            raise ValueError("jax_trees needs the 4-target model (gather a target-parallel run's state first)")
        p, s = {}, {}
        bns = _BNS if not model.lstm else (["bn1"] if blk.downsample else []) + ["bn2"]
        if model.lstm:
            sfxs = ["", "_reverse"][: blk.dirs]
            if blk.downsample:
                p["fc1_w"] = _arr(blk.fc1_w)
            p["lstm"] = [{name + sfx: _arr(getattr(blk, f"{name}_l{layer}")[:, d])
                          for name in _LSTM_NAMES for d, sfx in enumerate(sfxs)} for layer in range(NB_LAYERS)]
            for name in ("fc2_w", "fc3_w", "fc3_b"):
                p[name] = _arr(getattr(blk, name))
        else:
            for name in list(_CONVS) + ["dec2_b"]:
                p[name] = _split_targets(getattr(blk, name))
        p["input_mean"], p["input_scale"] = _arr(blk.input_mean), _arr(blk.input_scale)
        for bn in bns:
            mod = getattr(blk, bn)
            p[bn] = {"scale": _split_targets(mod.weight), "bias": _split_targets(mod.bias)}
            s[bn] = {"mean": _split_targets(mod.running_mean), "var": _split_targets(mod.running_var)}
        blocks.append(p)
        stats.append(s)
    return {"blocks": blocks}, {"blocks": stats}


def params_msgpack_bytes(model) -> bytes:
    """The bytes of the JAX package's `params.msgpack` for this model:
    flax.serialization.to_bytes({"params", "batch_stats"})."""
    params, batch_stats = jax_trees(model)
    return flax_msgpack.to_bytes({"params": params, "batch_stats": batch_stats})


def load_params_msgpack(path) -> Tuple[Dict[str, torch.Tensor], bool]:
    """A `params.msgpack` (the JAX package's, or `params_msgpack_bytes`')
    -> (the port's state_dict, whether it holds the LSTM variant). An LSTM
    bucket has the down-projection where its tree has `fc1_w`, which the
    JAX package's init writes for F > 10."""
    with open(path, "rb") as f:
        blob = flax_msgpack.restore(f.read())

    def tree(node):
        if isinstance(node, dict) and node and all(isinstance(k, str) and k.isdigit() for k in node):
            return [tree(v) for v in flax_msgpack.as_list(node)]
        if isinstance(node, dict):
            return {k: tree(v) for k, v in node.items()}
        return node

    params, batch_stats = tree(blob["params"]), tree(blob["batch_stats"])
    lstm = "lstm" in params["blocks"][0]
    convert = lstm_params_from_jax if lstm else params_from_jax
    return convert(params, batch_stats), lstm
