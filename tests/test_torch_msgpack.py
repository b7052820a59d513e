"""The JAX package's weight file, params.msgpack, in the port.

flax writes it (`serialization.to_bytes({"params", "batch_stats"})`); the
port reads and writes it in plain Python (models/flax_msgpack.py,
models/convert.py). The trees here have the JAX package's exact layout:
the shapes come from `jax.eval_shape` of its `Unmix._init` (a trace, no
compile), the values from a seeded numpy generator.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from torch_port_utils import DEVICE, MEL12, TINY_LEN, noise, port_model_dir

from xumx_slicq_tpu.models import Unmix as JaxUnmix
from xumx_slicq_torch.models import Unmix
from xumx_slicq_torch.models import flax_msgpack
from xumx_slicq_torch.models.convert import (jax_trees, load_params_msgpack, lstm_params_from_jax,
                                             params_from_jax, params_msgpack_bytes)
from xumx_slicq_torch.ops.slicqt import SliCQT
from xumx_slicq_torch.separator import Separator, load_model_weights, save_model_weights

CHUNK = 16384


def _shapes():
    return SliCQT(device=DEVICE, **MEL12).block_shapes(1, 2, TINY_LEN)


def _jax_trees(lstm: bool, seed: int):
    """(params, batch_stats) in the JAX package's layout, numpy values."""
    abstract = jax.eval_shape(JaxUnmix(_shapes(), lstm=lstm)._init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.1 + 0.5).astype(np.float32), abstract)


@pytest.mark.parametrize("lstm", [False, True], ids=["cdae", "lstm"])
def test_reads_flax_params_msgpack(tmp_path, lstm):
    """A file flax wrote gives the state_dict params_from_jax gives, and it
    loads into the port's Unmix."""
    params, stats = _jax_trees(lstm, seed=1)
    path = tmp_path / "params.msgpack"
    path.write_bytes(serialization.to_bytes({"params": params, "batch_stats": stats}))
    sd, is_lstm = load_params_msgpack(path)
    ref = (lstm_params_from_jax if lstm else params_from_jax)(params, stats)
    assert is_lstm is lstm and sorted(sd) == sorted(ref)
    for k in ref:
        assert torch.equal(sd[k], ref[k]), k
    Unmix(_shapes(), lstm=lstm, device=DEVICE).load_state_dict(sd)


@pytest.mark.parametrize("lstm", [False, True], ids=["cdae", "lstm"])
def test_port_params_msgpack_reads_back_in_flax(lstm):
    """The port's bytes: flax decodes them to the port's arrays, in the JAX
    package's tree (from_bytes checks every key against the template), and
    they equal flax's own encoding of that tree."""
    model = Unmix(_shapes(), lstm=lstm, seed=5, device=DEVICE)
    blob = params_msgpack_bytes(model)
    template = dict(zip(("params", "batch_stats"), _jax_trees(lstm, seed=0)))
    restored = serialization.from_bytes(template, blob)
    params, stats = jax_trees(model)
    flat_ours = jax.tree_util.tree_leaves_with_path({"params": params, "batch_stats": stats})
    flat_flax = dict(jax.tree_util.tree_leaves_with_path(restored))
    assert len(flat_ours) == len(flat_flax) > 0
    for path, a in flat_ours:
        np.testing.assert_array_equal(np.asarray(flat_flax[path]), a)
    assert blob == serialization.to_bytes({"params": params, "batch_stats": stats})


def test_codec_round_trip():
    """Every MessagePack type the format uses, against flax's decoder."""
    tree = {"a": [np.arange(300, dtype=np.int64), np.float32(2.5)], "b": {"x": None, "y": True, "z": -70000,
            "f": 1.25, "s": "é" * 40, "e": np.zeros((0, 3), np.float32)}}
    blob = flax_msgpack.to_bytes(tree)
    assert blob == serialization.to_bytes(tree)
    back = flax_msgpack.restore(blob)
    np.testing.assert_array_equal(flax_msgpack.as_list(back["a"])[0], tree["a"][0])
    assert back["a"]["1"] == np.float32(2.5) and back["b"]["z"] == -70000 and back["b"]["s"] == "é" * 40
    with pytest.raises(ValueError):
        flax_msgpack.unpackb(blob[:-3])


def test_separator_loads_params_msgpack_only(tmp_path):
    """A model directory holding only params.msgpack (and its manifest)
    demixes as the .pth route does; params.msgpack wins when both exist."""
    pth_dir = port_model_dir(tmp_path / "pth")
    msg_dir = tmp_path / "msgpack"
    msg_dir.mkdir()
    shutil.copy(pth_dir / "xumx_slicq_v2.json", msg_dir)
    ref = Separator.load(model_path=pth_dir, device=DEVICE, chunk_size=CHUNK)
    save_model_weights(msg_dir, ref.model)
    assert sorted(p.name for p in msg_dir.iterdir()) == ["params.msgpack", "xumx_slicq_v2.json"]
    ours = Separator.load(model_path=msg_dir, device=DEVICE, chunk_size=CHUNK)
    x = noise(4, (1, 2, 2 * CHUNK + 1000), 0.1)
    np.testing.assert_array_equal(ours(x), ref(x))

    other = Unmix(_shapes(), seed=11, device=DEVICE)
    save_model_weights(pth_dir, other)
    sd = load_model_weights(pth_dir)
    assert torch.equal(sd["blocks.0.enc1_w"], other.state_dict()["blocks.0.enc1_w"])
    (msg_dir / "xumx_slicq_v2.json").write_text(json.dumps({"args": {**json.loads(
        (pth_dir / "xumx_slicq_v2.json").read_text())["args"], "lstm": True}}))
    with pytest.raises(ValueError, match="CDAE"):
        Separator.load(model_path=msg_dir, device=DEVICE)
