"""The frozen reference against the port on the CPU at mel-12, so that the
reference is itself checked: the transform, both models' demix through the
Separator's chunk batches, and three train steps, offline and realtime."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

DATA = Path(__file__).resolve().parent / "data"
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import system  # noqa: E402
import weights as weightlib  # noqa: E402
from reference import models  # noqa: E402
from reference.demix import Demixer, chunk_plan  # noqa: E402
from reference.slicqt import PlainSliCQT  # noqa: E402
from traffic import train_steps  # noqa: E402

CPU = torch.device("cpu")


def config(name):
    return json.loads((DATA / f"{name}.json").read_text())


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_transform_matches_the_port():
    from xumx_slicq_torch.ops.slicqt import SliCQT

    ref, port = PlainSliCQT("mel", 12, 200.0), SliCQT(scale="mel", fbins=12, fmin=200.0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 2, 20000)).astype(np.float32))
    for a, b in zip(ref.forward(x), port.forward(x)):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    blocks = ref.forward(x)
    assert float((ref.backward(blocks, 20000) - port.backward(list(blocks), 20000)).abs().max()) <= 1e-6


def test_weights_fill_every_leaf_of_the_port_in_range():
    cfg = config("tiny_cdae")
    w = system.make_weights(cfg, 2**31 + 11, CPU)
    _, model, _ = system._unmix(cfg, CPU)
    system.load_weights(model, w)
    sd = model.state_dict()
    for name, shape, init in models.param_spec(cfg, system._reference_shapes(cfg)):
        lo, hi = weightlib._range(init, shape)
        assert sd[name].shape == shape and lo <= float(sd[name].min()) and float(sd[name].max()) <= hi
    assert torch.equal(w["blocks.0.enc1_w"], system.make_weights(cfg, 2**31 + 11, CPU)["blocks.0.enc1_w"])


@pytest.mark.parametrize("name,n", [("tiny_cdae", 20000), ("tiny_cdae", 70000), ("tiny_lstm", 20000),
                                    ("tiny_cdae_rt", 20000)])
def test_demix_matches_the_separator(name, n):
    cfg = config(name)
    w = system.make_weights(cfg, 5, CPU)
    audio = (np.random.default_rng(4).standard_normal((1, 2, n)) * 0.1).astype(np.float32)
    stems = system.separator(cfg, w, CPU).forward(audio)[:, 0]
    ref = Demixer(cfg, w, CPU).demix([audio[0]])[0]
    assert stems.shape == ref.shape
    assert float(np.abs(stems - ref).max()) <= 1e-5 * float(np.abs(ref).max())


def test_chunk_plan_pads_to_the_buckets():
    assert chunk_plan(5 * 1000, 1000, 100) == (1000, 5, [(0, 5, 8)])
    assert chunk_plan(9 * 1000, 1000, 100)[2] == [(c, 1, 1) for c in range(9)]
    assert chunk_plan(700, 1000, 100) == (700, 1, [(0, 1, 1)])


@pytest.mark.parametrize("name", ["tiny_cdae", "tiny_cdae_rt"])
def test_three_train_steps_match_the_port(name):
    cfg = config(name)
    p = json.loads((DATA / "tiny_train.json").read_text())
    batches = train_steps.make_batches(p, 2, 44100.0, 9, CPU)
    step, model, opt = system.train_step(cfg, system.make_weights(cfg, 9, CPU), CPU, p["lr"], p["weight_decay"])
    prog = train_steps.first_steps(step, model, opt, batches, CPU)
    ref = train_steps.reference_steps(cfg, system.make_weights(cfg, 9, CPU), batches, CPU, p)
    got = train_steps.compare(prog, ref)
    assert got["loss_gap"] <= 1e-5 and got["grad_gap"] <= 1e-4 and got["change_gap"] <= 1e-2
