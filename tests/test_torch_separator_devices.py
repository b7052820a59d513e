"""The Separator over several devices (`devices=[...]`, `inference
--n-devices`) against the single-device Separator, on the CPU.

The cases of tests/test_separator.py:61-109 for the JAX package's mesh
Separator: three chunks (one wave, a chunk batch of 2 a device), a long
track in several waves, batched input, short input; over two and four
devices, which here are copies on the CPU. The CDAE's stems do not depend on
the chunk batching, so they must agree to float rounding (the bound the JAX
test holds, 2e-5).
"""

import numpy as np
import pytest
import torch

from torch_port_utils import DEVICE, noise, port_model_dir

from xumx_slicq_torch import audio
from xumx_slicq_torch.inference import inference_main
from xumx_slicq_torch.separator import Separator

ATOL = 2e-5
CHUNK = 16384


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return port_model_dir(tmp_path_factory.mktemp("model"))


@pytest.fixture(scope="module")
def single(model_dir):
    return Separator.load(model_path=model_dir, device=DEVICE, chunk_size=CHUNK)


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("shape", [(1, 2, 2 * CHUNK + 3000), "waves", (2, 2, CHUNK + 500), (1, 2, 100)],
                         ids=["three_chunks", "waves", "batched", "short"])
def test_devices_match_single_device(model_dir, single, n_dev, shape):
    """waves: 8 n_dev + 2 chunks, a full wave (a chunk batch of 8 a device)
    and a wave of 2 chunks (1 a device on the first two)."""
    if shape == "waves":
        shape = (1, 2, (8 * n_dev + 1) * CHUNK + 11)
    many = Separator.load(model_path=model_dir, devices=[DEVICE] * n_dev, chunk_size=CHUNK)
    assert len(many.replicas) == n_dev and many.replicas[0] is many
    x = noise(sum(shape), shape, 0.1)
    a, b = many(x), single(x)
    assert a.shape == b.shape == (4, shape[0], 2, shape[2])
    np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def test_devices_forward_device_and_waves(model_dir, single):
    """forward_device over 2 devices keeps the single device's result, and
    the waves take the JAX package's buckets."""
    many = Separator.load(model_path=model_dir, devices=[DEVICE, DEVICE], chunk_size=CHUNK)
    x = torch.from_numpy(noise(3, (1, 2, 20 * CHUNK), 0.1))
    np.testing.assert_allclose(many.forward_device(x).numpy(), single.forward_device(x).numpy(), rtol=0,
                               atol=ATOL)
    seen = []
    est = many._waves(CHUNK, 20, lambda lo, nb, dev: seen.append((lo, nb)) or torch.zeros((nb, 2, CHUNK)))
    assert seen == [(0, 8), (8, 8), (16, 2), (18, 2)] and est.shape == (4, 20, 2, CHUNK)


def test_devices_exclusive_with_device(model_dir):
    with pytest.raises(ValueError, match="either device or devices"):
        Separator.load(model_path=model_dir, device=DEVICE, devices=[DEVICE])


def test_inference_cli_n_devices(model_dir, tmp_path):
    indir = tmp_path / "in"
    indir.mkdir()
    x = noise(2, (2, 3 * CHUNK + 5), 0.1)
    audio.save_audio(indir / "song.wav", x, 44100)
    outs = {}
    for n in (1, 2):
        out = tmp_path / f"out{n}"
        inference_main(["--input-dir", str(indir), "--output-dir", str(out), "--model-path", str(model_dir),
                        "--device", "cpu", "--chunk-size", str(CHUNK), "--n-devices", str(n)])
        outs[n] = {s: audio.load_audio(out / "song" / f"{s}.wav")[0] for s in Separator.sources}
    for s in Separator.sources:
        np.testing.assert_allclose(outs[2][s], outs[1][s], rtol=0, atol=ATOL)
