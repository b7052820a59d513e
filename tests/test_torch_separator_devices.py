"""The Separator over several devices (`devices=[...]`, `inference
--n-devices`) against the single-device Separator, on the CPU.

The cases of tests/test_separator.py:61-109 for the JAX package's mesh
Separator: three chunks (one wave, a chunk batch of 2 a device), a long
track in several waves, batched input, short input; over two and four
devices, which here are copies on the CPU. The CDAE's stems do not
depend on the chunk batching, so they must agree to float rounding (the
bound the JAX test holds, 2e-5).

The LSTM's stems do depend on it (models/lstm.py): the JAX mesh runs each
wave as one program on a chunk batch of bucket x n_dev chunks, zero chunks
included. So an LSTM model over several devices, and `forward_device` on
one, is held at the same bound to the one-device `_chunk_fn` on those zero-
padded wave batches, formed here independently of the Separator's code
(`wave_batches_reference`). The port's one-device `_chunk_fn` is held to
the JAX package's in tests/test_torch_lstm.py. The LSTM cases run at a
chunk of 512 samples: the recurrence's plain version walks the frames
one Python step at a time.
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
LSTM_CHUNK = 512


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return port_model_dir(tmp_path_factory.mktemp("model"))


@pytest.fixture(scope="module")
def single(model_dir):
    return Separator.load(model_path=model_dir, device=DEVICE, chunk_size=CHUNK)


@pytest.fixture(scope="module")
def lstm_seps(tmp_path_factory):
    """separator(realtime, n_dev): the mel-12 LSTM model (weights from the
    seed) on the CPU, as n_dev devices, one Separator a key."""
    dirs = {rt: port_model_dir(tmp_path_factory.mktemp("lstm"), lstm=True, realtime=rt) for rt in (False, True)}
    seps = {}

    def separator(realtime: bool, n_dev: int) -> Separator:
        if (realtime, n_dev) not in seps:
            where = dict(device=DEVICE) if n_dev == 1 else dict(devices=[DEVICE] * n_dev)
            seps[realtime, n_dev] = Separator.load(model_path=dirs[realtime], chunk_size=LSTM_CHUNK, **where)
        return seps[realtime, n_dev]

    return separator


def wave_batches_reference(sep: Separator, x: np.ndarray, n_dev: int, buckets=(1, 2, 4, 8)) -> np.ndarray:
    """(B, C, N) -> (4, B, C, N): each item's chunks in the JAX package's
    waves over n_dev devices (xumx_slicq_tpu/separator.py:164-185): at most
    max(buckets) n_dev chunks a wave, zero-padded to a chunk batch of
    b n_dev, b the least of the buckets that holds them, each batch through
    the one-device `_chunk_fn` of `sep`."""
    B, C, N = x.shape
    chunk = min(sep.chunk_size, max(N, sep.slicqt.sllen // 2 + 1))
    nchunks = -(-N // chunk)
    cap = buckets[-1] * n_dev
    out = np.zeros((4, B, C, nchunks * chunk), np.float32)
    for b in range(B):
        padded = np.zeros((C, nchunks * chunk), np.float32)
        padded[:, :N] = x[b]
        chunks = padded.reshape(C, nchunks, chunk).transpose(1, 0, 2)
        for ci in range(0, nchunks, cap):
            take = min(nchunks - ci, cap)
            batch = np.zeros((next(k for k in buckets if k * n_dev >= take) * n_dev, C, chunk), np.float32)
            batch[:take] = chunks[ci: ci + take]
            with torch.inference_mode():
                est = sep._chunk_fn(torch.from_numpy(batch))[:, :take].numpy()      # (4, take, C, chunk)
            for k in range(take):
                out[:, b, :, (ci + k) * chunk: (ci + k + 1) * chunk] = est[:, k]
    return out[..., :N]


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


@pytest.mark.parametrize(("n_dev", "realtime"), [(2, False), (4, False), (2, True)],
                         ids=["2-offline", "4-offline", "2-realtime"])
@pytest.mark.parametrize("shape", [(1, 2, 2 * LSTM_CHUNK + 300), "waves", (2, 2, LSTM_CHUNK + 50), (1, 2, 100),
                                   (1, 2, LSTM_CHUNK - 50)],
                         ids=["three_chunks", "waves", "batched", "short", "one_chunk"])
def test_lstm_devices_match_wave_batches(lstm_seps, realtime, n_dev, shape):
    """An LSTM model over n_dev devices: the stems of the wave batches
    (one_chunk and short: one chunk padded to a batch of n_dev). The
    realtime model shares the offline one's batching and runs on 2 devices
    only (the plain recurrence's Python steps bound these cases). waves:
    with the buckets cut to (1, 2), as tests/test_separator.py:85 cuts
    the JAX mesh's, 2 n_dev + 1 chunks: a full wave (2 a device) and a
    wave of one chunk padded to n_dev."""
    many = lstm_seps(realtime, n_dev)
    assert many.model.lstm and many.model.realtime is realtime and len(many.replicas) == n_dev
    buckets = (1, 2) if shape == "waves" else many._CHUNK_BATCH_BUCKETS
    if shape == "waves":
        shape = (1, 2, (2 * n_dev + 1) * LSTM_CHUNK + 11)
    x = noise(sum(shape) + n_dev, shape, 0.1)
    many._CHUNK_BATCH_BUCKETS = buckets
    try:
        a = many(x)
    finally:
        del many._CHUNK_BATCH_BUCKETS
    assert a.shape == (4, shape[0], 2, shape[2]) and np.isfinite(a).all()
    np.testing.assert_allclose(a, wave_batches_reference(lstm_seps(realtime, 1), x, n_dev, buckets), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("n_dev", [1, 2])
def test_lstm_forward_device_matches_wave_batches(lstm_seps, n_dev):
    """forward_device of an LSTM model on 10 chunks: on one device waves of
    8 and 2 chunks (JAX separator.py:286), on two one wave of 16."""
    x = noise(10 + n_dev, (1, 2, 10 * LSTM_CHUNK - 7), 0.1)
    a = lstm_seps(False, n_dev).forward_device(torch.from_numpy(x))
    assert a.shape == (4, 1, 2, x.shape[-1]) and a.device == torch.device(DEVICE)
    np.testing.assert_allclose(a.numpy(), wave_batches_reference(lstm_seps(False, 1), x, n_dev), rtol=0,
                               atol=ATOL)


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
