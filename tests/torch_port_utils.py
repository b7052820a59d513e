"""Shared helpers for the PyTorch port's tests (tests/test_torch_*.py).

Both packages get the same numpy inputs, made from a seed; the port runs
on the CPU (device="cpu", one thread, as several test workers share the
machine), the JAX package on its CPU backend (tests/conftest.py).
"""

import numpy as np
import torch

torch.set_num_threads(1)

DEVICE = "cpu"
SR = 44100
# the JAX package's test geometry (tests/test_separator.py:17-20)
MEL12 = dict(scale="mel", fbins=12, fmin=200.0)
TINY_ARGS = dict(
    fscale="mel", fbins=12, fmin=200.0, sample_rate=44100.0, seq_dur=0.3,
    nb_channels=2, realtime=False, lstm=False,
)
TINY_LEN = int(0.3 * SR)


def noise(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def complex_noise(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * scale).astype(np.complex64)


def to_np(a) -> np.ndarray:
    """numpy view of a torch tensor or a jax array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def rel_err(a, b) -> float:
    """max |a - b| / max |b|."""
    a, b = to_np(a), to_np(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def blocks_rel_err(xs, ys) -> float:
    """Worst rel_err over two lists of blocks."""
    assert len(xs) == len(ys)
    return max(rel_err(x, y) for x, y in zip(xs, ys))
