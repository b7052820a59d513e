"""The cross-rank BatchNorm's statistics (models/nn.py::_global_moments)
against float64, on the CPU.

Each "rank" of a dp group is a thread here, and a stand-in mesh exchanges
their tensors in memory, so no process is spawned. A batch whose mean is
3,000 times its standard deviation is split unevenly over 2 and 3 ranks,
in the layouts of BatchNorm2d (statistics over N, H, W) and of the LSTM's
BatchNorm1d (over the rows). Every rank's merged mean and biased variance
must be within 1e-5 relative of numpy's float64 `np.mean` / `np.var` of
the whole batch (the JAX package's sync-BN is a two-pass `jnp.var` of the
global batch, xumx_slicq_tpu/models/nn.py:85-86), and the running buffers
must be updated as xumx_slicq_tpu/models/nn.py:87-91 updates them. A
variance formed in one pass, E[x^2] - m^2, is off by ~1.3 of itself here in
float32.
"""

import threading

import numpy as np
import pytest
import torch

import torch_port_utils  # noqa: F401  (one intra-op thread)

from xumx_slicq_torch.models.nn import _global_moments

RTOL = 1e-5
MOMENTUM = 0.1
MEAN_OVER_STD = 3000.0


class StandInMesh:
    """One thread's place in an in-memory dp group: the collectives the
    cross-rank BatchNorm calls, forward only."""

    def __init__(self, slots: list, barrier: threading.Barrier, rank: int):
        self.dp, self.dp_rank, self.tp = len(slots), rank, 1
        self._slots, self._barrier = slots, barrier

    def gather_rows(self, flat: torch.Tensor) -> torch.Tensor:
        self._slots[self.dp_rank] = flat.detach().clone()
        self._barrier.wait()
        out = torch.stack(self._slots)
        self._barrier.wait()                  # every rank has read the slots before any writes again
        return out


def _run_ranks(parts, dims, mean0, var0):
    """_global_moments on each part in a thread of its own: per rank the
    (mean, var) it returns and its running buffers after the update."""
    slots, barrier = [None] * len(parts), threading.Barrier(len(parts), timeout=60)
    out, errors = [None] * len(parts), []

    def rank(r):
        try:
            mean, var = mean0.clone(), var0.clone()
            m, v = _global_moments(parts[r], dims, mean, var, MOMENTUM, StandInMesh(slots, barrier, r))
            out[r] = (m, v, mean, var)
        except BaseException as e:            # noqa: BLE001  (reported below)
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(len(parts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("split", [(3, 4), (1, 2, 4)], ids=["2_ranks", "3_ranks"])
@pytest.mark.parametrize("layout", ["batch_norm2d", "batch_norm1d"])
def test_global_moments_two_pass_merge(layout, split):
    rng = np.random.default_rng(len(split))
    if layout == "batch_norm2d":               # (B, C, H, W), statistics per channel over the rank's items
        shape, axis, dims, stat = (sum(split), 6, 12, 20), 0, (0, 2, 3), (6,)
        std = rng.uniform(0.5, 2.0, (1, 6, 1, 1))
    else:                                      # (targets, rows, features), statistics over the rank's rows
        shape, axis, dims, stat = (4, sum(split) * 37, 10), 1, (-2,), (4, 1, 10)
        std = rng.uniform(0.5, 2.0, (4, 1, 10))
        split = tuple(s * 37 for s in split)
    x = (rng.standard_normal(shape) * std + MEAN_OVER_STD * std).astype(np.float32)
    parts = [torch.from_numpy(p) for p in np.split(x, np.cumsum(split)[:-1], axis=axis)]
    mean0 = torch.from_numpy(rng.uniform(-1.0, 1.0, stat).astype(np.float32))
    var0 = torch.from_numpy(rng.uniform(0.5, 2.0, stat).astype(np.float32))

    x64 = x.astype(np.float64)
    m64, v64 = x64.mean(dims, keepdims=True), x64.var(dims, keepdims=True)
    n = x.size // m64.size
    running_mean = (1 - MOMENTUM) * mean0.double().numpy() + MOMENTUM * m64.reshape(stat)
    running_var = (1 - MOMENTUM) * var0.double().numpy() + MOMENTUM * v64.reshape(stat) * (n / (n - 1))
    for m, v, mean, var in _run_ranks(parts, dims, mean0, var0):
        assert m.shape == v.shape == m64.shape
        np.testing.assert_allclose(m.double().numpy(), m64, rtol=RTOL, atol=0)
        np.testing.assert_allclose(v.double().numpy(), v64, rtol=RTOL, atol=0)
        np.testing.assert_allclose(mean.double().numpy(), running_mean, rtol=RTOL, atol=0)
        np.testing.assert_allclose(var.double().numpy(), running_var, rtol=RTOL, atol=0)
