"""JAX goldens of the port's tests, committed under tests/goldens/.

Some port tests compare against a JAX output that depends only on seeded
inputs: a train step or a loss of seeded weights on a seeded batch, the
stems of a model directory written from seeded weights. Compiling those
JAX programs is most of such a test's time, so their outputs are kept as
files, and the test compares the port against the file at its own
tolerance. A file also holds a fingerprint of the inputs it was built from
(sha256 of every input array, in order): a test whose inputs differ refuses
the file rather than compare against stale numbers. Each golden has a
`slow` twin test that recomputes the output live from the JAX package and
holds both the port and the file to it.

    python tools/make_goldens.py [NAME ...]

rebuilds the files from the JAX package (every golden by default). A test
module lists its goldens in `GOLDENS`: name -> a function returning
(inputs fingerprint, output arrays), which the tool calls.
"""

import hashlib
from pathlib import Path

import numpy as np
import torch

GOLDEN_DIR = Path(__file__).resolve().parent / "goldens"
MODULES = ("test_torch_training", "test_torch_lstm_training", "test_torch_lstm", "test_torch_cdae_conv")   # the modules with GOLDENS
_INPUTS = "__inputs__"


def fingerprint(*arrays) -> str:
    """sha256 over the dtype, shape and bytes of each array (numpy or torch), in order."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a))
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def state_fingerprint(state: dict, *extra) -> str:
    """The fingerprint of a state dict's tensors in key order, then `extra`."""
    return fingerprint(*(state[k] for k in sorted(state)), *extra)


def path(name: str) -> Path:
    return GOLDEN_DIR / f"{name}.npz"


def save(name: str, inputs: str, arrays: dict) -> Path:
    GOLDEN_DIR.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path(name), **{_INPUTS: np.array(inputs)}, **arrays)
    return path(name)


def load(name: str, inputs: str) -> dict:
    """The arrays of golden `name`, if it was built from `inputs`."""
    with np.load(path(name)) as f:
        built_from = str(f[_INPUTS])
        if built_from != inputs:
            raise AssertionError(f"{path(name).name} was built from other inputs than this test's: "
                                 f"rebuild it with `python tools/make_goldens.py {name}`")
        return {k: f[k] for k in f.files if k != _INPUTS}
