"""Shared helpers for the PyTorch port's tests (tests/test_torch_*.py).

Both packages get the same numpy inputs, made from a seed; the port runs
on the CPU (device="cpu", one thread, as several test workers share the
machine), the JAX package on its CPU backend (tests/conftest.py).
"""

import numpy as np
import pytest
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


def port_model_dir(d, lstm: bool = False, realtime: bool = False, seed: int = 3):
    """A mel-12 model directory the port wrote: the reference's manifest
    name with TINY_ARGS, and seeded weights under reference names."""
    import json

    from xumx_slicq_torch.models import Unmix
    from xumx_slicq_torch.models.convert import to_reference_state_dict
    from xumx_slicq_torch.ops.slicqt import SliCQT

    d.mkdir(parents=True, exist_ok=True)
    (d / "xumx_slicq_v2.json").write_text(json.dumps({"args": dict(TINY_ARGS, lstm=lstm, realtime=realtime)}))
    shapes = SliCQT(device=DEVICE, **MEL12).block_shapes(1, 2, TINY_LEN)
    model = Unmix(shapes, lstm=lstm, realtime=realtime, seed=seed, device=DEVICE)
    torch.save(to_reference_state_dict(model), d / "xumx_slicq_v2.pth")
    return d


def one_thread_env() -> dict:
    """The environment for a child process a test starts: this one's, with
    OpenMP and the BLAS libraries on one thread, as the test workers share
    the machine's cores."""
    import os

    return dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")


def perturb_cdae(blocks, seed: int):
    """Each SlicedCDAE's BatchNorm statistics and affines and its whitening
    off their defaults (the folded biases are 0 and the whitening the
    identity at a fresh model's), so that folding and whitening matter."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for blk in blocks:
            for bn in (blk.bn1, blk.bn2, blk.bn3):
                for t, lo, hi in ((bn.running_mean, -0.1, 0.1), (bn.running_var, 0.6, 1.6),
                                  (bn.weight, 0.8, 1.2), (bn.bias, -0.1, 0.1)):
                    t.copy_(torch.empty(t.shape).uniform_(lo, hi, generator=g))
            blk.input_mean.copy_(torch.empty(blk.input_mean.shape).uniform_(-0.2, 0.0, generator=g))
            blk.input_scale.copy_(torch.empty(blk.input_scale.shape).uniform_(0.5, 2.0, generator=g))


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


def norm_rel(a, b, floor: float = 0.0) -> float:
    """||a - b|| / max(||b||, floor), in float64."""
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float(torch.linalg.vector_norm(a - b) / max(float(torch.linalg.vector_norm(b)), floor))


def keep_grads():
    """An optax link that passes the updates on and keeps them as its state:
    chained before AdamW, one JAX train step also returns its gradients."""
    import jax
    import jax.numpy as jnp
    import optax

    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda u, state, params=None: (u, u))


@pytest.fixture
def one_blas_thread():
    """NumPy's and SciPy's BLAS on one thread for the test (the float64
    BSS-eval engine's Gram solves and einsums): with several test workers
    on the machine, a BLAS pool per worker oversubscribes the cores."""
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=1, user_api="blas"):
        yield


def fail_on_rank(rank: int, which: int) -> int:
    """A rank function for parallel.mesh.spawn (importable by the ranks):
    rank `which` raises, the others return their rank."""
    if rank == which:
        raise RuntimeError(f"rank {rank} fails on purpose")
    return rank


def step_gradients(mesh, lstm: bool, batch: np.ndarray, double: bool = False, realtime: bool = False) -> dict:
    """One train step (every loss term, SD-SDR included) of the seeded
    mel-12 model on the global batch (B, 5, 2, L), in one process (mesh
    None) or as a rank of `mesh` on its rows: the gradients after the
    reduction across ranks, gathered into the one-process layout. The LSTM
    draws its dropout from a generator seeded alike on every rank.
    double: the model and the batch in float64 (the realtime model: K2
    takes float32 only)."""
    from xumx_slicq_torch.models import Unmix
    from xumx_slicq_torch.ops.slicqt import SliCQT
    from xumx_slicq_torch.parallel.mesh import shard_batch
    from xumx_slicq_torch.training import make_train_step

    slicqt = SliCQT(device=DEVICE, **MEL12)
    model = Unmix(slicqt.block_shapes(batch.shape[0], 2, batch.shape[-1]), lstm=lstm, realtime=realtime, seed=0,
                  device=DEVICE, mesh=mesh)
    rows = torch.from_numpy(shard_batch(batch, mesh) if mesh is not None else batch)
    if double:
        model.double()
        rows = rows.double()
    step, _ = make_train_step(slicqt, model, torch.optim.SGD(model.parameters(), lr=0.0), sdr_mcoef=0.1,
                              mesh=mesh)
    step(rows, torch.Generator().manual_seed(7) if lstm else None)
    grads = {name: p.grad for name, p in model.named_parameters()}
    return mesh.gather_state(grads) if mesh is not None else grads


def grad_batch() -> np.ndarray:
    """The global batch of the gradient comparisons: 4 seeded 0.3 s items.
    Each rank makes its own: an argument of more than a pipe's buffer
    would hold every rank's start until the one before it has imported
    torch."""
    return (np.random.default_rng(0).standard_normal((4, 5, 2, TINY_LEN)) * 0.1).astype(np.float32)


def train_then_gradients(rank: int, train_argv: list, devices: list, cases: list):
    """A rank function for parallel.mesh.spawn, which spares the tests a
    spawn: this rank of the trainer's run over `devices` (as training_main
    runs its ranks), then `step_gradients` on `grad_batch()` for each
    (n ranks, tp, lstm) case, each over a mesh of its own on the same
    ranks. Rank 0 returns (the run's loss histories, the cases'
    gradients), the others None."""
    from xumx_slicq_torch.parallel.mesh import make_mesh
    from xumx_slicq_torch.training import _train_rank, build_argparser

    losses = _train_rank(rank, build_argparser().parse_args(train_argv), devices)
    grads = [step_gradients(make_mesh(n, tp), lstm, grad_batch()) for n, tp, lstm in cases]
    return (losses, grads) if rank == 0 else None
