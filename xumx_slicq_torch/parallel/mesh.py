"""Ranks, groups and collectives: data parallelism with cross-rank BatchNorm
and the target-parallel split, on torch.distributed.

Counterpart of xumx_slicq_tpu/parallel/mesh.py. There one jitted program
spans a device mesh and XLA inserts the collectives from sharding
annotations; here each device is a process (a rank) and the port calls
every collective itself, through this module:

* `spawn` starts the ranks (the `spawn` start method, a FileStore
  rendezvous in a temporary directory: no network port) and returns each
  rank's result; a rank that fails fails the run.
* `make_mesh`, inside a rank, lays the ranks out as the JAX package's mesh
  (`mesh.py:50-60`): (dp, tp), rank = dp index * tp + tp index. A rank's dp
  group holds the ranks with its targets (the batch is split over it); its
  tp group the ranks with its rows (the 4-target weight stack is split
  over it).
* The backend is explicit: NCCL for one card per rank; gloo on the CPU and
  when ranks share a card, which NCCL refuses. Gloo reduces and broadcasts
  CUDA tensors but does not gather them, so every gather here is an
  all-reduce of a zero-filled buffer in which each rank fills its own slot:
  one code path under both backends.
"""

import os
import pickle
import re
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

NB_TARGETS = 4  # bass/vocals/other/drums: the stacked leading weight axis
TP_SIZES = (1, 2, 4)
TIMEOUT = timedelta(minutes=10)      # a collective that waits longer raises
RANKS_TIMEOUT = 3600.0               # seconds: spawn fails a run whose ranks are still running then

# The JAX package's names of every parameter and BatchNorm statistic stacked
# over the 4 targets (xumx_slicq_tpu/parallel/mesh.py:75-89); AdamW moments
# mirror their parameters. A copy: the port imports nothing of the JAX package.
_TARGET_STACKED_NAMES = frozenset({
    # CDAE
    "enc1_w", "enc2_w", "dec1_w", "dec2_w", "dec2_b",
    # BN params/stats (always nested under bn1/bn2/bn3)
    "scale", "bias", "mean", "var",
    # LSTM
    "fc1_w", "fc2_w", "fc3_w", "fc3_b",
    "w_ih", "w_hh", "b_ih", "b_hh",
    "w_ih_reverse", "w_hh_reverse", "b_ih_reverse", "b_hh_reverse",
})
# the port's BatchNorm names for the JAX package's
_PORT_LEAVES = {"weight": "scale", "running_mean": "mean", "running_var": "var"}


def jax_leaf_name(name: str) -> str:
    """The JAX package's leaf name of a port state_dict key:
    `blocks.3.bn1.running_mean` -> `mean`, `blocks.0.w_ih_l2` -> `w_ih`
    (the port stacks an LSTM layer's directions in one tensor)."""
    leaf = re.sub(r"_l\d+$", "", name.rsplit(".", 1)[-1])
    return _PORT_LEAVES.get(leaf, leaf)


def is_target_stacked(name: str, shape: Sequence[int]) -> bool:
    """The tp rule (the counterpart of `target_shardings`): a port
    parameter or buffer is split over the tp group iff its leaf is a known
    target-stacked name and its leading axis is target-major over the 4
    targets (the port concatenates the targets into it, or stacks them).
    Everything else (the per-bucket whitening, counters) is replicated, so
    an unknown tensor whose leading axis happens to be a multiple of 4 is
    never split."""
    return jax_leaf_name(name) in _TARGET_STACKED_NAMES and len(shape) >= 1 and shape[0] % NB_TARGETS == 0


def local_targets(tp_rank: int, tp: int) -> range:
    """The targets a tp rank holds: a contiguous range, so that the ranks'
    slices laid end to end in tp order are the 4 targets in order."""
    if tp not in TP_SIZES:
        raise ValueError(f"tp must be one of {TP_SIZES}, got {tp}")
    n = NB_TARGETS // tp
    return range(tp_rank * n, (tp_rank + 1) * n)


def take_targets(state: dict, targets: Sequence[int]) -> dict:
    """A full (4-target) state_dict cut to `targets`: each target-stacked
    tensor keeps the rows of those targets on its leading axis."""
    targets = list(targets)
    if targets == list(range(NB_TARGETS)):
        return dict(state)
    lo, hi = targets[0], targets[-1] + 1
    if targets != list(range(lo, hi)):
        raise ValueError(f"targets must be a contiguous range, got {targets}")
    out = {}
    for k, v in state.items():
        if isinstance(v, torch.Tensor) and is_target_stacked(k, v.shape):
            per = v.shape[0] // NB_TARGETS
            v = v[lo * per: hi * per].clone()
        out[k] = v
    return out


def backend_for(devices: Sequence) -> str:
    """NCCL for one card per rank, gloo on the CPU or when ranks share a
    card (NCCL refuses two ranks on one GPU)."""
    devs = [torch.device(d) for d in devices]
    kinds = {d.type for d in devs}
    if kinds == {"cpu"}:
        return "gloo"
    if kinds != {"cuda"}:
        raise ValueError(f"ranks must all be on the CPU or all on cards, got {devices}")
    idx = [d.index if d.index is not None else 0 for d in devs]
    return "nccl" if len(set(idx)) == len(idx) else "gloo"


# -- starting the ranks ------------------------------------------------------


def _rank_main(rank: int, world: int, store_path: str, backend: str, devices: list, threads: int,
               fn: Callable, args: tuple, out_dir: str):
    """A rank's process: join the group, run fn(rank, *args), leave the
    result (or the traceback) in out_dir."""
    try:
        torch.set_num_threads(threads)
        dev = torch.device(devices[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world, timeout=TIMEOUT)
        try:
            result = fn(rank, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn: Callable, devices: Sequence, args: tuple = ()) -> list:
    """Run fn(rank, *args) in one process per entry of `devices` (rank r on
    devices[r]; a card may appear more than once), each a member of one
    process group of the backend `backend_for(devices)` gives.
    fn must be importable (a module-level function) and its result
    picklable. Returns the results in rank order. Keep `args` small (tens
    of kB): a rank's start waits until the one before has read its
    arguments, and an argument larger than a pipe's buffer is read only
    after that rank has imported torch.

    The ranks inherit the caller's intra-op thread count. If a rank fails
    or dies, the others are stopped and this raises with its traceback: no
    run returns with a dead rank."""
    world = len(devices)
    backend = backend_for(devices)
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="xumx_ranks_")
    procs = []
    try:
        for r in range(world):
            p = ctx.Process(target=_rank_main, daemon=True,
                            args=(r, world, os.path.join(tmp, "store"), backend, [str(d) for d in devices],
                                  torch.get_num_threads(), fn, args, tmp))
            p.start()
            procs.append(p)
        deadline = time.monotonic() + RANKS_TIMEOUT
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {RANKS_TIMEOUT} s")
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode not in (0, None)]
        if failed:
            errs = []
            for r in range(world):
                path = os.path.join(tmp, f"{r}.err")
                if os.path.exists(path):
                    with open(path) as f:
                        errs.append(f"rank {r}:\n{f.read()}")
            raise RuntimeError(f"rank(s) {failed} of {world} failed (exit codes "
                               f"{[p.exitcode for p in procs]})\n" + "\n".join(errs))
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


# -- the mesh -----------------------------------------------------------------


class Mesh:
    """This rank's place in a (dp, tp) layout: its device, its dp and tp
    groups and their sizes, and the collectives the port runs over them.
    The one-process mesh (`make_mesh(1)`) has no groups and every
    collective is the identity."""

    def __init__(self, device: torch.device, dp: int = 1, tp: int = 1, rank: int = 0,
                 dp_group=None, tp_group=None):
        self.device = device
        self.dp, self.tp, self.rank = dp, tp, rank
        self.dp_rank, self.tp_rank = divmod(rank, tp)
        self.dp_group, self.tp_group = dp_group, tp_group
        self.targets = local_targets(self.tp_rank, tp)
        # every collective this rank ran: calls, bytes and host seconds in the calls (gloo's return once
        # the reduce is done, NCCL's once it is queued on the stream)
        self.stats = {"calls": 0, "bytes": 0, "seconds": 0.0}

    @property
    def size(self) -> int:
        return self.dp * self.tp

    def __repr__(self) -> str:
        return f"Mesh(dp={self.dp}, tp={self.tp}, rank={self.rank}, device={self.device})"

    def __deepcopy__(self, memo):
        return self                      # process groups are handles of the process, shared by copies

    # -- collectives ------------------------------------------------------

    def all_reduce_(self, t: torch.Tensor, group: str = "world") -> torch.Tensor:
        """Sum t in place over the "world", "dp" or "tp" group."""
        g, n = self._group(group)
        if n > 1:
            self._run(dist.all_reduce, t, group=g)
        return t

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's t, in place on every rank."""
        if self.size > 1:
            self._run(dist.broadcast, t, src=0)
        return t

    def _run(self, op, t: torch.Tensor, **kw):
        t0 = time.perf_counter()
        op(t, **kw)
        self.stats["calls"] += 1
        self.stats["bytes"] += t.numel() * t.element_size()
        self.stats["seconds"] += time.perf_counter() - t0

    def all_gather(self, t: torch.Tensor, group: str) -> torch.Tensor:
        """(group size, *t.shape): every member's t, in rank order within
        the group. An all-reduce of a zero buffer with this rank's slot
        filled (gloo gathers no CUDA tensor). Not differentiable."""
        g, n = self._group(group)
        if n == 1:
            return t[None]
        buf = t.new_zeros((n, *t.shape))
        buf[self._index(group)] = t
        self._run(dist.all_reduce, buf, group=g)
        return buf

    def gather_targets(self, flat: torch.Tensor) -> torch.Tensor:
        """(tp, *flat.shape): the tp group's slices, differentiable. Every
        tp rank computes the same loss from the gathered tensor, so the
        backward hands each rank the cotangent of its own slot, unsummed (a
        sum over the ranks would multiply the gradients by tp)."""
        if self.tp == 1:
            return flat[None]
        return _GatherShared.apply(flat, self)

    def gather_rows(self, flat: torch.Tensor) -> torch.Tensor:
        """(dp, *flat.shape): the dp group's slices, differentiable (the
        LSTM's encoded rows, the cross-rank BatchNorm's moments). Each dp
        rank computes the loss of its own rows from the gathered tensor, so
        the backward sums the cotangents over the group and hands each rank
        its slot."""
        if self.dp == 1:
            return flat[None]
        return _GatherRows.apply(flat, self)

    def mean_dp(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of t over the dp group (a new tensor)."""
        return self.all_reduce_(t.detach().clone(), "dp") / self.dp if self.dp > 1 else t

    def reduce_gradients(self, named_params) -> None:
        """After backward: target-stacked gradients averaged over the dp
        group; the replicated ones (the whitening) summed over the tp group,
        as each tp rank holds only its targets' share of them, then averaged
        over dp. One flat buffer per group."""
        if self.size == 1:
            return
        stacked, replicated = [], []
        for name, p in named_params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            (stacked if self.tp > 1 and self.holds_targets_of(name, p) else replicated).append(p.grad)
        for grads, group in ((stacked, "dp"), (replicated, "world")):
            if not grads:
                continue
            flat = torch.cat([g.reshape(-1) for g in grads])
            self.all_reduce_(flat, group).div_(self.dp)
            off = 0
            for g in grads:
                g.copy_(flat[off: off + g.numel()].view_as(g))
                off += g.numel()

    def gather_state(self, state: dict) -> dict:
        """A rank's state_dict (or a dict of AdamW moments keyed alike) with
        every target-stacked tensor gathered over the tp group into the
        4-target layout of a one-process run. A collective: every rank
        calls it."""
        if self.tp == 1:
            return dict(state)
        out = {}
        for k, v in state.items():
            if isinstance(v, torch.Tensor) and self.holds_targets_of(k, v):
                g = self.all_gather(v.contiguous(), "tp")
                v = g.reshape(g.shape[0] * g.shape[1], *g.shape[2:])
            out[k] = v
        return out

    def holds_targets_of(self, name: str, t: torch.Tensor) -> bool:
        """Whether this rank's tensor `name` is its targets' slice of a
        target-stacked tensor: the tp rule on the 4-target shape."""
        return t.ndim >= 1 and is_target_stacked(name, (t.shape[0] * self.tp,))

    def _group(self, group: str):
        if group == "world":
            return None, self.size
        if group == "dp":
            return self.dp_group, self.dp
        if group == "tp":
            return self.tp_group, self.tp
        raise ValueError(f"unknown group {group!r}")

    def _index(self, group: str) -> int:
        return {"world": self.rank, "dp": self.dp_rank, "tp": self.tp_rank}[group]


class _GatherShared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, mesh):
        ctx.mesh = mesh
        return mesh.all_gather(flat.detach().contiguous(), "tp")

    @staticmethod
    def backward(ctx, g):
        return g[ctx.mesh.tp_rank].contiguous(), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, mesh):
        ctx.mesh = mesh
        return mesh.all_gather(flat.detach().contiguous(), "dp")

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return mesh.all_reduce_(g.contiguous().clone(), "dp")[mesh.dp_rank].contiguous(), None


def make_mesh(n_devices: int = 1, tp: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """This rank's mesh over n_devices ranks, tp of them per dp group
    (tp in 1, 2, 4 and dividing n_devices, as mesh.py:50-60). Inside a rank
    of `spawn` (the process group is up and has n_devices members);
    n_devices = 1 needs no group. devices: one per rank (default: the CPU,
    or cuda:<rank> when the group is NCCL). Every rank builds every group,
    in the same order, as torch.distributed requires."""
    if tp not in TP_SIZES or n_devices % tp != 0:
        raise ValueError(f"{n_devices} devices not divisible by tp={tp} (tp in {TP_SIZES})")
    if n_devices == 1 and not dist.is_initialized():
        return Mesh(torch.device(devices[0] if devices else "cpu"))
    if not dist.is_initialized():
        raise RuntimeError("make_mesh(n > 1) runs inside a rank: start the ranks with mesh.spawn")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n_devices:
        raise ValueError(f"the process group has {world} ranks, the mesh asks for {n_devices}")
    if devices is None:
        devices = [f"cuda:{r}" for r in range(world)] if dist.get_backend() == "nccl" else ["cpu"] * world
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    dp = world // tp
    dp_groups = [dist.new_group([d * tp + t for d in range(dp)]) for t in range(tp)]
    tp_groups = [dist.new_group([d * tp + t for t in range(tp)]) for d in range(dp)]
    d_idx, t_idx = divmod(rank, tp)
    return Mesh(torch.device(devices[rank]), dp, tp, rank, dp_groups[t_idx], tp_groups[d_idx])


def shard_batch(batch, mesh: Mesh):
    """This rank's contiguous rows of a global batch (numpy or torch), as
    P("dp") places them: dp rank i holds rows [i B/dp, (i+1) B/dp)."""
    B = batch.shape[0]
    if B % mesh.dp:
        raise ValueError(f"batch of {B} not divisible by dp={mesh.dp}")
    n = B // mesh.dp
    return batch[mesh.dp_rank * n: (mesh.dp_rank + 1) * n]


def replicate(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank 0's tensor on every rank (a broadcast, in place)."""
    return mesh.broadcast_(t)


def replicate_arrays(arrays: List[np.ndarray], mesh: Mesh) -> List[np.ndarray]:
    """Rank 0's float32 arrays on every rank; each rank passes arrays of
    the same shapes (the values of ranks other than 0 are ignored)."""
    flat = torch.from_numpy(np.concatenate([np.asarray(a, np.float32).reshape(-1) for a in arrays]))
    flat = replicate(flat.to(mesh.device), mesh).cpu().numpy()
    out, off = [], 0
    for a in arrays:
        out.append(flat[off: off + np.size(a)].reshape(np.shape(a)))
        off += np.size(a)
    return out
