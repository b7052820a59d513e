"""Runtime helpers: host allocator reuse, profiling, device info.

Port of xumx_slicq_tpu/utils/runtime.py. Its `enable_compilation_cache`
has no counterpart here: there is no XLA program to cache. The port's
compiled code is cached already: `kernels/build.py` keeps each CUDA
library under build/ and rebuilds it only when its source is newer, and
Triton keeps its own cache of the K2 kernels.
"""

from contextlib import contextmanager
from pathlib import Path

import torch

_MALLOC_REUSE = False


def enable_host_malloc_reuse():
    """Keep freed large blocks in the glibc heap instead of returning them
    to the kernel (idempotent; no-op where glibc is absent).

    numpy routes array data through malloc; with the default
    M_MMAP_THRESHOLD (128 KB) every multi-MB temporary is a fresh
    mmap/munmap pair, so each allocation re-faults all its pages. On hosts
    with slow first-touch faults that dominates any numpy-heavy path (host
    BSS-eval). Raising the mmap/trim thresholds makes the heap an arena:
    pages fault once per process, then recycle. Costs RSS (the high-water
    working set stays resident); call it from CLI entry points, not at
    library import."""
    global _MALLOC_REUSE
    if _MALLOC_REUSE:
        return
    import ctypes

    try:
        libc = ctypes.CDLL("libc.so.6")
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
        _MALLOC_REUSE = True
    except Exception:
        pass


def device_platform() -> str:
    """"gpu" when a CUDA card is present, else "cpu"."""
    return "gpu" if torch.cuda.is_available() else "cpu"


@contextmanager
def profile_trace(logdir: str, name: str = "trace.json"):
    """torch.profiler over the block (host ops, and the card's kernels when
    one is present), written as a Chrome trace to logdir/name on exit;
    `utils.profile_stats` aggregates it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(logdir) / name))
