"""Build the port's CUDA C++ kernels with nvcc and load them with ctypes.

Each source `xumx_slicq_torch/csrc/<name>.cu` exposes a plain C interface
and compiles on its own into `build/xumx_slicq_torch/lib<name>.so` beside
the package (seconds per file: no PyTorch headers). A library is rebuilt
when its source is newer. `build_all()` starts one nvcc per source at once,
so a cold start pays for the slowest file only.
"""

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "xumx_slicq_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> Sequence[str]:
    """Names of every CUDA source in csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels build only on a CUDA machine")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    return not lib.exists() or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime


def build_all(names: Sequence[str] = None, extra_flags: Sequence[str] = ()) -> Dict[str, str]:
    """Compile every stale source in parallel; returns nvcc's output per
    name (ptxas statistics with extra_flags=("-Xptxas", "-v")). Raises on
    the first failed build with the compiler's message."""
    names = list(sources() if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        if not _stale(name) and not extra_flags:
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
        os.replace(tmp, _lib_path(name))  # atomic: a concurrent build never loads half a file
        logs[name] = out
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        if _stale(name):
            build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def function(lib: str, name: str, argtypes: tuple):
    """The C function `name` of csrc/<lib>.cu with its argument types,
    bound once; it returns a cudaError code."""
    fn = getattr(load(lib), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
