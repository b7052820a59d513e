"""xumx-slicq-torch: the PyTorch/CUDA port of xumx_slicq_tpu.

The same demixer as the JAX package beside it -- a Bark-scale sliced
Constant-Q Transform (sliCQT), a 70-bucket CDAE (or LSTM) mask network over
four targets, an embedded stereo Wiener-EM and the inverse transform --
written in PyTorch for one NVIDIA H100. The module layout mirrors
xumx_slicq_tpu/ so that each counterpart is easy to find; the JAX package is
the reference the port is tested against and is never imported from here.

Three stages run as kernels written by hand for Hopper (xumx_slicq_torch/
kernels/): the synthesis gather-assembly (K1, CUDA C++) and the stereo
Wiener-EM (K2, Triton), each with a backward kernel for training, and the
LSTM variant's recurrence (K5, CUDA C++). Every other stage is plain
PyTorch (cuFFT, cuDNN, matmuls). `separator` and `inference` demix with
either model; `training`, `loss` and `data` train either model;
`evaluation` and `ops.bsseval` score a MUSDB18-HQ tree with BSS-eval v4 on
the host or on the card. The tools: `export` (torch.export artifacts of the
chunk pipeline, the kernels as registered ops of `kernels.ops`),
`slicqfinder` (oracle transform search), `tuning`, `visualization`,
`demixui`, `ops.wiener_contrib` and `utils` (the profiler helpers).
`parallel` runs training across ranks (torch.distributed: data and target
parallelism) and `separator` demixes across devices; `models.convert` reads
and writes the JAX package's `params.msgpack`; `entry` holds the quick
entry points; `cadenza` is the Cadenza hearing-aid recipe.

Entry points take an explicit `device` ("cuda" by default) and raise when no
card is present unless the caller asked for "cpu".
"""

__version__ = "0.1.0"



def __getattr__(name):
    # lazy top-level conveniences, as the JAX package's
    if name == "Separator":
        from .separator import Separator

        return Separator
    if name == "SliCQT":
        from .ops.slicqt import SliCQT

        return SliCQT
    if name == "Unmix":
        from .models import Unmix

        return Unmix
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
