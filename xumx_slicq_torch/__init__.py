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
either model; `training`, `loss` and `data` train the CDAE model.

Entry points take an explicit `device` ("cuda" by default) and raise when no
card is present unless the caller asked for "cpu".
"""

__version__ = "0.1.0"

