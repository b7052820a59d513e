"""Kernels written by hand for Hopper (sm_90a), each beside its plain
PyTorch version:

* K1 `synth_assembly` (CUDA C++, csrc/synth_assembly.cu): the sliCQT
  synthesis gather-assembly, and `synth_assembly_backward`, its gradient;
* K2 `wiener_em` (Triton, triton_wiener_em.py): the stereo one-iteration
  Wiener-EM, and `wiener_em_backward`, its gradient in the magnitudes;
* K5 `lstm_recurrence` (CUDA C++, csrc/lstm_recurrence.cu): one layer of
  the LSTM variant's recurrence for every bucket, target and direction.

A wrapper launches its kernel for a CUDA tensor, runs the plain version for
a CPU tensor, and counts its launches in `<wrapper>.launches`. K1 and K2
are autograd Functions whose backward is the backward wrapper.
"""
