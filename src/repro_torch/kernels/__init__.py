"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions, and
the wrappers that bridge :mod:`repro_torch.core` to them.

Importing this package builds nothing: a kernel is compiled with ``nvcc`` at
its first launch on a CUDA tensor.
"""
