"""PyTorch/CUDA port of the `repro` package for NVIDIA Hopper (H100).

The JAX package `repro` is the reference; this package mirrors its module
paths and parameter trees, imports neither `jax` nor `repro`, and runs its
entry points on `cuda` unless the caller passes `device="cpu"`. Every
Pallas TPU kernel on a ported path becomes a hand-written Hopper kernel
(`kernels/*/csrc`), with its plain PyTorch version beside it for CPU
tensors and for checking.
"""
