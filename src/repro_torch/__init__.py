"""PyTorch/CUDA port of the HFRWKV serving stack.

Mirrors `src/repro/` module for module.  Plain tensor code is PyTorch; the
kernels on the serving path are hand-written CUDA C++ for Hopper
(`csrc/`), built with nvcc at first use and bound with ctypes
(`kernels/build.py`).  Every kernel wrapper takes its plain PyTorch version
for CPU tensors and launches its kernel (or raises) for CUDA tensors.

This package imports torch, numpy and the standard library only.
"""
