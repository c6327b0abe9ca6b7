"""Kernels of the port: CUDA C++ for sm_90a, each beside its plain version."""
