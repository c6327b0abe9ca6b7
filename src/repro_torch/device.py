"""Device resolution for the port's entry points, and the matmul settings
its plain versions run under.

Entry points take `device=` (default "cuda").  A CUDA device that is not
there raises: nothing in the port quietly moves to the CPU.
"""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    return dev


@contextlib.contextmanager
def exact_matmuls():
    """Full-f32 products and f32 reductions inside the block, the torch
    analogue of `repro.kernels.common.exact_jit`: TF32 and reduced-precision
    bf16 reductions are switched off and restored on exit, so the caller's
    process keeps its own settings.  Works as a decorator too; the plain
    versions that run matmuls on the card carry it."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, dnn.allow_tf32,
             mm.allow_bf16_reduced_precision_reduction)
    mm.allow_tf32 = dnn.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (mm.allow_tf32, dnn.allow_tf32,
         mm.allow_bf16_reduced_precision_reduction) = saved
