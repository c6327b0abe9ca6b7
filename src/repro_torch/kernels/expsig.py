"""The paper's reusable EXP-σ unit over a whole tensor (kernel K9).

Port of `repro/kernels/expsig.py`: `exp_kernel` (mode 0, the LUT e^x)
and `sigmoid_kernel` (mode 1, the PWL σ) replace the TPU kernel's two
modes.  Any shape, f32 or bf16 in, the same dtype out (computed in f32,
rounded once).  The CUDA kernel is `csrc/expsig.cu`; its math is
`csrc/hw_units.cuh`, which the hardware-numerics bodies of K2, K3 and K4
compile too.  The chunked prefill under the hardware numerics takes its
σ through `sigmoid_kernel`.

A CPU tensor takes the plain version (`core/approx/units.py`); a CUDA
tensor launches the kernel or raises, also when grad mode is on and x
requires grad: the hardware numerics are not trained (JAX's `loss_fn`
runs the standard ones), so K9 has no backward.
"""
from __future__ import annotations

import torch

from repro_torch.core.approx.units import exp_lut, lut_tensor, sigmoid_pwl
from repro_torch.kernels.build import (
    HW_UNTRAINED, check, counted, load_library, meta_like, refuse_grad,
    stream_ptr)

_DTYPES = (torch.float32, torch.bfloat16)


def exp_kernel_plain(x: torch.Tensor) -> torch.Tensor:
    return exp_lut(x).to(x.dtype)


def sigmoid_kernel_plain(x: torch.Tensor) -> torch.Tensor:
    return sigmoid_pwl(x).to(x.dtype)


def _launch(x: torch.Tensor, mode: int, wrapper) -> torch.Tensor:
    if x.dtype not in _DTYPES:
        raise TypeError(f"the EXP-σ kernel takes f32 or bf16, got {x.dtype}")
    refuse_grad(wrapper.__name__, x, why=HW_UNTRAINED)
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel():
        check(load_library().expsig(
            x.data_ptr(), lut_tensor("exp", x.device).data_ptr(),
            out.data_ptr(), x.numel(), mode, int(x.dtype == torch.bfloat16),
            stream_ptr(x)), "expsig")
        wrapper.launches += 1
    return out


@counted("exp_kernel", meta=meta_like)
def exp_kernel(x: torch.Tensor) -> torch.Tensor:
    """e^x by the paper's EXP unit, elementwise, in x's dtype."""
    if x.device.type == "cpu":
        return exp_kernel_plain(x)
    return _launch(x, 0, exp_kernel)


@counted("sigmoid_kernel", meta=meta_like)
def sigmoid_kernel(x: torch.Tensor) -> torch.Tensor:
    """σ(x) by the paper's PWL unit, elementwise, in x's dtype."""
    if x.device.type == "cpu":
        return sigmoid_kernel_plain(x)
    return _launch(x, 1, sigmoid_kernel)


exp_kernel.launches = 0
sigmoid_kernel.launches = 0
