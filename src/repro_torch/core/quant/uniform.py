"""9-bit uniform symmetric quantization, the paper's A9 activations (port
of `repro/core/quant/uniform.py`).

"9-bit" is a sign and 8 magnitude bits: the integer grid [-255, 255].
The scale is max|x| · fl(1/255), as XLA compiles the reference's
`amax / 255` under jit (it folds the division by a constant into a
multiply by the f32 reciprocal; eager JAX divides, and differs by an ulp
of the scale).  The codes are x / scale (a true division, as XLA keeps
it) rounded half to even and clipped.
"""
from __future__ import annotations

import numpy as np
import torch


def _qmax(bits: int) -> int:
    # sign + (bits - 1) magnitude bits, symmetric grid
    return (1 << (bits - 1)) - 1


def _amax(x: torch.Tensor, axis) -> torch.Tensor:
    """max|x| over everything (axis None, a 0-d tensor) or over every axis
    but `axis`, kept as size-1 dims."""
    if axis is None:
        return x.abs().amax()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    keep = {a % x.ndim for a in axes}
    red = tuple(i for i in range(x.ndim) if i not in keep)
    return x.abs().amax(dim=red, keepdim=True)


def uniform_quantize(x: torch.Tensor, bits: int = 9, *, axis=None):
    """x -> (int32 codes in [-qmax, qmax], f32 scale)."""
    x = x.to(torch.float32)
    qmax = _qmax(bits)
    amax = _amax(x, axis)
    recip = float(np.float32(1.0) / np.float32(qmax))
    scale = torch.where(amax <= 0, 1.0, amax * recip)
    codes = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int32)
    return codes, scale


def uniform_dequantize(codes: torch.Tensor, scale: torch.Tensor
                       ) -> torch.Tensor:
    return codes.to(torch.float32) * scale


class _FakeQuant(torch.autograd.Function):
    """Quantize-dequantize in x's dtype; the gradient passes straight
    through, as the reference's custom_vjp defines it."""

    @staticmethod
    def forward(ctx, x, bits, axis):
        codes, scale = uniform_quantize(x, bits, axis=axis)
        return uniform_dequantize(codes, scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def uniform_fake_quant(x: torch.Tensor, bits: int = 9, axis=None
                       ) -> torch.Tensor:
    return _FakeQuant.apply(x, bits, axis)
