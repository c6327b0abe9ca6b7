"""The single-pass row LayerNorm (kernel K11).

Port of `repro/kernels/fused_layernorm.py:fused_layernorm` (`_kernel`):
LayerNorm over the last axis with Σx and Σx² taken in f32 in the same
pass (the paper's LayerNorm module, Eq. 12: var = E[x²] − μ²), then
((x − μ)·rsqrt(var + eps))·γ + β in f32, stored in x's dtype.  The CUDA
kernel is `csrc/fused_layernorm.cu`; its header says what bounds it on an
H100 and how its design answers that.

The RWKV whole-sequence forwards (`models/rwkv4.py:forward`,
`models/rwkv6.py:forward`) send their ln0, ln1, ln2 and ln_f through it;
`models/layers.py:apply_norm`, which every other path calls, stays the
eager formula, so no earlier path's numbers move.

A CPU tensor takes the plain version (the formula of `apply_norm`'s
layernorm branch); a CUDA tensor launches the kernel or raises, also when
grad mode is on and an operand requires grad (no backward yet).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (
    check, load_library, refuse_grad, stream_ptr)

_DTYPES = (torch.float32, torch.bfloat16)


def fused_layernorm_plain(x, gamma, beta, *, eps: float = 1e-5):
    """μ and E[x²] in f32, var = E[x²] − μ², ((x − μ)·rsqrt(var + eps))·γ
    + β, cast back to x's dtype: `apply_norm`'s layernorm branch."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    ex2 = (x32 * x32).mean(dim=-1, keepdim=True)
    var = ex2 - mu * mu
    y = (x32 - mu) * torch.rsqrt(var + eps) * gamma + beta
    return y.to(x.dtype)


def fused_layernorm(x, gamma, beta, *, eps: float = 1e-5):
    """x (..., D) f32 or bf16; gamma, beta (D,) f32 or bf16 -> LayerNorm
    over the last axis, in x's dtype."""
    if x.device.type == "cpu":
        return fused_layernorm_plain(x, gamma, beta, eps=eps)
    refuse_grad("fused_layernorm", x, gamma, beta)
    D = x.shape[-1] if x.dim() else 0
    if x.dtype not in _DTYPES or gamma.dtype not in _DTYPES or \
            beta.dtype not in _DTYPES:
        raise TypeError("fused_layernorm takes f32 or bf16 x, gamma, beta; "
                        f"got {x.dtype}, {gamma.dtype}, {beta.dtype}")
    if D < 1 or gamma.shape != (D,) or beta.shape != (D,):
        raise ValueError(f"fused_layernorm: x {tuple(x.shape)} with gamma "
                         f"{tuple(gamma.shape)}, beta {tuple(beta.shape)}")
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError("fused_layernorm: operands on other devices")
    x = x.contiguous()
    gamma, beta = gamma.contiguous(), beta.contiguous()
    out = torch.empty_like(x)
    R = x.numel() // D
    if R == 0:
        return out
    per16 = 16 // x.element_size()
    vec = int(D % per16 == 0 and x.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    check(load_library().fused_layernorm(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), R,
        D, float(eps), int(x.dtype == torch.bfloat16),
        int(gamma.dtype == torch.bfloat16), int(beta.dtype == torch.bfloat16),
        vec, stream_ptr(x)), "fused_layernorm")
    fused_layernorm.launches += 1
    return out


fused_layernorm.launches = 0
