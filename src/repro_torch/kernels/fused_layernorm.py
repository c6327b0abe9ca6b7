"""The single-pass row LayerNorm (kernel K11) and its backward (K11-bwd).

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

On the card, with grad mode on and an operand that requires grad,
`fused_layernorm` runs through an autograd Function that saves (x, γ, β)
and whose backward is `fused_layernorm_bwd`: dx, dγ and dβ of the
single-pass formula, which the JAX package leaves to XLA's autodiff
(`csrc/fused_layernorm.cu` holds the formula; dγ and dβ are summed over
rows in a fixed order).

A CPU tensor takes the plain version (the formula of `apply_norm`'s
layernorm branch), which autograd differentiates; `fused_layernorm_bwd`
on CPU tensors is K11-bwd's plain version, its formula in torch ops.  A
CUDA tensor launches the kernels or raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.build import (
    check, counted, kernel_route, load_library, meta_like, stream_ptr)

_DTYPES = (torch.float32, torch.bfloat16)
# K11-bwd's blocks (two an SM on an H100): each owns a fixed set of rows
# and one row of dγ/dβ partials; a fixed G keeps the sums' order, and so
# their bits, fixed
BWD_BLOCKS = 264
# K11-bwd's instances (csrc/fused_layernorm.cu): warps a row, and chunks a
# lane at most for 16-byte loads of bf16 (8 values a chunk) and f32 (4),
# and for element loads (1)
BWD_WARPS = (1, 2, 4, 8, 16)
BWD_MAX_CHUNKS = {(torch.bfloat16, True): 3, (torch.float32, True): 4,
                  (torch.bfloat16, False): 8, (torch.float32, False): 8}


class BwdPlan(NamedTuple):
    """K11-bwd's instance for a row of D: `warps` warps a row, each lane
    holding `chunks` chunks of `per_chunk` values (16 bytes, or one
    element), `values` = chunks·per_chunk in all; `rows` rows a block at a
    time (the block's 32·max(8, warps) threads)."""
    warps: int
    chunks: int
    per_chunk: int
    values: int
    rows: int


def bwd_plan(D: int, dtype, vec: bool) -> BwdPlan:
    """The fewest warps a row (a power of two up to 16) whose lanes hold
    the row in registers, and the chunks a lane then needs.  Lane l of
    warp part p holds columns ((c·warps + p)·32 + l)·per_chunk + q.
    Raises for a row wider than 16 warps hold (12288 bf16 or 8192 f32
    values in 16-byte loads, 4096 by elements)."""
    per = (16 // torch.tensor([], dtype=dtype).element_size()) if vec else 1
    most = BWD_MAX_CHUNKS[(dtype, bool(vec))]
    chunks = -(-D // per)
    for w in BWD_WARPS:
        if chunks <= 32 * w * most:
            n = -(-chunks // (32 * w))
            return BwdPlan(w, n, per, n * per, max(8, w) // w)
    raise ValueError(f"fused_layernorm_bwd: a row of D = {D} ({dtype}) is "
                     f"wider than {BWD_WARPS[-1]} warps hold "
                     f"({32 * BWD_WARPS[-1] * most * per} values)")


def fused_layernorm_plain(x, gamma, beta, *, eps: float = 1e-5):
    """μ and E[x²] in f32, var = E[x²] − μ², ((x − μ)·rsqrt(var + eps))·γ
    + β, cast back to x's dtype: `apply_norm`'s layernorm branch."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    ex2 = (x32 * x32).mean(dim=-1, keepdim=True)
    var = ex2 - mu * mu
    y = (x32 - mu) * torch.rsqrt(var + eps) * gamma + beta
    return y.to(x.dtype)


def fused_layernorm_bwd_plain(x, gamma, beta, dy, *, eps: float = 1e-5):
    """K11-bwd's formula in torch ops, f32 throughout: x̂ = (x − μ)·rs,
    dx̂ = dy·γ, dx = rs·((dx̂ − mean dx̂) − x̂·mean(dx̂·x̂)), dγ = Σ_rows
    dy·x̂, dβ = Σ_rows dy, each cast to its operand's dtype."""
    x32, dy32 = x.to(torch.float32), dy.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    ex2 = (x32 * x32).mean(dim=-1, keepdim=True)
    rs = torch.rsqrt(ex2 - mu * mu + eps)
    xh = (x32 - mu) * rs
    dxh = dy32 * gamma.to(torch.float32)
    m1 = dxh.mean(dim=-1, keepdim=True)
    m2 = (dxh * xh).mean(dim=-1, keepdim=True)
    dx = rs * ((dxh - m1) - xh * m2)
    D = x.shape[-1]
    dg = (dy32 * xh).reshape(-1, D).sum(dim=0)
    db = dy32.reshape(-1, D).sum(dim=0)
    return dx.to(x.dtype), dg.to(gamma.dtype), db.to(beta.dtype)


def _check(x, gamma, beta, who):
    D = x.shape[-1] if x.dim() else 0
    if x.dtype not in _DTYPES or gamma.dtype not in _DTYPES or \
            beta.dtype not in _DTYPES:
        raise TypeError(f"{who} takes f32 or bf16 x, gamma, beta; "
                        f"got {x.dtype}, {gamma.dtype}, {beta.dtype}")
    if D < 1 or gamma.shape != (D,) or beta.shape != (D,):
        raise ValueError(f"{who}: x {tuple(x.shape)} with gamma "
                         f"{tuple(gamma.shape)}, beta {tuple(beta.shape)}")
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError(f"{who}: operands on other devices")
    return D


def _vec(D, *ts) -> int:
    """16-byte loads: D a multiple of 16 bytes' worth of elements, every
    row operand aligned."""
    per16 = 16 // ts[0].element_size()
    return int(D % per16 == 0 and all(t.data_ptr() % 16 == 0 for t in ts))


@counted("fused_layernorm", meta=lambda x, *_: meta_like(x))
def _forward(x, gamma, beta, eps):
    """The plain version on the CPU, K11 on the card."""
    if x.device.type == "cpu":
        return fused_layernorm_plain(x, gamma, beta, eps=eps)
    D = _check(x, gamma, beta, "fused_layernorm")
    x = x.contiguous()
    gamma, beta = gamma.contiguous(), beta.contiguous()
    out = torch.empty_like(x)
    R = x.numel() // D
    if R == 0:
        return out
    check(load_library().fused_layernorm(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), R,
        D, float(eps), int(x.dtype == torch.bfloat16),
        int(gamma.dtype == torch.bfloat16), int(beta.dtype == torch.bfloat16),
        _vec(D, x, out), stream_ptr(x)), "fused_layernorm")
    fused_layernorm.launches += 1
    return out


@counted("fused_layernorm_bwd",
         meta=lambda x, gamma, beta, *_, **__: meta_like(x, gamma, beta))
def fused_layernorm_bwd(x, gamma, beta, dy, *, eps: float = 1e-5):
    """(dx, dγ, dβ) of `fused_layernorm(x, gamma, beta)` for the output
    gradient dy (x's shape and dtype): the plain formula on the CPU, K11-bwd
    on the card."""
    if x.device.type == "cpu":
        return fused_layernorm_bwd_plain(x, gamma, beta, dy, eps=eps)
    D = _check(x, gamma, beta, "fused_layernorm_bwd")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError("fused_layernorm_bwd: dy must match x's shape, "
                         "dtype and device")
    x, dy = x.contiguous(), dy.contiguous()
    gamma = gamma.contiguous()
    dx = torch.empty_like(x)
    dg = torch.empty_like(gamma)
    db = torch.empty_like(beta)
    R = x.numel() // D
    if R == 0:
        return dx, dg.zero_(), db.zero_()
    vec = _vec(D, x, dy, dx)
    plan = bwd_plan(D, x.dtype, vec)
    G = min(-(-R // plan.rows), BWD_BLOCKS)
    partial = torch.empty((G, 2, D), dtype=torch.float32, device=x.device)
    check(load_library().fused_layernorm_bwd(
        x.data_ptr(), gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dg.data_ptr(), db.data_ptr(), partial.data_ptr(), R, D, G,
        plan.warps, plan.chunks, float(eps), int(x.dtype == torch.bfloat16),
        int(gamma.dtype == torch.bfloat16), int(beta.dtype == torch.bfloat16),
        vec, stream_ptr(x)), "fused_layernorm_bwd")
    fused_layernorm_bwd.launches += 1
    return dx, dg, db


fused_layernorm_bwd.launches = 0


class _FusedLayerNorm(torch.autograd.Function):
    """K11 with its backward: the forward keeps (x, γ, β); the backward is
    `fused_layernorm_bwd`, which recomputes μ and rs from x."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps = eps
        return _forward(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta = ctx.saved_tensors
        dx, dg, db = fused_layernorm_bwd(x, gamma, beta,
                                         dy.contiguous(), eps=ctx.eps)
        return dx, dg, db, None


def fused_layernorm(x, gamma, beta, *, eps: float = 1e-5):
    """x (..., D) f32 or bf16; gamma, beta (D,) f32 or bf16 -> LayerNorm
    over the last axis, in x's dtype.  On the card, with grad mode on and
    an operand that requires grad, its gradient comes from K11-bwd."""
    if kernel_route(x) and torch.is_grad_enabled() and (
            x.requires_grad or gamma.requires_grad or beta.requires_grad):
        return _FusedLayerNorm.apply(x, gamma, beta, eps)
    return _forward(x, gamma, beta, eps)


fused_layernorm.launches = 0
