"""Kernels K1 and K8: the matmul over Δ-PoT-packed weights with the f32
weights sign · level · scale (port of `repro/kernels/dpot_matmul.py`).

    out[M, N] = x[M, K] @ decode(wq[K, N]) * scale[N]

  dpot_matmul     K1, `dpot_matmul` (`_kernel`, `_decode_w8`): W8 codes
                  wq (K, N) uint8, bit 7 the sign, bits 2:0 Δq0 and 6:3 Δq1
  dpot_matmul_w4  K8, `dpot_matmul_w4` (`_kernel_w4`, `_decode_w4`): W4
                  nibble pairs wq4 (K/2, N) uint8, row 2k the low nibble,
                  bit 3 the sign, bits 2:0 Δq

x is (M, K) f32 or bf16, scale (N,) f32, the output (M, N) in x's dtype.
The weights are the TPU kernels' f32 values, not K5's, which rounds each
weight to bf16 as `unpack_leaf` does (`kernels/fused_prefill.py`).  The
TPU's bm/bn/bk tiling and its divisibility asserts are not taken: any M
and N run, and any even K for W4.

Both are the EXACT instances of K5's tensor-core kernel
(`csrc/chunk_matmul.cu`), under K5's plan (`chunk_matmul_plan`, from K
and N only, so a row's bits do not depend on M).  The scale is one per
column, so it comes after the sum: out = (x @ sign·level) · scale.  Each
level is exact in bf16 pieces (`fused_prefill.piece_table`): a W8 level
2^-q0 + 2^-(q0+Δq1) in two, hi and lo, a W4 level 2^-Δq in one.  A bf16
x, or each of an f32 x's three bf16 pieces (`split_bf16x3`), times a
piece is exact in f32, so the products are exact, and only the order and
rounding of the f32 sums differ from the plain version, with the scale's
one rounding after the sum: within K·2^-24·(|x| @ |w|) plus one step of
x's dtype.  Identity rows give the plain version's f32 weights bit for
bit.  MMAs a weight: K1 2 (bf16 x) or 6 (f32 x), K8 1 or 3.  What bounds
them on an H100 (NVIDIA H100 80GB HBM3, 700 W): at M 8 the code plane's
bytes over 3.35 TB/s; at M 128 the larger of those bytes and pieces · 2 ·
M · K · N bf16 operations over 989 TFLOP/s (rwkv6-7b's head: 0.139 ms
for K1, 0.0695 for K8, with a bf16 x).

The plain versions decode the plane with `dpot_unpack_int8` (or
`dpot_unpack_nibbles`) and `dpot_dequantize`, then one f32 matmul with
TF32 off: `kernels/ref.py:dpot_matmul_ref`.  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.  No JAX model path
calls these kernels: they are reached through the public entry point
`repro_torch.kernels.ops`, as the JAX package's are.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant.delta_pot import (
    FORMAT_W4, FORMAT_W8, dpot_dequantize, dpot_unpack_int8,
    dpot_unpack_nibbles)
from repro_torch.device import exact_matmuls
from repro_torch.kernels.build import refuse_grad
from repro_torch.kernels.fused_prefill import launch_chunk_mm, piece_table

NO_GRAD = "the TPU kernel defines no gradient either"


@exact_matmuls()
def dpot_matmul_plain(x: torch.Tensor, wq: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """K1's plain version: `kernels/ref.py:dpot_matmul_ref`."""
    w = dpot_dequantize(dpot_unpack_int8(wq, scale[None, :], FORMAT_W8.ks))
    return (x.to(torch.float32) @ w).to(x.dtype)


@exact_matmuls()
def dpot_matmul_w4_plain(x: torch.Tensor, wq4: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """K8's plain version: the same with `dpot_unpack_nibbles`."""
    w = dpot_dequantize(dpot_unpack_nibbles(wq4, scale[None, :],
                                            FORMAT_W4.ks))
    return (x.to(torch.float32) @ w).to(x.dtype)


def _launch(entry: str, plane: str, x, codes, scale, k_rows: int):
    """Check the operands, launch `entry` under K5's plan, return the
    output."""
    if x.ndim != 2 or codes.ndim != 2:
        raise ValueError(f"{entry}: x {tuple(x.shape)} and the codes "
                         f"{tuple(codes.shape)} must be 2-D")
    N = codes.shape[1]
    if codes.shape[0] != k_rows or tuple(scale.shape) != (N,):
        raise ValueError(f"{entry}: x {tuple(x.shape)}, codes "
                         f"{tuple(codes.shape)} and scale "
                         f"{tuple(scale.shape)} do not agree")
    if (x.dtype not in (torch.float32, torch.bfloat16)
            or codes.dtype != torch.uint8 or scale.dtype != torch.float32):
        raise TypeError(f"{entry} takes f32 or bf16 x, uint8 codes and f32 "
                        f"scale; got {x.dtype}, {codes.dtype}, {scale.dtype}")
    if not (codes.device == x.device == scale.device):
        raise ValueError(f"{entry}: x, codes and scale must be on one device")
    refuse_grad(entry, x, scale, why=NO_GRAD)
    x, codes, scale = x.contiguous(), codes.contiguous(), scale.contiguous()
    return launch_chunk_mm(
        entry, plane, x, codes,
        (scale.data_ptr(), piece_table(plane, x.device).data_ptr()),
        tail=(int(x.dtype == torch.bfloat16),))


def dpot_matmul(x: torch.Tensor, wq: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """K1: x (M, K) f32/bf16 @ W8 codes wq (K, N) uint8 with scale (N,)
    f32 -> (M, N) in x's dtype."""
    if x.device.type == "cpu":
        return dpot_matmul_plain(x, wq, scale)
    out = _launch("dpot_matmul", "w8", x, wq, scale, x.shape[-1])
    dpot_matmul.launches += 1
    return out


def dpot_matmul_w4(x: torch.Tensor, wq4: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """K8: x (M, K) f32/bf16 @ W4 nibble pairs wq4 (K/2, N) uint8 with
    scale (N,) f32 -> (M, N) in x's dtype; K must be even."""
    if x.device.type == "cpu":
        return dpot_matmul_w4_plain(x, wq4, scale)
    if x.shape[-1] % 2:
        raise ValueError(f"dpot_matmul_w4: K={x.shape[-1]} must be even")
    out = _launch("dpot_matmul_w4", "w4", x, wq4, scale, x.shape[-1] // 2)
    dpot_matmul_w4.launches += 1
    return out


dpot_matmul.launches = 0
dpot_matmul_w4.launches = 0
