"""Chunked-prefill building blocks: the chunk matmuls over the three
weight planes (kernels K5, K5-W4, K5-VQ) and the plain prefix-mask helpers.

Port of `repro/kernels/fused_prefill.py`.  Each wrapper replaces one TPU
kernel, x (M, K) bf16 @ a quantized plane decoded inside the kernel:

  dpot_w8_matmul  `dpot_chunk_matmul` (`_mm_kernel`)     W8 (K, N) + (N,) f32
  dpot_w4_matmul  `w4_chunk_matmul` (`_mm_kernel_w4`)    W4 (K/2, N) + (N,) f32
  vq_matmul       `vq_chunk_matmul` (`_mm_kernel_vq`)    VQ (K, N) + (C,) bf16

All three are one CUDA kernel template over a weight-decode policy
(`csrc/chunk_matmul.cu`; its header says what bounds it on an H100 and
how its design answers that).  The serving path calls them for every
prefill matmul (M = B·C) and for the prefill and decode heads (M = B).
`dpot_w8_matmul_f32x` is K5 for an f32 x, returning f32 (the TPU
kernel's `result_type(x, dt)`): under the hardware numerics att.wo's
input is f32.

A CPU tensor takes the plain version, `x @ unpack_leaf(leaf).to(bf16)`; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant.serving import leaf_plane, unpack_leaf
from repro_torch.device import exact_matmuls
from repro_torch.kernels.build import check, load_library, stream_ptr


@exact_matmuls()
def dpot_w8_matmul_plain(x: torch.Tensor, wq: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """The plain version: decode the whole plane, then one matmul."""
    w = unpack_leaf({"packed": wq, "scale": scale.reshape(1, -1)})
    return x @ w.to(x.dtype)


@exact_matmuls()
def dpot_w4_matmul_plain(x: torch.Tensor, wq4: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    w = unpack_leaf({"packed4": wq4, "scale": scale.reshape(1, -1)})
    return x @ w.to(x.dtype)


@exact_matmuls()
def vq_matmul_plain(x: torch.Tensor, idx: torch.Tensor,
                    codebook: torch.Tensor) -> torch.Tensor:
    w = unpack_leaf({"vq_idx": idx, "codebook": codebook})
    return x @ w.to(x.dtype)


def _check_operands(name, x, codes, aux, k_rows: int, aux_dtype,
                    aux_len: int | None, x_dtypes=(torch.bfloat16,)):
    M, K = x.shape
    Kc, N = codes.shape
    if Kc != k_rows or (aux_len is not None and aux.numel() != aux_len):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)} codes "
                         f"{tuple(codes.shape)} aux {aux.numel()} do not "
                         "agree")
    if (x.dtype not in x_dtypes or codes.dtype != torch.uint8
            or aux.dtype != aux_dtype):
        raise TypeError(f"{name} takes {x_dtypes} x, uint8 codes, "
                        f"{aux_dtype} aux; got {x.dtype}, {codes.dtype}, "
                        f"{aux.dtype}")
    if not (codes.device == x.device == aux.device):
        raise ValueError(f"{name}: x, codes and aux must be on one device")
    if not codes.is_contiguous():
        raise ValueError(f"{name}: codes must be contiguous")
    return M, K, N


def _w8_launch(x, wq, scale, entry: str, x_dtype):
    scale = scale.reshape(-1)
    M, K, N = _check_operands(entry, x, wq, scale, x.shape[1],
                              torch.float32, wq.shape[1], (x_dtype,))
    x, scale = x.contiguous(), scale.contiguous()
    out = torch.empty((M, N), dtype=x_dtype, device=x.device)
    check(getattr(load_library(), entry)(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
        M, K, N, stream_ptr(x)), entry)
    return out


def dpot_w8_matmul(x: torch.Tensor, wq: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) bf16 @ W8 plane wq (K, N) uint8 with scale (..., N) f32
    -> (M, N) bf16, the codes decoded in-kernel."""
    if x.device.type == "cpu":
        return dpot_w8_matmul_plain(x, wq, scale)
    out = _w8_launch(x, wq, scale, "dpot_w8_matmul", torch.bfloat16)
    dpot_w8_matmul.launches += 1
    return out


def dpot_w8_matmul_f32x(x: torch.Tensor, wq: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """K5's f32-activation form: x (M, K) f32 @ the W8 plane -> (M, N)
    f32, the bf16 weights promoted and the f32 sum not rounded."""
    if x.device.type == "cpu":
        return dpot_w8_matmul_plain(x, wq, scale)
    out = _w8_launch(x, wq, scale, "dpot_w8_matmul_f32x", torch.float32)
    dpot_w8_matmul_f32x.launches += 1
    return out


def dpot_w4_matmul(x: torch.Tensor, wq4: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) bf16 @ W4 plane wq4 (K/2, N) uint8 (row 2k in the low
    nibble of packed row k) with scale (..., N) f32 -> (M, N) bf16."""
    if x.device.type == "cpu":
        return dpot_w4_matmul_plain(x, wq4, scale)
    scale = scale.reshape(-1)
    if x.shape[1] % 2:
        raise ValueError(f"dpot_w4_matmul: K={x.shape[1]} must be even")
    M, K, N = _check_operands("dpot_w4_matmul", x, wq4, scale,
                              x.shape[1] // 2, torch.float32, wq4.shape[1])
    x, scale = x.contiguous(), scale.contiguous()
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    check(load_library().dpot_w4_matmul(
        x.data_ptr(), wq4.data_ptr(), scale.data_ptr(), out.data_ptr(),
        M, K, N, stream_ptr(x)), "dpot_w4_matmul")
    dpot_w4_matmul.launches += 1
    return out


def vq_matmul(x: torch.Tensor, idx: torch.Tensor,
              codebook: torch.Tensor) -> torch.Tensor:
    """x (M, K) bf16 @ codebook[idx (K, N) uint8], codebook (..., C) bf16
    with C <= 256 -> (M, N) bf16."""
    if x.device.type == "cpu":
        return vq_matmul_plain(x, idx, codebook)
    cb = codebook.reshape(-1)
    M, K, N = _check_operands("vq_matmul", x, idx, cb, x.shape[1],
                              torch.bfloat16, None)
    C = cb.numel()
    if not 1 <= C <= 256:
        raise ValueError(f"vq_matmul: codebook of {C} entries; uint8 "
                         "indices need 1..256")
    x, cb = x.contiguous(), cb.contiguous()
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    check(load_library().vq_matmul(
        x.data_ptr(), idx.data_ptr(), cb.data_ptr(), C, out.data_ptr(),
        M, K, N, stream_ptr(x)), "vq_matmul")
    vq_matmul.launches += 1
    return out


dpot_w8_matmul.launches = 0
dpot_w8_matmul_f32x.launches = 0
dpot_w4_matmul.launches = 0
vq_matmul.launches = 0


def chunk_matmul(x: torch.Tensor, leaf, dt) -> torch.Tensor:
    """`x @ leaf` over a (..., K) chunk tensor, plane aware: plain leaves
    take the torch matmul (as the JAX package leaves them to XLA); a plane
    leaf flattens the chunk to (S·C, K) and runs its kernel (K5, K5-W4 or
    K5-VQ).  x is in the compute dtype `dt`, or f32 (the result then f32,
    the weights promoted, as JAX's matmul promotes them)."""
    plane = leaf_plane(leaf)
    if plane is None:
        return x @ leaf.to(x.dtype)
    if x.dtype not in (dt, torch.float32):
        raise TypeError(f"chunk_matmul: x is {x.dtype}, compute dtype {dt}")
    lead, K = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, K)
    if plane == "w4":
        out = dpot_w4_matmul(xf, leaf["packed4"], leaf["scale"])
    elif plane == "vq":
        out = vq_matmul(xf, leaf["vq_idx"], leaf["codebook"])
    elif x.dtype == torch.float32:
        out = dpot_w8_matmul_f32x(xf, leaf["packed"], leaf["scale"])
    else:
        out = dpot_w8_matmul(xf, leaf["packed"], leaf["scale"])
    return out.reshape(*lead, out.shape[-1])


def shifted_prev(seq: torch.Tensor, first: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Token-shift previous-value sequence under a per-slot PREFIX mask.

    seq (B, C, D) are the per-position carry candidates; first (B, D) the
    incoming pool carry.  Position t sees seq[t-1] inside the valid prefix,
    the LAST valid entry once the prefix ends (the per-op oracle freezes
    its carry there), and `first` at t = 0 or on lanes with no valid
    token."""
    B, C = valid.shape
    nv = valid.to(torch.int32).sum(dim=1)
    j = torch.minimum(torch.arange(C, device=seq.device)[None, :],
                      nv[:, None]) - 1                           # (B, C)
    idx = j.clamp(min=0)[..., None].expand(B, C, seq.shape[-1])
    got = torch.gather(seq, 1, idx)
    return torch.where((j >= 0)[..., None], got, first[:, None])


def gather_last_valid(seq: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """seq (B, C, ...) -> (B, ...): the row of lane b at position idx[b]."""
    return seq[torch.arange(seq.shape[0], device=seq.device), idx]


def last_valid_select(seq: torch.Tensor, old: torch.Tensor,
                      n_valid: torch.Tensor) -> torch.Tensor:
    """Final-state helper: the last valid position of `seq` cast to `old`'s
    dtype, or `old` itself on lanes whose chunk had no valid token."""
    got = gather_last_valid(seq, (n_valid - 1).clamp(min=0)).to(old.dtype)
    anyv = (n_valid > 0).reshape((-1,) + (1,) * (old.ndim - 1))
    return torch.where(anyv, got, old)
