"""Chunked-prefill building blocks: the W8 chunk matmul (kernel K5) and
the plain prefix-mask helpers.

Port of `repro/kernels/fused_prefill.py`.  `dpot_w8_matmul` replaces the
TPU kernel `dpot_chunk_matmul` (`_mm_kernel`): x (M, K) bf16 @ the W8
plane (K, N) with its per-channel f32 scale, decoding the uint8 codes in
the kernel (`csrc/dpot_w8_matmul.cu`; its header says what bounds it on
an H100 and how its design answers that).  The serving path calls it for
every prefill matmul (M = B·C) and for the prefill and decode heads
(M = B).

A CPU tensor takes the plain version, `x @ unpack_leaf(w).to(bf16)`; a
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


def dpot_w8_matmul(x: torch.Tensor, wq: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) bf16 @ W8 plane wq (K, N) uint8 with scale (..., N) f32
    -> (M, N) bf16, the codes decoded in-kernel."""
    if x.device.type == "cpu":
        return dpot_w8_matmul_plain(x, wq, scale)
    M, K = x.shape
    K2, N = wq.shape
    scale = scale.reshape(-1)
    if K != K2 or scale.numel() != N:
        raise ValueError(f"shapes x {tuple(x.shape)} wq {tuple(wq.shape)} "
                         f"scale {scale.numel()} do not agree")
    if (x.dtype != torch.bfloat16 or wq.dtype != torch.uint8
            or scale.dtype != torch.float32):
        raise TypeError(f"dpot_w8_matmul takes bf16 x, uint8 wq, f32 scale; "
                        f"got {x.dtype}, {wq.dtype}, {scale.dtype}")
    if not (wq.device == x.device == scale.device):
        raise ValueError("x, wq and scale must be on one device")
    if not wq.is_contiguous():
        raise ValueError("wq must be contiguous")
    x, scale = x.contiguous(), scale.contiguous()
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    check(load_library().dpot_w8_matmul(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
        M, K, N, stream_ptr(x)), "dpot_w8_matmul")
    dpot_w8_matmul.launches += 1
    return out


dpot_w8_matmul.launches = 0


def chunk_matmul(x: torch.Tensor, leaf, dt) -> torch.Tensor:
    """`x @ leaf` over a (..., K) chunk tensor, packed-leaf aware: plain
    leaves take the torch matmul (as the JAX package leaves them to XLA);
    a W8 leaf flattens the chunk to (S·C, K) and runs K5."""
    if leaf_plane(leaf) is None:
        return x @ leaf
    if x.dtype != dt:
        raise TypeError(f"chunk_matmul: x is {x.dtype}, compute dtype {dt}")
    lead, K = x.shape[:-1], x.shape[-1]
    out = dpot_w8_matmul(x.reshape(-1, K), leaf["packed"], leaf["scale"])
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
