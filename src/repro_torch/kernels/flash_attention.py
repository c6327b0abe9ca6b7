"""Fused flash attention, forward (kernel K13).

Port of `repro/kernels/flash_attention.py:flash_attention`, the forward
(`_kernel`, `_kernel_fwd`): causal or full attention with GQA, an online
softmax over key tiles, the scores kept on chip, and optionally the
log-sum-exp of each row that the backward needs.  The backward (`_kernel_dq`,
`_kernel_dkv`) comes with the training slice.  The CUDA kernel is
`csrc/flash_attention.cu`.

Layout at the public function, as in JAX: q (B, Sq, H, d), k and v
(B, Skv, KVH, d) with H % KVH == 0; query head h reads kv head
h // (H // KVH), the head `jnp.repeat(k, H // KVH, axis=2)` gives it
(the kernel indexes it; nothing is repeated in memory).  f32 or bf16 in,
q's dtype out; d up to 128; any Sq, Skv >= 1.  The causal mask is
kpos <= qpos with both positions counted from 0.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.device import exact_matmuls
from repro_torch.kernels.build import check, load_library, stream_ptr

NEG_INF = -1e30
MAX_HEAD_DIM = 128
_DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention takes q, k, v all f32 or all bf16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q (B,Sq,H,d) and k = v (B,Skv,KVH,d) expected, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, d = q.shape
    Bk, Skv, KVH, dk = k.shape
    if Bk != B or dk != d or min(B, Sq, Skv, H, KVH) < 1:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                         "not pair")
    if H % KVH:
        raise ValueError(f"H={H} is not a multiple of KVH={KVH}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")


@exact_matmuls()
def flash_attention_plain(q, k, v, *, causal: bool = True,
                          return_lse: bool = False):
    """`_kernel`'s arithmetic in f32 over all keys at once: q·scale, the
    scores, the -1e30 mask, the row max, exp, the sum, p @ v, then the
    divide by max(l, 1e-30), rounded once to q's dtype; lse = m +
    log(max(l, 1e-30)) per row, (B, H, Sq) f32."""
    _check(q, k, v)
    B, Sq, H, d = q.shape
    rep = H // k.shape[2]
    f32 = torch.float32
    q32 = q.to(f32) * (1.0 / math.sqrt(d))
    k32 = k.to(f32).repeat_interleave(rep, dim=2)
    v32 = v.to(f32).repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q32, k32)
    if causal:
        qpos = torch.arange(Sq, device=q.device)
        kpos = torch.arange(k.shape[1], device=q.device)
        s = torch.where((kpos[None, :] <= qpos[:, None])[None, None], s,
                        NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp_min(p.sum(dim=-1), 1e-30)
    acc = torch.einsum("bhqk,bkhd->bqhd", p, v32)
    out = (acc / l.transpose(1, 2)[..., None]).to(q.dtype)
    if return_lse:
        return out, m + torch.log(l)
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    return_lse: bool = False):
    """Attention of q over k, v: (B, Sq, H, d) in q's dtype, and with
    `return_lse` also the (B, H, Sq) f32 log-sum-exp of each row."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     return_lse=return_lse)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device "
                           f"{q.device}")
    B, Sq, H, d = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    check(load_library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, Sq, Skv, H, KVH, d,
        int(causal), int(q.dtype == torch.bfloat16),
        ctypes.c_float(1.0 / math.sqrt(d)), stream_ptr(q)),
        "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
