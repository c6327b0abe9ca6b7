"""The masked sequential RWKV-6 WKV kernel (kernel K6).

Port of `repro/kernels/wkv6.py:wkv6_seq_pallas` (`_seq_kernel`): the
exact per-step `wkv6_step` recurrence over a prompt chunk, each head's
(N, N) state kept on chip for the whole window, with the `valid` commit
mask and the `carry_dtype` snap of the chunked prefill.  The CUDA kernel
is `csrc/wkv6_seq.cu`; its header says what bounds it on an H100 and how
its design answers that.  The chunked form `wkv6_pallas` (K10) waits for
the training slice.

The initial state may be f32 or the bf16 pool state itself: bf16 -> f32
is exact, so the kernel reads the pool's bf16 bytes and widens them on
chip instead of taking an f32 copy.  The final state is f32 (snapped
through bf16 when the carry is bf16), as the JAX kernel returns it.

A CPU tensor takes the plain version, a step loop over
`core/wkv/wkv6.py:wkv6_step`; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.wkv.wkv6 import wkv6_step
from repro_torch.kernels.build import check, load_library, stream_ptr

_CARRY = {None: None, "float32": None, "bfloat16": torch.bfloat16}


def wkv6_seq_plain(r, k, v, w, u, s0, *, valid=None,
                   carry_dtype: Optional[str] = None):
    """The plain version: T calls of `wkv6_step`, each committed only where
    `valid`, the carry snapped through `carry_dtype` after every step."""
    snap_dt = _CARRY[carry_dtype]
    snap = (lambda t: t) if snap_dt is None else \
        (lambda t: t.to(snap_dt).to(torch.float32))
    S = s0.to(torch.float32)
    ys = []
    for t in range(r.shape[1]):
        new, y = wkv6_step(S, r[:, t], k[:, t], v[:, t], w[:, t], u)
        ys.append(y)
        if valid is not None:
            new = torch.where(valid[:, t, None, None, None] != 0, new, S)
        S = snap(new)
    return torch.stack(ys, dim=1), S


def wkv6_seq(r, k, v, w, u, s0, *, valid=None,
             carry_dtype: Optional[str] = None):
    """r, k, v, w (B, T, H, N) f32; u (H, N) f32; s0 (B, H, N, N) f32 or
    bf16; valid (B, T) or None -> (y (B, T, H, N) f32, S (B, H, N, N)
    f32)."""
    if carry_dtype not in _CARRY:
        raise ValueError(f"carry_dtype {carry_dtype!r}: expected one of "
                         f"{sorted(c for c in _CARRY if c)} or None")
    if r.device.type == "cpu":
        return wkv6_seq_plain(r, k, v, w, u, s0, valid=valid,
                              carry_dtype=carry_dtype)
    B, T, H, N = r.shape
    ops = [r, k, v, w, u]
    if any(t.dtype != torch.float32 or t.device != r.device for t in ops):
        raise TypeError("wkv6_seq takes f32 r, k, v, w, u on one device")
    if s0.dtype not in (torch.float32, torch.bfloat16) or \
            s0.device != r.device:
        raise TypeError(f"wkv6_seq: s0 must be f32 or bf16 on {r.device}, "
                        f"got {s0.dtype} on {s0.device}")
    if any(t.shape != r.shape for t in (k, v, w)) or u.shape != (H, N) \
            or s0.shape != (B, H, N, N):
        raise ValueError("wkv6_seq: operand shapes do not agree")
    ops = [t.contiguous() for t in ops]
    s0 = s0.contiguous()
    vmask = None
    if valid is not None:
        if valid.shape != (B, T):
            raise ValueError(f"valid {tuple(valid.shape)} != {(B, T)}")
        vmask = valid.to(device=r.device, dtype=torch.int32).contiguous()
    y = torch.empty((B, T, H, N), dtype=torch.float32, device=r.device)
    sf = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    check(load_library().wkv6_seq(
        *(t.data_ptr() for t in ops), s0.data_ptr(),
        None if vmask is None else vmask.data_ptr(), y.data_ptr(),
        sf.data_ptr(), B, T, H, N, int(s0.dtype == torch.bfloat16),
        int(_CARRY[carry_dtype] is not None), stream_ptr(r)), "wkv6_seq")
    wkv6_seq.launches += 1
    return y, sf


wkv6_seq.launches = 0
