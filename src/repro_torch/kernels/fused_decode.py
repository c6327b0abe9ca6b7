"""One whole RWKV-4 block decode step per launch (kernel K3).

Port of `repro/kernels/fused_decode.py:fused_block_decode` for the RWKV-4
body with Δ-PoT W8 weights and exact numerics.  Pallas traced the model's
`block_decode` inside the kernel; CUDA cannot trace, so the body is
written into `csrc/rwkv4_block_decode.cu`, which rounds to bf16 at the
places the JAX trace does.  Its header says what bounds it on an H100 and
how its design answers that.

A CPU tensor takes the plain version — `models/rwkv4.py:block_decode` on
the layer's weights decoded by `unpack_leaf`, exactly what the JAX kernel
body ran; a CUDA tensor launches the kernel or raises (the CUDA kernel
takes W8 planes and a bf16 state only; plain bf16 weights and the W4/VQ
planes are not ported yet).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant.serving import is_packed_leaf, unpack_leaf
from repro_torch.device import exact_matmuls
from repro_torch.kernels.build import check, load_library, stream_ptr
from repro_torch.tree import tree_map

# the RWKV-4 decode state leaves, in the order the kernel takes them
STATE_KEYS = ("att_x", "ffn_x", "wkv_a", "wkv_b", "wkv_o")
MAX_BB = 8  # batch lanes per block the kernel instantiates


@exact_matmuls()
def rwkv4_block_decode_plain(lp, st, x):
    """The plain version: decode the packed leaves, run `block_decode`."""
    from repro_torch.models.rwkv4 import block_decode
    lp = tree_map(lambda l: unpack_leaf(l).to(x.dtype)
                  if is_packed_leaf(l) else l, lp, is_leaf=is_packed_leaf)
    return block_decode(lp, st, x)


def default_bb(B: int) -> int:
    """The batch tile: the whole batch in one block (as fused_decode.py:91)
    when it fits the kernel, else the largest divisor of B that does."""
    return max(d for d in range(1, min(B, MAX_BB) + 1) if B % d == 0)


def _w8(leaf, K: int, N: int, name: str):
    if not is_packed_leaf(leaf):
        raise TypeError(f"rwkv4_block_decode on CUDA takes Δ-PoT W8 planes; "
                        f"{name} is not packed")
    p, s = leaf["packed"], leaf["scale"].reshape(-1)
    if p.shape != (K, N) or p.dtype != torch.uint8 or not p.is_contiguous():
        raise ValueError(f"{name}: codes must be contiguous uint8 {(K, N)}, "
                         f"got {p.dtype} {tuple(p.shape)}")
    if s.numel() != N or s.dtype != torch.float32:
        raise ValueError(f"{name}: scale must be f32 with {N} entries")
    return [p, s.contiguous()]


def _vec(t, n: int, dtype, name: str):
    if t.shape != (n,) or t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} {(n,)}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def rwkv4_block_decode(lp, st, x, *, bb: int | None = None):
    """One layer's decode step: lp the layer's params (compute-cast, W8
    leaves with a (1, N) scale), st the five (B, D) state leaves, x (B, D)
    bf16 -> (x2 (B, D), new state)."""
    if x.device.type == "cpu":
        return rwkv4_block_decode_plain(lp, st, x)
    B, D = x.shape
    if not is_packed_leaf(lp["ffn"]["wk"]):
        raise TypeError("rwkv4_block_decode on CUDA takes Δ-PoT W8 planes")
    F = lp["ffn"]["wk"]["packed"].shape[-1]
    bb = default_bb(B) if bb is None else int(bb)
    if not 1 <= bb <= MAX_BB or B % bb:
        raise ValueError(f"batch tile bb={bb} must divide B={B} and lie in "
                         f"[1, {MAX_BB}]")
    bf = torch.bfloat16
    if x.dtype != bf:
        raise TypeError(f"x must be bf16, got {x.dtype}")
    att, ffn = lp["att"], lp["ffn"]
    ptrs = [x.contiguous()]
    for ln in ("ln1", "ln2"):
        ptrs += [_vec(lp[ln]["scale"], D, bf, f"{ln}.scale"),
                 _vec(lp[ln]["bias"], D, bf, f"{ln}.bias")]
    for name in ("time_mix_r", "time_mix_k", "time_mix_v", "time_decay",
                 "time_first"):
        ptrs.append(_vec(att[name], D, bf, f"att.{name}"))
    for name in ("wr", "wk", "wv", "wo"):
        ptrs += _w8(att[name], D, D, f"att.{name}")
    ptrs += [_vec(ffn["time_mix_r"], D, bf, "ffn.time_mix_r"),
             _vec(ffn["time_mix_k"], D, bf, "ffn.time_mix_k")]
    ptrs += _w8(ffn["wr"], D, D, "ffn.wr")
    ptrs += _w8(ffn["wk"], D, F, "ffn.wk")
    ptrs += _w8(ffn["wv"], F, D, "ffn.wv")
    for k in STATE_KEYS:
        s = st[k]
        if s.shape != (B, D) or s.dtype != bf:
            raise TypeError(f"state {k}: expected bf16 {(B, D)}, got "
                            f"{s.dtype} {tuple(s.shape)}")
        ptrs.append(s.contiguous())
    if any(t.device != x.device for t in ptrs):
        raise ValueError("rwkv4_block_decode: operands on several devices")
    outs = [torch.empty((B, D), dtype=bf, device=x.device)
            for _ in range(1 + len(STATE_KEYS))]
    arr = (ctypes.c_void_p * (len(ptrs) + len(outs)))(
        *(t.data_ptr() for t in ptrs + outs))
    check(load_library().rwkv4_block_decode(
        arr, len(arr), B, D, F, bb, stream_ptr(x)), "rwkv4_block_decode")
    rwkv4_block_decode.launches += 1
    return outs[0], dict(zip(STATE_KEYS, outs[1:]))


rwkv4_block_decode.launches = 0
