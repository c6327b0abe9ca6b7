"""Fused flash attention, forward (kernel K13) and backward (K13-dq and
K13-dkv).

Port of `repro/kernels/flash_attention.py:flash_attention`: causal or
full attention with GQA, an online softmax over key tiles, the scores
kept on chip, and the log-sum-exp of each row that the backward needs
(`_kernel`, `_kernel_fwd`); the backward recomputes p = exp(s - lse) tile
by tile and runs the dq and dk/dv products (`_kernel_dq`, `_kernel_dkv`,
launched by `_bwd_call`).  The CUDA kernels are `csrc/flash_attention.cu`
and `csrc/flash_attention_bwd.cu`.  The bf16 kernels run every product
on the tensor cores: q·kᵀ and dout·vᵀ on the raw bf16 operands (exact
products), and each product with an f32 operand (p·v in the forward; ds·k,
dsᵀ·q and pᵀ·dout in the backward) with that operand split into two bf16
pieces (`split_bf16x2` is the split's plain twin), so p and ds keep nearly
all their f32 precision; the f32 kernels run f32 FMAs on the CUDA cores
(each header says what bounds it and how it is built).

Layout at the public functions, as in JAX: q (B, Sq, H, d), k and v
(B, Skv, KVH, d) with H % KVH == 0; query head h reads kv head
h // (H // KVH), the head `jnp.repeat(k, H // KVH, axis=2)` gives it
(the kernels index it; nothing is repeated in memory).  f32 or bf16 in,
q's dtype out; d up to 128; any Sq, Skv >= 1.  The causal mask is
kpos <= qpos with both positions counted from 0.  The lse is (B, H, Sq)
f32 (JAX's is (B·H, Sq)).

`flash_attention` carries gradients when grad mode is on and an input
requires them: it then runs through an autograd Function that saves (q,
k, v, out, lse) in their own dtypes, as JAX's custom VJP saves them, and
whose backward is `flash_attention_bwd`.  Under no_grad and
inference_mode it is one forward launch and saves nothing.

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


def split_bf16x2(x: torch.Tensor):
    """The bf16 kernels' split of an f32 operand into two bf16 pieces
    (`csrc/common.cuh:c_to_a_pieces`), in plain torch, for the tests: hi =
    bf16(x), lo = bf16(x - hi), both rounded to nearest even and returned
    as f32.  x - hi is exact, so |x - hi - lo| <= 2^-17·|x| while x - hi is
    a normal f32, and <= 2^-134 (half bf16's least subnormal) below that;
    hi is finite for |x| < (2 - 2^-8)·2^127."""
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _vec_rows(*ts) -> bool:
    """Whether the bf16 kernels may copy rows in 16-byte chunks: whole
    chunks (d % 8 == 0), every tensor on a 16-byte address."""
    return ts[0].shape[-1] % 8 == 0 and all(t.data_ptr() % 16 == 0
                                            for t in ts)


def _forward(q, k, v, causal: bool, return_lse: bool):
    """One forward: the plain version on the CPU, K13 on the card."""
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
        ctypes.c_float(1.0 / math.sqrt(d)), int(_vec_rows(q, k, v)),
        stream_ptr(q)),
        "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


class _FlashAttention(torch.autograd.Function):
    """K13 with its backward: the forward keeps (q, k, v, out, lse) as
    JAX's `_flash_core_fwd` does; the backward is `flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _forward(q, k, v, causal, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(),
                                         causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True,
                    return_lse: bool = False):
    """Attention of q over k, v: (B, Sq, H, d) in q's dtype, and with
    `return_lse` also the (B, H, Sq) f32 log-sum-exp of each row.  With
    grad mode on and an input that requires grad, the result carries
    gradients through K13-dq and K13-dkv (the plain backward on CPU
    tensors)."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = _FlashAttention.apply(q, k, v, causal)
        return (out, lse) if return_lse else out
    return _forward(q, k, v, causal, return_lse)


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# Backward: dq and dk/dv (K13-dq, K13-dkv)
# ---------------------------------------------------------------------------


def _check_bwd(q, k, v, o, lse, do):
    _check(q, k, v)
    B, Sq, H, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"out and dout must be q's {q.dtype} "
                         f"{tuple(q.shape)}, got {o.dtype} "
                         f"{tuple(o.shape)} and {do.dtype} "
                         f"{tuple(do.shape)}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 {(B, H, Sq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if not (q.device == o.device == lse.device == do.device):
        raise ValueError("the backward's operands lie on different devices")


def _delta(o, do):
    """D = rowsum(dout ∘ out) in f32, (B, H, Sq): what `_bwd_call`
    computes outside its Pallas calls."""
    return (do.to(torch.float32) * o.to(torch.float32)).sum(dim=-1) \
        .transpose(1, 2).contiguous()


def _group_sum(x, rep: int):
    """(B, S, H, d) per-query-head gradients -> (B, S, H/rep, d): the
    transpose of `jnp.repeat(k, rep, axis=2)`, which XLA takes as a sum
    over each group's heads in order, every add rounded to x's dtype."""
    B, S, H, d = x.shape
    x = x.reshape(B, S, H // rep, rep, d)
    acc = x[..., 0, :]
    for i in range(1, rep):
        acc = acc + x[..., i, :]
    return acc.contiguous()


@exact_matmuls()
def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True):
    """`_kernel_dq` and `_kernel_dkv`'s arithmetic in f32 over all keys at
    once: the scores of q·scale, the -1e30 mask, p = exp(s - lse), dp =
    dout·v, ds = p·(dp - D), dq = scale·ds·k, dk = scale·dsᵀ·q, dv =
    pᵀ·dout; dq rounded once to q's dtype, dk and dv per query head rounded
    to k's dtype and then summed over each GQA group in that dtype, as
    JAX's `_flash_core_bwd` and `jnp.repeat`'s transpose do.  Returns (dq,
    dk, dv) shaped like q, k, v."""
    _check_bwd(q, k, v, o, lse, do)
    B, Sq, H, d = q.shape
    rep = H // k.shape[2]
    f32 = torch.float32
    scale = 1.0 / math.sqrt(d)
    q32, do32 = q.to(f32), do.to(f32)
    k32 = k.to(f32).repeat_interleave(rep, dim=2)
    v32 = v.to(f32).repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q32 * scale, k32)
    if causal:
        qpos = torch.arange(Sq, device=q.device)
        kpos = torch.arange(k.shape[1], device=q.device)
        s = torch.where((kpos[None, :] <= qpos[:, None])[None, None], s,
                        NEG_INF)
    p = torch.exp(s - lse[..., None])
    del s
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v32)
    ds = p * (dp - _delta(o, do)[..., None])
    del dp
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds, k32)
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, q32)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    return (dq.to(q.dtype), _group_sum(dk.to(k.dtype), rep),
            _group_sum(dv.to(v.dtype), rep))


def bwd_bounds(q, k, v, o, lse, do, causal, ref):
    """Per output of (dq, dk, dv), the bound on |kernel - plain|: one step
    of the output's type (2^-7 |ref| for bf16, 2^-22 for f32) plus the f32
    summation floor (rep·Sq + Skv + d + 8)·2^-24 times the magnitude of the
    terms each output sums (ds's own error carried through: p·(|do|@|v|ᵀ
    + |D| + |dp - D|·(scale·|q|@|k|ᵀ + 1))), and, for bf16 dk and dv, the
    plain version's rep per-head roundings and rep - 1 bf16 adds (JAX's
    order), rep·2^-8 times the sum of the per-head magnitudes.  The
    checks of K13-dq and K13-dkv (tests/test_torch_cuda.py, chip_smoke.py)
    and of their numerics on the CPU (tests/test_torch_flash.py) hold to
    it; no kernel path calls it."""
    B, Sq, H, d = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    rep, scale = H // KVH, 1.0 / math.sqrt(d)
    F = (rep * Sq + Skv + d + 8) * 2.0 ** -24
    group = lambda t: t.reshape(B, Skv, KVH, rep, d).sum(dim=3)
    with exact_matmuls():
        q32, do32 = q.float(), do.float()
        k32 = k.float().repeat_interleave(rep, dim=2)
        v32 = v.float().repeat_interleave(rep, dim=2)
        e = torch.einsum
        s = e("bqhd,bkhd->bhqk", q32 * scale, k32)
        keep = torch.ones_like(s, dtype=torch.bool)
        if causal:
            keep = (torch.arange(Skv, device=q.device)[None, :]
                    <= torch.arange(Sq, device=q.device)[:, None])
        p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
        del s, keep
        D = (do32 * o.float()).sum(-1).transpose(1, 2)[..., None]
        dp = e("bqhd,bkhd->bhqk", do32, v32)
        ms = scale * e("bqhd,bkhd->bhqk", q32.abs(), k32.abs())
        a = p * (e("bqhd,bkhd->bhqk", do32.abs(), v32.abs()) + D.abs()
                 + (dp - D).abs() * (ms + 1.0))
        fl = [F * scale * e("bhqk,bkhd->bqhd", a, k32.abs()),
              F * scale * group(e("bhqk,bqhd->bkhd", a, q32.abs())),
              F * group(e("bhqk,bqhd->bkhd", p * (ms + 1.0), do32.abs()))]
        del a, ms
        if q.dtype == torch.bfloat16:
            ds = p * (dp - D)
            fl[1] = fl[1] + rep * 2.0 ** -8 * group(
                scale * e("bhqk,bqhd->bkhd", ds, q32).abs())
            fl[2] = fl[2] + rep * 2.0 ** -8 * group(
                e("bhqk,bqhd->bkhd", p, do32).abs())
    rel = 2.0 ** -7 if q.dtype == torch.bfloat16 else 2.0 ** -22
    return [rel * r.float().abs() + f for r, f in zip(ref, fl)]


def _bwd_args(q, k, v, do, lse, delta):
    """The backward kernels' leading pointers and dimensions, from
    contiguous operands."""
    B, Sq, H, d = q.shape
    return ((q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr()),
            (B, Sq, k.shape[1], H, k.shape[2], d))


def _bwd_tail(q, k, v, do):
    """The backward kernels' trailing arguments: is_bf16, scale, vec and
    the stream."""
    return (int(q.dtype == torch.bfloat16),
            ctypes.c_float(1.0 / math.sqrt(q.shape[-1])),
            int(_vec_rows(q, k, v, do)), stream_ptr(q))


def _on_card(q, name: str):
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {q.device}")


def flash_attention_dq(q, k, v, o, lse, do, *, causal: bool = True,
                       delta=None):
    """dq (B, Sq, H, d) in q's dtype: K13-dq on the card (D = `_delta(o,
    do)` unless given), the plain backward's dq on the CPU."""
    _check_bwd(q, k, v, o, lse, do)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do,
                                         causal=causal)[0]
    _on_card(q, "flash_attention_dq")
    q, k, v, do, lse = (t.contiguous() for t in (q, k, v, do, lse))
    delta = _delta(o, do) if delta is None else delta.contiguous()
    dq = torch.empty_like(q)
    ptrs, dims = _bwd_args(q, k, v, do, lse, delta)
    check(load_library().flash_attention_dq(
        *ptrs, dq.data_ptr(), *dims, int(causal), *_bwd_tail(q, k, v, do)),
        "flash_attention_dq")
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, o, lse, do, *, causal: bool = True,
                        delta=None):
    """(dk, dv) (B, Skv, KVH, d) in k's dtype, each GQA group summed in f32
    and rounded once: K13-dkv on the card, the plain backward's on the
    CPU."""
    _check_bwd(q, k, v, o, lse, do)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do,
                                         causal=causal)[1:]
    _on_card(q, "flash_attention_dkv")
    q, k, v, do, lse = (t.contiguous() for t in (q, k, v, do, lse))
    delta = _delta(o, do) if delta is None else delta.contiguous()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ptrs, dims = _bwd_args(q, k, v, do, lse, delta)
    check(load_library().flash_attention_dkv(
        *ptrs, dk.data_ptr(), dv.data_ptr(), *dims, int(causal),
        *_bwd_tail(q, k, v, do)), "flash_attention_dkv")
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True):
    """(dq, dk, dv) of the attention whose forward gave `o` and `lse`,
    for the output gradient `do`: the plain version on the CPU, K13-dq and
    K13-dkv (sharing one D) on the card."""
    _check_bwd(q, k, v, o, lse, do)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    _on_card(q, "flash_attention_bwd")
    delta = _delta(o, do)
    dq = flash_attention_dq(q, k, v, o, lse, do, causal=causal, delta=delta)
    dk, dv = flash_attention_dkv(q, k, v, o, lse, do, causal=causal,
                                 delta=delta)
    return dq, dk, dv
