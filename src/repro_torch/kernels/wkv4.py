"""The masked RWKV-4 WKV sequence kernel (kernel K2) and its backward
(K2-bwd).

Port of `repro/kernels/wkv4.py:wkv4_pallas` with the `valid` commit
mask, the `carry_dtype` snap and both numerics: exact, or, given the
`exp_table`/`div_table` operands (both or neither), the paper's LUT exp
and LUT division (`core/approx/units.py`).  The CUDA kernel is
`csrc/wkv4_seq.cu`; its header says what bounds it on an H100 and how its
design answers that.

On the card, with grad mode on and k, v, w or u requiring grad, the
forward's own call (exact numerics, no `valid`, no carry snap, an initial
state that takes no gradient) runs through an autograd Function whose
backward is `wkv4_seq_bwd` (`csrc/wkv4_bwd.cu`; its header derives the
gradients).  The JAX package has no backward kernel: XLA differentiates
`wkv4_scan`.  Under grad, any other call raises on the card
(`refuse_grad`): the hardware numerics are not trained, as JAX's
`loss_fn` runs the standard ones.

A CPU tensor takes the plain version, a step loop over
`core/wkv/wkv4.py:wkv4_step` that autograd differentiates;
`wkv4_seq_bwd` on CPU tensors is K2-bwd's plain version, the same two
passes in torch ops.  A CUDA tensor launches the kernels or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.approx.units import div_lut, exp_lut
from repro_torch.core.wkv.wkv4 import WKV4State, wkv4_step
from repro_torch.kernels.build import (
    HW_UNTRAINED, check, load_library, refuse_grad, stream_ptr)

_CARRY = {None: None, "float32": None, "bfloat16": torch.bfloat16}


def _units(exp_table, div_table):
    """The (exp, div) of the recurrence: exact, or the LUT units."""
    if (exp_table is None) != (div_table is None):
        raise ValueError("exp_table and div_table travel together")
    if exp_table is None:
        return torch.exp, None
    return (lambda x: exp_lut(x, table=exp_table),
            lambda x, y: div_lut(x, y, table=div_table))


def wkv4_seq_plain(k, v, w, u, a0, b0, o0, *, valid=None,
                   carry_dtype: Optional[str] = None, exp_table=None,
                   div_table=None):
    """The plain version: T calls of `wkv4_step`, each committed only where
    `valid`, the carry snapped through `carry_dtype` after every step."""
    exp, div = _units(exp_table, div_table)
    snap_dt = _CARRY[carry_dtype]
    snap = (lambda t: t) if snap_dt is None else \
        (lambda t: t.to(snap_dt).to(torch.float32))
    a, b, o = a0, b0, o0
    ys = []
    for t in range(k.shape[1]):
        new, y = wkv4_step(WKV4State(a, b, o), k[:, t], v[:, t], w, u,
                           exp=exp, div=div)
        ys.append(y)
        na, nb, no = new
        if valid is not None:
            ok = valid[:, t, None] != 0
            na = torch.where(ok, na, a)
            nb = torch.where(ok, nb, b)
            no = torch.where(ok, no, o)
        a, b, o = snap(na), snap(nb), snap(no)
    return torch.stack(ys, dim=1), (a, b, o)


def wkv4_seq_bwd_plain(k, v, w, u, a0, b0, o0, gy):
    """K2-bwd's two passes in torch ops, step for step (the derivation is
    in `csrc/wkv4_bwd.cu`): a forward pass over K2's state keeping y, the
    denominator and the running max n of each step and summing gw and gu,
    then a reverse pass carrying the output gradient's decayed sums
    against their own running max.  -> (gk, gv, gw, gu)."""
    T = k.shape[1]
    a, b, o = a0, b0, o0
    da, db = torch.zeros_like(a), torch.zeros_like(b)
    gw, gu = torch.zeros_like(a), torch.zeros_like(a)
    saved = []
    for t in range(T):
        kt, vt, gt = k[:, t], v[:, t], gy[:, t]
        n = torch.maximum(o, u + kt)
        A = torch.exp(o - n)
        Bu = torch.exp(u + kt - n)
        den = A * b + Bu
        y = (A * a + Bu * vt) / den
        gw = gw + gt * (da - y * db) * (A / den)
        gu = gu + gt * (vt - y) * (Bu / den)
        saved.append((y, den, n))
        n2 = torch.maximum(o - w, kt)
        A2 = torch.exp(o - w - n2)
        B2 = torch.exp(kt - n2)
        da = A2 * (da - a)
        db = A2 * (db - b)
        a = A2 * a + B2 * vt
        b = A2 * b + B2
        o = n2
    gp, gq = torch.zeros_like(a), torch.zeros_like(a)
    og = torch.full_like(a, -1e38)
    gk, gv = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        kt, vt, gt = k[:, t], v[:, t], gy[:, t]
        y, den, n = saved[t]
        direct = gt * (torch.exp(u + kt - n) / den)
        E = torch.exp(kt + og)
        gk[t] = direct * (vt - y) + E * (gp * vt - gq)
        gv[t] = direct + E * gp
        nog = torch.maximum(og - w, -n)
        A = torch.exp(og - w - nog)
        Bt = torch.exp(-n - nog) * (gt / den)
        gp = A * gp + Bt
        gq = A * gq + Bt * y
        og = nog
    return (torch.stack(gk, dim=1), torch.stack(gv, dim=1), gw.sum(dim=0),
            gu.sum(dim=0))


def _check_f32(ops, device, who):
    if any(t.dtype != torch.float32 or t.device != device for t in ops):
        raise TypeError(f"{who} takes f32 operands on one device")


def wkv4_seq_bwd(k, v, w, u, a0, b0, o0, gy):
    """(gk, gv, gw, gu) of K2's exact y for the output gradient gy
    (B, T, C) f32: the plain passes on the CPU, K2-bwd on the card."""
    if k.device.type == "cpu":
        return wkv4_seq_bwd_plain(k, v, w, u, a0, b0, o0, gy)
    B, T, C = k.shape
    ops = [k, v, w, u, a0, b0, o0, gy]
    _check_f32(ops, k.device, "wkv4_seq_bwd")
    if v.shape != k.shape or gy.shape != k.shape or w.shape != (C,) or \
            u.shape != (C,) or any(s.shape != (B, C) for s in (a0, b0, o0)):
        raise ValueError("wkv4_seq_bwd: operand shapes do not agree")
    ops = [t.contiguous() for t in ops]
    f32 = dict(dtype=torch.float32, device=k.device)
    gk, gv = torch.empty((B, T, C), **f32), torch.empty((B, T, C), **f32)
    gw, gu = torch.empty(C, **f32), torch.empty(C, **f32)
    part = torch.empty((2, B, C), **f32)
    scratch = torch.empty((3, B, T, C), **f32)
    check(load_library().wkv4_seq_bwd(
        *(t.data_ptr() for t in ops), gk.data_ptr(), gv.data_ptr(),
        gw.data_ptr(), gu.data_ptr(), part.data_ptr(), scratch.data_ptr(),
        B, T, C, stream_ptr(k)), "wkv4_seq_bwd")
    wkv4_seq_bwd.launches += 1
    return gk, gv, gw, gu


wkv4_seq_bwd.launches = 0


def _forward(k, v, w, u, a0, b0, o0, *, valid, carry_dtype, exp_table,
             div_table):
    """One forward: the plain version on the CPU, K2 on the card."""
    if k.device.type == "cpu":
        return wkv4_seq_plain(k, v, w, u, a0, b0, o0, valid=valid,
                              carry_dtype=carry_dtype, exp_table=exp_table,
                              div_table=div_table)
    B, T, C = k.shape
    tabs = [] if exp_table is None else [exp_table, div_table]
    if any(t.shape != (256,) for t in tabs):
        raise ValueError("exp_table and div_table must be (256,)")
    ops = [k, v, w, u, a0, b0, o0, *tabs]
    _check_f32(ops, k.device, "wkv4_seq")
    if v.shape != k.shape or w.shape != (C,) or u.shape != (C,) or any(
            s.shape != (B, C) for s in (a0, b0, o0)):
        raise ValueError("wkv4_seq: operand shapes do not agree")
    ops = [t.contiguous() for t in ops]
    tab_ptrs = [None, None] if not tabs else [t.data_ptr() for t in ops[7:]]
    vmask = None
    if valid is not None:
        if valid.shape != (B, T):
            raise ValueError(f"valid {tuple(valid.shape)} != {(B, T)}")
        vmask = valid.to(device=k.device, dtype=torch.int32).contiguous()
    y = torch.empty((B, T, C), dtype=torch.float32, device=k.device)
    af, bf, of = (torch.empty((B, C), dtype=torch.float32, device=k.device)
                  for _ in range(3))
    check(load_library().wkv4_seq(
        *(t.data_ptr() for t in ops[:7]),
        None if vmask is None else vmask.data_ptr(), *tab_ptrs,
        y.data_ptr(), af.data_ptr(), bf.data_ptr(), of.data_ptr(),
        B, T, C, int(_CARRY[carry_dtype] is not None), stream_ptr(k)),
        "wkv4_seq")
    wkv4_seq.launches += 1
    return y, (af, bf, of)


class _WKV4(torch.autograd.Function):
    """K2 with its backward, for the forward's own call: the forward keeps
    its operands; the backward is `wkv4_seq_bwd`.  The finals carry no
    gradient."""

    @staticmethod
    def forward(ctx, k, v, w, u, a0, b0, o0):
        y, (af, bf, of) = _forward(k, v, w, u, a0, b0, o0, valid=None,
                                   carry_dtype=None, exp_table=None,
                                   div_table=None)
        ctx.save_for_backward(k, v, w, u, a0, b0, o0)
        ctx.mark_non_differentiable(af, bf, of)
        return y, af, bf, of

    @staticmethod
    def backward(ctx, gy, *_):
        gk, gv, gw, gu = wkv4_seq_bwd(*ctx.saved_tensors,
                                      gy.contiguous())
        return gk, gv, gw, gu, None, None, None


def wkv4_seq(k, v, w, u, a0, b0, o0, *, valid=None,
             carry_dtype: Optional[str] = None, exp_table=None,
             div_table=None):
    """k, v (B, T, C) f32; w, u (C,) f32; a0, b0, o0 (B, C) f32; valid
    (B, T) or None; exp_table, div_table (256,) f32 or None -> (y (B, T, C)
    f32, (a, b, o) finals (B, C) f32)."""
    if carry_dtype not in _CARRY:
        raise ValueError(f"carry_dtype {carry_dtype!r}: expected one of "
                         f"{sorted(c for c in _CARRY if c)} or None")
    _units(exp_table, div_table)
    if k.device.type != "cpu" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (k, v, w, u, a0, b0, o0)):
        own = (valid is None and _CARRY[carry_dtype] is None
               and exp_table is None
               and not any(t.requires_grad for t in (a0, b0, o0)))
        if own:
            y, af, bf, of = _WKV4.apply(k, v, w, u, a0, b0, o0)
            return y, (af, bf, of)
        refuse_grad(
            "wkv4_seq", k, v, w, u, a0, b0, o0,
            why="K2-bwd covers the exact numerics from an initial "
                "state that takes no gradient, without a valid mask or "
                "a carry snap; " + HW_UNTRAINED)
    return _forward(k, v, w, u, a0, b0, o0, valid=valid,
                    carry_dtype=carry_dtype, exp_table=exp_table,
                    div_table=div_table)


wkv4_seq.launches = 0
