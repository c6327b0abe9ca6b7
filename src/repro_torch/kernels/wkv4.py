"""The masked RWKV-4 WKV sequence kernel (kernel K2).

Port of `repro/kernels/wkv4.py:wkv4_pallas` with the `valid` commit
mask, the `carry_dtype` snap and both numerics: exact, or, given the
`exp_table`/`div_table` operands (both or neither), the paper's LUT exp
and LUT division (`core/approx/units.py`).  The CUDA kernel is
`csrc/wkv4_seq.cu`; its header says what bounds it on an H100 and how its
design answers that.

A CPU tensor takes the plain version, a step loop over
`core/wkv/wkv4.py:wkv4_step`; a CUDA tensor launches the kernel or raises,
also when grad mode is on and an operand requires grad (no backward yet).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.approx.units import div_lut, exp_lut
from repro_torch.core.wkv.wkv4 import WKV4State, wkv4_step
from repro_torch.kernels.build import (
    check, load_library, refuse_grad, stream_ptr)

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
    if k.device.type == "cpu":
        return wkv4_seq_plain(k, v, w, u, a0, b0, o0, valid=valid,
                              carry_dtype=carry_dtype, exp_table=exp_table,
                              div_table=div_table)
    refuse_grad("wkv4_seq", k, v, w, u, a0, b0, o0)
    B, T, C = k.shape
    tabs = [] if exp_table is None else [exp_table, div_table]
    if any(t.shape != (256,) for t in tabs):
        raise ValueError("exp_table and div_table must be (256,)")
    ops = [k, v, w, u, a0, b0, o0, *tabs]
    if any(t.dtype != torch.float32 or t.device != k.device for t in ops):
        raise TypeError("wkv4_seq takes f32 operands on one device")
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


wkv4_seq.launches = 0
