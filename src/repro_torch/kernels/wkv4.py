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
`wkv4_seq_bwd` on CPU tensors is K2-bwd's plain version, the same
passes in torch ops (the reverse pass chunk by chunk from checkpoints, as
the kernel runs it).  A CUDA tensor launches the kernels or raises.

Both kernels give a warp 32 consecutive channels of one batch row and
stage their operands through shared memory (`csrc/wkv4_common.cuh`); the
plan of a call has one owner, the source's `plan_of`, queried by the C
entry `wkv4_plan`, and `k2_plan` is its twin here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

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


# The plan's constants (csrc/wkv4_common.cuh, which owns them)
K2_LANES = 32           # channels a warp, one a lane
K2_TILE = 32            # K2: steps a ring stage
K2_MAX_TILE = 64
K2_STAGES = 4           # K2: ring stages a warp
K2_WARPS = 1            # K2: warps a block
K2_MAX_WARPS = 8
K2_CHUNK = 32           # K2-bwd: steps a checkpointed chunk (Lc)
K2_MAX_CHUNK = 64
K2_BUFS = 3             # K2-bwd: chunk buffers in shared memory
K2_ROWS = 9             # K2-bwd: k, v, gy, y, den, n, Bu, gk, gv a buffer
K2_BWD_THREADS = 64     # K2-bwd: the forward/recompute and reverse warps
K2_TAB_FLOATS = 512     # the hw numerics' EXP and DIV tables
K2_GROUP = 8            # steps run together before one division check
K2_MAX_SMEM = 232448    # the most shared memory a block may take


class K2Plan(NamedTuple):
    """A K2 and K2-bwd call's launches (`csrc/wkv4_common.cuh:Plan`, field
    for field)."""
    fwd_grid_x: int        # K2: blocks over the channel groups
    fwd_grid_y: int        # K2: blocks over the batch rows
    fwd_threads: int
    warps: int             # K2: warps a block
    lanes: int             # channels a warp
    tile: int              # K2: steps a ring stage
    stages: int            # K2: ring stages a warp
    fwd_smem: int          # K2: dynamic shared bytes a block
    chunk: int             # K2-bwd: Lc
    n_chunks: int          # K2-bwd: ⌈T / Lc⌉
    bwd_grid_x: int        # K2-bwd: a block a channel group ...
    bwd_grid_y: int        # ... and batch row
    bwd_threads: int
    bwd_smem: int          # K2-bwd: three chunk buffers of nine rows
    checkpoint_bytes: int  # K2-bwd: (3, B, n_chunks, C) f32 of (a, b, o)


def k2_plan(B: int, T: int, C: int, *, hw: bool = False,
            tile: Optional[int] = None, warps: Optional[int] = None,
            chunk: Optional[int] = None) -> K2Plan:
    """The launches of K2 and K2-bwd for (B, T, C): the twin of the
    source's `plan_of`, held to it on the card by its C query `wkv4_plan`.
    tile, warps (K2) and chunk (K2-bwd's Lc) default to the plan's; no
    output depends on them.  Raises ValueError where the source refuses."""
    tile = tile or K2_TILE
    warps = warps or K2_WARPS
    chunk = chunk or K2_CHUNK
    if not (1 <= B <= 65535 and T >= 0 and C >= 1
            and 1 <= tile <= K2_MAX_TILE and 1 <= warps <= K2_MAX_WARPS
            and 1 <= chunk <= K2_MAX_CHUNK):
        raise ValueError(f"k2_plan: (B, T, C) {(B, T, C)}, tile {tile}, "
                         f"warps {warps}, chunk {chunk} out of range")
    groups = -(-C // K2_LANES)
    n_chunks = -(-T // chunk)
    stage = 3 * tile * K2_LANES + (tile + 3) // 4 * 4
    plan = K2Plan(
        -(-groups // warps), B, warps * K2_LANES, warps, K2_LANES, tile,
        K2_STAGES, 4 * (warps * K2_STAGES * stage
                        + (K2_TAB_FLOATS if hw else 0)),
        chunk, n_chunks, groups, B, K2_BWD_THREADS,
        4 * K2_BUFS * K2_ROWS * chunk * K2_LANES, 4 * 3 * B * n_chunks * C)
    if max(plan.fwd_smem, plan.bwd_smem) > K2_MAX_SMEM:
        raise ValueError(f"k2_plan: {plan} passes {K2_MAX_SMEM} shared "
                         f"bytes")
    return plan


def _fwd_step(a, b, o, kt, vt, w, u):
    """One step of K2-bwd's forward pass and recompute (`csrc/wkv4_bwd.cu`,
    its `fwd_front` and the (a, b) chain): -> (n, A, Bu, den, y, A2, B2,
    n2)."""
    n = torch.maximum(o, u + kt)
    A = torch.exp(o - n)
    Bu = torch.exp(u + kt - n)
    den = A * b + Bu
    y = (A * a + Bu * vt) / den
    n2 = torch.maximum(o - w, kt)
    A2 = torch.exp(o - w - n2)
    B2 = torch.exp(kt - n2)
    return n, A, Bu, den, y, A2, B2, n2


def wkv4_seq_bwd_plain(k, v, w, u, a0, b0, o0, gy, *,
                       chunk: Optional[int] = None):
    """K2-bwd's passes in torch ops, step for step (the derivation is in
    `csrc/wkv4_bwd.cu`): a forward pass over K2's state summing gw and gu
    and keeping (a, b, o) at the start of every chunk of `chunk` steps
    (default the plan's Lc), then a reverse pass over the chunks from the
    last, each chunk's y, denominator and running max n recomputed from
    its checkpoint, carrying the output gradient's decayed sums against
    their own running max.  The recompute repeats the forward's
    operations, so any chunk gives the same bits (`chunk >= T`: the
    whole forward run twice).  -> (gk, gv, gw, gu)."""
    T = k.shape[1]
    Lc = chunk or K2_CHUNK
    a, b, o = a0, b0, o0
    da, db = torch.zeros_like(a), torch.zeros_like(b)
    gw, gu = torch.zeros_like(a), torch.zeros_like(a)
    ckpt = []
    for t in range(T):
        kt, vt, gt = k[:, t], v[:, t], gy[:, t]
        if t % Lc == 0:
            ckpt.append((a, b, o))
        n, A, Bu, den, y, A2, B2, n2 = _fwd_step(a, b, o, kt, vt, w, u)
        gw = gw + gt * (da - y * db) * (A / den)
        gu = gu + gt * (vt - y) * (Bu / den)
        da = A2 * (da - a)
        db = A2 * (db - b)
        a = A2 * a + B2 * vt
        b = A2 * b + B2
        o = n2
    gp, gq = torch.zeros_like(a), torch.zeros_like(a)
    og = torch.full_like(a, -1e38)
    gk, gv = [None] * T, [None] * T
    for j in range(len(ckpt) - 1, -1, -1):
        a, b, o = ckpt[j]
        saved = []
        for t in range(j * Lc, min(T, (j + 1) * Lc)):
            kt, vt = k[:, t], v[:, t]
            n, _, _, den, y, A2, B2, n2 = _fwd_step(a, b, o, kt, vt, w, u)
            saved.append((y, den, n))
            a = A2 * a + B2 * vt
            b = A2 * b + B2
            o = n2
        for t in range(min(T, (j + 1) * Lc) - 1, j * Lc - 1, -1):
            gk[t], gv[t], gp, gq, og = _rev_step(
                k[:, t], v[:, t], gy[:, t], *saved[t - j * Lc], w, u, gp,
                gq, og)
    return (torch.stack(gk, dim=1), torch.stack(gv, dim=1), gw.sum(dim=0),
            gu.sum(dim=0))


def _rev_step(kt, vt, gt, y, den, n, w, u, gp, gq, og):
    """One step of K2-bwd's reverse pass: -> (gk, gv, gp, gq, og)."""
    direct = gt * (torch.exp(u + kt - n) / den)
    E = torch.exp(kt + og)
    gk = direct * (vt - y) + E * (gp * vt - gq)
    gv = direct + E * gp
    nog = torch.maximum(og - w, -n)
    A = torch.exp(og - w - nog)
    Bt = torch.exp(-n - nog) * (gt / den)
    return gk, gv, A * gp + Bt, A * gq + Bt * y, nog


def _check_f32(ops, device, who):
    if any(t.dtype != torch.float32 or t.device != device for t in ops):
        raise TypeError(f"{who} takes f32 operands on one device")


def wkv4_seq_bwd(k, v, w, u, a0, b0, o0, gy, *,
                 chunk: Optional[int] = None):
    """(gk, gv, gw, gu) of K2's exact y for the output gradient gy
    (B, T, C) f32: the plain passes on the CPU, K2-bwd on the card.
    `chunk`: the checkpointed chunk Lc (default the plan's); the outputs
    do not depend on it."""
    if k.device.type == "cpu":
        return wkv4_seq_bwd_plain(k, v, w, u, a0, b0, o0, gy, chunk=chunk)
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
    plan = k2_plan(B, T, C, chunk=chunk)
    part = torch.empty((2, B, C), **f32)
    ckpt = torch.empty((3, B, plan.n_chunks, C), **f32)
    check(load_library().wkv4_seq_bwd(
        *(t.data_ptr() for t in ops), gk.data_ptr(), gv.data_ptr(),
        gw.data_ptr(), gu.data_ptr(), part.data_ptr(), ckpt.data_ptr(),
        B, T, C, plan.chunk, stream_ptr(k)), "wkv4_seq_bwd")
    wkv4_seq_bwd.launches += 1
    return gk, gv, gw, gu


wkv4_seq_bwd.launches = 0


def _forward(k, v, w, u, a0, b0, o0, *, valid, carry_dtype, exp_table,
             div_table, tile=None, warps=None):
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
    plan = k2_plan(B, T, C, hw=bool(tabs), tile=tile, warps=warps)
    y = torch.empty((B, T, C), dtype=torch.float32, device=k.device)
    af, bf, of = (torch.empty((B, C), dtype=torch.float32, device=k.device)
                  for _ in range(3))
    check(load_library().wkv4_seq(
        *(t.data_ptr() for t in ops[:7]),
        None if vmask is None else vmask.data_ptr(), *tab_ptrs,
        y.data_ptr(), af.data_ptr(), bf.data_ptr(), of.data_ptr(),
        B, T, C, int(_CARRY[carry_dtype] is not None), plan.tile,
        plan.warps, stream_ptr(k)), "wkv4_seq")
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
             div_table=None, tile: Optional[int] = None,
             warps: Optional[int] = None):
    """k, v (B, T, C) f32; w, u (C,) f32; a0, b0, o0 (B, C) f32; valid
    (B, T) or None; exp_table, div_table (256,) f32 or None -> (y (B, T, C)
    f32, (a, b, o) finals (B, C) f32).  tile, warps: K2's ring stage and
    block (`k2_plan`; default the plan's), which no output depends on."""
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
                    div_table=div_table, tile=tile, warps=warps)


wkv4_seq.launches = 0
