"""K10's decomposition on the CPU: its plan and its plain twin.

K10 (`kernels/wkv6.py:wkv6_chunked_kernel`, `csrc/wkv6_chunked.cu`) runs a
call as three launches (`k10_plan`): a block a chunk for the chunk's state
increment ΔS_g and e^Ltot_g, a thread a (b, h, n, m) chain for the
in-order recurrence S_g = e^Ltot_g S_(g-1) + ΔS_g, and a block a chunk for
y.  Its products run on the tensor cores in exact bf16 pieces through
sub-chunks of 16, the blocks of att below the diagonal factored through
their sub-chunk's start, the diagonal blocks with exact pairwise
exponents.  `wkv6_chunked_twin`, below, transcribes that in plain torch
(it is nothing of the port's runtime); it is
held here against K10's plain version (`wkv6_chunked_plain`, the card's
yardstick), JAX's scan (`repro/core/wkv/wkv6.py:wkv6_scan`) and JAX's
two-level `wkv6_chunked`, on numpy inputs from a seed.  The plan's
passes are the source's: `tests/test_torch_cuda.py::
test_wkv6_chunked_plan_is_the_source` holds them on the card to the C
entry's `wkv6_chunked_plan`, so the limits checked here are the launch's.

Tolerance: the checks' bound for two f32 evaluations of the chunked WKV-6
in other orders (`chip_smoke.py:_k10_bound`,
`tests/test_torch_cuda.py:_wkv6_chunked_bound`): (8G + 2C + 2N + 16)·2^-24
of each output's magnitude (the plain version on |r|, |k|, |v|, |u|,
|s0|) plus 2C·2^-23·max|log w| of it.  JAX's `wkv6_chunked` is left out
under strong decay (it gives NaN on the CPU, ROADMAP "Reference status")
and where C is no multiple of its sub-chunk (T 40: C 40).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core.wkv.wkv6 import wkv6_chunked as j_chunked
from repro.core.wkv.wkv6 import wkv6_scan as j_scan
from repro.kernels.common import exact_jit
from repro_torch.kernels.fused_prefill import split_bf16x3
from repro_torch.kernels.wkv6 import (
    K10_OUT_THREADS, K10_SUB, chunk_length, k10_plan, wkv6_chunked_plain)

ROOT = Path(__file__).resolve().parents[1]
SMS = 132                      # an H100's SMs
SMEM_PER_SM = 228 * 1024       # shared memory an SM holds
SMEM_PER_BLOCK = 227 * 1024    # the most one block may take
SMEM_RESERVED = 1024           # the runtime's share of each block

# (B, T, H, N, s0, decay shift, bf16 r/k/v): C 64 at N 16 / 32 / 64, C 32
# (T 96), C 4 (T 100, one padded sub-chunk), C 40 (three sub-chunks, the
# last padded), C 1, strong decay (log w ~ -20; e^L underflows), the
# forward's bf16 operands
CASES = {
    "N16-C64-s0": (2, 128, 2, 16, True, 0.0, False),
    "N32-C64": (1, 256, 2, 32, False, 0.5, False),
    "N64-C64-s0": (1, 128, 2, 64, True, 0.0, False),
    "N64-C32-s0": (2, 96, 2, 64, True, 0.0, False),
    "N16-C4-s0": (1, 100, 2, 16, True, 0.0, False),
    "N32-C40": (1, 40, 2, 32, False, 0.0, False),
    "N16-C1-s0": (1, 1, 2, 16, True, 0.0, False),
    "N64-strong-s0": (1, 64, 2, 64, True, 3.0, False),
    "N16-strong": (2, 128, 2, 16, False, 3.0, False),
    "N32-C32-weak-s0": (1, 32, 2, 32, True, -3.0, False),
    "N16-C64-bf16": (2, 128, 2, 16, False, 0.0, True),
    "N64-C64-bf16-s0": (1, 192, 2, 64, True, 0.0, True),
}


def _inputs(B, T, H, N, shift, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(r=f(B, T, H, N), k=f(B, T, H, N), v=f(B, T, H, N),
                w=np.exp(-np.exp(0.5 * f(B, T, H, N) + shift)).astype(
                    np.float32),
                u=(0.5 * f(H, N)).astype(np.float32), s0=f(B, H, N, N))


def _bound(r, k, v, w, u, s0):
    """(y bound, S bound): the checks' sum-order bound of each output."""
    B, T, H, N = r.shape
    C = chunk_length(T)
    G = T // C
    mag = wkv6_chunked_plain(r.float().abs(), k.float().abs(),
                             v.float().abs(), w, u.abs(),
                             None if s0 is None else s0.abs())
    logw = float(torch.log(torch.clamp(w.float(), min=1e-38)).abs().max())
    rel = (8 * G + 2 * C + 2 * N + 16) * 2.0 ** -24 \
        + 2 * C * 2.0 ** -23 * logw
    return rel * mag[0], rel * mag[1]


def _within(got, want, bound, what):
    got, want = got.float(), torch.as_tensor(np.array(want)).float()
    assert got.shape == want.shape, what
    assert bool(torch.isfinite(got).all()), what
    d = (got - want).abs()
    assert bool((d <= bound).all()), (what, float((d / bound).max()))


def wkv6_chunked_twin(r, k, v, w, u, s0=None, *, chunk: int = 64):
    """K10's decomposition (`csrc/wkv6_chunked.cu`) in plain torch: the
    chunk padded to `k10_plan`'s Cp (rows >= C: r = k
    = v = 0, log w = 0), L and Lprev as the plain version takes them; A:
    ΔS_g and e^Ltot_g; B: S_(g-1) by the in-order recurrence; C: y =
    (r e^Lprev) @ S_(g-1) + att @ v + bonus, att's blocks below the
    diagonal factored through their sub-chunk's start, its 16x16
    diagonal blocks with the exact pairwise exponents.  Each f32 operand
    of a product enters as `split_bf16x3`'s three pieces (a bf16 r, k, v:
    itself), the piece products with i + j <= 2 kept, a_0 b_0 summed
    apart from the rest as the kernel's two accumulators.  All in f32."""
    B, T, H, N = r.shape
    plan = k10_plan(B, T, H, N, chunk)
    C, G, Cp, n_sub = plan.C, plan.G, plan.Cp, plan.n_sub
    f32 = torch.float32
    v_exact = v.dtype == torch.bfloat16

    def tiles(x):                          # (B, G, H, Cp, N), zero past C
        x = x.to(f32).reshape(B, G, C, H, N).permute(0, 1, 3, 2, 4)
        return F.pad(x, (0, 0, 0, Cp - C))

    def pieces(x, exact=False):
        return [x] if exact else list(split_bf16x3(x))

    def mm(a, b, b_exact=False):           # (hi, lo) of a @ b
        pa, pb = pieces(a), pieces(b, b_exact)
        hi = pa[0] @ pb[0]
        lo = torch.zeros_like(hi)
        for i, x in enumerate(pa):
            for j, z in enumerate(pb):
                if 1 <= i + j <= 2:
                    lo = lo + x @ z
        return hi, lo

    rs, ks, vs = tiles(r), tiles(k), tiles(v)
    lw = tiles(torch.log(torch.clamp(w.to(f32), min=1e-38)))
    cum = [lw[..., 0, :]]
    for c in range(1, Cp):
        cum.append(cum[-1] + lw[..., c, :])
    L = torch.stack(cum, dim=-2)                       # (B, G, H, Cp, N)
    Lp = L - lw
    # A: ΔS_g = (k e^(Ltot - L))ᵀ v and e^Ltot_g
    Ltot = L[..., -1:, :]
    hi, lo = mm((ks * torch.exp(Ltot - L)).transpose(-1, -2), vs, v_exact)
    dS = hi + lo                                       # (B, G, H, N, N)
    eL = torch.exp(Ltot[..., 0, :])                    # (B, G, H, N)
    # B: S_(g-1) for every chunk, in order
    S = torch.zeros((B, H, N, N), dtype=f32, device=r.device) \
        if s0 is None else s0.to(f32)
    prev = []
    for g in range(G):
        prev.append(S)
        S = eL[:, g, :, :, None] * S + dS[:, g]
    prev = torch.stack(prev, dim=1)                    # (B, G, H, N, N)
    # C: att, then y
    att = torch.zeros(rs.shape[:-1] + (Cp,), dtype=f32, device=r.device)
    lower = torch.tril(torch.ones((K10_SUB, K10_SUB), dtype=torch.bool,
                                  device=r.device), diagonal=-1)
    for a in range(n_sub):
        rows = slice(a * K10_SUB, (a + 1) * K10_SUB)
        lst = Lp[..., a * K10_SUB:a * K10_SUB + 1, :]
        D = Lp[..., rows, None, :] - L[..., None, rows, :]
        pair = (rs[..., rows, None, :] * ks[..., None, rows, :]
                * torch.exp(D)).sum(-1)
        att[..., rows, rows] = torch.where(lower, pair, 0.0)
        r_loc = rs[..., rows, :] * torch.exp(Lp[..., rows, :] - lst)
        for bk in range(a):
            keys = slice(bk * K10_SUB, (bk + 1) * K10_SUB)
            k_rel = ks[..., keys, :] * torch.exp(lst - L[..., keys, :])
            hi, lo = mm(r_loc, k_rel.transpose(-1, -2))
            att[..., rows, keys] = hi + lo
    hi1, lo1 = mm(rs * torch.exp(Lp), prev)
    hi2, lo2 = mm(att, vs, v_exact)
    bonus = torch.sum(rs * u.to(f32)[None, None, :, None, :] * ks, dim=-1,
                      keepdim=True)
    y = ((hi1 + hi2) + (lo1 + lo2)) + bonus * vs
    y = y[..., :C, :].permute(0, 1, 3, 2, 4).reshape(B, T, H, N)
    return y, S


@pytest.mark.parametrize("case", list(CASES))
def test_twin_against_plain_and_jax(case):
    """The twin against K10's plain version, JAX's scan and (where it runs)
    JAX's two-level chunked form: y and the final state within the bound."""
    B, T, H, N, with_s0, shift, bf = CASES[case]
    d = _inputs(B, T, H, N, shift, seed=len(case))
    t = {k_: torch.from_numpy(x) for k_, x in d.items()}
    if bf:   # the forward's types: bf16 r, k, v (their f32 values to JAX)
        for k_ in "rkv":
            t[k_] = t[k_].to(torch.bfloat16)
            d[k_] = t[k_].float().numpy()
    s0 = t["s0"] if with_s0 else None
    args = [t[k_] for k_ in "rkvwu"]
    y, S = wkv6_chunked_twin(*args, s0)
    assert y.dtype == torch.float32 and y.shape == (B, T, H, N)
    assert S.dtype == torch.float32 and S.shape == (B, H, N, N)
    by, bS = _bound(*args, s0)
    refs = {"plain": wkv6_chunked_plain(*args, s0)}
    jargs = [d[k_] for k_ in "rkvwu"]
    js0 = d["s0"] if with_s0 else None
    refs["jax scan"] = exact_jit(j_scan)(*jargs, js0)
    C = chunk_length(T)
    if shift < 3.0 and C % min(K10_SUB, C) == 0:
        refs["jax chunked"] = exact_jit(
            lambda *a: j_chunked(*a, chunk=C))(*jargs, js0)
    for name, (ry, rS) in refs.items():
        _within(y, ry, by, f"{case} y vs {name}")
        _within(S, rS, bS, f"{case} S vs {name}")


@pytest.mark.parametrize("case", ["N64-C64-s0", "N16-C4-s0", "N32-C40"])
def test_twin_is_repeatable_and_chunk_local(case):
    """The same inputs give the same bits; a sequence cut after chunk g
    gives y up to there and, continued from its final state, the rest,
    within the bound: the chunks meet only through S."""
    B, T, H, N, with_s0, shift, _ = CASES[case]
    d = _inputs(B, T, H, N, shift, seed=7)
    t = {k_: torch.from_numpy(x) for k_, x in d.items()}
    s0 = t["s0"] if with_s0 else None
    args = [t[k_] for k_ in "rkvwu"]
    y, S = wkv6_chunked_twin(*args, s0)
    y2, S2 = wkv6_chunked_twin(*args, s0)
    assert torch.equal(y, y2) and torch.equal(S, S2)
    C = chunk_length(T)
    if T // C < 2:
        return
    cut = (T // C // 2) * C
    head = [x[:, :cut] for x in args[:4]] + [args[4]]
    tail = [x[:, cut:] for x in args[:4]] + [args[4]]
    if chunk_length(cut) != C or chunk_length(T - cut) != C:
        return
    yh, Sh = wkv6_chunked_twin(*head, s0)
    yt, St = wkv6_chunked_twin(*tail, Sh)
    by, bS = _bound(*args, s0)
    _within(yh, y[:, :cut], by[:, :cut], f"{case} head y")
    _within(yt, y[:, cut:], by[:, cut:], f"{case} tail y")
    _within(St, S, bS, f"{case} tail S")


@pytest.mark.parametrize("B,T,H,N", [(1, 32768, 64, 64), (1, 4096, 64, 64),
                                     (3, 96, 4, 64), (1, 100, 2, 16),
                                     (2, 40, 2, 32), (32, 32768, 4, 16)])
def test_plan_workspace_and_passes(B, T, H, N):
    """The workspace is 4·B·H·G·(N² + N) bytes (ΔS_g / S_(g-1) and e^Ltot_g
    of every chunk), the passes are A, B, C in order with a block a chunk
    for A and C and a thread a (b, h, n, m) chain for B, and the chunk is
    padded to whole sub-chunks of 16."""
    p = k10_plan(B, T, H, N)
    C = chunk_length(T)
    G = T // C
    assert (p.C, p.G) == (C, G)
    assert p.Cp % K10_SUB == 0 and p.C <= p.Cp < p.C + K10_SUB
    assert p.n_sub == p.Cp // K10_SUB
    assert p.workspace_bytes == 4 * B * H * G * (N * N + N)
    names = [x[0] for x in p.passes]
    assert names == ["chunk_state", "state_scan", "chunk_output"]
    (_, ga, ta, _), (_, gb, tb, _), (_, gc, tc, _) = p.passes
    assert ga == gc == B * H * G
    assert gb * tb >= B * H * N * N > (gb - 1) * tb
    assert tc == K10_OUT_THREADS and ta % 32 == 0 and tb % 32 == 0


def test_plan_at_the_timed_shape():
    """rwkv6-7b's layer at B1 T32768 H64 N64: 545 MB of workspace (537 MB
    of states), 32768 blocks in launches A and C (every SM busy at B 1,
    where a block a head gave 64), and two blocks of
    launch C an SM in shared memory."""
    p = k10_plan(1, 32768, 64, 64)
    assert p.workspace_bytes == 4 * 512 * 64 * (64 * 64 + 64)
    assert 4 * 512 * 64 * 64 * 64 == 536_870_912
    for name, blocks, threads, smem in p.passes:
        assert blocks > SMS, name
        assert smem <= SMEM_PER_BLOCK, name
    smem_c = p.passes[2][3]
    assert 2 * (smem_c + SMEM_RESERVED) <= SMEM_PER_SM


@pytest.mark.parametrize("N", [16, 32, 64])
@pytest.mark.parametrize("T", [64, 96, 100, 40, 1])
@pytest.mark.parametrize("rkv_bytes", [2, 4])
def test_plan_fits_every_shape(N, T, rkv_bytes):
    """Every (N, C) the kernel takes fits a block's shared memory, f32 r,
    k, v (three pieces of v) included."""
    p = k10_plan(1, T, 2, N, rkv_bytes=rkv_bytes)
    for name, _, _, smem in p.passes:
        assert smem + SMEM_RESERVED <= SMEM_PER_BLOCK, (name, smem)


def _smoke():
    """chip_smoke.py as a module (its K10 bound), loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "_k10_plan_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("T,N,bf", [(32768, 64, True), (4096, 64, False),
                                    (96, 64, True), (100, 16, False),
                                    (40, 32, True), (1, 16, False)])
def test_two_level_work_is_the_sub_chunk_split(T, N, bf):
    """`chip_smoke.py:_k10_two_level_ops`, the work under K10's bound,
    counts the pairs of the sub-chunk split as its masks give them: the
    strictly-lower pairs inside the 16-row diagonal blocks (exact
    exponents), those below them (factored products, six piece products),
    the earlier keys each sub-chunk decays, and att @ v over every
    strictly-lower pair (three piece products for a bf16 v, six for f32)."""
    smoke = _smoke()
    B, H = 1, 2
    dt = torch.bfloat16 if bf else torch.float32
    r = torch.empty((B, T, H, N), dtype=dt)
    p = k10_plan(B, T, H, N)
    C, chunks = p.C, B * H * p.G
    i = torch.arange(C)
    lower = i[:, None] > i[None, :]
    same = (i[:, None] // K10_SUB) == (i[None, :] // K10_SUB)
    diag, off = int((lower & same).sum()), int((lower & ~same).sum())
    keys = sum(int((i < K10_SUB * a).sum()) for a in range(p.n_sub))
    pv = 3 if bf else 6
    cuda_ops, mma = smoke._k10_two_level_ops(r, r)
    assert cuda_ops == chunks * (7 * N * diag + 18 * C * N + 3 * N * keys
                                 + 2 * N * N)
    assert mma == chunks * 2 * N * (C * N * (pv + 6) + 6 * off
                                    + pv * (diag + off))
    one_level = C * (C - 1) // 2
    assert diag + off == one_level and diag <= 120 * p.n_sub


def test_bound_at_the_timed_shape():
    """At rwkv6-7b's layer (B1 T32768 H64 N64, bf16 r, k, v, f32 w) K10's
    least time is its bytes (bf16 r, k, v, f32 w and y: 14 B an element;
    1.88 GB) over 3.35 TB/s: the two-level form's operations take less,
    the one-level form's (the bound before the tensor cores) more."""
    smoke = _smoke()
    r = torch.empty((1, 32768, 64, 64), dtype=torch.bfloat16)
    w = torch.empty((1, 32768, 64, 64), dtype=torch.float32)
    b = smoke._k10_bound_ms(r, r, w, None)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == b["bytes_bound_ms"]
    assert b["bytes"] == 14 * 32768 * 64 * 64 + 4 * 64 * 64 + 4 * 64 ** 3
    assert b["ops_bound_ms"] < b["bytes_bound_ms"] < \
        b["one_level_f32_bound_ms"]

