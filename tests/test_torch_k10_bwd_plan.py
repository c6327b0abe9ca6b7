"""K10-bwd's decomposition on the CPU: its plan, its work count and its
plain twin.

K10-bwd (`kernels/wkv6.py:wkv6_chunked_bwd`, `csrc/wkv6_chunked_bwd.cu`)
runs a call as four launches (`k10_bwd_plan`): (r e^Lp)ᵀ dy a chunk on
the tensor cores, the reverse chain of the state gradients G_g, a block a
chunk for dr, dk, dv, dw and du's partials, and du's sum in a fixed
order.  The chunk-gradient launch pads a chunk to whole sub-chunks of 16
and factors every pairwise decay between sub-chunks through their
boundaries, so that its products run on the tensor cores in bf16 pieces
(two for bf16 r, k, v, three for f32); the 16x16 diagonal blocks keep the
exact pairwise decay, a product of the pair's own e^l, each taken once
and shared by dr, dk, A and the dw walk.  `wkv6_chunked_bwd_twin`,
below, transcribes those passes in plain torch (it is nothing of the
port's runtime).  It is held here against K10-bwd's plain version
(`wkv6_chunked_bwd_plain`, the card's yardstick), the VJP of JAX's scan
(`repro/core/wkv/wkv6.py:wkv6_scan`) and, where it runs, the VJP of JAX's
two-level `wkv6_chunked`, on numpy inputs from a seed.  The plan's
launches are the source's: `tests/test_torch_cuda.py::
test_wkv6_chunked_bwd_plan_is_the_source` holds them on the card to the C
entry's `wkv6_chunked_bwd_plan`.

Tolerances.  Against the plain version, the on-card checks' rule
(`chip_smoke.py:_wkv6_bwd_ok`): per output max |d| <= (2^-10 + λ)·max M
and mean |d| <= (2^-13 + λ)·mean M, M the output's magnitude (the plain
passes on |r|, |k|, |v|, |u|, |dy|), λ = 2C·2^-23·max|log w|; a bf16
output may move by one bf16 step, 2^-7 of M.  Against JAX, the rule of
`tests/test_torch_wkv6_bwd.py`: max |d| <= 2^-12 max|ref| and mean |d| <=
2^-14 mean|ref| (f32 outputs).  JAX's `wkv6_chunked` takes dw as dℓ / w,
which cancels at small w, so dw is held to the scan's; it is left out
under strong decay (NaN on the CPU, ROADMAP "Reference status") and where
C is no multiple of its sub-chunk.
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core.wkv.wkv6 import wkv6_chunked as j_chunked
from repro.core.wkv.wkv6 import wkv6_scan as j_scan
from repro.kernels.common import exact_jit
from repro_torch.kernels.flash_attention import split_bf16x2
from repro_torch.kernels.fused_prefill import split_bf16x3
from repro_torch.kernels.wkv6 import (
    K10_BWD_GRAD_THREADS, K10_SUB, _cum_logs, chunk_length, k10_bwd_pieces,
    k10_bwd_plan, k10_plan, wkv6_chunked_bwd_plain)

ROOT = Path(__file__).resolve().parents[1]
SMS = 132                      # an H100's SMs
SMEM_PER_SM = 228 * 1024       # shared memory an SM holds
SMEM_PER_BLOCK = 227 * 1024    # the most one block may take
SMEM_RESERVED = 1024           # the runtime's share of each block
NAMES = ("dr", "dk", "dv", "dw", "du")

# (B, T, H, N, s0, decay shift, bf16 r/k/v): C 64 at N 16 / 32 / 64, C 32
# (T 96), C 40 (three sub-chunks, the last padded), C 4 (one padded
# sub-chunk), C 1, strong decay (w down to 1.6e-38), the forward's bf16
# operands
CASES = {
    "N16-C64-s0": (2, 128, 2, 16, True, 0.0, False),
    "N32-C32-s0": (1, 96, 2, 32, True, 0.0, False),
    "N64-C64": (1, 128, 2, 64, False, 0.0, False),
    "N32-C40": (1, 40, 2, 32, False, 0.0, False),
    "N16-C4-s0": (1, 100, 2, 16, True, 0.0, False),
    "N16-C1": (1, 1, 2, 16, False, 0.0, False),
    "N16-strong": (2, 128, 2, 16, False, None, False),
    "N64-C64-bf16": (1, 128, 2, 64, False, 0.0, True),
    "N32-C40-bf16-strong": (1, 40, 2, 32, False, None, True),
}


def _inputs(B, T, H, N, shift, seed):
    """r, k, v, u, dy N(0, 1) (u halved), s0 N(0, 1), w = exp(-exp(0.5 z +
    shift)) or, for shift None, w = exp(-87 z³), z ~ U(0, 1): strong decay
    down to 1.6e-38, just above the clamp.  f32 numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    if shift is None:
        w = np.maximum(np.exp(-87.0 * rng.random((B, T, H, N)) ** 3),
                       1.1e-38)
    else:
        w = np.exp(-np.exp(0.5 * f(B, T, H, N) + shift))
    return dict(r=f(B, T, H, N), k=f(B, T, H, N), v=f(B, T, H, N),
                w=w.astype(np.float32), u=(0.5 * f(H, N)).astype(np.float32),
                dy=f(B, T, H, N), s0=f(B, H, N, N))


def _pieces(x, p):
    """x as p bf16 pieces: itself (p 1, a bf16 value), the rounded split
    (p 2) or the exact three-way split (p 3)."""
    if p == 1:
        return [x]
    return list(split_bf16x2(x) if p == 2 else split_bf16x3(x))


def _mm(a, b, pa, pb, k):
    """a @ b as the kernel's piece products: a in pa bf16 pieces, b in pb,
    the products a_i b_j with i + j <= k, a_0 b_0 summed apart from the
    rest (the two accumulators), then added once."""
    xa, xb = _pieces(a, pa), _pieces(b, pb)
    hi = xa[0] @ xb[0]
    lo = torch.zeros_like(hi)
    for i, x in enumerate(xa):
        for j, z in enumerate(xb):
            if 1 <= i + j <= k:
                lo = lo + x @ z
    return hi + lo


def wkv6_chunked_bwd_twin(r, k, v, w, u, dy, s0=None, *, chunk: int = 64):
    """K10-bwd's passes (`csrc/wkv6_chunked_bwd.cu`) in plain torch.

    The chunk is padded to `k10_plan`'s Cp rows (rows >= C: r = k = v = dy
    = 0, w = 1) and cut into sub-chunks b of 16 rows.  The decays are
    products of e^l = max(w, 1e-38): per sub-chunk and column, D'_t
    of the e^l before row t (e^(Lp_t - Lst_b)), D''_s of those after s
    (e^(Lend_b - L_s)), e^(T_b) of all 16; across sub-chunks the running
    products e^Lb_b and c(a, b) = e^(Lb_a - Lb_(b+1)) of the sub-chunks
    between; inside one, E[t, s] = e^(Lp_t - L_s) of those between s and
    t, one multiply a pair.  With R' = r D', K'' = k D'', K'_a = K'' c(a,
    sub(j)) (keys j < 16a, k_j e^(Lb_a - L_j)), R''_b = R' c(sub(t), b)
    (rows t past b, r_t e^(Lp_t - Lb_(b+1))), E_b = c(nsub, b):
      1  Q = (r e^Lp)ᵀ dy a chunk (e^Lp the running product of e^l); 2
         G_g by the reverse chain, S_(g-1) by K10's (the forward's
         workspace);
      3  VD = dy vᵀ, SD = dy Sᵀ, σ_a = Σ_(t in a) R' SD;
         XI_a = e^(Lb_a) SD_a + VD[a, <a] K'_a  (= X_(16a), (S_(16a-1)
         dy_t)_n: the running state at the sub-chunk's start);
         P̃_b = E_b ⊙ (v Gᵀ) + VD[>b, <=b]ᵀ R''_b over the keys s <= 16b +
         15; PT_s = P̃_(sub s)[s]; ρ_b = Σ_(s < 16b) K'_b[s] P̃_b[s];
         Q̃_b = e^(Lb_b) (Σ_(a>b) c(a, b) σ_a + E_b rowsum(S ⊙ G)) + ρ_b;
         the walk of each (n, b) over its 16 steps s:
           dw_s = Σ_t r_t E X[t] + D''_s Q̃ (X[t] from XI, X[t] <- w_s X[t]
           + k_s VD[t, s]; Q̃ <- w_s Q̃ + k_s PT_s, w_s = e^(l_s)),
           dk_s = D''_s PT_s + Σ_t r_t E VD[t, s] + u r_s VD[s, s],
           dr_t = D'_t XI_t + u k_t VD[t, t] + Σ_s k_s E VD[t, s],
           A[t, s] = Σ_n r_t k_s E, the bonus Σ_n r_s u k_s;
         A[a, bb < a] = R'_a K'_aᵀ on the tensor cores; dv = (K'' E_b) G
         + Aᵀ dy (the diagonal blocks strictly lower) + bonus dy;
      4  du over the chunks and the batch in order.
    Each product takes `_mm`'s piece products: an f32 operand in
    `k10_bwd_pieces` pieces (two for bf16 r, k, v, three for f32), v as
    itself when bf16; K10's ΔS (the forward) its own three.
    -> (dr, dk, dv in r's dtype, dw in w's, du (H, N) f32)."""
    B, T, H, N = r.shape
    plan = k10_plan(B, T, H, N, chunk)
    C, G, Cp, ns = plan.C, plan.G, plan.Cp, plan.n_sub
    f32 = torch.float32
    bf = r.dtype == torch.bfloat16
    P = k10_bwd_pieces(2 if bf else 4)
    PV = 1 if bf else 3
    mm = lambda a, b, pa=P, pb=P: _mm(a, b, pa, pb, P - 1)
    S16 = K10_SUB

    def tiles(x, pad=0.0):                 # (B, G, H, Cp, N), pad past C
        x = x.to(f32).reshape(B, G, C, H, N).permute(0, 1, 3, 2, 4)
        return F.pad(x, (0, 0, 0, Cp - C), value=pad)

    rs, ks, vs, dys = (tiles(x) for x in (r, k, v, dy))
    ew = torch.clamp(tiles(w, 1.0), min=1e-38)         # e^l, exactly
    # launches 1 and 2: Q_g = (r e^Lp)ᵀ dy, G_g; S_(g-1) by K10's chain
    L, Lp = _cum_logs(w.to(f32).reshape(B, G, C, H, N))
    L, Lp = (F.pad(x.permute(0, 1, 3, 2, 4), (0, 0, 0, Cp - C))
             for x in (L, Lp))
    Ltot = L[..., C - 1, :]                             # (B, G, H, N)
    dS = _mm((ks * torch.exp(Ltot[..., None, :] - L)).transpose(-1, -2), vs,
             3, PV, 2)
    Sg = torch.zeros((B, H, N, N), dtype=f32) if s0 is None else s0.to(f32)
    prev = []
    for g in range(G):
        prev.append(Sg)
        Sg = torch.exp(Ltot[:, g])[..., None] * Sg + dS[:, g]
    Sp = torch.stack(prev, dim=1)                       # (B, G, H, N, N)
    d, eLp = torch.ones_like(ew[..., 0, :]), []         # e^Lp, products
    for c_ in range(Cp):
        eLp.append(d)
        d = d * ew[..., c_, :]
    Q = mm((rs * torch.stack(eLp, dim=-2)).transpose(-1, -2), dys)
    Gd = torch.zeros_like(Sg)
    grads = [None] * G
    for g in range(G - 1, -1, -1):
        grads[g] = Gd
        Gd = torch.exp(Ltot[:, g])[..., None] * Gd + Q[:, g]
    Gg = torch.stack(grads, dim=1)                      # (B, G, H, N, N)

    # launch 3: the decays, products of e^l
    e5 = ew.reshape(B, G, H, ns, S16, N)
    Dp, Dpp = [None] * S16, [None] * S16
    d = torch.ones_like(e5[..., 0, :])
    for j in range(S16):
        Dp[j] = d
        d = d * e5[..., j, :]
    eT = d                                              # (.., ns, N)
    d = torch.ones_like(d)
    for j in range(S16 - 1, -1, -1):
        Dpp[j] = d
        d = d * e5[..., j, :]
    Dp = torch.stack(Dp, dim=-2).reshape(B, G, H, Cp, N)
    Dpp = torch.stack(Dpp, dim=-2).reshape(B, G, H, Cp, N)
    eLb, d = [], torch.ones_like(eT[..., 0, :])
    for b in range(ns):
        eLb.append(d)
        d = d * eT[..., b, :]
    cfs = {}
    for b in range(ns):
        d = torch.ones_like(eT[..., 0, :])
        for a in range(b + 1, ns + 1):
            cfs[a, b] = d
            if a < ns:
                d = d * eT[..., a, :]
    c = lambda a, b: cfs[a, b]                          # (B, G, H, N)
    Rp, Kpp = rs * Dp, ks * Dpp
    sub = lambda b: slice(b * S16, (b + 1) * S16)

    def Kp(a, upto):                       # K'_a over the keys < upto
        return torch.cat([Kpp[..., :0, :]] + [
            Kpp[..., sub(j), :] * c(a, j)[..., None, :]
            for j in range(upto // S16)], dim=-2)

    def Rpp(b):                            # R''_b over the rows past b
        return torch.cat([Rp[..., sub(a), :] * c(a, b)[..., None, :]
                          for a in range(b + 1, ns)], dim=-2)

    VD = mm(dys, vs.transpose(-1, -2), P, PV)           # (.., Cp, Cp)
    SD = mm(dys, Sp.transpose(-1, -2))
    sigma = [(Rp[..., sub(a), :] * SD[..., sub(a), :]).sum(-2)
             for a in range(ns)]
    XI = SD.clone()
    for a in range(ns):
        XI[..., sub(a), :] = eLb[a][..., None, :] * SD[..., sub(a), :]
        if a:
            XI[..., sub(a), :] += mm(VD[..., sub(a), :S16 * a],
                                     Kp(a, S16 * a))
    PT = torch.zeros_like(SD)
    Y0 = (Sp * Gg).sum(-1)
    Qt = []
    for b in range(ns):
        keys = slice(0, S16 * (b + 1))
        Pb = c(ns, b)[..., None, :] * mm(vs[..., keys, :],
                                         Gg.transpose(-1, -2), PV, P)
        if b < ns - 1:
            Pb = Pb + mm(VD[..., S16 * (b + 1):, keys].transpose(-1, -2),
                         Rpp(b))
        PT[..., sub(b), :] = Pb[..., sub(b), :]
        rho = (Kp(b, S16 * b) * Pb[..., :S16 * b, :]).sum(-2)
        q0 = c(ns, b) * Y0
        for a in range(b + 1, ns):
            q0 = q0 + c(a, b) * sigma[a]
        Qt.append(eLb[b] * q0 + rho)
    # the walk of each (n, b), and A's diagonal blocks
    u32 = u.to(f32)[None, None, :, :]
    dr, dk, dw = (torch.zeros_like(SD) for _ in range(3))
    A = torch.zeros_like(VD)
    du = torch.zeros_like(SD[..., 0, :])
    later = lambda js: (torch.arange(S16) > js)[:, None]
    for b in range(ns):
        o = S16 * b
        X = XI[..., sub(b), :].clone()
        drd = torch.zeros_like(X)
        q = Qt[b]
        eb = ew[..., sub(b), :]
        for js in range(S16):
            s = o + js
            vd = VD[..., o:o + S16, s, None]                # VD[t, s]
            E = [torch.zeros_like(eb[..., 0, :])] * S16
            e = torch.ones_like(E[0])
            for jt in range(js + 1, S16):
                E[jt] = e
                e = e * eb[..., jt, :]
            E = torch.stack(E, dim=-2)                      # E[t, s]
            re = rs[..., sub(b), :] * E
            A[..., o:o + S16, s] = (re * ks[..., s, None, :]).sum(-1)
            drd = drd + ks[..., s, None, :] * E * vd
            dw[..., s, :] = (re * X).sum(-2) + e * q        # e is D''_s
            dk[..., s, :] = e * PT[..., s, :] + (re * vd).sum(-2) \
                + u32 * rs[..., s, :] * VD[..., s, s, None]
            du = du + rs[..., s, :] * ks[..., s, :] * VD[..., s, s, None]
            X = torch.where(later(js), ew[..., s, None, :] * X
                            + ks[..., s, None, :] * vd, X)
            q = ew[..., s, :] * q + ks[..., s, :] * PT[..., s, :]
        dr[..., sub(b), :] = Dp[..., sub(b), :] * XI[..., sub(b), :] \
            + u32[..., None, :] * ks[..., sub(b), :] * torch.diagonal(
                VD[..., sub(b), sub(b)], dim1=-2, dim2=-1)[..., None] + drd
    bonus = (rs * u32[..., None, :] * ks).sum(-1, keepdim=True)
    for a in range(1, ns):
        for bb in range(a):
            A[..., sub(a), sub(bb)] = mm(
                Rp[..., sub(a), :],
                (Kpp[..., sub(bb), :] * c(a, bb)[..., None, :])
                .transpose(-1, -2))
    KF = torch.cat([Kpp[..., sub(b), :] * c(ns, b)[..., None, :]
                    for b in range(ns)], dim=-2)
    dv = mm(KF, Gg) + mm(A.transpose(-1, -2), dys) + bonus * dys
    out = []
    for x in (dr, dk, dv, dw):
        out.append(x[..., :C, :].permute(0, 1, 3, 2, 4).reshape(B, T, H, N))
    out[3] = torch.where(w.to(f32) >= 1e-38, out[3], torch.zeros_like(out[3]))
    du_sum = torch.zeros((H, N), dtype=f32)
    for g in range(G):
        for bi in range(B):
            du_sum = du_sum + du[bi, g]
    return (out[0].to(r.dtype), out[1].to(k.dtype), out[2].to(v.dtype),
            out[3].to(w.dtype), du_sum)


def _torch_inputs(d, bf):
    t = {k_: torch.from_numpy(x) for k_, x in d.items()}
    if bf:        # the forward's types: bf16 r, k, v (their f32 values to JAX)
        for k_ in "rkv":
            t[k_] = t[k_].to(torch.bfloat16)
            d[k_] = t[k_].float().numpy()
    return t


def _jax_rule(got, ref, what):
    for name, a, b in zip(NAMES, got, ref):
        a = a.float().numpy()
        d = np.abs(a - b)
        assert np.isfinite(a).all(), (what, name)
        assert float(d.max()) <= 2.0 ** -12 * float(np.abs(b).max()), (
            what, name, float(d.max()))
        assert float(d.mean()) <= 2.0 ** -14 * float(np.abs(b).mean()), (
            what, name, float(d.mean()))


def _jax_vjp(fn, d, with_s0):
    """The VJP of fn's y on dy, compiled whole under `exact_jit` (every
    trace-level rounding real), from d's s0 or the zero state."""
    def vjp_of(r, k, v, w, u, dy, *s0):
        _, vjp = jax.vjp(lambda *a: fn(*a, *s0)[0], r, k, v, w, u)
        return vjp(dy)
    args = [jnp.asarray(d[k_]) for k_ in ("r", "k", "v", "w", "u", "dy")]
    s0 = [jnp.asarray(d["s0"])] if with_s0 else []
    return [np.asarray(g) for g in exact_jit(vjp_of)(*args, *s0)]


@pytest.mark.parametrize("case", list(CASES))
def test_twin_against_plain_and_jax(case):
    """The twin against K10-bwd's plain version (the card's rule), and
    against the VJPs of JAX's scan and, where it runs, JAX's two-level
    chunked form (dw from the scan's; JAX's rule; f32 operands only, as
    the bf16 cases' outputs are rounded to bf16)."""
    B, T, H, N, with_s0, shift, bf = CASES[case]
    d = _inputs(B, T, H, N, shift, seed=len(case) + 3)
    t = _torch_inputs(d, bf)
    s0 = t["s0"] if with_s0 else None
    args = [t[k_] for k_ in "rkvwu"] + [t["dy"]]
    got = wkv6_chunked_bwd_twin(*args, s0)
    assert [g.dtype for g in got] == [args[0].dtype] * 3 + [torch.float32] * 2
    C = chunk_length(T)
    ref = wkv6_chunked_bwd_plain(*args, s0)
    mag = wkv6_chunked_bwd_plain(*(x.abs() for x in args[:3]), t["w"],
                                 t["u"].abs(), t["dy"].abs(),
                                 None if s0 is None else s0.abs())
    ok, errs = _smoke()._wkv6_bwd_ok(got, ref, mag, t["w"], C,
                                     3 if bf else 0)
    assert ok, errs
    if bf:
        return
    scan = _jax_vjp(j_scan, d, with_s0)
    _jax_rule(got, scan, f"{case} vs jax scan")
    if shift is not None and C % min(K10_SUB, C) == 0:
        chunked = _jax_vjp(lambda *a: j_chunked(*a, chunk=C), d, with_s0)
        chunked[3] = scan[3]
        _jax_rule(got, chunked, f"{case} vs jax chunked")


def test_twin_is_repeatable():
    """The same inputs give the same bits."""
    B, T, H, N, with_s0, shift, bf = CASES["N32-C40"]
    t = _torch_inputs(_inputs(B, T, H, N, shift, seed=9), bf)
    args = [t[k_] for k_ in "rkvwu"] + [t["dy"]]
    a = wkv6_chunked_bwd_twin(*args)
    b = wkv6_chunked_bwd_twin(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# --- the plan -------------------------------------------------------------

@pytest.mark.parametrize("B,T,H,N", [(4, 1024, 64, 64), (1, 4096, 64, 64),
                                     (3, 96, 4, 64), (1, 100, 2, 16),
                                     (2, 40, 2, 32), (1, 1, 2, 16)])
def test_plan_passes_and_scratch(B, T, H, N):
    """Four launches in order: a block a chunk for (r e^Lp)ᵀ dy and for the
    chunk gradients, a thread a (b, h, n, m) chain for the state
    gradients, a thread a (h, n) for du's sum; the scratch is the forward's
    workspace's size (the state gradients, then du's partials)."""
    p = k10_bwd_plan(B, T, H, N)
    fwd = k10_plan(B, T, H, N)
    assert (p.C, p.G, p.Cp, p.n_sub) == (fwd.C, fwd.G, fwd.Cp, fwd.n_sub)
    assert p.scratch_bytes == fwd.workspace_bytes
    names = [x[0] for x in p.passes]
    assert names == ["state_grad", "grad_scan", "chunk_grad", "du_sum"]
    (_, g1, t1, _), (_, g2, t2, _), (_, g3, t3, _), (_, g4, t4, _) = \
        p.passes
    chunks = B * H * p.G
    assert g1 == g3 == chunks
    assert g2 * t2 >= B * H * N * N > (g2 - 1) * t2
    assert g4 * t4 >= H * N > (g4 - 1) * t4
    assert t3 == K10_BWD_GRAD_THREADS and all(
        t % 32 == 0 for t in (t1, t2, t3, t4))
    # the walk runs a thread a (n, sub-chunk) of the chunk
    assert N * p.n_sub <= t3


@pytest.mark.parametrize("N", [16, 32, 64])
@pytest.mark.parametrize("T", [64, 96, 100, 40, 1])
@pytest.mark.parametrize("rkv_bytes", [2, 4])
def test_plan_fits_every_shape(N, T, rkv_bytes):
    """Every (N, C) the kernel takes fits a block's shared memory, f32 r,
    k, v included."""
    p = k10_bwd_plan(1, T, 2, N, rkv_bytes=rkv_bytes)
    for name, _, _, smem in p.passes:
        assert smem + SMEM_RESERVED <= SMEM_PER_BLOCK, (name, smem)


@pytest.mark.parametrize("rkv_bytes", [2, 4])
def test_two_blocks_an_sm_at_the_train_shape(rkv_bytes):
    """At rwkv6-7b's train shape (B4 T1024 H64 N64, C 64) the chunk
    gradients' launch holds two blocks an SM in shared memory, bf16 and
    f32 r, k, v alike, and every launch spreads over the card."""
    p = k10_bwd_plan(4, 1024, 64, 64, rkv_bytes=rkv_bytes)
    for name, blocks, _, smem in p.passes[:3]:
        assert blocks > SMS, name
    smem = p.passes[2][3]
    assert 2 * (smem + SMEM_RESERVED) <= SMEM_PER_SM


# --- the work under the bound ----------------------------------------------

@functools.lru_cache(maxsize=None)
def _smoke():
    """chip_smoke.py as a module (its K10-bwd checks and cost), loaded by
    path."""
    spec = importlib.util.spec_from_file_location(
        "_k10_bwd_plan_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("T,N,bf", [(1024, 64, True), (1024, 64, False),
                                    (96, 64, True), (100, 16, False),
                                    (40, 32, True), (1, 16, False)])
def test_two_level_work_is_the_sub_chunk_split(T, N, bf):
    """`chip_smoke.py:_k10_bwd_two_level_ops`, the work under K10-bwd's
    bound, counts the pairs of the sub-chunk split as its masks give them:
    the strictly-lower pairs inside the 16-row diagonal blocks (one exact
    exponent each, shared by dr, dk, A and the walk), the elementwise
    decays, and every product once per bf16 piece product (six for f32 x
    f32, three for f32 x a bf16 v)."""
    smoke = _smoke()
    B, H = 1, 2
    p = k10_bwd_plan(B, T, H, N)
    C, chunks = p.C, B * H * p.G
    i = torch.arange(C)
    lower = i[:, None] > i[None, :]
    same = (i[:, None] // K10_SUB) == (i[None, :] // K10_SUB)
    diag, off = int((lower & same).sum()), int((lower & ~same).sum())
    # P̃_b: keys s up to b's end, rows t past it, for each sub-chunk b
    sb = i // K10_SUB
    keys = [int((sb <= b).sum()) for b in range(p.n_sub)]
    rows = [int((sb > b).sum()) for b in range(p.n_sub)]
    # the piece products: f32 x f32 and f32 x v, as the pieces go in
    pa = k10_bwd_pieces(2 if bf else 4)
    pv = 1 if bf else 3
    ff = sum(1 for a in range(pa) for b in range(pa) if a + b < pa)
    fv = sum(1 for a in range(pa) for b in range(pv) if a + b < pa)
    cuda_ops, mma = smoke._k10_bwd_two_level_ops(B, T, H, N, 2 if bf else 4)
    assert cuda_ops == chunks * N * (13 * diag + 24 * C + 2 * N)
    macs = (ff * C * N * N                         # (r e^Lp)ᵀ dy
            + fv * N * int((~lower).T.sum())       # VD, i <= t
            + ff * C * N * N                       # SD
            + ff * N * off                         # XI's VD K'
            + ff * N * sum(k_ * r_ for k_, r_ in zip(keys, rows))
            + fv * N * N * sum(keys)               # P̃'s v (E_b G)ᵀ
            + ff * N * off                         # A below the diagonal
            + ff * N * (diag + off)                # Aᵀ dy
            + ff * C * N * N)                      # (K'' E_b) G
    assert mma == chunks * 2 * macs
    assert diag + off == C * (C - 1) // 2 and diag <= 120 * p.n_sub


def test_bound_at_the_train_shape():
    """At rwkv6-7b's train shape (B4 T1024 H64 N64, bf16 r, k, v, f32 w)
    the two-level form's work sits under the one-level f32 figure; the
    bound is the larger of its bytes and that work, and the one-level
    figure rides beside it."""
    smoke = _smoke()
    b = smoke._k10_bwd_bound_ms(4, 1024, 64, 64, 64, 2, 4)
    assert b["bound_ms"] == max(b["bytes_bound_ms"], b["ops_bound_ms"])
    assert b["ops_bound_ms"] < b["one_level_f32_bound_ms"]
    assert abs(b["bytes_bound_ms"] - 0.140) < 0.001
    assert abs(b["one_level_f32_bound_ms"] - 0.2628) < 0.0005
