"""K6-bwd's decomposition on the CPU: its plan and its plain twin.

K6-bwd (`kernels/wkv6.py:wkv6_seq_bwd`, `csrc/wkv6_seq_bwd.cu`) runs a
block of 4N threads a (b, h) pair (`k6_bwd_plan`): thread 4n + j holds row
n, columns j·N/4 .. of the state and of its gradient G.  The state is
checkpointed every K6_BWD_WINDOW steps (a group); each group, from the
last, is rerun from its checkpoint with the forward's update and walked
backward.  The sums over m (dr, dk, dw, v·dy) run in a row's four threads;
each step parks dv's terms G k_n, and the sum over n (dv and the bonus)
runs in order once a group.
`wkv6_seq_bwd_twin`, below, transcribes that in plain torch (nothing of
the port's runtime) and is held against K6-bwd's plain version
(`wkv6_seq_bwd_plain`, the card's yardstick) and the VJP of JAX's scan
(`repro/core/wkv/wkv6.py:wkv6_scan`), on numpy inputs from a seed.  The
plan is the source's: `tests/test_torch_cuda.py::
test_wkv6_seq_bwd_plan_is_the_source` holds it on the card to the C
entry's `wkv6_seq_bwd_plan`.

Tolerances.  Against the plain version the on-card checks' rule
(`chip_smoke.py:_wkv6_bwd_ok`, all f32, λ = 0 as no log is taken): per
output max |d| <= 2^-10 max M and mean |d| <= 2^-13 mean M, M the output's
magnitude (the plain passes on |r|, |k|, |v|, |u|, |s0|, |dy|); against
JAX the rule of `tests/test_torch_wkv6_bwd.py`: max |d| <= 2^-12
max|ref|, mean |d| <= 2^-14 mean|ref|.  The recomputed states repeat the
forward's update, so they are the plain version's bits.
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.wkv.wkv6 import wkv6_scan as j_scan
from repro.kernels.common import exact_jit
from repro_torch.kernels.wkv6 import (
    K6_BWD_HEAD_DIMS, K6_BWD_ROW_LANES, K6_BWD_WINDOW, K6_MAX_SMEM,
    _seq_state_step, k6_bwd_plan, wkv6_seq_bwd_plain)

NAMES = ("dr", "dk", "dv", "dw", "du")
SMS = 132

# (B, T, H, N, s0): T 1 (a lone step), 13 (ends inside a group), 40 (whole
# groups), 45 (a ragged last group of 5)
CASES = {
    "N16-T13-s0": (2, 13, 2, 16, True),
    "N32-T40": (2, 40, 2, 32, False),
    "N64-T45-s0": (1, 45, 2, 64, True),
    "N64-T1": (2, 1, 2, 64, False),
    "N16-T40-s0": (1, 40, 3, 16, True),
}


def _inputs(B, T, H, N, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(r=f(B, T, H, N), k=f(B, T, H, N), v=f(B, T, H, N),
                w=np.exp(-np.exp(f(B, T, H, N))).astype(np.float32),
                u=(0.5 * f(H, N)).astype(np.float32), s0=f(B, H, N, N),
                dy=f(B, T, H, N))


def _seg_sum(x, lanes):
    """Σ over the last axis cut into `lanes` segments, each summed in
    order, the segments added as the row's butterfly adds them: lanes 1
    apart, then 2 apart."""
    parts = [p.sum(-1) for p in x.chunk(lanes, dim=-1)]
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


def _rows_sum(x):
    """Σ over axis -2 (the rows n) in order, as the kernel sums a column's
    parked terms after each group."""
    out = x[..., 0, :]
    for i in range(1, x.shape[-2]):
        out = out + x[..., i, :]
    return out


def wkv6_seq_bwd_twin(r, k, v, w, u, s0, dy):
    """K6-bwd's passes (`csrc/wkv6_seq_bwd.cu`) in plain torch, (b, h)
    batched: pass 1 runs the state forward from s0 and keeps it at the
    start of every group of K6_BWD_WINDOW steps; pass 2 takes the groups
    from the last, reruns each group's states S_(t-1) from its checkpoint
    (`_seq_state_step`, the forward's update and bits) and walks its steps
    backward from G = 0:
      dr = Σ_m S_(t-1) dy_m + u k (v·dy), dk = u r (v·dy) + Σ_m G v_m,
      dw = Σ_m S_(t-1) G, v·dy: over each row's four column segments;
      dv_m = (Σ_n r u k) dy_m + Σ_n G k_n: over the rows in order;
      du += r k (v·dy); G <- w G + r ⊗ dy;
    du summed over the batch in order.  -> (dr, dk, dv, dw, du), f32."""
    f32 = torch.float32
    r, k, v, w, u, dy = (t.to(f32) for t in (r, k, v, w, u, dy))
    B, T, H, N = r.shape
    W, L = K6_BWD_WINDOW, K6_BWD_ROW_LANES
    nwin = -(-T // W)
    S = s0.to(f32)
    ckpt = []
    for g in range(nwin):
        ckpt.append(S)
        for t in range(g * W, min(T, (g + 1) * W)):
            S = _seq_state_step(S, k[:, t], v[:, t], w[:, t])
    G = torch.zeros_like(S)
    du = torch.zeros_like(r[:, 0])
    out = [torch.zeros_like(r) for _ in range(4)]
    for g in range(nwin - 1, -1, -1):
        t0, t1 = g * W, min(T, (g + 1) * W)
        S, prev = ckpt[g], []
        for t in range(t0, t1):
            prev.append(S)
            S = _seq_state_step(S, k[:, t], v[:, t], w[:, t])
        for t in range(t1 - 1, t0 - 1, -1):
            Sp = prev[t - t0]
            rt, kt, vt, wt, gt = (x[:, t] for x in (r, k, v, w, dy))
            vm, gm = vt[..., None, :], gt[..., None, :]
            kn, rn = kt[..., :, None], rt[..., :, None]
            vdy = _seg_sum(vm * gm + torch.zeros_like(Sp), L)
            out[0][:, t] = _seg_sum(Sp * gm, L) + u * kt * vdy
            out[1][:, t] = u * rt * vdy + _seg_sum(G * vm, L)
            out[3][:, t] = _seg_sum(Sp * G, L)
            bonus = _rows_sum((rt * u * kt)[..., :, None])
            out[2][:, t] = bonus * gt + _rows_sum(G * kn)
            du = du + rt * kt * vdy
            G = wt[..., :, None] * G + rn * gm
    du_sum = torch.zeros_like(u)
    for b in range(B):
        du_sum = du_sum + du[b]
    return (*out, du_sum)


@functools.lru_cache(maxsize=None)
def _smoke():
    """chip_smoke.py as a module (its backward checks), loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "_k6_bwd_plan_smoke", Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", list(CASES))
def test_twin_against_plain_and_jax(case):
    """The twin against K6-bwd's plain version (the card's rule) and the
    VJP of JAX's scan compiled whole under `exact_jit` (JAX's rule), from
    s0 or the zero state."""
    B, T, H, N, with_s0 = CASES[case]
    d = _inputs(B, T, H, N, seed=len(case) + 17)
    if not with_s0:
        d["s0"] = np.zeros_like(d["s0"])
    t = {k_: torch.from_numpy(x) for k_, x in d.items()}
    args = [t[k_] for k_ in ("r", "k", "v", "w", "u", "s0", "dy")]
    got = wkv6_seq_bwd_twin(*args)
    ref = wkv6_seq_bwd_plain(*args)
    mag = wkv6_seq_bwd_plain(*(x.abs() for x in args[:3]), t["w"],
                             t["u"].abs(), t["s0"].abs(), t["dy"].abs())
    ok, errs = _smoke()._wkv6_bwd_ok(got, ref, mag, torch.ones(1), 1, 0)
    assert ok, errs

    def vjp_of(r, k, v, w, u, s0, dy):
        _, vjp = jax.vjp(lambda *a: j_scan(*a, s0)[0], r, k, v, w, u)
        return vjp(dy)
    jref = exact_jit(vjp_of)(*(jnp.asarray(d[k_]) for k_ in
                               ("r", "k", "v", "w", "u", "s0", "dy")))
    for name, a, b in zip(NAMES, got, jref):
        b = np.asarray(b)
        dd = np.abs(a.numpy() - b)
        assert float(dd.max()) <= 2.0 ** -12 * float(np.abs(b).max()), name
        assert float(dd.mean()) <= 2.0 ** -14 * float(np.abs(b).mean()), \
            name


def test_twin_lone_step_has_no_dw():
    """A lone step (T 1): G is zero before it, so dw is zero, bit for
    bit."""
    d = _inputs(1, 1, 2, 16, seed=5)
    t = [torch.from_numpy(d[k_]) for k_ in ("r", "k", "v", "w", "u", "s0",
                                            "dy")]
    got = wkv6_seq_bwd_twin(*t)
    assert bool((got[3] == 0).all())


@pytest.mark.parametrize("B,T,H,N", [(2, 40, 64, 64), (8, 16, 64, 64),
                                     (1, 1, 2, 16), (3, 13, 5, 32),
                                     (1, 100, 2, 16)])
def test_plan(B, T, H, N):
    """A block a (b, h) of 4N threads (N / 4 columns a thread, whole
    warps of eight rows), the group's states, staged rows and bonus terms
    within a block's shared memory, and a scratch of one state a group
    and du's partials."""
    p = k6_bwd_plan(B, T, H, N)
    assert p.blocks == B * H and p.threads == K6_BWD_ROW_LANES * N
    assert p.threads % 32 == 0 and p.threads <= 1024
    assert p.window == K6_BWD_WINDOW
    assert p.smem <= K6_MAX_SMEM
    assert p.smem >= 4 * K6_BWD_WINDOW * N * N
    assert p.scratch_floats == B * H * (-(-T // K6_BWD_WINDOW) * N * N + N)


def test_plan_at_the_train_shape():
    """rwkv6-7b's S 40 train step (B2 H64 N64): 128 blocks of 256 threads,
    one an SM (each under the card's 132), and five groups: the first
    design's window of 32 gave two, and a scratch of 32 states a block."""
    p = k6_bwd_plan(2, 40, 64, 64)
    assert p.blocks == 128 <= SMS and p.threads == 256
    assert -(-40 // p.window) == 5


@pytest.mark.parametrize("N", [8, 48, 128])
def test_plan_refuses_other_heads(N):
    assert N not in K6_BWD_HEAD_DIMS
    with pytest.raises(ValueError):
        k6_bwd_plan(1, 8, 2, N)
