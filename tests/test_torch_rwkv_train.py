"""Port vs JAX: the RWKV training slice on the smoke models (rwkv4 L2 D64
F256 V256; rwkv6 L2 D64 H4 N16 F128 V256; B 2): `loss_fn` and its
gradient against JAX's `jax.value_and_grad(loss_fn)`, one and two steps
of `build_train_step` against JAX's on `make_host_mesh()`, remat, the
routing of the train step through K2, K11 and K12 (their plain versions
on the CPU, which autograd differentiates), K2-bwd's and K11-bwd's plain
versions through their autograd Functions against JAX's autodiff, the
refusals that stay, `build_step_for_cell`'s train branch and the launcher
with checkpoints.

Tolerances (those of `tests/test_torch_train.py`):
  * f32 config: the loss within 1e-6 relative; each gradient leaf within
    1e-5 of its max and mean magnitude (max |d| <= 1e-5 max|ref|, mean
    |d| <= 1e-5 mean|ref|); the params after each AdamW step within 1e-6
    of the leaf's mean magnitude plus, per element, what AdamW makes of a
    gradient error of 1e-5 max|g| in each step's gradient
    (`_adam_allowance`: the first-order change of m̂ / (√v̂ + eps) over
    JAX's clipped gradients of every step so far, summed over the steps'
    learning rates; at step 1 it is `test_torch_train.py`'s eps·δg / (|g| +
    eps)², at step 2 m̂ and √v̂ no longer cancel, and an element whose two
    gradients nearly cancel in m̂ moves by δg / √v̂).
    Both sides compute in f32; the port's gradient comes from torch's
    autograd, JAX's from XLA's autodiff, so they differ in the order of
    their sums.  rwkv6 at S 128 takes the chunked WKV
    (S % 64 == 0), whose cumsum JAX and the port take in other orders
    (`tests/test_torch_rwkv_forward.py`): there the gradients are held
    within 2^-12 of each leaf's max and 2^-14 of its mean.
  * bf16 config: the port held to an f32 witness (JAX's f32 config on the
    same weights and batch), the recipe of `test_torch_train.py`: the loss
    and each gradient leaf's mean gap (mean |d| / mean|witness|) within
    1.25x JAX's own bf16 gap to it.  A leaf's max gap is one element, and
    which elements a bf16 rounding flips is chance (rwkv4 smoke's leaves
    hold 64 to 16k elements: their max ratios read 0.59–1.47 while the
    means read 0.70–1.10): two bf16 paths each a bf16 noise distance from
    the witness may sit √2 apart, so the max is held within 1.25·√2x.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from port_helpers import f32, to_port
from repro.configs.base import ShapeConfig as JShape
from repro.data import SyntheticLM as JSyn
from repro.kernels.common import exact_jit
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models.registry import Model as JModel
from repro.models.registry import get_model as j_get_model
from repro.models.registry import loss_fn as j_loss_fn
from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.kernels import expsig
from repro_torch.kernels import fused_layernorm as K11
from repro_torch.kernels import wkv4 as K2
from repro_torch.kernels import wkv6 as K6_10
from repro_torch.launch.steps import (
    build_step_for_cell, build_train_step, loss_and_grads)
from repro_torch.launch.train import train, train_model
from repro_torch.models import registry as REG
from repro_torch.models.registry import get_model
from repro_torch.optim import cosine_schedule
from repro_torch.tree import keystr, leaves_with_path

B = 2
HEADROOM = 1.25
CASES = [("rwkv4-169m", 64), ("rwkv6-7b", 64), ("rwkv6-7b", 128)]


def _j(arch, **over):
    m = j_get_model(arch, smoke=True)
    return JModel(cfg=dataclasses.replace(m.cfg, **over), module=m.module)


def _t(arch, **over):
    m = get_model(arch, smoke=True)
    return type(m)(cfg=dataclasses.replace(m.cfg, **over), module=m.module)


def _batch(S, step=0, mask_tail=0):
    hb = JSyn(vocab=256, seq_len=S, global_batch=B, seed=0).batch(step)
    if mask_tail:
        hb["mask"] = hb["mask"].copy()
        hb["mask"][:, -mask_tail:] = 0
    return ({k: jnp.asarray(v) for k, v in hb.items()},
            {k: torch.from_numpy(v) for k, v in hb.items()})


def _flat_j(tree):
    return {jax.tree_util.keystr(p): f32(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _flat_t(tree):
    return {keystr(p): f32(v) for p, v in leaves_with_path(tree)}


def _gaps(got, ref):
    d = np.abs(got - ref)
    return (float(d.max() / np.abs(ref).max()),
            float(d.mean() / np.abs(ref).mean()))


def _jax_value_and_grad(model, params, batch):
    fn = exact_jit(jax.value_and_grad(lambda p: j_loss_fn(model, p,
                                                          batch)[0]))
    loss, grads = fn(params)
    return float(loss), _flat_j(grads)


def _port_value_and_grad(model, params, batch):
    (loss, _), grads = loss_and_grads(model, params, batch)
    return float(loss), _flat_t(grads)


def _limits(arch, S):
    """(max, mean) relative gradient limits of the f32 comparison."""
    chunked = arch == "rwkv6-7b" and S % 64 == 0 and S > 64
    return (2.0 ** -12, 2.0 ** -14) if chunked else (1e-5, 1e-5)


@pytest.fixture(scope="module")
def init():
    """Each arch's seeded JAX weights and their port copy."""
    out = {}
    for arch in {a for a, _ in CASES}:
        jp = _j(arch).init_params(jax.random.PRNGKey(0))
        out[arch] = (jp, to_port(jp))
    return out


@pytest.mark.parametrize("arch,S", CASES)
def test_loss_and_grads_match_jax_f32(init, arch, S):
    """loss_fn's value and gradient on a masked batch (the last eight
    tokens of each row out), f32 config, against jax.value_and_grad."""
    jp, tp = init[arch]
    jb, tb = _batch(S, mask_tail=8)
    jl, jg = _jax_value_and_grad(_j(arch, dtype="float32"), jp, jb)
    tl, tg = _port_value_and_grad(_t(arch, dtype="float32"), tp, tb)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    assert jg.keys() == tg.keys()
    max_rel, mean_rel = _limits(arch, S)
    for key in jg:
        mx, mean = _gaps(tg[key], jg[key])
        assert mx <= max_rel and mean <= mean_rel, (key, mx, mean)


@pytest.mark.parametrize("arch,S", CASES)
def test_loss_and_grads_bf16_held_to_f32_witness(init, arch, S):
    """bf16 config: the port's loss and each gradient leaf no farther from
    the f32 witness than 1.25x JAX's bf16 loss_fn is."""
    jp, tp = init[arch]
    jb, tb = _batch(S)
    wl, wg = _jax_value_and_grad(_j(arch, dtype="float32"), jp, jb)
    jl, jg = _jax_value_and_grad(_j(arch), jp, jb)
    tl, tg = _port_value_and_grad(_t(arch), tp, tb)
    assert abs(tl - wl) <= HEADROOM * abs(jl - wl) + 1e-6 * abs(wl)
    for key in wg:
        j_max, j_mean = _gaps(jg[key], wg[key])
        t_max, t_mean = _gaps(tg[key], wg[key])
        assert t_mean <= HEADROOM * j_mean, (key, t_mean, j_mean)
        assert t_max <= HEADROOM * 2 ** 0.5 * j_max, (key, t_max, j_max)


def _jax_steps(model, params, S, steps):
    """JAX's jitted train step: the loss and params after each step, and
    the gradient each step took (read before the step donates its
    params)."""
    shape = JShape("custom", S, B, "train")
    jitted, _, _, (init_opt, _) = j_build_train_step(model, make_host_mesh(),
                                                     shape)
    opt, p, losses, ps, gs = init_opt(params), params, [], [], []
    for step in range(steps):
        jb = _batch(S, step)[0]
        gs.append(_jax_value_and_grad(model, p, jb)[1])
        p, opt, m = jitted(p, opt, jb)
        losses.append(float(m["loss"]))
        ps.append(_flat_j(p))
    return losses, ps, gs


def _port_steps(model, params, S, steps):
    step_fn, _, (init_opt, _) = build_train_step(model)
    opt, losses, ps = init_opt(params), [], []
    for step in range(steps):
        params, opt, m = step_fn(params, opt, _batch(S, step)[1])
        losses.append(float(m["loss"]))
        ps.append(_flat_t(params))
    return losses, ps


def _adam_allowance(gs, key, steps, b1=0.9, b2=0.95, eps=1e-8, rel=1e-5):
    """Per element, the most the params after `steps` AdamW steps move for
    a gradient error of rel·max|g| in each step's (clipped) gradient: the
    first-order change of u = m̂ / (√v̂ + eps), Σ_j |∂u/∂g_j|·δ_j, at most
    2 a step (a flipped sign), times each step's learning rate."""
    clipped = []
    for g in gs[:steps]:
        gn = np.sqrt(sum(float(np.sum(np.square(x))) for x in g.values()))
        clipped.append(g[key].astype(np.float64) * min(1.0, 1.0 / gn))
    total = 0.0
    for s in range(steps):
        t = s + 1
        wm = [(1 - b1) * b1 ** (s - j) / (1 - b1 ** t) for j in range(t)]
        wv = [(1 - b2) * b2 ** (s - j) / (1 - b2 ** t) for j in range(t)]
        m = sum(w * g for w, g in zip(wm, clipped))
        r = np.sqrt(sum(w * g * g for w, g in zip(wv, clipped)))
        du = 0.0
        for j in range(t):
            dudg = wm[j] / (r + eps) - m * wv[j] * clipped[j] / (
                np.maximum(r, 1e-30) * (r + eps) ** 2)
            du = du + np.abs(dudg) * rel * float(np.abs(clipped[j]).max())
        lr = float(cosine_schedule(3e-4, 200, 10_000)(t))
        total = total + lr * np.minimum(2.0, du)
    return total


@pytest.mark.parametrize("arch", ["rwkv4-169m", "rwkv6-7b"])
def test_train_steps_match_jax_f32(arch):
    """One and two AdamW steps of build_train_step (f32 config, S 64)
    against JAX's jitted step: the losses within 1e-6, the params within
    1e-6 of each leaf's mean magnitude plus `_adam_allowance`."""
    S, steps = 64, 2
    jm, tm = _j(arch, dtype="float32"), _t(arch, dtype="float32")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = to_port(jp)                # before JAX's step donates jp
    jl, jps, jgs = _jax_steps(jm, jp, S, steps)
    tl, tps = _port_steps(tm, tp, S, steps)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    for i in range(steps):
        for key in jps[i]:
            allow = 1e-6 * float(np.abs(jps[i][key]).mean()) + \
                _adam_allowance(jgs, key, i + 1)
            d = np.abs(tps[i][key] - jps[i][key])
            assert (d <= allow).all(), (i, key, float(d.max()))


@pytest.mark.parametrize("arch", ["rwkv4-169m", "rwkv6-7b"])
def test_remat_changes_no_bit(arch):
    """The gradients with remat (each layer recomputed in the backward)
    equal those without it bit for bit."""
    _, tb = _batch(64)
    params = _t(arch).init_params(0, "cpu")
    (l1, _), g1 = loss_and_grads(_t(arch), params, tb)
    (l2, _), g2 = loss_and_grads(_t(arch, remat=False), params, tb)
    assert torch.equal(l1, l2)
    for (p, a), (_, b) in zip(leaves_with_path(g1), leaves_with_path(g2)):
        assert torch.equal(a, b), p


class _Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


def _spies(monkeypatch, arch="rwkv4-169m"):
    spies = {}
    wkv = ((K2, "_forward"), (K2, "wkv4_seq_bwd")) \
        if arch == "rwkv4-169m" else (
            (K6_10, "_chunked_forward"), (K6_10, "wkv6_chunked_bwd"),
            (K6_10, "_seq_forward"), (K6_10, "wkv6_seq_bwd"))
    for mod, name in (*wkv, (K11, "_forward"), (K11, "fused_layernorm_bwd"),
                      (REG, "fused_cross_entropy")):
        spy = _Spy(getattr(mod, name))
        monkeypatch.setattr(mod, name, spy)
        spies[f"{mod.__name__.split('.')[-1]}.{name}"] = spy
    return spies


@pytest.mark.parametrize("mode", [
    "train", "no_remat", "no_grad", "rwkv6-train", "rwkv6-no_remat",
    "rwkv6-no_grad", "rwkv6-S40-train"])
def test_grad_routing_through_backward_kernels(monkeypatch, mode):
    """rwkv4's train step runs K2 twice a layer (the forward and its
    recompute under remat), K11 2L + 2 + 2L times, and its loss through
    K12 once; without remat K2 and K11 run once each.  rwkv6's ("rwkv6-"
    modes) runs K10 in K2's place at S 128 and K6 at S 40 (no multiple of
    the chunk), as often.  On the CPU autograd differentiates their plain
    versions, so K2-bwd, K10-bwd, K6-bwd and K11-bwd are never called (on
    the card the step launches them once per forward call:
    tests/test_torch_cuda.py:test_train_step_rwkv4_smoke_on_card and
    test_train_step_rwkv6_smoke_on_card)."""
    arch = "rwkv6-7b" if mode.startswith("rwkv6") else "rwkv4-169m"
    spies = _spies(monkeypatch, arch)
    tm = _t(arch, remat=not mode.endswith("no_remat"))
    params = tm.init_params(0, "cpu")
    S = 40 if "S40" in mode else 64 if arch == "rwkv4-169m" else 128
    _, tb = _batch(S)
    L = tm.cfg.n_layers
    if mode.endswith("no_grad"):
        with torch.no_grad():
            tm.forward(params, tb)
        fwd, ln, ce = L, 2 * L + 2, 0
    else:
        step, _, (init_opt, _) = build_train_step(tm)
        step(params, init_opt(params), tb)
        rec = mode.endswith("train")
        fwd, ln, ce = ((2 if rec else 1) * L,
                       2 * L + 2 + (2 * L if rec else 0), 1)
    wkv = (fwd, 0) if arch == "rwkv4-169m" else \
        (0, 0, fwd, 0) if S == 40 else (fwd, 0, 0, 0)
    assert tuple(s.calls for s in spies.values()) == (*wkv, ln, 0, ce), \
        spies.keys()


def _bwd_gaps(got, ref):
    """Per output of a backward: (max |d| / max|ref|, mean |d| /
    mean|ref|), in f32."""
    return [_gaps(f32(a), f32(r)) for a, r in zip(got, ref)]


@pytest.mark.parametrize("k_scale", [1.0, 8.0])
def test_wkv4_bwd_function_matches_jax_autodiff(monkeypatch, k_scale):
    """K2's autograd Function on CPU tensors (its forward K2's plain
    version, its backward `wkv4_seq_bwd`, whose plain version holds the
    two passes K2-bwd runs on the card) against JAX's autodiff of
    `wkv4_scan` from the zero state (o0 = -1e38), B 2 T 24 C 16 with a
    seeded N(0, 1) output gradient; k at 8x scale drives the running max
    across the whole exp range.  y bit for bit with the plain forward;
    gk, gv, gw, gu within 1e-5 of each output's max and mean magnitude
    (both f32; the sums are taken in other orders)."""
    from repro.core.wkv.wkv4 import wkv4_scan
    rng = np.random.default_rng(int(k_scale))
    B, T, C = 2, 24, 16
    k = (k_scale * rng.standard_normal((B, T, C))).astype(np.float32)
    v = rng.standard_normal((B, T, C)).astype(np.float32)
    w = np.exp(0.5 * rng.standard_normal(C)).astype(np.float32)
    u = rng.standard_normal(C).astype(np.float32)
    gy = rng.standard_normal((B, T, C)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: wkv4_scan(*a)[0], *map(jnp.asarray,
                                                        (k, v, w, u)))
    ref = vjp(jnp.asarray(gy))
    spy = _Spy(K2.wkv4_seq_bwd)
    monkeypatch.setattr(K2, "wkv4_seq_bwd", spy)
    ins = [torch.from_numpy(a).requires_grad_() for a in (k, v, w, u)]
    a0, b0 = torch.zeros(B, C), torch.zeros(B, C)
    o0 = torch.full((B, C), -1e38)
    y, *_ = K2._WKV4.apply(*ins, a0, b0, o0)
    got = torch.autograd.grad(y, ins, torch.from_numpy(gy))
    assert spy.calls == 1
    with torch.no_grad():
        assert torch.equal(y, K2.wkv4_seq_plain(*ins, a0, b0, o0)[0])
    for name, (mx, mean) in zip(("gk", "gv", "gw", "gu"),
                                _bwd_gaps(got, ref)):
        assert mx <= 1e-5 and mean <= 1e-5, (name, mx, mean)


@pytest.mark.parametrize("chunk", [1, 5, 16])
@pytest.mark.parametrize("k_scale", [1.0, 8.0])
def test_wkv4_bwd_plain_chunked_matches_jax_autodiff(k_scale, chunk):
    """K2-bwd's plain version with its reverse pass in chunks of `chunk`
    steps (each recomputed from a checkpoint, as the kernel runs it)
    against JAX's autodiff of `wkv4_scan` from the zero state, on the
    inputs of `test_wkv4_bwd_function_matches_jax_autodiff` (B 2 T 24
    C 16, T no multiple of 5 or 16), with its tolerance: gk, gv, gw, gu
    within 1e-5 of each output's max and mean magnitude."""
    from repro.core.wkv.wkv4 import wkv4_scan
    rng = np.random.default_rng(int(k_scale))
    B, T, C = 2, 24, 16
    k = (k_scale * rng.standard_normal((B, T, C))).astype(np.float32)
    v = rng.standard_normal((B, T, C)).astype(np.float32)
    w = np.exp(0.5 * rng.standard_normal(C)).astype(np.float32)
    u = rng.standard_normal(C).astype(np.float32)
    gy = rng.standard_normal((B, T, C)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: wkv4_scan(*a)[0], *map(jnp.asarray,
                                                        (k, v, w, u)))
    ref = vjp(jnp.asarray(gy))
    a0, b0 = torch.zeros(B, C), torch.zeros(B, C)
    o0 = torch.full((B, C), -1e38)
    got = K2.wkv4_seq_bwd_plain(*map(torch.from_numpy, (k, v, w, u)), a0,
                                b0, o0, torch.from_numpy(gy), chunk=chunk)
    for name, (mx, mean) in zip(("gk", "gv", "gw", "gu"),
                                _bwd_gaps(got, ref)):
        assert mx <= 1e-5 and mean <= 1e-5, (name, mx, mean)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_bwd_function_matches_jax_autodiff(monkeypatch, dtype):
    """K11's autograd Function on CPU tensors (its backward
    `fused_layernorm_bwd`, whose plain version is K11-bwd's formula)
    against JAX's autodiff of `apply_norm`'s single-pass LayerNorm, x
    (3, 40, 96) at offset 0.5, γ and β in x's dtype, a seeded N(0, 1)
    output gradient in that dtype.  f32: dx, dγ, dβ within 1e-5 of each
    output's max and mean magnitude.  bf16: each output is an f32 value
    rounded once, so an f32 difference in the order of sums can flip one
    rounding: max |d| within one bf16 step (2^-7) of the max magnitude,
    mean |d| within 2^-9 of the mean."""
    from repro.models.layers import apply_norm
    rng = np.random.default_rng(7)
    D = 96
    x = (2 * rng.standard_normal((3, 40, D)) + 0.5).astype(np.float32)
    gamma, beta = (rng.standard_normal(D).astype(np.float32)
                   for _ in range(2))
    dy = rng.standard_normal(x.shape).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jg, jb, jdy = (jnp.asarray(a).astype(jd) for a in (x, gamma, beta,
                                                            dy))
    _, vjp = jax.vjp(lambda a, g, b: apply_norm(
        {"scale": g, "bias": b}, a, "layernorm"), jx, jg, jb)
    ref = vjp(jdy)
    spy = _Spy(K11.fused_layernorm_bwd)
    monkeypatch.setattr(K11, "fused_layernorm_bwd", spy)
    ins = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        td).requires_grad_() for a in (jx, jg, jb)]
    out = K11._FusedLayerNorm.apply(*ins, 1e-5)
    got = torch.autograd.grad(out, ins, torch.from_numpy(dy).to(td))
    assert spy.calls == 1
    assert [g.dtype for g in got] == [td] * 3
    lim = (1e-5, 1e-5) if dtype == "float32" else (2.0 ** -7, 2.0 ** -9)
    for name, (mx, mean) in zip(("dx", "dgamma", "dbeta"),
                                _bwd_gaps(got, ref)):
        assert mx <= lim[0] and mean <= lim[1], (name, mx, mean)


def test_refusals_that_stay():
    """Under grad, on a tensor off the CPU (meta tensors stand in for the
    card, where nothing is built here), what K10-bwd and K6-bwd do not
    cover raises naming the calls they do, before anything is built: K6
    with a valid mask, with a carry snap, with a bf16 initial state or
    with one that requires grad, K10 with such a state; K9 and K2 with the LUT tables or
    a valid mask raise naming the hardware numerics.  The forward's own
    calls of K10, K6, K2 and K11 go on to their kernels (the build raises
    RuntimeError here)."""
    meta = lambda *s: torch.empty(s, device="meta")
    g = meta(64).requires_grad_()
    rkvw = lambda: [meta(1, 128, 2, 16) for _ in range(4)]
    u = meta(2, 16).requires_grad_()
    s0g = meta(1, 2, 16, 16).requires_grad_()
    k2 = lambda **kw: K2.wkv4_seq(meta(1, 8, 64), meta(1, 8, 64), g,
                                  meta(64), meta(1, 64), meta(1, 64),
                                  meta(1, 64), **kw)
    k6 = lambda s0=None, **kw: K6_10.wkv6_seq(
        *rkvw(), u, meta(1, 2, 16, 16) if s0 is None else s0, **kw)
    own = "initial state that takes no gradient"
    for call, why in (
            (lambda: K6_10.wkv6_chunked_kernel(*rkvw(), u, s0g), own),
            (lambda: k6(valid=meta(1, 128)), own),
            (lambda: k6(carry_dtype="bfloat16"), own),
            (lambda: k6(s0g), own),
            (lambda: k6(torch.empty((1, 2, 16, 16), dtype=torch.bfloat16,
                                    device="meta")), own),
            (lambda: expsig.sigmoid_kernel(g), "hardware numerics"),
            (lambda: k2(exp_table=meta(256), div_table=meta(256)),
             "hardware numerics"),
            (lambda: k2(valid=meta(1, 8)), "valid mask")):
        with pytest.raises(NotImplementedError, match=why):
            call()
    for call in (k2, lambda: K11.fused_layernorm(meta(4, 64), g, meta(64)),
                 lambda: K6_10.wkv6_chunked_kernel(*rkvw(), u), k6):
        with pytest.raises(RuntimeError):
            call()


@pytest.mark.parametrize("arch", ["rwkv4-169m", "rwkv6-7b"])
def test_train_step_for_cell(arch):
    """build_step_for_cell(arch, "train_4k") gives the train step with
    meta arguments at the cell's shape, for both RWKV families."""
    step, (params, opt, batch), kind = build_step_for_cell(arch, "train_4k")
    cfg = get_model(arch).cfg
    assert kind == "train_step" and callable(step)
    assert params["embed"].device.type == "meta"
    assert params["embed"].shape == (cfg.vocab, cfg.d_model)
    assert opt.mu["blocks"]["ffn"]["wk"].shape == (cfg.n_layers,
                                                   cfg.d_model, cfg.d_ff)
    assert batch["tokens"].shape == (256, 4096)
    assert batch["labels"].dtype == torch.int32


def test_launcher_checkpoints_resume_and_learns(tmp_path):
    """`train` on rwkv4 smoke: the loss goes down over 24 steps (the mean
    of the last four below the first four's); a checkpoint every 8 steps,
    three kept, the last holding the final params bit for bit; a run
    resumed from it starts at step 24 with the loss an uninterrupted
    26-step run reads there, bit for bit (the optimizer state restarts, as
    in JAX, so only that first loss is shared)."""
    ck = str(tmp_path / "ck")
    out = train("rwkv4-169m", steps=24, global_batch=2, seq_len=32,
                device="cpu", ckpt_dir=ck, ckpt_every=8, log_every=100)
    losses = out["losses"]
    assert len(losses) == 24 and np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4]), losses
    assert latest_step(ck) == 24
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000008", "step_00000016", "step_00000024"]
    saved = restore_checkpoint(ck, 24, out["params"])
    for (p, a), (_, b) in zip(leaves_with_path(out["params"]),
                              leaves_with_path(saved)):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    model = get_model("rwkv4-169m", smoke=True)
    resumed = train_model(model, steps=26, global_batch=2, seq_len=32,
                          device="cpu", ckpt_dir=ck, ckpt_every=100)
    fresh = train_model(model, steps=26, global_batch=2, seq_len=32,
                        device="cpu", ckpt_dir=ck, ckpt_every=100,
                        resume=False)
    assert len(resumed["losses"]) == 2 and len(fresh["losses"]) == 26
    assert fresh["losses"][:24] == losses
    assert resumed["losses"][0] == fresh["losses"][24]
