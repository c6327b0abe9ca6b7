"""Port vs JAX: the learning-rate schedules and the optimizers
(`repro_torch/optim/` against `repro/optim/`) over a small tree, on
numpy-seeded parameters and gradients.

Tolerance: f32 within 1e-6 relative, per element: |d| <= 1e-6·|ref| +
1e-6·mean|ref| of the leaf (the second term for elements where an update
p - lr·u, or a moment's b·m + (1 - b)·g, cancels most of the operands,
whose scale the leaf's mean stands for; the schedules are scalars and
take 1e-6·|ref| alone).  Both sides run the same f32 operations in the
same order; they may differ in the last bit where a library routine does
(cos, pow, sqrt) or a sum runs in another order (the global norm,
Adafactor's means), and a last-bit change moves the results by a few
units of 2^-24 of the operands.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.optim import optimizers as jopt
from repro.optim import schedules as jsch
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsch
from repro_torch.tree import leaves_with_path

RTOL = 1e-6
STEPS = [0, 1, 2, 7, 99, 199, 200, 201, 1234, 9999, 10_000, 25_000]


@pytest.mark.parametrize("sched", [
    ("linear_warmup", (3e-4, 200)), ("linear_warmup", (1.0, 0)),
    ("cosine_schedule", (3e-4, 200, 10_000)),
    ("cosine_schedule", (1e-3, 10, 500, 0.0))])
def test_schedules_match_jax(sched):
    name, args = sched
    jf, tf = getattr(jsch, name)(*args), getattr(tsch, name)(*args)
    for s in STEPS:
        want = np.float32(jf(jnp.int32(s)))
        got = tf(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


def _tree(seed, scale=1.0):
    """A small parameter-shaped tree: a stacked (L, K, N) matrix, a
    factored (130, 140) matrix, vectors and a nested dict."""
    rng = np.random.default_rng(seed)
    n = lambda *s: (scale * rng.normal(size=s)).astype(np.float32)
    return {"blocks": {"w": n(2, 6, 5), "b": n(2, 5)},
            "big": n(130, 140), "head": {"scale": n(7)}}


def _to_j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_t(tree):
    return {k: _to_t(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def _assert_trees(jtree, ttree):
    jl = {jax.tree_util.keystr(p): np.asarray(v)
          for p, v in jax.tree_util.tree_leaves_with_path(jtree)}
    tl = {"".join(f"[{k!r}]" for k in p): v.numpy()
          for p, v in leaves_with_path(ttree)}
    assert jl.keys() == tl.keys()
    for key in jl:
        scale = float(np.abs(jl[key]).mean())
        np.testing.assert_allclose(tl[key], jl[key], rtol=RTOL,
                                   atol=RTOL * scale, err_msg=key)


@pytest.mark.parametrize("scale", [1e-3, 3.0])
def test_clip_by_global_norm_matches_jax(scale):
    """Below and above the clip norm of 1."""
    g = _tree(1, scale)
    jg, jn = jopt.clip_by_global_norm(_to_j(g), 1.0)
    tg, tn = topt.clip_by_global_norm(_to_t(g), 1.0)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=RTOL)
    _assert_trees(jg, tg)


@pytest.mark.parametrize("kind,kw", [
    ("adamw", {"lr": "cosine"}), ("adamw", {"lr": 1e-2}),
    ("adamw", {"lr": 1e-2, "clip_norm": None}),
    ("adafactor", {"lr": "cosine"}),
    ("adafactor", {"lr": 1e-2, "weight_decay": 0.1})])
def test_optimizer_matches_jax(kind, kw):
    """Three updates from the same params and gradients (some steps
    clipped): the params, the moments and the count after each."""
    kw = dict(kw)
    if kw["lr"] == "cosine":
        jlr, tlr = (jsch.cosine_schedule(3e-2, 2, 10),
                    tsch.cosine_schedule(3e-2, 2, 10))
    else:
        jlr = tlr = kw["lr"]
    del kw["lr"]
    jinit, jupd = getattr(jopt, kind)(jlr, **kw)
    tinit, tupd = getattr(topt, kind)(tlr, **kw)
    p = _tree(0)
    jp, tp = _to_j(p), _to_t(p)
    js, ts = jinit(jp), tinit(tp)
    for step, scale in enumerate((0.05, 4.0, 0.3)):
        g = _tree(10 + step, scale)
        jp, js = jupd(_to_j(g), js, jp)
        tp, ts = tupd(_to_t(g), ts, tp)
        assert int(ts.count) == int(js.count) == step + 1
        _assert_trees(jp, tp)
        _assert_trees(js.nu, ts.nu)
        if kind == "adamw":
            _assert_trees(js.mu, ts.mu)
        else:
            assert ts.mu is None


def test_adamw_takes_a_given_step_and_decays_matrices_only():
    """lr(step) at a given step, not the count; weight decay on ndim >= 2
    leaves only (a zero gradient moves a matrix, not a vector)."""
    p = {"m": np.ones((3, 4), np.float32), "v": np.ones(4, np.float32)}
    g = {"m": np.zeros((3, 4), np.float32), "v": np.zeros(4, np.float32)}
    sched = (jsch.linear_warmup(1e-2, 100), tsch.linear_warmup(1e-2, 100))
    jinit, jupd = jopt.adamw(sched[0])
    tinit, tupd = topt.adamw(sched[1])
    jp, _ = jupd(_to_j(g), jinit(_to_j(p)), _to_j(p), jnp.int32(49))
    tp, _ = tupd(_to_t(g), tinit(_to_t(p)), _to_t(p),
                 torch.tensor(49, dtype=torch.int32))
    _assert_trees(jp, tp)
    assert bool((tp["v"] == 1).all()) and bool((tp["m"] < 1).all())


def test_update_is_in_place():
    """The update writes into the given params and moments (the torch
    idiom) and returns the same tensors."""
    init, upd = topt.adamw(1e-2)
    tp = _to_t(_tree(0))
    st = init(tp)
    ids = [id(t) for _, t in leaves_with_path(tp)]
    before = tp["big"].clone()
    new, st2 = upd(_to_t(_tree(3)), st, tp)
    assert [id(t) for _, t in leaves_with_path(new)] == ids
    assert st2.mu is st.mu and not torch.equal(before, tp["big"])
