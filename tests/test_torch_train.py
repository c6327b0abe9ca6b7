"""Port vs JAX: the training slice on smollm smoke (L2 D64 H4 KVH2, tied,
S = 512, the flash-attention routing threshold, with use_flash_kernel so
every layer's attention runs through K13's wrapper and its backward):
`loss_fn`, `Model.param_count`, one and two steps of the train step
against JAX's `build_train_step` on `make_host_mesh()`, the routing of
K13 and its backward, remat, `build_step_for_cell`'s train branch, the
launcher and the straggler detector.

Tolerances:
  * f32 config (dtype "float32"): the loss within 1e-6 relative, each
    gradient leaf within 1e-5 of its max and mean magnitude (max |d| <=
    1e-5 max|ref|, mean |d| <= 1e-5 mean|ref|; read: 1e-6), the params
    after each AdamW step within 1e-6 of the leaf's mean magnitude (read:
    1e-8 to 1e-7), plus, per element, what AdamW's normalisation makes of
    a gradient error of 1e-5 max|g|: g / (|g| + eps) moves by eps·δg /
    (|g| + eps)², times the steps' learning rates (nothing for |g| >> eps;
    up to a step's whole move for a gradient near eps = 1e-8, where the
    two f32 sums may differ by 10%).  Both sides compute in f32 and differ
    only in the order of their sums.
  * bf16 config: JAX's jitted step may elide bf16 roundings that eager
    torch makes, so the port is held to an f32 witness (JAX's f32 config
    on the same weights and batch), the recipe of
    `tests/test_torch_transformer.py`: per gradient leaf and for the
    loss, the port's gap to the witness (mean |d| / mean|witness|, and
    max |d| / max|witness|) within 1.25x JAX's own bf16 gap to it, and
    the params after each step no farther from the witness's params than
    1.25x JAX's bf16 params are, as the mean |d| over every weight of the
    model: AdamW moves an element by about ±lr whatever its gradient's
    size, so a bf16 error that flips a small gradient's sign moves it by
    2·lr, and which few elements flip is chance (one of ln2.scale's 128
    flips in one path and not the other: 2.25x on that leaf), while over
    all 170k weights the two bf16 paths read 1.03–1.05x.
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
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models.registry import Model as JModel
from repro.models.registry import get_model as j_get_model
from repro.models.registry import loss_fn as j_loss_fn
from repro.runtime import StragglerDetector as JStraggler
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch.steps import (
    build_step_for_cell, build_train_step, loss_and_grads, make_optimizer)
from repro_torch.launch.train import train, train_model
from repro_torch.models.registry import get_model, loss_fn
from repro_torch.optim import cosine_schedule
from repro_torch.runtime import StragglerDetector
from repro_torch.tree import keystr, leaves_with_path

ARCH = "smollm-135m"
B, S = 2, 512
HEADROOM = 1.25


def _j(**over):
    m = j_get_model(ARCH, smoke=True)
    return JModel(cfg=dataclasses.replace(m.cfg, **over), module=m.module)


def _t(**over):
    m = get_model(ARCH, smoke=True)
    return type(m)(cfg=dataclasses.replace(m.cfg, **over), module=m.module)


def _batch(step=0, seq=S):
    hb = JSyn(vocab=256, seq_len=seq, global_batch=B, seed=0).batch(step)
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


def _jax_run(model, params, steps):
    """JAX's jitted train step on the host mesh: (grads at step 0, the
    loss of each step, the params after each step)."""
    shape = JShape("custom", S, B, "train")
    jitted, _, _, (init_opt, _) = j_build_train_step(model, make_host_mesh(),
                                                     shape)
    jb0, _ = _batch(0)
    grads = jax.jit(jax.grad(lambda p: j_loss_fn(model, p, jb0)[0]))(params)
    opt, p, losses, ps = init_opt(params), params, [], []
    for step in range(steps):
        p, opt, m = jitted(p, opt, _batch(step)[0])
        losses.append(float(m["loss"]))
        ps.append(_flat_j(p))
    return _flat_j(grads), losses, ps


def _port_run(model, params, steps):
    _, tb0 = _batch(0)
    (_, _), grads = loss_and_grads(model, params, tb0)
    step_fn, _, (init_opt, _) = build_train_step(model)
    opt, losses, ps = init_opt(params), [], []
    for step in range(steps):
        params, opt, m = step_fn(params, opt, _batch(step)[1])
        losses.append(float(m["loss"]))
        ps.append(_flat_t(params))
    return _flat_t(grads), losses, ps


@pytest.fixture(scope="module")
def f32_runs():
    jp = _j().init_params(jax.random.PRNGKey(0))
    tp = to_port(jp)              # before JAX's step donates jp
    over = {"use_flash_kernel": True, "dtype": "float32"}
    return _jax_run(_j(**over), jp, 2), _port_run(_t(**over), tp, 2)


@pytest.fixture(scope="module")
def bf16_runs(f32_runs):
    jp = _j().init_params(jax.random.PRNGKey(0))
    tp = to_port(jp)
    return (_jax_run(_j(use_flash_kernel=True), jp, 2),
            _port_run(_t(use_flash_kernel=True), tp, 2), f32_runs[0])


@pytest.mark.parametrize("steps", [1, 2])
def test_train_steps_match_jax_f32(f32_runs, steps):
    (jg, jl, jps), (tg, tl, tps) = f32_runs
    np.testing.assert_allclose(tl[:steps], jl[:steps], rtol=1e-6)
    if steps == 1:
        assert jg.keys() == tg.keys()
        for key in jg:
            mx, mean = _gaps(tg[key], jg[key])
            assert mx <= 1e-5 and mean <= 1e-5, (key, mx, mean)
    ref, got = jps[steps - 1], tps[steps - 1]
    lrs = sum(float(cosine_schedule(3e-4, 200, 10_000)(s + 1))
              for s in range(steps))
    gn = np.sqrt(sum(float(np.sum(np.square(g))) for g in jg.values()))
    eps = 1e-8
    for key in ref:
        g = np.abs(jg[key]) * min(1.0, 1.0 / gn)       # as clipped
        adam = np.minimum(2.0, eps * 1e-5 * float(np.abs(jg[key]).max())
                          / (g + eps) ** 2)
        allow = 1e-6 * float(np.abs(ref[key]).mean()) + lrs * adam
        d = np.abs(got[key] - ref[key])
        assert (d <= allow).all(), (key, float(d.max()))


@pytest.mark.parametrize("steps", [1, 2])
def test_train_steps_bf16_held_to_f32_witness(bf16_runs, steps):
    (jg, jl, jps), (tg, tl, tps), (wg, wl, wps) = bf16_runs
    for i in range(steps):
        j_gap, t_gap = abs(jl[i] - wl[i]), abs(tl[i] - wl[i])
        assert t_gap <= HEADROOM * j_gap + 1e-6 * abs(wl[i]), (i, t_gap,
                                                              j_gap)
    if steps == 1:
        for key in wg:
            j_max, j_mean = _gaps(jg[key], wg[key])
            t_max, t_mean = _gaps(tg[key], wg[key])
            assert t_mean <= HEADROOM * j_mean, (key, t_mean, j_mean)
            assert t_max <= HEADROOM * j_max, (key, t_max, j_max)
    w = wps[steps - 1]
    j_gap = sum(float(np.abs(jps[steps - 1][k] - w[k]).sum()) for k in w)
    t_gap = sum(float(np.abs(tps[steps - 1][k] - w[k]).sum()) for k in w)
    assert 0 < t_gap <= HEADROOM * j_gap, (t_gap, j_gap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_matches_jax(dtype):
    """The loss and its metrics on a masked batch (a quarter of the tokens
    masked out): f32 within 1e-6 relative; bf16 within 1e-3 relative (the
    bf16 logits of two eager/compiled programs differ by a few steps)."""
    jm, tm = _j(dtype=dtype), _t(dtype=dtype)
    jp = jm.init_params(jax.random.PRNGKey(1))
    jb, tb = _batch(3, seq=64)
    mask = np.ones((B, 64), np.float32)
    mask[:, 48:] = 0
    jb["mask"], tb["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    jl, jmet = j_loss_fn(jm, jp, jb)
    tl, tmet = loss_fn(tm, to_port(jp), tb)
    rtol = 1e-6 if dtype == "float32" else 1e-3
    np.testing.assert_allclose(float(tl), float(jl), rtol=rtol)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=rtol)
    assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0
    assert tl.dtype == torch.float32 and tl.shape == ()
    # no mask: the mean over every token
    del jb["mask"], tb["mask"]
    np.testing.assert_allclose(float(loss_fn(tm, to_port(jp), tb)[0]),
                               float(j_loss_fn(jm, jp, jb)[0]), rtol=rtol)


@pytest.mark.parametrize("smoke", [True, False])
def test_param_count_matches_jax(smoke):
    assert get_model(ARCH, smoke=smoke).param_count() == \
        j_get_model(ARCH, smoke=smoke).param_count()


class _Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


@pytest.mark.parametrize("mode", ["train", "no_grad", "inference"])
def test_grad_routing_through_k13_backward(monkeypatch, mode):
    """A train step with use_flash_kernel at S = 512 runs K13's forward
    twice a layer (the forward and its recompute under remat) and its
    backward once a layer; a forward under no_grad or inference_mode runs
    the forward once a layer and no backward."""
    fwd = _Spy(FA._forward)
    bwd = _Spy(FA.flash_attention_bwd)
    monkeypatch.setattr(FA, "_forward", fwd)
    monkeypatch.setattr(FA, "flash_attention_bwd", bwd)
    tm = _t(use_flash_kernel=True)
    params = tm.init_params(0, "cpu")
    _, tb = _batch(0)
    L = tm.cfg.n_layers
    if mode == "train":
        step, _, (init_opt, _) = build_train_step(tm)
        step(params, init_opt(params), tb)
        assert (fwd.calls, bwd.calls) == (2 * L, L)
        return
    ctx = torch.no_grad() if mode == "no_grad" else torch.inference_mode()
    with ctx:
        logits, _ = tm.forward(params, tb)
    assert logits.grad_fn is None
    assert (fwd.calls, bwd.calls) == (L, 0)


def test_remat_changes_no_bit():
    """The gradients with remat (each layer recomputed in the backward)
    equal those without it bit for bit, and the step without remat runs
    K13's forward once a layer."""
    _, tb = _batch(0)
    params = _t().init_params(0, "cpu")
    (l1, _), g1 = loss_and_grads(_t(use_flash_kernel=True), params, tb)
    (l2, _), g2 = loss_and_grads(_t(use_flash_kernel=True, remat=False),
                                 params, tb)
    assert torch.equal(l1, l2)
    for (p, a), (_, b) in zip(leaves_with_path(g1), leaves_with_path(g2)):
        assert torch.equal(a, b), p
    assert all(g.dtype == torch.float32 for _, g in leaves_with_path(g1))


def test_make_optimizer_and_step_for_cell():
    """The default schedule is cosine_schedule(3e-4, 200, 10_000); the
    train cell returns the train step with meta arguments at its shape."""
    init, update = make_optimizer(_t().cfg)
    p = {"w": torch.ones(3, 3)}
    g = {"w": torch.full((3, 3), 0.5)}
    update(g, init(p), p)
    # step 1 of the schedule: 3e-4 · 2/200 · cos(0) → p = 1 - lr·(1 + 0.1)
    lr = 3e-4 * (2 / 200)
    np.testing.assert_allclose(p["w"].numpy(), 1 - lr * 1.1, rtol=1e-6)
    step, (params, opt, batch), kind = build_step_for_cell(
        ARCH, "train_4k", cfg_overrides={"use_flash_kernel": True})
    assert kind == "train_step" and callable(step)
    assert params["embed"].device.type == "meta"
    assert params["embed"].shape == (49152, 576)
    assert opt.mu["embed"].shape == (49152, 576) and opt.count.shape == ()
    assert batch["tokens"].shape == (256, 4096)
    assert batch["labels"].dtype == torch.int32
    assert batch["mask"].dtype == torch.float32


def test_train_launcher(tmp_path):
    """`train` on the smoke config: finite losses that equal a second run
    (the same seeds), the checkpoint option writing its steps (the store
    is `tests/test_torch_checkpoint.py`'s), and an RWKV arch training too
    (its slice is `tests/test_torch_rwkv_train.py`)."""
    out = train(ARCH, smoke=True, steps=2, global_batch=2, seq_len=32,
                device="cpu", log_every=1)
    again = train_model(get_model(ARCH, smoke=True), steps=2,
                        global_batch=2, seq_len=32, device="cpu",
                        ckpt_dir=str(tmp_path), ckpt_every=1)
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert out["losses"] == again["losses"] and len(out["step_s"]) == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000001", "step_00000002"]
    rwkv = train("rwkv4-169m", steps=1, global_batch=1, seq_len=8,
                 device="cpu")
    assert np.isfinite(rwkv["losses"]).all()


def test_straggler_detector_matches_jax():
    times = {0: [1.0, 1.1, 0.9, 1.0, 1.0, 1.2], 1: [1.0] * 6,
             2: [2.0, 2.5, 3.0, 2.2, 2.4, 2.6], 3: [1.1] * 6}
    j, t = JStraggler(list(times)), StragglerDetector(list(times))
    for i in range(6):
        for h, ts in times.items():
            j.record(h, ts[i])
            t.record(h, ts[i])
        assert t.stragglers() == j.stragglers()
    assert t.stragglers() == [2]
