"""Port vs JAX: the cross-entropy K12 and its backward K12-bwd (their plain
versions on the CPU) against the JAX package's `fused_cross_entropy` in
interpret mode (its Pallas forward and backward kernels run in Python) and
its oracle `fused_cross_entropy_ref` under `jax.grad`, and `loss_fn` with a
mask on top of them.

Tolerances:
  * the NLL: |d| <= 2^-20 (1 + |ref|).  Both sides compute the row's
    log-sum-exp in f32 from the same values (bf16 logits widen exactly),
    the plain version as a log-softmax, the TPU kernel as an online max
    and sum-exp over vocabulary blocks: their sums differ in order and
    their lse by a few f32 steps.
  * the gradient dx = (softmax − onehot)·g: in f32 |d| <= 2^-20 |ref| +
    2^-22 |g| of the row; in bf16 one bf16 step, 2^-7 |ref| (both round
    the f32 cotangent once; an lse a few f32 steps apart may tip a
    rounding), plus the same floor.
  * `loss_fn` on the CPU is the arithmetic it was before K12: bit for bit
    against the log-softmax formula written out.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from port_helpers import f32, to_port
from repro.kernels.fused_ce import _ce_bwd, _fwd_call
from repro.kernels.fused_ce import fused_cross_entropy as j_ce
from repro.kernels.ref import fused_cross_entropy_ref as j_ce_ref
from repro.models.registry import Model as JModel
from repro.models.registry import get_model as j_get_model
from repro.models.registry import loss_fn as j_loss_fn
from repro_torch.kernels import fused_ce as K12
from repro_torch.kernels.fused_ce import (
    fused_cross_entropy, fused_cross_entropy_bwd, fused_cross_entropy_bwd_plain,
    fused_cross_entropy_plain)
from repro_torch.models import registry as REG
from repro_torch.models.registry import get_model, loss_fn

# (N, V, bn, bv, dtype): a vocabulary in 128-blocks; a ragged one (333 =
# 9·37: JAX's bv shrinks to 111); a bf16 one of 700 (bv 350); one row
CASES = [(64, 1024, 32, 128, "float32"), (24, 333, 8, 128, "float32"),
         (16, 700, 16, 512, "bfloat16"), (1, 50, 1, 128, "bfloat16")]


def _inputs(N, V, dtype, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(N, V)) * 3).astype(np.float32)
    lbl = rng.integers(0, V, N).astype(np.int32)
    # labels at both ends and at the edges of a 128-block
    edges = np.array([0, V - 1, min(127, V - 1), min(128, V - 1)], np.int32)
    lbl[:min(4, N)] = edges[:min(4, N)]
    g = rng.uniform(0.1, 1.0, N).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return jx, jnp.asarray(lbl), jnp.asarray(g), tx, torch.from_numpy(lbl), \
        torch.from_numpy(g)


@pytest.mark.parametrize("N,V,bn,bv,dtype", CASES)
def test_nll_matches_jax_kernel_and_ref(N, V, bn, bv, dtype):
    jx, jl, _, tx, tl, _ = _inputs(N, V, dtype, N + V)
    got = f32(fused_cross_entropy(tx, tl))
    for want in (f32(j_ce(jx, jl, bn=bn, bv=bv)), f32(j_ce_ref(jx, jl))):
        assert (np.abs(got - want) <= 2.0 ** -20 * (1 + np.abs(want))).all()


def _grad_ok(got, ref, g, dtype):
    step = 2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -20
    d = np.abs(got - ref)
    return bool((d <= step * np.abs(ref) + 2.0 ** -22 * g[:, None]).all()), \
        float(d.max())


@pytest.mark.parametrize("N,V,bn,bv,dtype", CASES)
def test_grad_matches_jax_kernel_and_ref(N, V, bn, bv, dtype):
    """The plain version's autograd gradient of Σ g·NLL against jax.grad
    through the Pallas kernels (the custom VJP's `_bwd_kernel`) and
    through the oracle; both in the logits' dtype."""
    jx, jl, jg, tx, tl, tg = _inputs(N, V, dtype, 2 * N + V)
    xa = tx.clone().requires_grad_()
    (fused_cross_entropy(xa, tl) * tg).sum().backward()
    assert xa.grad.dtype == tx.dtype
    got, g = f32(xa.grad), np.asarray(jg)
    for fn in (lambda a: j_ce(a, jl, bn=bn, bv=bv), lambda a: j_ce_ref(a,
                                                                       jl)):
        want = f32(jax.grad(lambda a: jnp.sum(fn(a) * jg))(jx))
        ok, err = _grad_ok(got, want, g, dtype)
        assert ok, err


@pytest.mark.parametrize("N,V,bn,bv,dtype", CASES)
def test_bwd_formula_matches_jax_bwd_kernel(N, V, bn, bv, dtype):
    """K12-bwd's plain version (its formula) against JAX's `_ce_bwd` (the
    `_bwd_kernel` launch) on the same lse, from JAX's `_fwd_call`."""
    jx, jl, jg, tx, tl, tg = _inputs(N, V, dtype, 3 * N + V)
    _, lse = _fwd_call(jx, jl, bn, bv, True)
    want, _ = _ce_bwd(bn, bv, True, (jx, jl, lse), jg)
    tlse = torch.from_numpy(np.asarray(lse))
    got = fused_cross_entropy_bwd(tx, tl, tlse, tg)
    assert got.dtype == tx.dtype
    ok, err = _grad_ok(f32(got), f32(want), np.asarray(jg), dtype)
    assert ok, err
    assert torch.equal(got, fused_cross_entropy_bwd_plain(tx, tl, tlse, tg))


def test_batched_leading_axes():
    """(B, S, V) logits with (B, S) labels give the (B·S, V) rows' NLL."""
    _, _, _, tx, tl, _ = _inputs(12, 100, "float32", 7)
    flat = fused_cross_entropy(tx, tl)
    assert torch.equal(fused_cross_entropy(tx.reshape(3, 4, 100),
                                           tl.reshape(3, 4)).reshape(-1),
                       flat)
    assert flat.dtype == torch.float32


def _j(arch, **over):
    m = j_get_model(arch, smoke=True)
    return JModel(cfg=dataclasses.replace(m.cfg, **over), module=m.module)


def _t(arch, **over):
    m = get_model(arch, smoke=True)
    return type(m)(cfg=dataclasses.replace(m.cfg, **over), module=m.module)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_loss_fn(monkeypatch, dtype):
    """rwkv4 smoke's loss_fn on a batch with a quarter of its tokens masked
    out: one call of fused_cross_entropy; the loss equals the pre-K12
    formula (-Σ log_softmax[label]·mask / Σ mask) bit for bit and JAX's
    loss_fn within 1e-6 (f32) or 1e-3 (bf16) relative."""
    jm, tm = _j("rwkv4-169m", dtype=dtype), _t("rwkv4-169m", dtype=dtype)
    jp = jm.init_params(jax.random.PRNGKey(2))
    tp = to_port(jp)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 256, (2, 33)).astype(np.int32)
    mask = np.ones((2, 32), np.float32)
    mask[:, 24:] = 0
    hb = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}
    calls = []
    monkeypatch.setattr(REG, "fused_cross_entropy",
                        lambda *a: calls.append(1) or K12.fused_cross_entropy(
                            *a))
    tl, tmet = loss_fn(tm, tp, {k: torch.from_numpy(v) for k, v in hb.items()})
    assert len(calls) == 1
    logits, _ = tm.forward(tp, {"tokens": torch.from_numpy(hb["tokens"])})
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, torch.from_numpy(hb["labels"])[..., None]
                      .long())[..., 0]
    m = torch.from_numpy(mask)
    assert torch.equal(tmet["loss"], -torch.sum(ll * m) / torch.clamp(
        torch.sum(m), min=1.0))
    jl, _ = j_loss_fn(jm, jp, {k: jnp.asarray(v) for k, v in hb.items()})
    rtol = 1e-6 if dtype == "float32" else 1e-3
    np.testing.assert_allclose(float(tl), float(jl), rtol=rtol)


def test_wrappers_off_cpu_go_to_the_kernels():
    """Tensors off the CPU (meta tensors stand in for the card) go to K12
    and K12-bwd, whose build raises here; no counter moves and nothing
    falls back to the plain versions."""
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,
                                                    device="meta")
    before = (fused_cross_entropy.launches, fused_cross_entropy_bwd.launches)
    x = meta(4, 100, dt=torch.bfloat16)
    lbl = meta(4, dt=torch.int32)
    with pytest.raises(RuntimeError):
        fused_cross_entropy(x, lbl)
    with pytest.raises(RuntimeError):
        fused_cross_entropy(x.requires_grad_(), lbl)
    with pytest.raises(RuntimeError):
        fused_cross_entropy_bwd(x, lbl, meta(4), meta(4))
    with pytest.raises(TypeError):
        fused_cross_entropy(meta(4, 100, dt=torch.float16), lbl)
    assert (fused_cross_entropy.launches,
            fused_cross_entropy_bwd.launches) == before
