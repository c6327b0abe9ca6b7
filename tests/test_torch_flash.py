"""Port vs JAX: the flash-attention kernel K13's plain version
(`repro_torch.kernels.flash_attention.flash_attention` on CPU tensors)
against `repro.kernels.flash_attention.flash_attention`, whose Pallas
kernel runs in interpret mode here as `tests/test_kernels.py` runs it;
and its backward: `flash_attention_bwd_plain` against JAX's `_bwd_call`
(interpret mode) and `jax.grad` of `flash_attention`, directly and
through the port's autograd Function.

Tolerances: f32 outputs and the lse within 2e-5 absolute and relative,
the bound `tests/test_kernels.py` holds the TPU kernel to against its
oracle (both sides compute in f32, only the summation order differs);
bf16 outputs elementwise within one bf16 step, |d| <= 2^-7 |ref| + 2^-20
max|ref| (each side rounds its f32 result once, and f32 values a few ulps
apart can round to neighbouring bf16 values).  The backward's f32
gradients: 2e-5 as well (the same f32 arithmetic in another order);
against `jax.grad` in f32 1e-4, `tests/test_kernels.py`'s bound for the
TPU kernels' gradients.  bf16 gradients: dq within one bf16 step as
above; dk and dv within one step plus rep·2^-8 times the sum of the
group's per-head magnitudes: both sides round each query head's f32
gradient to bf16 and sum the H/KVH heads of a group in bf16 (JAX's
`jnp.repeat` transpose, which XLA adds head after head, each add
rounded), so a per-head value a few f32 ulps off can round to its
neighbour and carry through the rep - 1 adds.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import jax

from repro.kernels.flash_attention import _bwd_call, _fwd_call
from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_dkv, flash_attention_dq, flash_attention_plain)

# tests/test_kernels.py's four shapes, then smollm-135m's head layout
# (H 9, KVH 3, d 64) and phi3's d = 96, at a ragged length for the blocks
SHAPES = [
    (2, 64, 4, 4, 32, True, 32, 32),
    (1, 128, 4, 2, 64, True, 64, 32),
    (2, 32, 2, 2, 16, False, 32, 32),
    (1, 256, 8, 1, 64, True, 128, 64),
    (1, 96, 9, 3, 64, True, 32, 32),
    (1, 48, 4, 4, 96, True, 16, 16),
]


def _qkv(B, S, H, KVH, d, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(dtype)
                 for s in ((B, S, H, d), (B, S, KVH, d), (B, S, KVH, d)))


@pytest.mark.parametrize("B,S,H,KVH,d,causal,bq,bkv", SHAPES)
def test_plain_matches_jax_f32(B, S, H, KVH, d, causal, bq, bkv):
    q, k, v = _qkv(B, S, H, KVH, d)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, bq=bq, bkv=bkv))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("H,KVH,d", [(2, 2, 32), (9, 3, 64)])
def test_plain_matches_jax_bf16(H, KVH, d):
    q, k, v = _qkv(1, 64, H, KVH, d, seed=1)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(j_flash(jq, jk, jv, bq=32, bkv=32), np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16) for a in (jq, jk, jv))
    got = flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    d_ = np.abs(got - want)
    assert (d_ <= 2.0 ** -7 * np.abs(want)
            + 2.0 ** -20 * np.abs(want).max()).all(), d_.max()


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_fwd_call(causal):
    """The (B, H, Sq) lse against `_fwd_call`'s (B·H, Sq) rows, the
    forward output the training slice's backward reads."""
    B, S, H, d = 2, 64, 3, 32
    q, k, v = _qkv(B, S, H, H, d, seed=2)
    heads = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3).reshape(
        B * H, S, d)
    o_j, lse_j = _fwd_call(heads(q), heads(k), heads(v), causal=causal,
                           bq=32, bkv=16, interpret=True)
    out, lse = flash_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=causal, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    np.testing.assert_allclose(lse.reshape(B * H, S).numpy(),
                               np.asarray(lse_j), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        out.permute(0, 2, 1, 3).reshape(B * H, S, d).numpy(),
        np.asarray(o_j), rtol=2e-5, atol=2e-5)


def test_ragged_cross_lengths():
    """Sq != Skv: the mask counts both positions from 0 (the TPU kernel's
    rule), so a causal row i sees keys 0..i, and rows past Skv all keys."""
    q, _, _ = _qkv(1, 7, 2, 1, 8, seed=3)
    _, k, v = _qkv(1, 5, 2, 1, 8, seed=4)
    out = flash_attention_plain(*map(torch.from_numpy, (q, k, v)))
    kk = np.repeat(k, 2, axis=2)
    vv = np.repeat(v, 2, axis=2)
    for i in range(7):
        n = min(i + 1, 5)
        s = np.einsum("hd,khd->hk", q[0, i] / np.sqrt(8), kk[0, :n])
        p = np.exp(s - s.max(-1, keepdims=True))
        want = np.einsum("hk,khd->hd", p / p.sum(-1, keepdims=True),
                         vv[0, :n])
        np.testing.assert_allclose(out[0, i].numpy(), want, rtol=1e-5,
                                   atol=1e-6)


def test_wrapper_refusals():
    """Wrong dtype, mixed dtypes, a head count that is not a multiple of
    the kv heads, a head dim past 128 and a device without a kernel all
    raise before anything launches."""
    t = lambda *s, dt=torch.float32, dev="cpu": torch.zeros(
        s, dtype=dt, device=dev)
    before = flash_attention.launches
    with pytest.raises(TypeError):
        flash_attention(t(1, 4, 2, 8, dt=torch.float16),
                        t(1, 4, 2, 8, dt=torch.float16),
                        t(1, 4, 2, 8, dt=torch.float16))
    with pytest.raises(TypeError):
        flash_attention(t(1, 4, 2, 8), t(1, 4, 2, 8, dt=torch.bfloat16),
                        t(1, 4, 2, 8))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(t(1, 4, 3, 8), t(1, 4, 2, 8), t(1, 4, 2, 8))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(t(1, 4, 2, 160), t(1, 4, 2, 160), t(1, 4, 2, 160))
    with pytest.raises(RuntimeError):
        flash_attention(t(1, 4, 2, 8, dev="meta"), t(1, 4, 2, 8, dev="meta"),
                        t(1, 4, 2, 8, dev="meta"))
    assert flash_attention.launches == before


# --- the backward ---------------------------------------------------------


def _heads(a):
    """(B, S, h, d) -> JAX's (B·h, S, d) kernel layout."""
    B, S, h, d = a.shape
    return jnp.asarray(a).transpose(0, 2, 1, 3).reshape(B * h, S, d)


def _unheads(a, B, h):
    """(B·h, S, d) -> (B, S, h, d), as numpy."""
    a = np.asarray(a, np.float32)
    return a.reshape(B, h, a.shape[1], a.shape[2]).transpose(0, 2, 1, 3)


def _jax_bwd(q, k, v, do, causal, bq, bkv):
    """JAX's forward and backward kernels (interpret mode) on the
    repeated heads, as `flash_attention`'s custom VJP runs them: (o, lse,
    dq, per-head dk, per-head dv) in the port's layouts."""
    B, S, H, d = q.shape
    rep = H // k.shape[2]
    kr, vr = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)
    o, lse = _fwd_call(_heads(q), _heads(kr), _heads(vr), causal=causal,
                       bq=bq, bkv=bkv, interpret=True)
    dq, dk, dv = _bwd_call(_heads(q), _heads(kr), _heads(vr), o, lse,
                           _heads(do), causal=causal, bq=bq, bkv=bkv,
                           interpret=True)
    return (_unheads(o, B, H), np.asarray(lse).reshape(B, H, S),
            _unheads(dq, B, H), _unheads(dk, B, H), _unheads(dv, B, H))


def _group(a, KVH):
    B, S, H, d = a.shape
    return a.reshape(B, S, KVH, H // KVH, d).sum(axis=3)


@pytest.mark.parametrize("B,S,H,KVH,d,causal,bq,bkv", SHAPES)
def test_bwd_plain_matches_bwd_call(B, S, H, KVH, d, causal, bq, bkv):
    """f32: the plain backward against `_bwd_call`'s dq and its per-head
    dk, dv summed over each GQA group, from the same o and lse."""
    q, k, v = _qkv(B, S, H, KVH, d, seed=5)
    do = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)
    o, lse, dq, dk, dv = _jax_bwd(q, k, v, do, causal, bq, bkv)
    t = lambda a: torch.from_numpy(np.array(a))
    got = flash_attention_bwd_plain(t(q), t(k), t(v), t(o), t(lse), t(do),
                                    causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got,
                          (dq, _group(dk, KVH), _group(dv, KVH))):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=2e-5,
                                   err_msg=name)
    # the wrappers of the two kernels take the plain version on the CPU
    assert torch.equal(flash_attention_dq(t(q), t(k), t(v), t(o), t(lse),
                                          t(do), causal=causal), got[0])
    dkv = flash_attention_dkv(t(q), t(k), t(v), t(o), t(lse), t(do),
                              causal=causal)
    assert torch.equal(dkv[0], got[1]) and torch.equal(dkv[1], got[2])
    assert all(torch.equal(a, b) for a, b in zip(flash_attention_bwd(
        t(q), t(k), t(v), t(o), t(lse), t(do), causal=causal), got))


def _bf16_ok(got, want, heads=None, rep=1):
    """One bf16 step, plus rep·2^-8 · Σ_h |per-head| for a group sum."""
    d = np.abs(got - want)
    bound = 2.0 ** -7 * np.abs(want) + 2.0 ** -20 * np.abs(want).max()
    if heads is not None:
        bound = bound + rep * 2.0 ** -8 * heads
    assert (d <= bound).all(), float(d.max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("via", ["plain", "autograd"])
def test_bwd_matches_jax_grad(dtype, via):
    """GQA (H 9, KVH 3): the gradients of sum(out · dout) from `jax.grad`
    of JAX's `flash_attention` (its custom VJP, interpret mode) against
    the plain backward called directly and through the port's autograd
    Function; in bf16 also the per-head roundings' allowance from
    `_bwd_call`'s per-head gradients."""
    B, S, H, KVH, d = 1, 96, 9, 3, 64
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    q, k, v = _qkv(B, S, H, KVH, d, seed=7)
    do = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))

    def loss(q, k, v):
        out = j_flash(q, k, v, bq=32, bkv=32)
        return jnp.sum(out.astype(jnp.float32) * jdo.astype(jnp.float32))
    want = [np.asarray(g, np.float32)
            for g in jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)]
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(tdt)
    tq, tk, tv, tdo = t(jq), t(jk), t(jv), t(jdo)
    if via == "plain":
        o, lse = flash_attention(tq, tk, tv, return_lse=True)
        got = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo)
    else:
        leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
        got = torch.autograd.grad(flash_attention(*leaves), leaves, tdo)
    got = [g.float().numpy() for g in got]
    if dtype == "float32":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        return
    *_, dk_h, dv_h = _jax_bwd(np.asarray(jq, np.float32),
                              np.asarray(jk, np.float32),
                              np.asarray(jv, np.float32),
                              np.asarray(jdo, np.float32), True, 32, 32)
    _bf16_ok(got[0], want[0])
    _bf16_ok(got[1], want[1], _group(np.abs(dk_h), KVH), H // KVH)
    _bf16_ok(got[2], want[2], _group(np.abs(dv_h), KVH), H // KVH)


def test_autograd_saves_residuals_only_with_grad():
    """With grad the output carries a backward node holding q, k, v, out
    and lse in their own dtypes (JAX's residuals); under no_grad and
    inference_mode it is the plain forward with no node."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 64, 4, 2, 16, seed=9))
    qg = q.clone().requires_grad_()
    out = flash_attention(qg, k, v)
    saved = out.grad_fn.saved_tensors
    assert [t.dtype for t in saved] == [torch.bfloat16] * 4 + [torch.float32]
    assert saved[4].shape == (1, 4, 64)
    with torch.no_grad():
        assert flash_attention(qg, k, v).grad_fn is None
    with torch.inference_mode():
        assert flash_attention(qg, k, v).grad_fn is None
    assert torch.equal(flash_attention(q, k, v), out.detach())


def test_bwd_wrapper_refusals():
    """A wrong lse or dout shape or dtype raises before anything runs."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 2, 2, 8))
    o, lse = flash_attention(q, k, v, return_lse=True)
    before = (flash_attention_dq.launches, flash_attention_dkv.launches)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, o, lse.transpose(1, 2), o)
    with pytest.raises(ValueError, match="dout"):
        flash_attention_bwd(q, k, v, o, lse, o.to(torch.bfloat16))
    with pytest.raises(ValueError, match="lse"):
        flash_attention_dq(q, k, v, o, lse.double(), o)
    assert (flash_attention_dq.launches,
            flash_attention_dkv.launches) == before
