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

The bf16 kernels' numerics, which run only on the card, are held here
through plain twins: `split_bf16x2`, the two-piece bf16 split of p and ds,
meets |x - hi - lo| <= 2^-17·|x| while x - hi is a normal f32 and 2^-134
below that (hypothesis, with subnormals and ±FLT_MAX, and 2^20 random bit
patterns; 2^-17 is reached); and a plain model of K13-dq and K13-dkv
(exact bf16 products for t and dp, p = exp2(fma(t, c, -lse·log2(e))), p
and ds in two pieces in the three products, the GQA group summed in f32
and rounded once) stays within `bwd_bounds` of JAX's `_bwd_call`
(interpret mode, its per-head gradients rounded and summed in bf16 as the
custom VJP does) on random inputs and on inputs where a few keys dominate
each row.
"""
import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import jax

try:
    from hypothesis import example, given, settings, strategies as st
except ImportError:  # pragma: no cover
    from conftest import hypothesis_stubs
    given, settings, st = hypothesis_stubs()

    def example(*a, **k):
        return lambda fn: fn

from repro.kernels.flash_attention import _bwd_call, _fwd_call
from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch.device import exact_matmuls
from repro_torch.kernels.flash_attention import (
    _delta, _group_sum, bwd_bounds, flash_attention, flash_attention_bwd,
    flash_attention_bwd_plain, flash_attention_dkv, flash_attention_dq,
    flash_attention_plain, split_bf16x2)

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


# --- the bf16 backward kernels' numerics, through plain twins -------------

FLT_MAX = float(np.finfo(np.float32).max)
HI_MAX = (2.0 - 2.0 ** -8) * 2.0 ** 127      # hi finite below this


def _split2_ok(x: np.ndarray):
    """split_bf16x2's contract on an f32 array of finite values: two bf16
    values, |x - hi - lo| <= 2^-17·|x| while x - hi is a normal f32, and
    <= 2^-134 below that."""
    t = torch.from_numpy(x.astype(np.float32))
    t = t[t.double().abs() < HI_MAX]
    hi, lo = split_bf16x2(t)
    for piece in (hi, lo):
        assert bool(((piece.view(torch.int32) & 0xFFFF) == 0).all())
        assert bool(torch.isfinite(piece).all())
    r = t - hi                                       # exact in f32
    assert torch.equal(r.double(), t.double() - hi.double())
    res = (t.double() - hi.double() - lo.double()).abs()
    normal = r.double().abs() >= 2.0 ** -126
    assert bool((res[normal] <= 2.0 ** -17 * t.double().abs()[normal])
                .all())
    assert bool((res[~normal] <= 2.0 ** -134).all())


@settings(max_examples=500, deadline=None)
@given(st.floats(width=32, allow_nan=False, allow_infinity=False,
                 allow_subnormal=True))
@example(FLT_MAX)
@example(-FLT_MAX)
@example(2.0 ** -149)
@example(-(2.0 ** -126) * (1 + 2.0 ** -23))
@example(1.0 + 2.0 ** -8 + 2.0 ** -23)
@example(-0.0)
def test_bf16x2_split_contract(x):
    _split2_ok(np.array([x], dtype=np.float32))


def test_bf16x2_split_over_random_bits():
    """2^20 random bit patterns (every exponent, both signs, subnormals);
    the bound is reached: x = 0x5a004040 leaves 2^-17.003·|x|, beyond
    2^-18."""
    bits = np.random.default_rng(1).integers(0, 2 ** 32, 2 ** 20,
                                             dtype=np.uint64)
    x = bits.astype(np.uint32).view(np.float32)
    _split2_ok(x[np.isfinite(x)])
    t = torch.tensor([0x5A004040], dtype=torch.int32).view(torch.float32)
    hi, lo = split_bf16x2(t)
    res = float((t.double() - hi.double() - lo.double()).abs() / t.double())
    assert 2.0 ** -18 < res <= 2.0 ** -17


def _dominated(B, S, H, KVH, d, seed):
    """(q, k, v, dout), f32 numpy, where a few keys take most of each row's
    weight: every query leans on one direction u (|u| = 1) and keys 0,
    S / 3 and 2·S / 3 lie along it, so their scores sit ~8 above the
    others' N(0, 5); key 0 is in every causal row (as
    tests/test_torch_cuda.py draws them for the kernels)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, d))
    k = rng.normal(size=(B, S, KVH, d))
    v = rng.normal(size=(B, S, KVH, d))
    do = rng.normal(size=(B, S, H, d))
    u = rng.normal(size=d)
    u /= np.linalg.norm(u)
    q += 2.0 * np.sqrt(d) * u
    for j in (0, S // 3, 2 * S // 3):
        k[:, j] = 0.25 * k[:, j] + 4.0 * u
    return tuple(a.astype(np.float32) for a in (q, k, v, do))


@exact_matmuls()
def _tc_bwd_model(q, k, v, o, lse, do, causal):
    """The bf16 kernels' arithmetic (csrc/flash_attention_bwd.cu's
    numerics contract) in plain torch, their sums in another order: t =
    q·kᵀ and dp = dout·vᵀ on the raw bf16 values, p = exp2(fma(t, c,
    -lse·log2(e))) with c = f32(scale·log2(e)) (the fma in f64, one f32
    rounding), ds = p·(dp - D), p and ds as split_bf16x2's two pieces in
    dq = scale·ds·k, dk = scale·dsᵀ·q and dv = pᵀ·dout, dk and dv summed
    over each GQA group in f32, each output rounded once to bf16."""
    B, Sq, H, d = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    rep = H // KVH
    scale = np.float32(1.0 / math.sqrt(d))
    log2e = np.float32(math.log2(math.e))
    c = float(scale * log2e)
    q32, do32 = q.float(), do.float()
    k32 = k.float().repeat_interleave(rep, dim=2)
    v32 = v.float().repeat_interleave(rep, dim=2)
    e = torch.einsum
    t = e("bqhd,bkhd->bhqk", q32, k32)
    nl = -(lse * float(log2e))
    p = torch.exp2((t.double() * c + nl.double()[..., None]).float())
    if causal:
        keep = torch.arange(Skv)[None, :] <= torch.arange(Sq)[:, None]
        p = torch.where(keep, p, 0.0)
    ds = p * (e("bqhd,bkhd->bhqk", do32, v32) - _delta(o, do)[..., None])
    group = lambda x: x.reshape(B, Skv, KVH, rep, d).sum(dim=3)
    (ph, pl), (sh, sl) = split_bf16x2(p), split_bf16x2(ds)
    dq = e("bhqk,bkhd->bqhd", sh, k32) + e("bhqk,bkhd->bqhd", sl, k32)
    dk = e("bhqk,bqhd->bkhd", sh, q32) + e("bhqk,bqhd->bkhd", sl, q32)
    dv = e("bhqk,bqhd->bkhd", ph, do32) + e("bhqk,bqhd->bkhd", pl, do32)
    bf = torch.bfloat16
    return ((float(scale) * dq).to(bf), (float(scale) * group(dk)).to(bf),
            group(dv).to(bf))


@pytest.mark.parametrize("inputs", ["random", "dominated"])
@pytest.mark.parametrize("B,S,H,KVH,d,causal,bq,bkv", [
    (1, 128, 6, 2, 64, True, 64, 32),
    (1, 96, 9, 3, 64, True, 32, 32),
    (2, 64, 4, 4, 32, False, 32, 32),
])
def test_tc_bwd_model_matches_bwd_call(B, S, H, KVH, d, causal, bq, bkv,
                                       inputs):
    """The model of the bf16 kernels against JAX's `_bwd_call` on bf16
    inputs (interpret mode; dq rounded once, each head's dk and dv rounded
    and the group added in bf16, as `_flash_core_bwd` and `jnp.repeat`'s
    transpose do), from JAX's own o and lse, within `bwd_bounds`."""
    if inputs == "random":
        q, k, v = _qkv(B, S, H, KVH, d, seed=10)
        do = np.random.default_rng(11).normal(size=q.shape).astype(
            np.float32)
    else:
        q, k, v, do = _dominated(B, S, H, KVH, d, seed=12)
    jq, jk, jv, jdo = (np.asarray(jnp.asarray(a, jnp.bfloat16))
                       for a in (q, k, v, do))
    o, lse, dq, dk_h, dv_h = _jax_bwd(jq, jk, jv, jdo, causal, bq, bkv)
    bf = torch.bfloat16
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(bf)
    tq, tk, tv, tdo, to = t(jq), t(jk), t(jv), t(jdo), t(o)
    tlse = torch.from_numpy(np.array(lse))
    rep = H // KVH
    want = (t(dq), _group_sum(t(dk_h), rep), _group_sum(t(dv_h), rep))
    got = _tc_bwd_model(tq, tk, tv, to, tlse, tdo, causal)
    for name, g, w, bnd in zip(("dq", "dk", "dv"), got, want, bwd_bounds(
            tq, tk, tv, to, tlse, tdo, causal, want)):
        dd = (g.float() - w.float()).abs()
        assert bool((dd <= bnd).all()), (name, float(dd.max()))
