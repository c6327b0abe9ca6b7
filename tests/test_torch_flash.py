"""Port vs JAX: the flash-attention kernel K13's plain version
(`repro_torch.kernels.flash_attention.flash_attention` on CPU tensors)
against `repro.kernels.flash_attention.flash_attention`, whose Pallas
kernel runs in interpret mode here as `tests/test_kernels.py` runs it.

Tolerances: f32 outputs and the lse within 2e-5 absolute and relative,
the bound `tests/test_kernels.py` holds the TPU kernel to against its
oracle (both sides compute in f32, only the summation order differs);
bf16 outputs elementwise within one bf16 step, |d| <= 2^-7 |ref| + 2^-20
max|ref| (each side rounds its f32 result once, and f32 values a few ulps
apart can round to neighbouring bf16 values).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.flash_attention import _fwd_call
from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_plain)

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
