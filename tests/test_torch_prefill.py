"""Port vs JAX: chunked prefill (chunk matmuls through K5, the masked WKV
scan through K2; their plain versions on the CPU) and the slice as a
whole — a prefill chunk, then 32 kernel-path decode steps.

JAX's own chunked prefill does not run under jax >= 0.5 (the WKV Pallas
kernel uses the removed pl.load/pl.store), so the reference is the
engine's per-op masked scan, `tests/test_prefill.py:oracle_prefill`, from
random (non-fresh) recurrent states over full, partial, empty and
single-token prefix masks.  Comparisons use the port_helpers rule.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from port_helpers import assert_close, to_port
from repro.core.quant.serving import pack_params as j_pack
from repro.core.quant.serving import unpack_params as j_unpack_params
from repro.kernels.common import exact_jit
from repro.models.registry import get_model as j_get_model
from repro_torch.kernels.fused_prefill import (
    gather_last_valid, last_valid_select, shifted_prev)
from repro_torch.models.registry import get_model as t_get_model
from repro_torch.models.rwkv4 import STATE_KEYS
from test_prefill import _prefix_valid, _random_state, oracle_prefill

B, C = 4, 6
PREFIX_LENS = (C, 3, 0, 1)


@pytest.fixture(scope="module")
def models():
    jm = j_get_model("rwkv4-169m", smoke=True)
    tm = t_get_model("rwkv4-169m", smoke=True)
    return jm, tm, jm.init_params(jax.random.PRNGKey(0))


def _case(jm, rng):
    state = _random_state(jm, rng)
    tokens = jnp.asarray(rng.integers(0, jm.cfg.vocab, (B, C)), jnp.int32)
    return state, tokens, _prefix_valid(PREFIX_LENS)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "w8"])
def test_prefill_chunk_matches_oracle(models, quantized, rng):
    jm, tm, params = models
    jp = j_pack(params) if quantized else params
    state, tokens, valid = _case(jm, rng)
    s1, l1 = exact_jit(lambda p, s: oracle_prefill(
        jm, p, s, tokens, valid, quantized=quantized))(jp, state)
    s2, l2 = tm.prefill_chunk(to_port(jp), to_port(state), to_port(tokens),
                              to_port(valid))
    assert tuple(l2.shape) == l1.shape == (B, 1, jm.cfg.vocab)
    assert_close(l1, l2, "last-valid logits")
    for k in STATE_KEYS:
        assert_close(s1[k], s2[k], k)
    # the lane with no valid token keeps its state and has zero logits
    empty = PREFIX_LENS.index(0)
    assert not l2[empty].any()
    for k in STATE_KEYS:
        assert torch.equal(s2[k][:, empty], to_port(state)[k][:, empty])


def test_prefill_then_decode_matches_jax(models, rng):
    """The slice as a whole with W8 weights: one prefill chunk through the
    kernel path's plain versions, then 32 kernel-path decode steps, against
    JAX's oracle prefill and per-op decode, teacher forced."""
    jm, tm, params = models
    jp = j_pack(params)
    tp = to_port(jp)
    state, tokens, valid = _case(jm, rng)
    js, jl = exact_jit(lambda p, s: oracle_prefill(
        jm, p, s, tokens, valid, quantized=True))(jp, state)
    ts, tl = tm.prefill_chunk(tp, to_port(state), to_port(tokens),
                              to_port(valid))
    assert_close(jl, tl, "prefill logits")
    jstep = exact_jit(lambda p, s, t: jm.decode_step(
        j_unpack_params(p), s, t, jnp.int32(0)))
    for i in range(32):
        t = rng.integers(0, jm.cfg.vocab, (B, 1)).astype(np.int32)
        jl, js = jstep(jp, js, jnp.asarray(t))
        tl, ts = tm.decode_step_fused(tp, ts, torch.from_numpy(t), 0)
        assert_close(jl, tl, f"logits step {i}")
        for k in STATE_KEYS:
            assert_close(js[k], ts[k], f"{k} step {i}")


def test_shifted_prev_prefix_semantics():
    """Position t sees seq[t-1] inside the prefix, the LAST valid entry
    after it (the oracle's frozen carry), and `first` at t=0 / empty."""
    seq = torch.arange(1, 5, dtype=torch.float32).reshape(1, 4, 1)
    seq = torch.cat([seq, seq * 10], 0)                  # (2, 4, 1)
    first = torch.tensor([[100.0], [200.0]])
    valid = torch.zeros((2, 4), dtype=torch.bool)
    valid[0, :2] = True
    out = shifted_prev(seq, first, valid)[..., 0]
    assert out[0].tolist() == [100.0, 1.0, 2.0, 2.0]
    assert out[1].tolist() == [200.0] * 4


def test_last_valid_helpers():
    seq = torch.arange(12, dtype=torch.float32).reshape(3, 4, 1)
    assert gather_last_valid(seq, torch.tensor([0, 3, 1]))[:, 0].tolist() \
        == [0.0, 7.0, 9.0]
    old = torch.full((3, 1), -1.0, dtype=torch.bfloat16)
    got = last_valid_select(seq, old, torch.tensor([2, 0, 4]))
    assert got.dtype == torch.bfloat16
    assert got[:, 0].tolist() == [1.0, -1.0, 11.0]


# --- the W4 and VQ chunk matmuls (K5-W4, K5-VQ) and a mixed-plane tree ---

from port_helpers import assert_bitwise, mixed_policies
from repro.core.quant import delta_pot as jdp
from repro.core.quant.vq import vq_quantize as j_vq_quantize
from repro.kernels.fused_prefill import vq_chunk_matmul, w4_chunk_matmul
from repro_torch.kernels.fused_prefill import (
    chunk_matmul, dpot_w4_matmul, dpot_w4_matmul_plain, vq_matmul,
    vq_matmul_plain)


@pytest.mark.parametrize("plane", ["w4", "vq"])
def test_w4_vq_matmul_plain_matches_jax(rng, plane):
    """The plain versions of K5-W4 and K5-VQ against the TPU kernels
    `w4_chunk_matmul` / `vq_chunk_matmul` in interpret mode: bit for bit
    (both decode with unpack_leaf, then one bf16 matmul with f32
    accumulation, K whole); the wrappers on CPU tensors are the plain
    versions and launch nothing; chunk_matmul dispatches on the plane."""
    K, N, M = 64, 96, 24
    w = jnp.asarray(rng.standard_t(4.0, size=(K, N)) * 0.1, jnp.float32)
    x = jnp.asarray(rng.normal(size=(M, K)), jnp.bfloat16)
    if plane == "w4":
        q = jdp.dpot_quantize(w, jdp.FORMAT_W4, axis=-1)
        jleaf = {"packed4": jdp.dpot_pack_nibbles(q),
                 "scale": q.scale.astype(jnp.float32)}
        want = w4_chunk_matmul(x, jleaf["packed4"], jleaf["scale"],
                               dt="bfloat16", bm=8, bn=32, interpret=True)
        codes, aux = "packed4", "scale"
        wrapper, plain = dpot_w4_matmul, dpot_w4_matmul_plain
    else:
        idx, cb = j_vq_quantize(w, 256)
        jleaf = {"vq_idx": idx, "codebook": cb}
        want = vq_chunk_matmul(x, idx, cb, dt="bfloat16", bm=8, bn=32,
                               interpret=True)
        codes, aux = "vq_idx", "codebook"
        wrapper, plain = vq_matmul, vq_matmul_plain
    leaf, tx = to_port(jleaf), to_port(x)
    got = plain(tx, leaf[codes], leaf[aux])
    assert got.dtype == torch.bfloat16
    assert_bitwise(want, got, plane)
    before = wrapper.launches
    assert torch.equal(wrapper(tx, leaf[codes], leaf[aux]), got)
    assert wrapper.launches == before
    got3 = chunk_matmul(tx.reshape(3, 8, K), leaf, torch.bfloat16)
    assert torch.equal(got3.reshape(M, N), got)


def test_prefill_chunk_mixed_matches_oracle(models, rng):
    """Chunked prefill over a MIXED tree (W8, W4 nibble pairs and a VQ
    codebook; the head W4) against the JAX per-op masked scan."""
    jm, tm, params = models
    jmixed, tmixed = mixed_policies()
    jp = j_pack(params, jmixed)
    state, tokens, valid = _case(jm, rng)
    s1, l1 = exact_jit(lambda p, s: oracle_prefill(
        jm, p, s, tokens, valid, quantized=True))(jp, state)
    tp = to_port(jp)
    assert tp["blocks"]["att"]["wk"].keys() == {"packed4", "scale"}
    assert tp["blocks"]["ffn"]["wv"].keys() == {"vq_idx", "codebook"}
    s2, l2 = tm.prefill_chunk(tp, to_port(state), to_port(tokens),
                              to_port(valid))
    assert_close(l1, l2, "last-valid logits")
    for k in STATE_KEYS:
        assert_close(s1[k], s2[k], k)
