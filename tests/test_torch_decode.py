"""Port vs JAX: RWKV-4 decode — the per-op `decode_step` and the kernel
path `decode_step_fused` (K3 per layer, the head through K5; their plain
versions on the CPU) — on the smoke model, fp and Δ-PoT W8.

Teacher forced: both sides consume the same 32 random tokens from the fresh
state, each carrying its own state; every step's logits and every state
leaf hold to the port_helpers rule.  The JAX side compiles with
`exact_jit`, whose rounding is the trace's, as eager torch's is.
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
from repro_torch.core.quant.serving import broadcast_packed_scales
from repro_torch.core.quant.serving import pack_params as t_pack
from repro_torch.core.quant.serving import unpack_params as t_unpack_params
from repro_torch.kernels.fused_decode import (
    rwkv4_block_decode, rwkv4_block_decode_plain)
from repro_torch.models.registry import get_model as t_get_model
from repro_torch.models.rwkv4 import STATE_KEYS, _layer

B, STEPS = 4, 32


@pytest.fixture(scope="module")
def models():
    jm = j_get_model("rwkv4-169m", smoke=True)
    tm = t_get_model("rwkv4-169m", smoke=True)
    params = jm.init_params(jax.random.PRNGKey(0))
    return jm, tm, params


def _trajectory(jm, tm, jp, tp, jstep, tstep, rng):
    js = jm.init_decode_state(B, 0, jnp.bfloat16)
    ts = tm.init_decode_state(B, 0, device="cpu")
    toks = rng.integers(0, jm.cfg.vocab, (STEPS, B, 1)).astype(np.int32)
    for i in range(STEPS):
        jl, js = jstep(jp, js, jnp.asarray(toks[i]))
        tl, ts = tstep(tp, ts, torch.from_numpy(toks[i]))
        assert tuple(tl.shape) == jl.shape == (B, 1, jm.cfg.vocab)
        assert_close(jl, tl, f"logits step {i}")
        for k in STATE_KEYS:
            assert ts[k].dtype == torch.bfloat16
            assert_close(js[k], ts[k], f"{k} step {i}")


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "w8"])
def test_decode_step_matches_jax(models, quantized, rng):
    jm, tm, params = models
    jp = j_pack(params) if quantized else params
    tp = to_port(jp)
    j_un = j_unpack_params if quantized else (lambda p: p)
    t_un = t_unpack_params if quantized else (lambda p: p)
    jstep = exact_jit(lambda p, s, t: jm.decode_step(j_un(p), s, t,
                                                      jnp.int32(0)))
    tstep = lambda p, s, t: tm.decode_step(t_un(p), s, t, 0)
    _trajectory(jm, tm, jp, tp, jstep, tstep, rng)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "w8"])
def test_decode_step_fused_matches_jax(models, quantized, rng):
    """The kernel path (plain versions on the CPU) against JAX's fused
    block decode, the Pallas kernel in interpret mode."""
    jm, tm, params = models
    jp = j_pack(params) if quantized else params
    tp = to_port(jp)
    jstep = exact_jit(lambda p, s, t: jm.decode_step_fused(p, s, t,
                                                            jnp.int32(0)))
    tstep = lambda p, s, t: tm.decode_step_fused(p, s, t, 0)
    _trajectory(jm, tm, jp, tp, jstep, tstep, rng)


def test_fused_equals_per_op_on_cpu(models, rng):
    """On the CPU the kernel path runs the plain versions, which share the
    per-op block body and decode: the two paths agree bit for bit."""
    _, tm, params = models
    tp = to_port(j_pack(params))
    s1 = s2 = tm.init_decode_state(B, 0, device="cpu")
    for _ in range(4):
        toks = torch.from_numpy(
            rng.integers(0, tm.cfg.vocab, (B, 1)).astype(np.int32))
        l1, s1 = tm.decode_step(t_unpack_params(tp), s1, toks, 0)
        l2, s2 = tm.decode_step_fused(tp, s2, toks, 0)
        assert torch.equal(l1, l2)
        for k in STATE_KEYS:
            assert torch.equal(s1[k], s2[k])


def test_block_decode_cpu_is_plain(models, rng):
    """On CPU tensors the K3 wrapper runs its plain version and launches
    nothing."""
    _, tm, params = models
    tp = tm.cast_params(t_pack(to_port(params)))
    lp = _layer(broadcast_packed_scales(tp["blocks"], tm.cfg.n_layers), 0)
    D = tm.cfg.d_model
    st = {k: torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)
                              ).to(torch.bfloat16) for k in STATE_KEYS}
    st["wkv_b"] = st["wkv_b"].abs() + 0.5
    x = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)).to(
        torch.bfloat16)
    before = rwkv4_block_decode.launches
    x2, new = rwkv4_block_decode(lp, st, x)
    x2p, newp = rwkv4_block_decode_plain(lp, st, x)
    assert rwkv4_block_decode.launches == before
    assert torch.equal(x2, x2p)
    assert all(torch.equal(new[k], newp[k]) for k in STATE_KEYS)
