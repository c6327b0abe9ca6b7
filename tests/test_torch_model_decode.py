"""Port vs JAX: the whole-model decode path "model" — kernel K4 over the
slab form of the weights, the head through K5 (their plain versions on
the CPU) — on the smoke model, with W8 and MIXED (W8 / W4 / VQ) trees.

Teacher forced: both sides consume the same 16 random tokens from the
fresh state, each carrying its own state; every step's logits and every
state leaf hold to the port_helpers rule.  The references are JAX's
`decode_step_fused_model` (the Pallas megakernel in interpret mode, on
its own prepared slabs) and JAX's per-op `decode_step` on the unpacked
tree, both compiled with `exact_jit`.  Inside the port, on the CPU, the
model path runs the same plain body as the per-op and block paths, so
there the three agree bit for bit.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from port_helpers import assert_close, mixed_policies, to_port
from repro.core.quant.serving import pack_params as j_pack
from repro.core.quant.serving import unpack_params as j_unpack_params
from repro.kernels.common import exact_jit
from repro.models.registry import get_model as j_get_model
from repro_torch.core.quant.serving import (
    FusedLayerStack, fuse_layer_stack, pack_params as t_pack,
    unpack_params as t_unpack_params)
from repro_torch.kernels.fused_decode import (
    MAX_BB, SMEM_BYTES, rwkv4_model_decode, rwkv4_model_decode_plain,
    stack_table, tile_plan)
from repro_torch.models.registry import get_model as t_get_model
from repro_torch.models.rwkv4 import STATE_KEYS, prepare_fused_model_params

B, STEPS = 4, 16


@pytest.fixture(scope="module")
def models():
    jm = j_get_model("rwkv4-169m", smoke=True)
    tm = t_get_model("rwkv4-169m", smoke=True)
    return jm, tm, jm.init_params(jax.random.PRNGKey(0))


def _packed(params, which):
    jmixed, tmixed = mixed_policies()
    jp = j_pack(params, None if which == "w8" else jmixed)
    return jp, t_pack(to_port(params), None if which == "w8" else tmixed)


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


@pytest.mark.parametrize("which", ["w8", "mixed"])
def test_model_decode_matches_jax_megakernel(models, which, rng):
    """The port's prepared model path against JAX's megakernel on JAX's
    own prepared slabs (`prepare_fused_model_params`)."""
    jm, tm, params = models
    jp, tp = _packed(params, which)
    jprep = jm.prepare_fused_model_params(jp)
    tprep = tm.prepare_path_params(tm.decode_paths()["model"], tp)
    assert isinstance(tprep["blocks"], FusedLayerStack)
    jstep = exact_jit(lambda p, s, t: jm.decode_step_fused_model(
        p, s, t, jnp.int32(0)))
    tstep = lambda p, s, t: tm.decode_step_fused_model(p, s, t, 0)
    _trajectory(jm, tm, jprep, tprep, jstep, tstep, rng)


@pytest.mark.parametrize("which", ["w8", "mixed"])
def test_model_decode_matches_jax_per_op(models, which, rng):
    """The port's prepared model path against JAX's per-op decode on the
    unpacked tree."""
    jm, tm, params = models
    jp, tp = _packed(params, which)
    tprep = prepare_fused_model_params(tp, tm.cfg)
    jstep = exact_jit(lambda p, s, t: jm.decode_step(
        j_unpack_params(p), s, t, jnp.int32(0)))
    tstep = lambda p, s, t: tm.decode_step_fused_model(p, s, t, 0)
    _trajectory(jm, tm, jp, tprep, jstep, tstep, rng)


def test_model_equals_block_and_per_op_on_cpu(models, rng):
    """On the CPU the model path (prepared or raw), the block path and the
    per-op path run the same plain body: bit for bit, on a MIXED tree."""
    _, tm, params = models
    _, tp = _packed(params, "mixed")
    prep = prepare_fused_model_params(tp, tm.cfg)
    s = [tm.init_decode_state(B, 0, device="cpu") for _ in range(4)]
    for _ in range(4):
        toks = torch.from_numpy(
            rng.integers(0, tm.cfg.vocab, (B, 1)).astype(np.int32))
        outs = [tm.decode_step(t_unpack_params(tp), s[0], toks, 0),
                tm.decode_step_fused(tp, s[1], toks, 0),
                tm.decode_step_fused_model(prep, s[2], toks, 0),
                tm.decode_step_fused_model(tp, s[3], toks, 0)]
        for lg, st in outs[1:]:
            assert torch.equal(lg, outs[0][0])
            assert all(torch.equal(st[k], outs[0][1][k]) for k in STATE_KEYS)
        s = [o[1] for o in outs]


def test_model_decode_cpu_is_plain(models, rng):
    """On CPU tensors the K4 wrapper runs its plain version and launches
    nothing."""
    _, tm, params = models
    _, tp = _packed(params, "mixed")
    stack = prepare_fused_model_params(tp, tm.cfg)["blocks"]
    L, D = tm.cfg.n_layers, tm.cfg.d_model
    st = {k: torch.from_numpy(rng.normal(size=(L, B, D)).astype(np.float32)
                              ).to(torch.bfloat16) for k in STATE_KEYS}
    st["wkv_b"] = st["wkv_b"].abs() + 0.5
    x = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)).to(
        torch.bfloat16)
    before = rwkv4_model_decode.launches
    x2, new = rwkv4_model_decode(stack, st, x)
    x2p, newp = rwkv4_model_decode_plain(stack, st, x)
    assert rwkv4_model_decode.launches == before
    assert torch.equal(x2, x2p)
    assert all(torch.equal(new[k], newp[k]) for k in STATE_KEYS)
    assert all(tuple(new[k].shape) == (L, B, D) for k in STATE_KEYS)


def test_stack_table_matches_manifest(models):
    """The K4 wrapper's table: each vector's offset in the bf16 slab row
    and each matrix's offset in the uint8 slab row and plane, read off the
    manifest and checked against the expected shapes; a leaf the kernel
    does not take raises."""
    _, tm, params = models
    _, tp = _packed(params, "mixed")
    stack = prepare_fused_model_params(tp, tm.cfg)["blocks"]
    D, F = tm.cfg.d_model, tm.cfg.d_ff
    got_F, vec_offs, mats = stack_table(stack, D)
    assert got_F == F
    # bf16 row, flatten order: att.time_decay, time_first, time_mix_k/r/v,
    # ffn.time_mix_k/r, ln1.bias/scale, ln2.bias/scale (enum Vec order)
    assert vec_offs == [i * D for i in (8, 7, 10, 9, 3, 2, 4, 0, 1, 6, 5)]
    # att.wk W4, ffn.wv VQ, the rest W8 (enum Mat order)
    assert [m.plane for m in mats] == [0, 1, 0, 0, 0, 0, 2]
    # uint8 row: att wk (D/2·D), wo, wr, wv, then ffn wk (D·F), wr, wv
    assert [m.offset for m in mats] == [
        D * D // 2 + D * D, 0, D * D // 2 + 2 * D * D, D * D // 2,
        D * D // 2 + 3 * D * D + D * F, D * D // 2 + 3 * D * D,
        D * D // 2 + 4 * D * D + D * F]
    # shared scales of N entries (ffn.wk: F), the VQ codebook of 256
    assert tuple(m.aux.numel() for m in mats) == (D,) * 5 + (F, 256)
    with_lut = fuse_layer_stack(
        {**tp["blocks"], "_luts": {"exp": torch.zeros(1, 256)}},
        tm.cfg.n_layers)
    with pytest.raises(ValueError, match="_luts"):
        stack_table(with_lut, D)


def test_stack_table_raises_on_per_layer_scales(models):
    """With L = 1 the slab layout keeps the (1, ...) scales and codebook
    in the f32 and bf16 slabs (their leading axis equals L, as in the JAX
    package).  K4 indexes scales and codebooks without the layer, so its
    table raises on such a stack; the plain version still runs it."""
    import dataclasses
    from repro_torch.core.quant.serving import cast_compute
    _, tm, _ = models
    cfg = dataclasses.replace(tm.cfg, n_layers=1)
    one = t_get_model(cfg)
    _, tmixed = mixed_policies()
    tp = cast_compute(t_pack(one.init_params(0, device="cpu"), tmixed),
                      torch.bfloat16)
    stack = fuse_layer_stack(tp["blocks"], 1)
    assert stack.aux == () and set(stack.slabs) == {
        "uint8", "bfloat16", "float32"}
    D = cfg.d_model
    with pytest.raises(ValueError, match="of kind 'aux'"):
        stack_table(stack, D)
    st = {k: torch.zeros((1, 2, D), dtype=torch.bfloat16)
          for k in STATE_KEYS}
    x, _ = rwkv4_model_decode(stack, st, torch.ones((2, D),
                                                    dtype=torch.bfloat16))
    assert bool(torch.isfinite(x.float()).all())


def test_check_tile_raises_on_oversized_bb():
    """bb lanes must divide B, lie in [1, 8] and leave room beside their
    inputs for two weight stages of K3's plan in 227 KB of shared memory
    (`tile_plan`, K4's tile rule as K3's): rwkv4-7b (D 4096, F 16384)
    takes 32 KB of inputs a lane, so bb = 4 raises where bb = 3 fits (64-row
    stages, four slots) and bb = 1 fits; there is no silent smaller tile."""
    assert tile_plan(8, 8, 768, 3072, False, False).stages == 17   # 169M
    tile_plan(4, 2, 4096, 16384, False, False)
    assert tile_plan(3, 3, 4096, 16384, False, False)[2:4] == (64, 4)
    assert tile_plan(3, 1, 4096, 16384, False, False).kc == 128
    with pytest.raises(ValueError, match="shared memory"):
        tile_plan(4, 4, 4096, 16384, False, False)
    with pytest.raises(ValueError, match="divide"):
        tile_plan(8, 3, 768, 3072, False, False)
    with pytest.raises(ValueError, match="divide"):
        tile_plan(16, 16, 64, 256, False, False)
    assert MAX_BB == 8 and SMEM_BYTES == 232_448
