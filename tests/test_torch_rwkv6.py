"""Port vs JAX: the RWKV-6 serving slice on `rwkv6-7b` smoke (L2 D64 H4
N16 F128 V256) — packing and the slab form, the per-op decode, the kernel
decode paths (K7 per layer and K7 for every layer; their plain versions
on the CPU), the chunked prefill (K5 + K6) and the engine.

Tolerances: packed leaves, slabs and pre-decoded leaves bit for bit;
logits and state leaves by the port_helpers rule (max |d| <= 2^-5 max|ref|,
mean |d| <= 2^-8 mean|ref|).  The JAX side compiles with `exact_jit`,
whose rounding is the trace's, as eager torch's is; JAX's fused decode
runs its Pallas kernels in interpret mode.  JAX's chunked prefill does
not run under jax >= 0.5 (K6's Pallas kernel uses the removed
pl.load/pl.store), so the prefill reference is the engine's per-op masked
scan, `tests/test_prefill.py:oracle_prefill`.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from port_helpers import assert_bitwise, assert_close, to_port
from repro.core.quant.serving import pack_params as j_pack
from repro.core.quant.serving import unpack_params as j_unpack_params
from repro.kernels.common import exact_jit
from repro.models import rwkv6 as j_rwkv6
from repro.models.registry import get_model as j_get_model
from repro_torch.bridge import fused_stack_to_numpy
from repro_torch.core.quant.policy import PlanePolicy
from repro_torch.core.quant.serving import (
    FusedLayerStack, fuse_layer_stack, pack_params as t_pack,
    unpack_params as t_unpack_params)
from repro_torch.kernels.fused_decode import (
    RWKV6_MAT_KEYS, RWKV6_VEC_KEYS, rwkv6_block_decode,
    rwkv6_block_decode_plain, rwkv6_model_decode, rwkv6_model_decode_plain,
    rwkv6_stack_table)
from repro_torch.launch.serve import sequential_decode
from repro_torch.models import rwkv6 as t_rwkv6
from repro_torch.models.registry import get_model as t_get_model
from repro_torch.models.rwkv4 import _layer
from repro_torch.models.rwkv6 import STATE_KEYS
from repro_torch.serving import ServingEngine
from repro_torch.tree import keystr, leaves_with_path
from test_prefill import _prefix_valid, _random_state, oracle_prefill

ARCH = "rwkv6-7b"
B, STEPS = 4, 12
C, PREFIX_LENS = 6, (6, 3, 0, 1)


@pytest.fixture(scope="module")
def models():
    jm = j_get_model(ARCH, smoke=True)
    tm = t_get_model(ARCH, smoke=True)
    return jm, tm, jm.init_params(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def packed(models):
    jm, _, params = models
    jp = j_pack(params)
    return jp, to_port(jp)


def _flat(tree):
    return {keystr(tuple(k.key for k in p)): l for p, l in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# --- packing, the slab form and the prefill's pre-decoded leaves ---------


def test_pack_params_bitwise(models, packed):
    """pack_params on the RWKV-6 tree, leaf by leaf, against JAX's: the
    2-D, 3-D and 4-D stacked planes (time_maa_x, time_maa, time_faaaa,
    maa_w2) with their shared (1, ..., N) scales, and the bf16 leaves."""
    jm, tm, params = models
    jp, _ = packed
    tp = t_pack(to_port(params))
    jflat = _flat(jp)
    tflat = {keystr(p): l for p, l in leaves_with_path(tp)}
    assert sorted(jflat) == sorted(tflat)
    for key, leaf in jflat.items():
        assert str(tflat[key].dtype).replace("torch.", "") == \
            leaf.dtype.name, key
        assert_bitwise(leaf, tflat[key], key)
    D, H, N = tm.cfg.d_model, tm.cfg.n_heads, tm.cfg.rwkv_head_dim
    att = tp["blocks"]["att"]
    assert {k: tuple(att[k]["scale"].shape) for k in
            ("time_maa_x", "time_maa", "time_faaaa", "maa_w2")} == {
        "time_maa_x": (1, D), "time_maa": (1, 1, D),
        "time_faaaa": (1, 1, N), "maa_w2": (1, 1, 1, D)}
    assert att["time_faaaa"]["packed"].shape == (2, H, N)


def test_init_packs_each_leaf_as_drawn():
    """build_plan packs each leaf as it is drawn, the stacked leaves one
    layer at a time under their shared scale: the bytes equal packing the
    whole f32 tree afterwards."""
    tm = t_get_model(ARCH, smoke=True)
    from repro_torch.core.quant.serving import pack_leaf
    for policy in (None, PlanePolicy(default="w4")):
        whole = t_pack(tm.init_params(3, device="cpu"), policy)
        drawn = tm.init_params(3, device="cpu", leaf_fn=lambda p, t: (
            pack_leaf(keystr(p), t, policy)))
        a, b = leaves_with_path(whole), leaves_with_path(drawn)
        assert [p for p, _ in a] == [p for p, _ in b]
        for (p, x), (_, y) in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y), p


def test_fuse_layer_stack_bitwise(models, packed):
    """The slab form of the W8 tree equals JAX's
    prepare_fused_model_params byte for byte, and K7-model's table reads
    each vector's and plane's offset and shared scale off its manifest."""
    jm, tm, _ = models
    jp, tp = packed
    js, ja, jmf = fused_stack_to_numpy(
        jm.prepare_fused_model_params(jp)["blocks"])
    stack = t_rwkv6.prepare_fused_model_params(tp, tm.cfg)["blocks"]
    ts, ta, tmf = fused_stack_to_numpy(stack)
    assert tmf == jmf and sorted(ts) == sorted(js)
    for k in js:
        assert ts[k].shape == js[k].shape and \
            ts[k].tobytes() == js[k].tobytes(), k
    assert len(ta) == len(ja) == 15
    for a, b in zip(ja, ta):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    cfg = tm.cfg
    D, F, H, N = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.rwkv_head_dim
    vec_offs, mats = rwkv6_stack_table(stack, D, F, H, N)
    entries = dict(zip(stack.tdef, stack.manifest))
    assert vec_offs == [entries[p][2] for p in RWKV6_VEC_KEYS]
    assert [m.offset for m in mats] == [
        entries[p + ("packed",)][2] for p in RWKV6_MAT_KEYS]
    assert {(m.plane, m.slab) for m in mats} == {(0, "uint8")}
    assert [m.aux.numel() for m in mats] == [
        D, D, N, 160, D, 64, D] + [D] * 6 + [F, D]


def test_stack_table_raises_on_other_planes_and_leaves(models):
    """K7 takes W4 and VQ planes beside W8 (att.wg's codes in the uint8
    slab, its scale or codebook a shared aux leaf), but no leaf it does
    not know: an extra leaf raises before anything launches."""
    _, tm, params = models
    cfg = tm.cfg
    dims = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.rwkv_head_dim)
    D = cfg.d_model
    wg = RWKV6_MAT_KEYS.index(("att", "wg"))
    for plane, aux in (("w4", D), ("vq", 256)):
        policy = PlanePolicy(default="w8",
                             overrides=((r"\['att'\]\['wg'\]", plane),))
        tp = tm.cast_params(t_pack(to_port(params), policy))
        stack = fuse_layer_stack(tp["blocks"], cfg.n_layers)
        _, mats = rwkv6_stack_table(stack, *dims)
        entries = dict(zip(stack.tdef, stack.manifest))
        key = {"w4": "packed4", "vq": "vq_idx"}[plane]
        assert mats[wg].plane == {"w4": 1, "vq": 2}[plane]
        assert mats[wg].offset == entries[("att", "wg", key)][2]
        assert mats[wg].slab == "uint8" and mats[wg].aux.numel() == aux
        assert all(m.plane == 0 for i, m in enumerate(mats) if i != wg)
    tp = tm.cast_params(t_pack(to_port(params)))
    extra = fuse_layer_stack(
        {**tp["blocks"], "_luts": {"exp": torch.zeros(1, 256)}},
        cfg.n_layers)
    with pytest.raises(ValueError, match="_luts"):
        rwkv6_stack_table(extra, *dims)


def test_predecode_packed_leaves_bitwise(models, packed):
    """prepare_prefill_params decodes time_maa_x, time_maa, maa_w2 and
    time_faaaa (bf16, as JAX's) and leaves every other plane packed."""
    jm, tm, _ = models
    jp, tp = packed
    jprep = _flat(jm.prepare_prefill_params(jp))
    tprep = {keystr(p): l for p, l in leaves_with_path(
        tm.prepare_path_params(tm.prefill_paths()["chunked"], tp))}
    assert sorted(jprep) == sorted(tprep)
    for key, leaf in jprep.items():
        assert_bitwise(leaf, tprep[key], key)
    for k in ("time_maa_x", "time_maa", "maa_w2", "time_faaaa"):
        assert f"['blocks']['att']['{k}']" in tprep
    assert "['blocks']['att']['maa_w1']['packed']" in tprep


# --- the two numerics traps ---------------------------------------------


def test_group_norm_biased_variance(rng):
    """GroupNorm takes jnp.var's biased variance mean((y - μ)²): on a head
    of 4 the unbiased one would be 4/3 of it, moving every output."""
    H = 2
    y = rng.normal(size=(3, 8)).astype(np.float32) * 3 + 1
    p = {"scale": rng.normal(size=8).astype(np.float32),
         "bias": rng.normal(size=8).astype(np.float32)}
    want = exact_jit(lambda p, y: j_rwkv6._group_norm(p, y, H))(
        p, jnp.asarray(y, jnp.bfloat16))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ty = torch.from_numpy(y).to(torch.bfloat16)
    got = t_rwkv6._group_norm(tp, ty, H)
    assert got.dtype == torch.bfloat16
    assert_bitwise(want, got, "group norm")
    yh = ty.float().reshape(3, H, -1)
    unbiased = ((yh - yh.mean(-1, keepdim=True)) * torch.rsqrt(
        yh.var(-1, keepdim=True) + 64e-5)).reshape(3, -1) * tp["scale"] \
        + tp["bias"]
    assert not torch.equal(unbiased.to(torch.bfloat16), got)


def test_silu_matches_jax_bf16():
    """silu on bf16 rounds each op of XLA's x·(1/(1+exp(-x))), as
    jax.nn.silu under exact_jit does; F.silu rounds once and differs."""
    x = np.linspace(-12, 12, 4001).astype(np.float32)
    want = exact_jit(jax.nn.silu)(jnp.asarray(x, jnp.bfloat16))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    assert_bitwise(want, t_rwkv6.silu(tx), "silu")
    assert not torch.equal(torch.nn.functional.silu(tx), t_rwkv6.silu(tx))


# --- decode ---------------------------------------------------------------


def _trajectory(jm, tm, jp, tp, jstep, tstep, rng, steps=STEPS):
    js = jm.init_decode_state(B, 0, jnp.bfloat16)
    ts = tm.init_decode_state(B, 0, dtype=torch.bfloat16, device="cpu")
    toks = rng.integers(0, jm.cfg.vocab, (steps, B, 1)).astype(np.int32)
    for i in range(steps):
        jl, js = jstep(jp, js, jnp.asarray(toks[i]))
        tl, ts = tstep(tp, ts, torch.from_numpy(toks[i]))
        assert tuple(tl.shape) == jl.shape == (B, 1, jm.cfg.vocab)
        assert_close(jl, tl, f"logits step {i}")
        for k in STATE_KEYS:
            assert ts[k].dtype == torch.bfloat16
            assert_close(js[k], ts[k], f"{k} step {i}")


def test_block_decode_matches_jax(models, packed, rng):
    """One layer's block_decode on the decoded W8 layer 0 from a random
    bf16 state, against JAX's."""
    jm, tm, _ = models
    jp, tp = packed
    jl0 = jax.tree_util.tree_map(
        lambda a: a[0], jm.cast_params(j_unpack_params(jp))["blocks"])
    tl0 = _layer(tm.cast_params(t_unpack_params(tp))["blocks"], 0)
    cfg = tm.cfg
    D, H, N = cfg.d_model, cfg.n_heads, cfg.rwkv_head_dim
    n = lambda *s: rng.normal(size=s).astype(np.float32)
    st = {"att_x": n(B, D), "ffn_x": n(B, D), "wkv_s": n(B, H, N, N)}
    x = n(B, D)
    jst = {k: jnp.asarray(v, jnp.bfloat16) for k, v in st.items()}
    jx, jnew = exact_jit(lambda p, s, x: j_rwkv6.block_decode(
        p, s, x, jm.cfg))(jl0, jst, jnp.asarray(x, jnp.bfloat16))
    tst = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in st.items()}
    tx, tnew = t_rwkv6.block_decode(tl0, tst, torch.from_numpy(x).to(
        torch.bfloat16), cfg)
    assert_close(jx, tx, "x")
    for k in STATE_KEYS:
        assert_close(jnew[k], tnew[k], k)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "w8"])
def test_decode_step_matches_jax(models, packed, quantized, rng):
    jm, tm, params = models
    jp, tp = packed if quantized else (params, to_port(params))
    j_un = j_unpack_params if quantized else (lambda p: p)
    t_un = t_unpack_params if quantized else (lambda p: p)
    jstep = exact_jit(lambda p, s, t: jm.decode_step(j_un(p), s, t,
                                                      jnp.int32(0)))
    tstep = lambda p, s, t: tm.decode_step(t_un(p), s, t, 0)
    _trajectory(jm, tm, jp, tp, jstep, tstep, rng)


@pytest.mark.parametrize("path", ["block", "model"])
def test_fused_decode_matches_jax_kernels(models, packed, path, rng):
    """The kernel paths (K7 per layer, K7 for every layer; plain versions
    on the CPU) against JAX's fused block decode and megakernel, the
    Pallas kernels in interpret mode, each on its own prepared form."""
    jm, tm, _ = models
    jp, tp = packed
    if path == "block":
        jstep = exact_jit(lambda p, s, t: jm.decode_step_fused(
            p, s, t, jnp.int32(0)))
        tstep = lambda p, s, t: tm.decode_step_fused(p, s, t, 0)
    else:
        jp = jm.prepare_fused_model_params(jp)
        tp = tm.prepare_path_params(tm.decode_paths()["model"], tp)
        assert isinstance(tp["blocks"], FusedLayerStack)
        jstep = exact_jit(lambda p, s, t: jm.decode_step_fused_model(
            p, s, t, jnp.int32(0)))
        tstep = lambda p, s, t: tm.decode_step_fused_model(p, s, t, 0)
    _trajectory(jm, tm, jp, tp, jstep, tstep, rng)


@pytest.mark.parametrize("path", ["block", "model"])
def test_fused_decode_matches_jax_per_op(models, packed, path, rng):
    """The kernel paths against JAX's per-op decode on the unpacked
    tree."""
    jm, tm, _ = models
    jp, tp = packed
    if path == "model":
        tp = t_rwkv6.prepare_fused_model_params(tp, tm.cfg)
    tstep = {"block": tm.decode_step_fused,
             "model": tm.decode_step_fused_model}[path]
    jstep = exact_jit(lambda p, s, t: jm.decode_step(
        j_unpack_params(p), s, t, jnp.int32(0)))
    _trajectory(jm, tm, jp, tp, jstep, lambda p, s, t: tstep(p, s, t, 0),
                rng)


def test_fused_paths_equal_per_op_on_cpu(models, packed, rng):
    """On the CPU the block and model paths (prepared or raw) run the
    per-op block body on the same decoded weights: bit for bit."""
    _, tm, _ = models
    _, tp = packed
    prep = t_rwkv6.prepare_fused_model_params(tp, tm.cfg)
    s = [tm.init_decode_state(B, 0, dtype=torch.bfloat16, device="cpu")
         for _ in range(4)]
    for _ in range(3):
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


def test_kernel_wrappers_on_cpu_are_plain(models, packed, rng):
    """On CPU tensors the K7 wrappers run their plain versions and launch
    nothing; the model form equals the block form layer by layer."""
    _, tm, _ = models
    _, tp = packed
    cfg = tm.cfg
    L, D, H, N = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.rwkv_head_dim
    stack = t_rwkv6.prepare_fused_model_params(tp, cfg)["blocks"]
    bf = lambda *s: torch.from_numpy(
        rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
    st = {"att_x": bf(L, B, D), "ffn_x": bf(L, B, D),
          "wkv_s": bf(L, B, H, N, N)}
    x = bf(B, D)
    before = (rwkv6_block_decode.launches, rwkv6_model_decode.launches)
    xm, newm = rwkv6_model_decode(stack, st, x, cfg)
    xp, newp = rwkv6_model_decode_plain(stack, st, x, cfg)
    assert torch.equal(xm, xp)
    assert all(torch.equal(newm[k], newp[k]) for k in STATE_KEYS)
    from repro_torch.core.quant.serving import broadcast_packed_scales
    blocks = broadcast_packed_scales(tm.cast_params(tp)["blocks"], L)
    xb = xq = x
    for l in range(L):
        lp = _layer(blocks, l)
        st_l = {k: st[k][l] for k in STATE_KEYS}
        xb, sb = rwkv6_block_decode(lp, st_l, xb, cfg)
        xq, _ = rwkv6_block_decode_plain(lp, st_l, xq, cfg)
        assert torch.equal(xb, xq)
        assert all(torch.equal(sb[k], newm[k][l]) for k in STATE_KEYS)
    assert torch.equal(xb, xm)
    assert (rwkv6_block_decode.launches,
            rwkv6_model_decode.launches) == before


# --- prefill and the slice as a whole -----------------------------------


def _case(jm, rng):
    state = _random_state(jm, rng)
    tokens = jnp.asarray(rng.integers(0, jm.cfg.vocab, (B, C)), jnp.int32)
    return state, tokens, _prefix_valid(PREFIX_LENS, C)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "w8"])
def test_prefill_chunk_matches_oracle(models, packed, quantized, rng):
    """Chunked prefill (K5 + K6 plain versions) against JAX's per-op masked
    scan, from random states, over full, partial, empty and single-token
    prefix masks; the empty lane keeps its state and has zero logits."""
    jm, tm, params = models
    jp = packed[0] if quantized else params
    state, tokens, valid = _case(jm, rng)
    s1, l1 = exact_jit(lambda p, s: oracle_prefill(
        jm, p, s, tokens, valid, quantized=quantized))(jp, state)
    tp = tm.prepare_path_params(tm.prefill_paths()["chunked"], to_port(jp))
    s2, l2 = tm.prefill_chunk(tp, to_port(state), to_port(tokens),
                              to_port(valid))
    assert tuple(l2.shape) == l1.shape == (B, 1, jm.cfg.vocab)
    assert_close(l1, l2, "last-valid logits")
    for k in STATE_KEYS:
        assert_close(s1[k], s2[k], k)
    empty = PREFIX_LENS.index(0)
    assert not l2[empty].any()
    for k in STATE_KEYS:
        assert torch.equal(s2[k][:, empty], to_port(state)[k][:, empty])


def test_prefill_then_decode_matches_jax(models, packed, rng):
    """The slice as a whole with W8 weights: one prefill chunk through the
    kernel path's plain versions (on the raw tree, which prefill_chunk
    prepares itself), then kernel-path decode steps on the model path,
    against JAX's oracle prefill and per-op decode, teacher forced."""
    jm, tm, _ = models
    jp, tp = packed
    state, tokens, valid = _case(jm, rng)
    js, jl = exact_jit(lambda p, s: oracle_prefill(
        jm, p, s, tokens, valid, quantized=True))(jp, state)
    ts, tl = tm.prefill_chunk(tp, to_port(state), to_port(tokens),
                              to_port(valid))
    assert_close(jl, tl, "prefill logits")
    prep = t_rwkv6.prepare_fused_model_params(tp, tm.cfg)
    jstep = exact_jit(lambda p, s, t: jm.decode_step(
        j_unpack_params(p), s, t, jnp.int32(0)))
    for i in range(STEPS):
        t = rng.integers(0, jm.cfg.vocab, (B, 1)).astype(np.int32)
        jl, js = jstep(jp, js, jnp.asarray(t))
        tl, ts = tm.decode_step_fused_model(prep, ts, torch.from_numpy(t), 0)
        assert_close(jl, tl, f"logits step {i}")
        for k in STATE_KEYS:
            assert_close(js[k], ts[k], f"{k} step {i}")


# --- the engine -----------------------------------------------------------


def _engine(path):
    return ServingEngine(ARCH, smoke=True, quantized=True, max_batch=4,
                         prefill_chunk=4, fused_decode=path,
                         fused_prefill=True, device="cpu")


def _prompts(n, vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(k)).tolist()
            for k in rng.integers(1, 11, n)]


@pytest.mark.parametrize("path", ["block", "model"])
def test_engine_solo_equals_batched(path):
    """Each request's stream is the same whether it shares the pool with
    five others (ragged prompts, chunk splits, slot reuse) or runs
    alone."""
    eng = _engine(path)
    prompts = _prompts(6, eng.model.cfg.vocab, 4)
    handles = [eng.submit(p, max_new_tokens=5) for p in prompts]
    assert eng.run()["decode_tokens"] == 30
    for p, h in zip(prompts, handles):
        solo = eng.submit(p, max_new_tokens=5)
        eng.run()
        assert solo.tokens == h.tokens


@pytest.mark.parametrize("path", ["block", "model"])
def test_engine_matches_sequential_decode(path):
    """Greedy streams of the kernel paths (chunked prefill, K7 decode)
    against batch-1 greedy per-op decode of each request on the unpacked
    tree."""
    eng = _engine(path)
    assert eng.plan.prepared.prefill["blocks"]["att"]["time_maa"].dtype \
        == torch.bfloat16
    prompts = _prompts(3, eng.model.cfg.vocab, 5)
    handles = [eng.submit(p, max_new_tokens=4) for p in prompts]
    eng.run()
    for p, h in zip(prompts, handles):
        assert h.tokens == sequential_decode(
            eng.model, eng.plan.prepared.raw, p, 4, device="cpu")
