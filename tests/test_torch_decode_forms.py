"""Port vs JAX: every weight form the decode and prefill kernels take, on
the smoke models — K7 (RWKV-6, block and model form) on MIXED, W4, VQ and
plain bf16 trees, K3 and K4 (RWKV-4) on plain bf16 trees under the exact
and the hardware numerics, and K5-W4 / K5-VQ with an f32 x, as the hw
prefill feeds att.wo (their plain versions on the CPU).

Tolerances: decode trajectories hold logits and every state leaf to the
port_helpers rule (max |d| <= 2^-5 max|ref|, mean |d| <= 2^-8
mean|ref|) against JAX's `decode_step_fused` and
`decode_step_fused_model`, their Pallas kernels in interpret mode,
compiled with `exact_jit`.  The f32-x plain versions hold to JAX's
`w4_chunk_matmul` / `vq_chunk_matmul` on an f32 x within the f32
summation bound K·2^-24·(|x| @ |w|) (two f32 sums of the same products in
other orders), their decode bit for bit.  JAX's chunked prefill does not
run under jax 0.9 (ROADMAP "Reference status"), so the hw prefill on W4
and VQ trees is held bit for bit to the port's per-op hw step scanned
with masked commits, which `tests/test_torch_hw.py` ties to JAX.  The
wrappers' tables are checked without a launch.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from port_helpers import MIXED_OVERRIDES, assert_bitwise, assert_close, \
    to_port
from repro.core.quant import delta_pot as jdp
from repro.core.quant.policy import PlanePolicy as JPolicy
from repro.core.quant.serving import pack_params as j_pack
from repro.core.quant.serving import unpack_params as j_unpack_params
from repro.core.quant.vq import vq_quantize as j_vq_quantize
from repro.kernels.common import exact_jit
from repro.kernels.fused_prefill import vq_chunk_matmul, w4_chunk_matmul
from repro.models import rwkv4 as J4
from repro.models.registry import get_model as j_get_model
from repro_torch.core.quant.policy import PlanePolicy as TPolicy
from repro_torch.core.quant.serving import (
    FusedLayerStack, broadcast_packed_scales, fuse_layer_stack, pack_leaf,
    pack_params as t_pack, unpack_params as t_unpack_params)
from repro_torch.kernels import fused_prefill as FP
from repro_torch.kernels.fused_decode import (
    MAT_KEYS, PLANE_IDS, RWKV6_MAT_KEYS, rwkv6_layer_table,
    rwkv6_stack_table, stack_table)
from repro_torch.models import rwkv4 as T4
from repro_torch.models.registry import get_model as t_get_model
from repro_torch.models.rwkv4 import _layer

B, STEPS = 4, 8
# all-W4 with time_maa_x kept W8: pack_leaf pairs a (L, D) leaf along the
# layer axis, which no fused path takes (test_rwkv6_w4_time_maa_x_raises)
W4_MAA_X_W8 = (r"time_maa_x", "w8")
# the rwkv6 trees under test: (default plane, overrides), None plain
POLICIES6 = {"mixed": ("w8", MIXED_OVERRIDES),
             "w4": ("w4", (W4_MAA_X_W8,)),
             "vq": ("vq", ()),
             "plain": None}


@pytest.fixture(scope="module")
def rwkv6():
    jm = j_get_model("rwkv6-7b", smoke=True)
    tm = t_get_model("rwkv6-7b", smoke=True)
    return jm, tm, jm.init_params(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def rwkv4():
    jm = j_get_model("rwkv4-169m", smoke=True)
    tm = t_get_model("rwkv4-169m", smoke=True)
    return jm, tm, jm.init_params(jax.random.PRNGKey(0))


def _trees(jm, tm, params, which):
    """The JAX and port trees of one form, compute-cast: packed under the
    policy, or plain bf16."""
    if which is None:
        return jm.cast_params(params), tm.cast_params(to_port(params))
    default, over = which
    jp = j_pack(params, JPolicy(default=default, overrides=over))
    tp = t_pack(to_port(params), TPolicy(default=default, overrides=over))
    return jp, tm.cast_params(tp)


def _trajectory(jm, tm, jp, tp, jstep, tstep, rng, keys):
    """Teacher forced from the fresh state: every step's logits and state
    leaves to the port_helpers rule."""
    js = jm.init_decode_state(B, 0, jnp.bfloat16)
    ts = tm.init_decode_state(B, 0, dtype=torch.bfloat16, device="cpu")
    toks = rng.integers(0, jm.cfg.vocab, (STEPS, B, 1)).astype(np.int32)
    for i in range(STEPS):
        jl, js = jstep(jp, js, jnp.asarray(toks[i]))
        tl, ts = tstep(tp, ts, torch.from_numpy(toks[i]))
        assert tuple(tl.shape) == jl.shape == (B, 1, jm.cfg.vocab)
        assert_close(jl, tl, f"logits step {i}")
        for k in keys:
            assert ts[k].dtype == torch.bfloat16
            assert_close(js[k], ts[k], f"{k} step {i}")


# --- K7 on MIXED, W4, VQ and plain bf16 trees ----------------------------


@pytest.mark.parametrize("path", ["block", "model"])
@pytest.mark.parametrize("form", list(POLICIES6))
def test_rwkv6_fused_forms_match_jax(rwkv6, form, path, rng):
    """rwkv6's kernel paths (K7 per layer, K7 for every layer; the plain
    versions on the CPU) on each weight form against JAX's
    decode_step_fused / decode_step_fused_model on the same form, each on
    its own prepared tree."""
    jm, tm, params = rwkv6
    jp, tp = _trees(jm, tm, params, POLICIES6[form])
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
    _trajectory(jm, tm, jp, tp, jstep, tstep, rng,
                ("att_x", "ffn_x", "wkv_s"))


def test_rwkv6_w4_time_maa_x_raises(rwkv6, rng):
    """Under PLANE_W4 pack_leaf pairs time_maa_x (L, D) along the layer
    axis (packed4 (L/2, D)).  JAX's per-op decode runs that tree, and so
    does the port's (held to it); JAX's fused paths fail on it, and K7's
    tables, block and model, raise on time_maa_x before anything could
    launch."""
    jm, tm, params = rwkv6
    cfg = tm.cfg
    jp, tp = _trees(jm, tm, params, ("w4", ()))
    L, D = cfg.n_layers, cfg.d_model
    assert tp["blocks"]["att"]["time_maa_x"]["packed4"].shape == (L // 2, D)
    jstep = exact_jit(lambda p, s, t: jm.decode_step(
        jm.cast_params(j_unpack_params(p)), s, t, jnp.int32(0)))
    tstep = lambda p, s, t: tm.decode_step(t_unpack_params(p), s, t, 0)
    _trajectory(jm, tm, jp, tp, jstep, tstep, rng,
                ("att_x", "ffn_x", "wkv_s"))
    toks = jnp.zeros((B, 1), jnp.int32)
    js = jm.init_decode_state(B, 0, jnp.bfloat16)
    with pytest.raises(Exception):
        jax.block_until_ready(jm.decode_step_fused(jp, js, toks,
                                                   jnp.int32(0)))
    with pytest.raises(Exception):
        jax.block_until_ready(jm.decode_step_fused_model(
            jm.prepare_fused_model_params(jp), js, toks, jnp.int32(0)))
    dims = (D, cfg.d_ff, cfg.n_heads, cfg.rwkv_head_dim)
    lp = _layer(broadcast_packed_scales(tp["blocks"], L), 0)
    with pytest.raises(ValueError, match="time_maa_x.*pairs contraction"):
        rwkv6_layer_table(lp, *dims)
    stack = fuse_layer_stack(tp["blocks"], L)
    with pytest.raises(ValueError, match="time_maa_x.*pairs contraction"):
        rwkv6_stack_table(stack, *dims)


@pytest.mark.parametrize("form", ["mixed", "w4", "plain"])
def test_rwkv6_tables(rwkv6, form):
    """K7's tables without a launch: each matrix's plane id and slab (codes
    in the uint8 slab, plain weights in the bf16 slab at their manifest
    offsets), every scale and codebook one shared aux leaf, and the block
    form's table on layer 0 agreeing plane for plane."""
    jm, tm, params = rwkv6
    cfg = tm.cfg
    D, F, H, N = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.rwkv_head_dim
    _, tp = _trees(jm, tm, params, POLICIES6[form])
    stack = tm.prepare_path_params(tm.decode_paths()["model"],
                                   tp)["blocks"]
    entries = dict(zip(stack.tdef, stack.manifest))
    _, mats = rwkv6_stack_table(stack, D, F, H, N)
    for path, m in zip(RWKV6_MAT_KEYS, mats):
        if m.plane == PLANE_IDS["bf16"]:
            assert m.slab == "bfloat16" and m.aux is None
            assert m.offset == entries[path][2]
            continue
        key = {0: "packed", 1: "packed4", 2: "vq_idx"}[m.plane]
        assert m.slab == "uint8" and m.offset == entries[path + (key,)][2]
        aux_key = "codebook" if m.plane == PLANE_IDS["vq"] else "scale"
        e = entries[path + (aux_key,)]
        assert e[0] == "aux" and stack.aux[e[1]].shape[0] == 1
        assert m.aux.data_ptr() == stack.aux[e[1]].data_ptr()
    want = {"mixed": {("att", "wk"): 1, ("ffn", "wv"): 2},
            "w4": {p: 1 for p in RWKV6_MAT_KEYS
                   if p not in (("att", "time_maa_x"), ("att", "time_maa"))},
            "plain": {p: 3 for p in RWKV6_MAT_KEYS}}[form]
    assert [m.plane for m in mats] == [want.get(p, 0)
                                      for p in RWKV6_MAT_KEYS]
    lp = _layer(broadcast_packed_scales(tp["blocks"], cfg.n_layers), 0)
    assert [m[2] for m in rwkv6_layer_table(lp, D, F, H, N)] == [
        m.plane for m in mats]


def k7_slices(K: int, plane: str, warps: int = 16):
    """The K slices of K7's matvecs, one a warp, as
    `csrc/rwkv6_body.cuh:slice_sums` cuts them: from K alone, a W4
    matrix's in row pairs."""
    p = 2 if plane == "w4" else 1
    return [(p * (K // p * w // warps), p * (K // p * (w + 1) // warps))
            for w in range(warps)]


@pytest.mark.parametrize("K", [32, 64, 160, 4096, 14336])
def test_k7_w4_slices_are_even(K):
    """K7's 16 K slices (the kernel's formula) cover 0..K in order from K
    alone; a W4 matrix's start and end on even rows (its bytes pair
    rows), at maa_w2's rank 32, td_w2's 64 and rwkv6-7b's widths."""
    for plane in ("w8", "w4", "vq", "bf16"):
        sl = k7_slices(K, plane)
        assert sl[0][0] == 0 and sl[-1][1] == K
        assert all(a[1] == b[0] and a[0] <= a[1] for a, b in zip(sl, sl[1:]))
        if plane == "w4":
            assert all(k0 % 2 == 0 and k1 % 2 == 0 for k0, k1 in sl)


# --- K3 and K4 on plain bf16 trees, exact and hw ---------------------------


@pytest.mark.parametrize("hw", [False, True], ids=["exact", "hw"])
@pytest.mark.parametrize("path", ["block", "model"])
def test_rwkv4_plain_fused_matches_jax(rwkv4, path, hw, rng):
    """K3 and K4 (their plain versions on the CPU) on a plain bf16 tree
    against JAX's decode_step_fused / decode_step_fused_model on the same
    plain tree (interpret mode), exact and under the hardware numerics."""
    jm, tm, params = rwkv4
    jp, tp = _trees(jm, tm, params, None)
    if path == "block":
        jstep = exact_jit(lambda p, s, t: J4.decode_step_fused(
            p, s, t, jnp.int32(0), jm.cfg, hw=hw))
        tstep = lambda p, s, t: T4.decode_step_fused(p, s, t, 0, tm.cfg,
                                                     hw=hw)
    else:
        jp = jm.prepare_fused_model_params(jp, hw=hw)
        tp = tm.prepare_fused_model_params(tp, hw=hw)
        jstep = exact_jit(lambda p, s, t: J4.decode_step_fused_model(
            p, s, t, jnp.int32(0), jm.cfg, hw=hw))
        tstep = lambda p, s, t: T4.decode_step_fused_model(p, s, t, 0,
                                                           tm.cfg, hw=hw)
    _trajectory(jm, tm, jp, tp, jstep, tstep, rng, T4.STATE_KEYS)


def test_rwkv4_plain_stack_table(rwkv4):
    """K4's table of a plain bf16 stack: no uint8 slab, each matrix's
    weights in the bf16 slab at its manifest offset (plane bf16, no aux);
    an f32 plain matrix raises, and so does a layer of plain and packed
    matrices."""
    jm, tm, params = rwkv4
    _, tp = _trees(jm, tm, params, None)
    stack = tm.prepare_fused_model_params(tp)["blocks"]
    assert set(stack.slabs) == {"bfloat16"}
    D, F = tm.cfg.d_model, tm.cfg.d_ff
    entries = dict(zip(stack.tdef, stack.manifest))
    got_F, _, mats = stack_table(stack, D)
    assert got_F == F
    assert [(m.offset, m.slab, m.plane, m.aux) for m in mats] == [
        (entries[p][2], "bfloat16", PLANE_IDS["bf16"], None)
        for p in MAT_KEYS]
    att = {**tp["blocks"]["att"], "wo": tp["blocks"]["att"]["wo"].float()}
    with pytest.raises(TypeError, match="att.wo is float32"):
        stack_table(fuse_layer_stack({**tp["blocks"], "att": att},
                                     tm.cfg.n_layers), D)
    # a layer mixing plain and packed matrices is no tree's and K3/K4
    # compile none: it raises before a launch
    att["wo"] = pack_leaf("['blocks']['att']['wo']", att["wo"])
    with pytest.raises(ValueError, match="not both"):
        stack_table(fuse_layer_stack({**tp["blocks"], "att": att},
                                     tm.cfg.n_layers), D)


def test_rwkv4_plain_equals_per_op_on_cpu(rwkv4, rng):
    """On the CPU the K3 and K4 paths on a plain tree run their plain
    versions over the per-op body: bit for bit equal to decode_step, exact
    and hw."""
    jm, tm, params = rwkv4
    _, tp = _trees(jm, tm, params, None)
    for hw in (False, True):
        prep = tm.prepare_fused_model_params(tp, hw=hw)
        s = [tm.init_decode_state(B, 0, device="cpu") for _ in range(3)]
        for _ in range(2):
            toks = torch.from_numpy(
                rng.integers(0, tm.cfg.vocab, (B, 1)).astype(np.int32))
            ref = T4.decode_step(tp, s[0], toks, 0, tm.cfg, hw=hw)
            outs = [T4.decode_step_fused(tp, s[1], toks, 0, tm.cfg, hw=hw),
                    T4.decode_step_fused_model(prep, s[2], toks, 0, tm.cfg,
                                               hw=hw)]
            for lg, st in outs:
                assert torch.equal(lg, ref[0])
                assert all(torch.equal(st[k], ref[1][k])
                           for k in T4.STATE_KEYS)
            s = [ref[1]] + [o[1] for o in outs]


# --- K5-W4 and K5-VQ with an f32 x -----------------------------------------


@pytest.mark.parametrize("plane", ["w4", "vq"])
def test_f32x_plain_matches_jax(rng, plane):
    """The plain versions of K5-W4 and K5-VQ on an f32 x against JAX's
    w4_chunk_matmul / vq_chunk_matmul on the same f32 x (interpret mode,
    result f32): the decode bit for bit (identity rows), each output
    within the f32 summation bound; the f32-x wrappers on CPU tensors are
    the plain versions and launch nothing, and chunk_matmul sends an f32
    x to them."""
    K, N, M = 64, 96, 24
    w = jnp.asarray(rng.standard_t(4.0, size=(K, N)) * 0.1, jnp.float32)
    x = jnp.asarray(rng.normal(size=(M, K)), jnp.float32)
    eye = jnp.eye(K, dtype=jnp.float32)
    if plane == "w4":
        q = jdp.dpot_quantize(w, jdp.FORMAT_W4, axis=-1)
        jleaf = {"packed4": jdp.dpot_pack_nibbles(q),
                 "scale": q.scale.astype(jnp.float32)}
        run = lambda a: w4_chunk_matmul(a, jleaf["packed4"], jleaf["scale"],
                                        dt="bfloat16", bm=8, bn=32,
                                        interpret=True)
        codes, aux = "packed4", "scale"
        wrapper, plain = FP.dpot_w4_matmul_f32x, FP.dpot_w4_matmul_plain
    else:
        idx, cb = j_vq_quantize(w, 256)
        jleaf = {"vq_idx": idx, "codebook": cb}
        run = lambda a: vq_chunk_matmul(a, idx, cb, dt="bfloat16", bm=8,
                                        bn=32, interpret=True)
        codes, aux = "vq_idx", "codebook"
        wrapper, plain = FP.vq_matmul_f32x, FP.vq_matmul_plain
    want, jw = run(x), run(eye)
    assert want.dtype == jnp.float32
    leaf, tx = to_port(jleaf), to_port(x)
    got = wrapper(tx, leaf[codes], leaf[aux])
    assert got.dtype == torch.float32
    tw = wrapper(torch.eye(K), leaf[codes], leaf[aux])
    assert_bitwise(jw, tw, f"{plane} decode")
    bound = K * 2.0 ** -24 * (np.abs(np.asarray(x)) @ np.abs(np.asarray(jw)))
    assert (np.abs(got.numpy() - np.asarray(want)) <= bound).all()
    before = wrapper.launches
    assert torch.equal(got, plain(tx, leaf[codes], leaf[aux]))
    assert wrapper.launches == before
    got3 = FP.chunk_matmul(tx.reshape(3, 8, K), leaf, torch.bfloat16)
    assert got3.dtype == torch.float32
    assert torch.equal(got3.reshape(M, N), got)


def _random_state4(tm, rng):
    st = tm.init_decode_state(8, 0, device="cpu")
    out = {}
    for k, v in st.items():
        vals = torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
        out[k] = (vals - 1.0 if k == "wkv_o" else vals).to(v.dtype)
    return out


@pytest.mark.parametrize("plane", ["w4", "vq"])
def test_prefill_chunk_hw_planes_equal_masked_scan(rwkv4, plane, rng,
                                                   monkeypatch):
    """prefill_chunk(hw=True) on a PLANE_W4 / PLANE_VQ tree (att.wo's f32
    x through K5-W4 or K5-VQ in their f32-x forms; plain on the CPU)
    against the per-op hw step scanned over the chunk with masked commits,
    from a random state, prefix lengths 0, 1, ..., 8: bit for bit."""
    _, tm, params = rwkv4
    tp = t_pack(to_port(params), TPolicy(default=plane))
    f32x = {"w4": "dpot_w4_matmul_f32x", "vq": "vq_matmul_f32x"}[plane]
    calls = []
    real = getattr(FP, f32x)
    monkeypatch.setattr(FP, f32x, lambda *a: calls.append(1) or real(*a))
    plain = tm.cast_params(t_unpack_params(tp))
    Bp, Cp = 8, 8
    lens = (Cp, 5, 0, 1, Cp, 3, 7, Cp)
    state = _random_state4(tm, rng)
    toks = torch.from_numpy(
        rng.integers(0, tm.cfg.vocab, (Bp, Cp)).astype(np.int32))
    valid = torch.zeros((Bp, Cp), dtype=torch.bool)
    for i, n in enumerate(lens):
        valid[i, :n] = True
    st, lg = T4.prefill_chunk(tp, state, toks, valid, 0, tm.cfg, hw=True)
    assert len(calls) == tm.cfg.n_layers
    so, last = state, torch.zeros_like(lg)
    for t in range(Cp):
        lt, sn = T4.decode_step(plain, so, toks[:, t:t + 1], 0, tm.cfg,
                                hw=True)
        ok = valid[:, t]
        so = {k: torch.where(ok[None, :, None], sn[k], so[k]) for k in so}
        last = torch.where(ok[:, None, None], lt, last)
    assert torch.equal(lg, last)
    assert all(torch.equal(st[k], so[k]) for k in T4.STATE_KEYS)
