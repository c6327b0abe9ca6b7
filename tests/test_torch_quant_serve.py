"""Port vs JAX: the quantized serve step (`build_serve_step(variant=
"quantized")`, W8 codes decoded by `unpack_params` inside the step), its
cell entry, `serve_legacy(quantized=True)` and the K1/K8 wrappers off the
CPU, on the smoke models.

Tolerances: the teacher-forced logits and every state leaf of each step
hold to tests/port_helpers.py's decode rule (max |d| <= 2^-5 max|ref|,
mean |d| <= 2^-8 mean|ref|): both sides decode the same codes to the
same bf16 weights, then compute in bf16 with f32 accumulation in their own
orders.  Inside the port, the quantized step equals the base step on
`unpack_params(tree)` bit for bit (the same operations on the same
weights); the fake-quantized tree of serve_legacy is held as
tests/test_torch_quant.py holds fake_quantize_tree.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from port_helpers import assert_close, f32, to_port
from repro.configs.base import ShapeConfig
from repro.core.quant import delta_pot as jdp
from repro.core.quant.policy import QuantPolicy as JQuantPolicy
from repro.core.quant.policy import fake_quantize_tree as j_fake_tree
from repro.core.quant.serving import pack_params as j_pack
from repro.core.quant.serving import unpack_params as j_unpack_params
from repro.kernels.common import exact_jit
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import build_serve_step as j_build_serve_step
from repro.models.registry import get_model as j_get_model
from repro_torch.core.quant.serving import (
    is_packed_leaf, unpack_params)
from repro_torch.kernels.dpot_matmul import dpot_matmul, dpot_matmul_w4
from repro_torch.launch import serve as t_serve
from repro_torch.launch.steps import build_serve_step, build_step_for_cell
from repro_torch.models.registry import get_model as t_get_model
from repro_torch.tree import keystr, leaves_with_path

B, S, STEPS = 2, 16, 8
ARCHS = ["rwkv4-169m", "rwkv6-7b", "smollm-135m"]


def _state_leaves(state):
    return dict((keystr(p), l) for p, l in leaves_with_path(state))


def _jax_quantized_step(jm, arch):
    """JAX's quantized serve step, compiled with the trace's roundings
    (`xla_allow_excess_precision=False`, as `exact_jit` compiles: plain
    jit elides bf16 roundings that eager torch makes).  For rwkv4 and
    rwkv6 it is `build_serve_step(variant="quantized")`'s own program on
    a 1x1 host mesh; for smollm that program fails under jax 0.9's
    explicit-sharding mesh (a ShardingTypeError at `layers.py:226`'s
    KV-cache write, the version gap of ROADMAP "Reference status"), so
    smollm takes the step's body, decode_step(unpack_params(p)), without
    the mesh."""
    if arch == "smollm-135m":
        return exact_jit(lambda p, s, t, pos: jm.decode_step(
            j_unpack_params(p), s, t, pos))
    jitted, _, _ = j_build_serve_step(jm, make_host_mesh(),
                                      ShapeConfig("d", S, B, "decode"),
                                      variant="quantized")
    cache = {}

    def step(*args):
        if "c" not in cache:
            cache["c"] = jitted.lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return cache["c"](*args)
    return step


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_serve_step_matches_jax(rng, arch):
    """Teacher forced for STEPS tokens from the fresh state, each side
    carrying its own state, on the same packed W8 tree (JAX's
    pack_params, bridged): every step's logits and state leaves."""
    jm = j_get_model(arch, smoke=True)
    tm = t_get_model(arch, smoke=True)
    jp = j_pack(jm.init_params(jax.random.PRNGKey(0)))
    tp = to_port(jp)
    jstep = _jax_quantized_step(jm, arch)
    tstep = build_serve_step(tm, variant="quantized")
    js = jm.init_decode_state(B, S)
    ts = tm.init_decode_state(B, S, device="cpu")
    toks = rng.integers(0, jm.cfg.vocab, (STEPS, B, 1)).astype(np.int32)
    for i in range(STEPS):
        jl, js = jstep(jp, js, jnp.asarray(toks[i]), jnp.int32(i))
        tl, ts = tstep(tp, ts, torch.from_numpy(toks[i]), i)
        assert tuple(tl.shape) == jl.shape == (B, 1, jm.cfg.vocab)
        assert_close(jl, tl, f"{arch} logits step {i}")
        jflat = {jax.tree_util.keystr(k): v for k, v in
                 jax.tree_util.tree_flatten_with_path(js)[0]}
        tflat = _state_leaves(ts)
        assert sorted(jflat) == sorted(tflat)
        for k, v in jflat.items():
            assert_close(v, tflat[k], f"{arch} state {k} step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_step_equals_base_on_unpacked(rng, arch):
    """The quantized step on the packed tree equals the base step on
    unpack_params of it, bit for bit, logits and state, over 3 steps."""
    tm = t_get_model(arch, smoke=True)
    packed = to_port(j_pack(j_get_model(arch, smoke=True).init_params(
        jax.random.PRNGKey(1))))
    plain = unpack_params(packed)
    q, base = (build_serve_step(tm, variant="quantized"),
               build_serve_step(tm))
    sq = tm.init_decode_state(B, S, device="cpu")
    sb = tm.init_decode_state(B, S, device="cpu")
    for i in range(3):
        tok = torch.from_numpy(rng.integers(0, tm.cfg.vocab, (B, 1)).astype(
            np.int32))
        lq, sq = q(packed, sq, tok, i)
        lb, sb = base(plain, sb, tok, i)
        assert torch.equal(lq, lb)
        for (_, a), (_, b) in zip(leaves_with_path(sq),
                                  leaves_with_path(sb)):
            assert torch.equal(a, b)


def test_unpack_params_stacked_per_layer_is_bitwise():
    """unpack_leaf decodes a stacked leaf one layer at a time: the bits
    equal a whole-plane decode, for W8 and W4 planes with a shared (1, 1,
    N) scale and with per-layer (L, 1, N) scales."""
    from repro_torch.core.quant.serving import (
        _decode_plane, broadcast_packed_scales, pack_leaf, unpack_leaf)
    from repro_torch.core.quant.policy import PLANE_W4
    g = torch.Generator().manual_seed(0)
    w = torch.randn((3, 16, 12), generator=g)
    for leaf in (pack_leaf("['blocks']['wk']", w),
                 pack_leaf("['blocks']['wk']", w, PLANE_W4)):
        for lf in (leaf, broadcast_packed_scales({"x": leaf}, 3)["x"]):
            plane = "w4" if "packed4" in lf else "w8"
            codes = lf["packed4" if plane == "w4" else "packed"]
            whole = _decode_plane(plane, codes, lf["scale"])
            got = unpack_leaf(lf)
            assert got.dtype == torch.bfloat16
            assert torch.equal(got.view(torch.int16),
                               whole.view(torch.int16))


def test_step_for_cell_quantized():
    """build_step_for_cell(..., serve_variant="quantized"): the kind, and
    packed_abstract's meta tree as the step's parameters at the decode
    cell's batch (rwkv6-7b at full size: shapes only)."""
    step, (params, state, tok, pos), kind = build_step_for_cell(
        "rwkv6-7b", "decode_32k", serve_variant="quantized")
    assert kind == "serve_step[quantized]" and callable(step)
    wk = params["blocks"]["ffn"]["wk"]
    assert wk["packed"].device.type == "meta"
    assert tuple(wk["packed"].shape) == (32, 4096, 14336)
    assert wk["packed"].dtype == torch.uint8
    assert tuple(wk["scale"].shape) == (1, 1, 14336)
    assert tuple(tok.shape) == (128, 1)
    leaves = [l for _, l in leaves_with_path(params,
                                             is_leaf=is_packed_leaf)]
    assert sum(map(is_packed_leaf, leaves)) == 16
    assert all(l.dtype == torch.bfloat16 and l.device.type == "meta"
               for l in leaves if not is_packed_leaf(l))
    _, _, kind = build_step_for_cell("rwkv6-7b", "decode_32k")
    assert kind == "serve_step[base]"


def test_serve_step_variants_refused():
    tm = t_get_model("rwkv4-169m", smoke=True)
    with pytest.raises(NotImplementedError, match="item 10"):
        build_serve_step(tm, variant="replicated")
    with pytest.raises(ValueError):
        build_serve_step(tm, variant="w4")


def test_serve_legacy_quantized(monkeypatch, capsys):
    """serve_legacy(quantized=True) fake-quantizes its tree under
    QuantPolicy() (the tree held against JAX's fake_quantize_tree of the
    same weights: the exact-level model of JAX's codes bit for bit, JAX
    within 2^-20, the additive leaves as jax.jit's) and decodes its
    tokens from it; the CLI's --legacy --quantized reaches it."""
    seen = {}
    real = t_serve.fake_quantize_tree

    def spy(params, policy):
        seen["in"], seen["out"] = params, real(params, policy)
        return seen["out"]
    monkeypatch.setattr(t_serve, "fake_quantize_tree", spy)
    toks = t_serve.serve_legacy("rwkv4-169m", smoke=True, batch=2,
                                n_tokens=4, quantized=True, device="cpu")
    assert tuple(toks.shape) == (2, 5)
    assert "quantized (Δ-PoT W9/A9 policy)" in capsys.readouterr().out
    # the tokens come from the fake-quantized tree
    tm = t_get_model("rwkv4-169m", smoke=True)
    state = tm.init_decode_state(2, 12, device="cpu")
    want, _ = t_serve.greedy_decode(tm, seen["out"], state, toks[:, :1], 4)
    assert torch.equal(toks, want)
    # the tree against JAX's fake_quantize_tree of the same weights
    jin = jax.tree_util.tree_map(
        lambda t: jnp.asarray(f32(t)), seen["in"])
    jout = j_fake_tree(jin, JQuantPolicy())
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jout)[0]}
    jin_flat = {jax.tree_util.keystr(k): v for k, v in
                jax.tree_util.tree_flatten_with_path(jin)[0]}
    from repro.core.quant.policy import classify_param, uniform_fake_quant
    for path, got in leaves_with_path(seen["out"]):
        key = keystr(path)
        ref = f32(jflat[key]).astype(np.float64)
        g = f32(got).astype(np.float64)
        assert bool((np.abs(g - ref) <= 2.0 ** -20 * np.abs(ref)).all()), key
        if classify_param(key, jin_flat[key]) == "matmul":
            q = jdp.dpot_quantize(jin_flat[key], jdp.FORMAT_W9, axis=-1)
            lvl = jdp._level_table_np(q.ks).astype(np.float32)[
                np.asarray(q.codes, np.int64)]
            exact = (np.asarray(q.signs).astype(np.float32) * lvl
                     * np.asarray(q.scale)).astype(np.float32)
            np.testing.assert_array_equal(f32(got), exact, err_msg=key)
        else:
            want = jax.jit(lambda v: uniform_fake_quant(v, 9, None))(
                jin_flat[key])
            np.testing.assert_array_equal(f32(got), f32(want), err_msg=key)
    monkeypatch.undo()
    t_serve.main(["--legacy", "--quantized", "--smoke", "--device", "cpu",
                  "--batch", "2", "--tokens", "2"])
    out = capsys.readouterr().out
    assert "quantized (Δ-PoT W9/A9 policy)" in out and "tok/s" in out


def test_dpot_matmul_wrappers_raise_off_cpu():
    """K1 and K8 on tensors that are not on the CPU go to their kernels
    or raise; they never fall back to the plain versions (meta tensors
    stand in for a device here: without nvcc the build raises)."""
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,
                                                    device="meta")
    before = (dpot_matmul.launches, dpot_matmul_w4.launches)
    with pytest.raises((RuntimeError, NotImplementedError)):
        dpot_matmul(meta(4, 8), meta(8, 6, dt=torch.uint8), meta(6))
    with pytest.raises((RuntimeError, NotImplementedError)):
        dpot_matmul_w4(meta(4, 8, dt=torch.bfloat16),
                       meta(4, 6, dt=torch.uint8), meta(6))
    with pytest.raises(ValueError):
        dpot_matmul(meta(4, 8), meta(9, 6, dt=torch.uint8), meta(6))
    with pytest.raises(TypeError):
        dpot_matmul(meta(4, 8, dt=torch.float16),
                    meta(8, 6, dt=torch.uint8), meta(6))
    with pytest.raises(ValueError):
        dpot_matmul_w4(meta(4, 7), meta(4, 6, dt=torch.uint8), meta(6))
    assert (dpot_matmul.launches, dpot_matmul_w4.launches) == before
