"""The port's analysis tools against the JAX package's, on the CPU.

`launch/op_analysis.py` counts a call op by op; each hand-written kernel
records its own FLOPs through its wrapper's hook.  Held here:
  * each kernel's FLOPs equal `repro.launch.hlo_analysis.analyze_text` of
    the JAX function the port's tests hold it against, at a smoke shape,
    exactly (FLOP counts are integers; no tolerance): the Pallas matmuls
    in interpret mode for K1, K8 and K5's forms, `wkv4_ref`, `wkv6_scan`
    and `wkv6_chunked` and their VJPs (`jax.vjp`, the backward function
    alone) for K2, K6, K10 and their backward kernels, the Pallas
    LayerNorm, cross-entropy and EXP-σ kernels in interpret mode,
    `flash_attention_ref` and its VJP for K13, K13-dq (the VJP in q) and
    K13-dkv (in k and v), and the fused decode steps for K3, K4 and K7;
  * a smoke prefill step's FLOPs, for rwkv4-169m, smollm-135m and
    rwkv6-7b, against `analyze_text` of JAX's `build_prefill_step` on
    `make_host_mesh()`, within 1% (read: equal);
  * the bytes of a toy chain against a hand count (JAX's fusion
    boundaries differ from eager ops, so bytes are not compared with it);
  * the count of a smoke cell on the CPU equals its count on meta tensors,
    op for op, train steps included (under a count the CPU takes the
    kernels' autograd Functions);
  * `model_flops_estimate` against JAX's for every port config, the
    roofline terms against a hand computation with the H100 constants;
  * `run_cell` on one smoke cell per family and its skips;
  * the dry-run stubs (`cfg.wkv_stub`, `cfg.attn_stub`): the smoke
    forward of each equals JAX's forward of the same stub config on the
    same bridged weights within port_helpers' rule (max |d| <= 2^-5
    max|ref|, mean |d| <= 2^-8 mean|ref|).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from port_helpers import assert_close, to_port

from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import get_config as j_get_config
from repro.core.wkv.wkv4 import wkv4_scan as j_wkv4_scan
from repro.core.wkv.wkv6 import wkv6_chunked as j_chunked
from repro.core.wkv.wkv6 import wkv6_scan as j_scan
from repro.kernels.common import exact_jit
from repro.kernels.expsig import exp_kernel as j_exp
from repro.kernels.expsig import sigmoid_kernel as j_sigmoid
from repro.kernels.fused_ce import fused_cross_entropy as j_ce
from repro.kernels.fused_layernorm import fused_layernorm as j_layernorm
from repro.launch.hlo_analysis import analyze_text
from repro.launch.mesh import make_host_mesh
from repro.launch.roofline import model_flops_estimate as j_model_flops
from repro.launch.steps import build_prefill_step as j_build_prefill_step
from repro.models.registry import Model as JModel
from repro.models.registry import get_model as j_get_model
from repro_torch.configs import base as CB
from repro_torch.kernels import ops
from repro_torch.kernels.expsig import exp_kernel, sigmoid_kernel
from repro_torch.kernels.fused_ce import (
    fused_cross_entropy, fused_cross_entropy_bwd)
from repro_torch.kernels.fused_decode import rwkv6_block_decode
from repro_torch.kernels.fused_layernorm import (
    fused_layernorm, fused_layernorm_bwd)
from repro_torch.kernels.fused_prefill import (
    dpot_w4_matmul, dpot_w4_matmul_f32x, dpot_w8_matmul, dpot_w8_matmul_f32x,
    vq_matmul, vq_matmul_f32x)
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_dkv, flash_attention_dq)
from repro_torch.kernels.wkv4 import wkv4_seq, wkv4_seq_bwd
from repro_torch.kernels.wkv6 import (
    chunk_length, wkv6_chunked_bwd, wkv6_chunked_kernel, wkv6_seq,
    wkv6_seq_bwd)
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.op_analysis import OpCount, analyze_call
from repro_torch.launch.steps import (
    build_prefill_step, build_step_for_cell, build_train_step)
from repro_torch.models.registry import Model, get_model

# the package re-exports functions under its submodules' names
j_dpot = importlib.import_module("repro.kernels.dpot_matmul")
j_prefill = importlib.import_module("repro.kernels.fused_prefill")
j_ref = importlib.import_module("repro.kernels.ref")
RNG = np.random.default_rng(0)


def _jflops(fn, *args) -> float:
    return analyze_text(jax.jit(fn).lower(*args).compile().as_text()).flops


def _jvjp_flops(fn, primals, cotangent) -> float:
    """The dots of JAX's VJP of `fn` at `primals`: the backward function
    alone, its residuals closed over."""
    _, vjp = jax.vjp(fn, *primals)
    return _jflops(lambda c: vjp(c), cotangent)


def _count(fn, *args, **kw):
    """(the call's result, the one kernel op it recorded)."""
    with OpCount() as oc:
        out = fn(*args, **kw)
    (name, launches), = oc.metrics.kernels.items()
    return out, oc.metrics.ops[name], name


def _f32(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --- each kernel's FLOPs against its JAX reference -------------------------

M, K, N = 8, 64, 64


def _planes():
    wq = RNG.integers(0, 256, (K, N), dtype=np.uint8)
    wq4 = RNG.integers(0, 256, (K // 2, N), dtype=np.uint8)
    scale = RNG.random(N).astype(np.float32)
    cb = RNG.standard_normal(256).astype(np.float32)
    return wq, wq4, scale, cb


@pytest.mark.parametrize("name", ["K1", "K8", "K5", "K5-W4", "K5-VQ",
                                  "K5-f32x", "K5-W4-f32x", "K5-VQ-f32x"])
def test_matmul_flops_equal_jax(name):
    wq, wq4, scale, cb = _planes()
    x = _f32(M, K)
    xb = jnp.asarray(x, jnp.bfloat16)
    bf = jnp.bfloat16
    jax_ref = {
        "K1": lambda: _jflops(j_dpot.dpot_matmul, xb, jnp.asarray(wq),
                              jnp.asarray(scale)),
        "K8": lambda: _jflops(j_dpot.dpot_matmul_w4, xb, jnp.asarray(wq4),
                              jnp.asarray(scale)),
        "K5": lambda: _jflops(lambda a, b, c: j_prefill.dpot_chunk_matmul(
            a, b, c, dt=bf), xb, jnp.asarray(wq), jnp.asarray(scale)),
        "K5-W4": lambda: _jflops(lambda a, b, c: j_prefill.w4_chunk_matmul(
            a, b, c, dt=bf), xb, jnp.asarray(wq4), jnp.asarray(scale)),
        "K5-VQ": lambda: _jflops(lambda a, b, c: j_prefill.vq_chunk_matmul(
            a, b, c, dt=bf), xb, jnp.asarray(wq), jnp.asarray(cb, bf)),
    }
    for base in ("K5", "K5-W4", "K5-VQ"):
        jax_ref[base + "-f32x"] = jax_ref[base]
    xt = _t(x).to(torch.bfloat16)
    x32 = _t(x)
    cbt = _t(cb).to(torch.bfloat16)
    port = {
        "K1": lambda: ops.dpot_matmul(xt, _t(wq), _t(scale)),
        "K8": lambda: ops.dpot_matmul_w4(xt, _t(wq4), _t(scale)),
        "K5": lambda: dpot_w8_matmul(xt, _t(wq), _t(scale)),
        "K5-W4": lambda: dpot_w4_matmul(xt, _t(wq4), _t(scale)),
        "K5-VQ": lambda: vq_matmul(xt, _t(wq), cbt),
        "K5-f32x": lambda: dpot_w8_matmul_f32x(x32, _t(wq), _t(scale)),
        "K5-W4-f32x": lambda: dpot_w4_matmul_f32x(x32, _t(wq4), _t(scale)),
        "K5-VQ-f32x": lambda: vq_matmul_f32x(x32, _t(wq), cbt),
    }
    out, stat, _ = _count(port[name])
    assert stat.flops == jax_ref[name]() == 2 * M * N * K
    assert stat.count == 1 and tuple(out.shape) == (M, N)


def test_wkv4_flops_equal_jax():
    """K2 and K2-bwd: JAX's recurrence has no dot, forward or VJP."""
    B, T, C = 2, 8, 16
    k, v, gy = (_f32(B, T, C) for _ in range(3))
    w, u = RNG.random(C).astype(np.float32), _f32(C)
    z = np.zeros((B, C), np.float32)
    o0 = np.full((B, C), -1e38, np.float32)
    want = _jflops(lambda *a: j_ref.wkv4_ref(*a), k, v, w, u, z, z, o0)
    want_bwd = _jvjp_flops(lambda k, v, w, u: j_wkv4_scan(k, v, w, u)[0],
                           (k, v, w, u), gy)
    args = [_t(a) for a in (k, v, w, u, z, z, o0)]
    _, fwd, _ = _count(wkv4_seq, *args)
    _, bwd, _ = _count(wkv4_seq_bwd, *args, _t(gy))
    assert fwd.flops == want == 0 and bwd.flops == want_bwd == 0


def _wkv6_inputs(B, T, H, N):
    r, k, v, gy = (_f32(B, T, H, N) for _ in range(4))
    w = (RNG.random((B, T, H, N)) * 0.5 + 0.4).astype(np.float32)
    return r, k, v, w, _f32(H, N), gy


@pytest.mark.parametrize("shape", [(2, 8, 2, 16), (1, 12, 4, 32)])
def test_wkv6_seq_flops_equal_jax(shape):
    """K6 and K6-bwd: `wkv6_scan`'s r·S contraction, and its VJP's."""
    r, k, v, w, u, gy = _wkv6_inputs(*shape)
    want = _jflops(lambda *a: j_scan(*a)[0], r, k, v, w, u)
    want_bwd = _jvjp_flops(lambda *a: j_scan(*a)[0], (r, k, v, w, u), gy)
    B, T, H, N = shape
    s0 = torch.zeros((B, H, N, N))
    args = [_t(a) for a in (r, k, v, w, u)]
    _, fwd, _ = _count(wkv6_seq, *args, s0)
    _, bwd, _ = _count(wkv6_seq_bwd, *args, s0, _t(gy))
    assert fwd.flops == want == 2 * B * T * H * N * N
    assert bwd.flops == want_bwd


# (B, T, H, N): one sub-chunk a chunk (C 16), four (C 64; one chunk and
# two), and a chunk halved to fit T (96 -> 32, two sub-chunks).  H >= 2 and an
# initial state given: at H = 1 XLA rewrites some of the reference's
# contractions as reductions, and against a zero initial state it folds
# the first chunk's state product away; either is counted as no dot.  The
# reference returns y and the final state, as K10 does.
@pytest.mark.parametrize("shape", [(1, 32, 2, 16), (2, 64, 2, 32),
                                   (1, 128, 2, 16), (1, 96, 2, 16)])
def test_wkv6_chunked_flops_equal_jax(shape):
    """K10 and K10-bwd: `wkv6_chunked`'s einsums at K10's chunk, and the
    dots of its VJP (the initial state taking no gradient)."""
    B, T, H, N = shape
    r, k, v, w, u, gy = _wkv6_inputs(*shape)
    s0 = _f32(B, H, N, N)
    chunk = 64 if T != 32 else 16
    C = chunk_length(T, chunk)
    fn = lambda *a: j_chunked(*a, state=s0, chunk=C)
    want = _jflops(fn, r, k, v, w, u)
    want_bwd = _jvjp_flops(lambda *a: fn(*a)[0], (r, k, v, w, u), gy)
    args = [_t(a) for a in (r, k, v, w, u)]
    _, fwd, _ = _count(wkv6_chunked_kernel, *args, _t(s0), chunk=chunk)
    _, bwd, _ = _count(wkv6_chunked_bwd, *args, _t(gy), _t(s0),
                       chunk=chunk)
    assert (fwd.flops, bwd.flops) == (want, want_bwd)


def test_norm_ce_expsig_flops_equal_jax():
    """K11, K12, K9 and the backward of K11 and K12: no dot in JAX's
    kernels (interpret mode) or in the VJPs of their references."""
    x, g, b = _f32(16, 64), _f32(64), _f32(64)
    lab = RNG.integers(0, 64, 16).astype(np.int32)
    dy = _f32(16, 64)
    want = {
        "ln": _jflops(j_layernorm, x, g, b),
        "ln_bwd": _jvjp_flops(j_ref.fused_layernorm_ref, (x, g, b), dy),
        "ce": _jflops(j_ce, x, lab),
        "ce_bwd": _jvjp_flops(lambda a: j_ce(a, lab), (x,), _f32(16)),
        "exp": _jflops(j_exp, x), "sigmoid": _jflops(j_sigmoid, x)}
    tx, tg, tb = _t(x), _t(g), _t(b)
    lse = torch.logsumexp(tx, -1)
    got = {
        "ln": _count(fused_layernorm, tx, tg, tb)[1].flops,
        "ln_bwd": _count(fused_layernorm_bwd, tx, tg, tb, _t(dy))[1].flops,
        "ce": _count(fused_cross_entropy, tx, _t(lab))[1].flops,
        "ce_bwd": _count(fused_cross_entropy_bwd, tx, _t(lab), lse,
                         torch.ones(16))[1].flops,
        "exp": _count(exp_kernel, tx)[1].flops,
        "sigmoid": _count(sigmoid_kernel, tx)[1].flops}
    assert got == want == dict.fromkeys(want, 0.0)


@pytest.mark.parametrize("shape", [(1, 128, 2, 1, 16), (2, 64, 4, 2, 32)])
def test_attention_flops_equal_jax(shape):
    """K13: `flash_attention_ref`'s dots; K13-dq: its VJP in q (dp, dq);
    K13-dkv: its VJP in k and v (dp, dv, dk)."""
    B, S, H, KVH, d = shape
    q, do = _f32(B, S, H, d), _f32(B, S, H, d)
    k, v = _f32(B, S, KVH, d), _f32(B, S, KVH, d)
    ref = lambda a, b, c: j_ref.flash_attention_ref(a, b, c, True)
    want = _jflops(ref, q, k, v)
    want_dq = _jvjp_flops(lambda a: ref(a, k, v), (q,), do)
    want_dkv = _jvjp_flops(lambda b, c: ref(q, b, c), (k, v), do)
    tq, tk, tv, tdo = (_t(a) for a in (q, k, v, do))
    (o, lse), fwd, _ = _count(flash_attention, tq, tk, tv, return_lse=True)
    _, dq, _ = _count(flash_attention_dq, tq, tk, tv, o, lse, tdo)
    _, dkv, _ = _count(flash_attention_dkv, tq, tk, tv, o, lse, tdo)
    X = B * H * S * S * d
    assert (fwd.flops, dq.flops, dkv.flops) == (want, want_dq, want_dkv) \
        == (4 * X, 4 * X, 6 * X)


def _port_products(metrics) -> float:
    """The aten ops' products in a count (what is not a kernel's)."""
    return metrics.flops - sum(metrics.ops[k].flops for k in metrics.kernels)


@pytest.mark.parametrize("arch,path,kernel", [
    ("rwkv4-169m", "decode_step_fused", "rwkv4_block_decode"),
    ("rwkv4-169m", "decode_step_fused_model", "rwkv4_model_decode"),
    ("rwkv6-7b", "decode_step_fused", "rwkv6_block_decode"),
    ("rwkv6-7b", "decode_step_fused_model", "rwkv6_model_decode")])
def test_decode_kernel_flops_equal_jax(arch, path, kernel):
    """K3, K4 and K7: the fused decode step's FLOPs equal JAX's fused
    step's, the kernel's share being all but the head's product."""
    B = 4
    jm = j_get_model(arch, smoke=True)
    jp = jm.init_params(jax.random.PRNGKey(0))
    jst = jm.init_decode_state(B, 0)
    tok = jnp.zeros((B, 1), jnp.int32)
    want = _jflops(lambda p, s, t: getattr(jm, path)(p, s, t, 0), jp, jst,
                   tok)
    tm = get_model(arch, smoke=True)
    params = tm.init_params(0, "cpu")
    if path == "decode_step_fused_model":
        params = tm.prepare_fused_model_params(params)
    m = analyze_call(getattr(tm, path), params,
                     tm.init_decode_state(B, 0, device="cpu"),
                     torch.zeros((B, 1), dtype=torch.int32), 0)
    cfg = tm.cfg
    head = 2 * B * cfg.d_model * cfg.vocab
    assert m.flops == want
    assert _port_products(m) == head
    assert m.ops[kernel].flops == want - head
    assert m.kernels[kernel] == (1 if "model" in path else cfg.n_layers)


def test_k7_records_one_launch_a_tile():
    """K7 launches once per 8-lane tile, as its `.launches` counts."""
    tm = get_model("rwkv6-7b", smoke=True)
    from repro_torch.models.rwkv4 import _layer
    params = tm.cast_params(tm.init_params(0, "cpu"))
    lp = _layer(params["blocks"], 0)
    st = tm.init_decode_state(16, 0, device="cpu")
    st0 = {k: v[0] for k, v in st.items()}
    x = torch.zeros((16, tm.cfg.d_model), dtype=torch.bfloat16)
    _, stat, _ = _count(rwkv6_block_decode, lp, st0, x, tm.cfg)
    assert stat.count == 2


# --- whole steps against JAX's ----------------------------------------------

@pytest.mark.parametrize("arch", ["rwkv4-169m", "smollm-135m", "rwkv6-7b"])
def test_prefill_step_flops_equal_jax(arch):
    """A smoke prefill step (B 2, S 64): the port's count against
    `analyze_text` of JAX's `build_prefill_step` on the host mesh, within
    1%."""
    B, S = 2, 64
    jitted, args, _ = j_build_prefill_step(
        j_get_model(arch, smoke=True), make_host_mesh(),
        JShape("p", S, B, "prefill"))
    want = analyze_text(jitted.lower(*args).compile().as_text()).flops
    tm = get_model(arch, smoke=True)
    got = analyze_call(build_prefill_step(tm), tm.abstract_params(),
                       {"tokens": torch.empty((B, S), dtype=torch.int32,
                                              device="meta")})
    assert abs(got.flops - want) <= 0.01 * want
    assert got.flop_counter_flops <= got.flops


def test_bytes_hand_count():
    """mm (8x16 @ 16x4, f32), add (8x4 + 8x4), view: the mm reads 512 +
    256 and writes 128 bytes, the add reads 256 and writes 128; the view
    is free."""
    a, b, c = torch.ones(8, 16), torch.ones(16, 4), torch.ones(8, 4)

    def chain(a, b, c):
        return (a @ b + c).view(32)

    m = analyze_call(chain, a, b, c)
    assert m.hbm_bytes == (8 * 16 + 16 * 4 + 8 * 4) * 4 + 3 * 8 * 4 * 4
    assert m.flops == 2 * 8 * 16 * 4 == m.flop_counter_flops
    assert set(m.ops) == {"mm", "add"}
    assert m.ops["mm"].bytes == (128 + 64 + 32) * 4
    assert m.coll_bytes == 0 and m.loops == []
    assert m.argument_bytes == (128 + 64 + 32) * 4 and m.output_bytes == 128


def test_stack_keys_by_model_line():
    tm = get_model("rwkv4-169m", smoke=True)
    m = analyze_call(build_prefill_step(tm), tm.abstract_params(),
                     {"tokens": torch.empty((2, 16), dtype=torch.int32,
                                            device="meta")}, stack=True)
    lines = [k for k in m.ops if k.startswith("models/")]
    assert any(k.startswith("models/rwkv4.py:") for k in lines)
    assert sum(s.flops for s in m.ops.values()) == m.flops


def _meta_like(tree):
    return jax.tree_util.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def _cells():
    B, S = 2, 128
    out = []
    for arch in ("rwkv4-169m", "rwkv6-7b", "smollm-135m"):
        out += [(arch, "prefill", B, S), (arch, "train", B, S)]
    out += [("rwkv6-7b", "train", 2, 40)]          # K6 and K6-bwd
    return out


@pytest.mark.parametrize("arch,kind,B,S", _cells())
def test_count_is_device_independent(arch, kind, B, S):
    """The same smoke cell counted on CPU tensors and on meta tensors:
    the same op table, op for op, and the same kernel launches."""
    tm = get_model(arch, smoke=True)
    toks = torch.randint(0, tm.cfg.vocab, (B, S), dtype=torch.int32)
    if kind == "prefill":
        step = build_prefill_step(tm)
        cpu = (tm.init_params(0, "cpu"), {"tokens": toks})
    else:
        step, _, (init_opt, _) = build_train_step(
            tm, CB.ShapeConfig("c", S, B, "train"))
        p = tm.init_params(0, "cpu")
        cpu = (p, init_opt(p), {"tokens": toks, "labels": toks})
    meta = tuple(_meta_like(a) for a in cpu)
    mc, mm = analyze_call(step, *cpu), analyze_call(step, *meta)
    assert mc.ops == mm.ops
    assert mc.kernels == mm.kernels
    L = tm.cfg.n_layers
    if arch.startswith("rwkv"):
        # ln0, two a layer, ln_f; remat runs each layer's two again
        assert mc.kernels["fused_layernorm"] == 2 * L + 2 + (
            2 * L if kind == "train" and tm.cfg.remat else 0)


def test_no_launch_counter_moves_under_a_count():
    """On CPU and meta tensors nothing launches: every wrapper's
    `.launches` stays where it was while the count records the ops."""
    wrappers = (fused_layernorm, wkv4_seq, wkv4_seq_bwd,
                fused_layernorm_bwd, fused_cross_entropy,
                fused_cross_entropy_bwd)
    before = [w.launches for w in wrappers]
    tm = get_model("rwkv4-169m", smoke=True)
    step, args, _ = build_train_step(tm, CB.ShapeConfig("c", 16, 2, "train"))
    m = analyze_call(step, *args[:2], {k: torch.empty(
        (2, 16), dtype=torch.int32, device="meta")
        for k in ("tokens", "labels")})
    assert m.kernels["wkv4_seq_bwd"] == tm.cfg.n_layers
    assert [w.launches for w in wrappers] == before


# --- roofline ----------------------------------------------------------------

@pytest.mark.parametrize("arch", CB.list_configs())
def test_model_flops_estimate_equals_jax(arch):
    cfg, jcfg = CB.get_config(arch), j_get_config(arch)
    for kind, tokens in (("train", 4096 * 256), ("prefill", 32768 * 32),
                         ("decode", 128)):
        assert roofline.model_flops_estimate(cfg, kind, tokens) == \
            j_model_flops(jcfg, kind, tokens)


def test_model_flops_moe_waits():
    cfg = dataclasses.replace(CB.get_config("smollm-135m"), n_experts=8)
    with pytest.raises(NotImplementedError, match="9a"):
        roofline.model_flops_estimate(cfg, "train", 1)


def test_roofline_terms_by_hand():
    from repro_torch.launch.op_analysis import OpMetrics
    m = OpMetrics(flops=989e9, hbm_bytes=6.7e9, flop_counter_flops=5.0)
    r = roofline.analyze(m, chips=1, model_flops=494.5e9)
    assert r.compute_s == pytest.approx(1e-3)
    assert r.memory_s == pytest.approx(2e-3)
    assert r.collective_s == 0 and r.bottleneck == "memory"
    assert r.useful_ratio == pytest.approx(0.5) and r.xla_flops == 5.0
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NVLINK_BW) == (
        989e12, 3.35e12, 900e9)
    m.coll_bytes = 9e9
    assert roofline.analyze(m).bottleneck == "collective"


# --- the dry run ---------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [("rwkv4-169m", "prefill_32k"),
                                        ("rwkv6-7b", "train_4k"),
                                        ("smollm-135m", "decode_32k")])
def test_run_cell_ok(arch, shape):
    rec = dryrun.run_cell(arch, shape, smoke=True, save=False)
    assert rec["status"] == "ok", rec
    assert (rec["mesh"], rec["chips"], rec["arch"], rec["shape"]) == (
        "single", 1, arch, shape)
    r = rec["roofline"]
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert r["flops"] > 0 and r["hbm_bytes"] > 0 and r["model_flops"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0


def test_run_cell_skips():
    dense = dryrun.run_cell("smollm-135m", "long_500k", smoke=True,
                            save=False)
    assert dense["status"] == "skip" and "sub-quadratic" in dense["reason"]
    other = dryrun.run_cell("zamba2-7b", "train_4k", smoke=True, save=False)
    assert other == {"cell": "zamba2-7b__train_4k__single",
                     "status": "skip", "reason": dryrun.NOT_PORTED}
    assert set(CB.ASSIGNED_ARCHS) >= {"rwkv6-7b", "smollm-135m"}
    assert len(CB.ASSIGNED_ARCHS) == 10 and len(CB.RWKV4_ARCHS) == 5
    for arch in CB.list_configs():
        assert CB.supported_shapes(CB.get_config(arch))["long_500k"] == (
            "ok" if arch.startswith("rwkv") else
            CB.supported_shapes(CB.get_config("smollm-135m"))["long_500k"])


# --- the stubs -----------------------------------------------------------

def _stub_forward(arch, field, S):
    jm0 = j_get_model(arch, smoke=True)
    jm = JModel(cfg=dataclasses.replace(jm0.cfg, **{field: True}),
                module=jm0.module)
    tm0 = get_model(arch, smoke=True)
    tm = Model(cfg=dataclasses.replace(tm0.cfg, **{field: True}),
               module=tm0.module)
    params = jm.init_params(jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, jm.cfg.vocab, (2, S))
    want = exact_jit(lambda p, t: jm.forward(p, {"tokens": t})[0])(
        params, jnp.asarray(toks, jnp.int32))
    with OpCount() as oc:
        got, _ = tm.forward(to_port(params),
                            {"tokens": torch.from_numpy(toks)})
    return want, got, oc.metrics


def test_wkv_stub_matches_jax():
    want, got, m = _stub_forward("rwkv4-169m", "wkv_stub", 48)
    assert_close(want, got, "rwkv4 wkv_stub")
    assert "wkv4_seq" not in m.kernels and m.kernels["fused_layernorm"] == 6


def test_attn_stub_matches_jax():
    want, got, m = _stub_forward("smollm-135m", "attn_stub", 64)
    assert_close(want, got, "smollm attn_stub")
    assert "bmm" not in m.ops           # no score or value product left
