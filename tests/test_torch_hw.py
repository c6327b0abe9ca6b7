"""Port vs JAX: rwkv4 under the paper's hardware numerics (LUT exp, PWL σ,
LUT division, A9 activations) on the smoke model, 8 lanes: the per-op
`decode_step(hw=True)`, the kernel paths (K3-hw per layer, K4-hw for all
layers, K2-hw and K9 in the chunked prefill; their plain versions on the
CPU), the prepared LUT stack and the legacy launcher.

Against JAX the port holds the `tests/port_helpers.py` rule, and each
trajectory prints the share of its outputs that are bit-equal: XLA's
`exp2` on the CPU is inexact at integers (`test_torch_approx.py`), and
one A9 scale moved by an ulp moves a whole tensor's codes.  Inside the
port, on the CPU, the kernel paths run the plain versions over the same
per-op body and are bit for bit equal to it, and so is the chunked
prefill to a scan of the per-op step with masked commits (JAX's K2 does
not run under jax 0.9, so the per-op comparison ties this chain to JAX).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from port_helpers import assert_close, f32, to_port
from repro.core.quant.serving import pack_params as j_pack
from repro.core.quant.serving import unpack_params as j_unpack_params
from repro.kernels.common import exact_jit
from repro.models import rwkv4 as J4
from repro.models.registry import get_model as j_get_model
from repro_torch.bridge import fused_stack_to_numpy
from repro_torch.core.approx.units import div_lut, exp_lut, lut_tensor
from repro_torch.core.quant.serving import pack_params as t_pack
from repro_torch.core.quant.serving import unpack_params as t_unpack_params
from repro_torch.core.wkv.wkv4 import WKV4State, wkv4_step
from repro_torch.kernels.expsig import sigmoid_kernel
from repro_torch.kernels.fused_decode import (
    HW_SCRATCH_FLOATS, rwkv4_block_decode, rwkv4_model_decode, stack_luts,
    stack_table, tile_plan)
from repro_torch.kernels.fused_prefill import dpot_w8_matmul_f32x
from repro_torch.kernels.wkv4 import wkv4_seq
from repro_torch.launch import serve as t_serve
from repro_torch.models import rwkv4 as T4
from repro_torch.models.registry import get_model as t_get_model
from repro_torch.models.rwkv4 import STATE_KEYS

B, STEPS, C = 8, 16, 8
PREFIX_LENS = (C, 5, 0, 1, C, 3, 7, C)


@pytest.fixture(scope="module")
def models():
    jm = j_get_model("rwkv4-169m", smoke=True)
    tm = t_get_model("rwkv4-169m", smoke=True)
    return jm, tm, jm.init_params(jax.random.PRNGKey(0))


def _trajectory(jm, tm, jp, tp, jstep, tstep, rng, what):
    """Teacher forced from the fresh state: every step's logits and state
    leaves to the port_helpers rule; prints the bit-equal share."""
    js = jm.init_decode_state(B, 0, jnp.bfloat16)
    ts = tm.init_decode_state(B, 0, device="cpu")
    toks = rng.integers(0, jm.cfg.vocab, (STEPS, B, 1)).astype(np.int32)
    same = total = 0
    for i in range(STEPS):
        jl, js = jstep(jp, js, jnp.asarray(toks[i]))
        tl, ts = tstep(tp, ts, torch.from_numpy(toks[i]))
        assert tuple(tl.shape) == jl.shape == (B, 1, jm.cfg.vocab)
        assert_close(jl, tl, f"logits step {i}")
        pairs = [(jl, tl)] + [(js[k], ts[k]) for k in STATE_KEYS]
        for k in STATE_KEYS:
            assert ts[k].dtype == torch.bfloat16
            assert_close(js[k], ts[k], f"{k} step {i}")
        for r, g in pairs:
            same += int((f32(r) == f32(g)).sum())
            total += f32(r).size
    print(f"{what}: {same / total:.4f} of {total} outputs bit-equal to JAX")


def _j_hw_step(jm, unpack):
    return exact_jit(lambda p, s, t: J4.decode_step(
        jm.cast_params(unpack(p)), s, t, jnp.int32(0), jm.cfg, hw=True))


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "w8"])
def test_decode_step_hw_matches_jax(models, quantized, rng):
    jm, tm, params = models
    jp = j_pack(params) if quantized else params
    j_un = j_unpack_params if quantized else (lambda p: p)
    t_un = t_unpack_params if quantized else (lambda p: p)
    tstep = lambda p, s, t: T4.decode_step(tm.cast_params(t_un(p)), s, t, 0,
                                           tm.cfg, hw=True)
    _trajectory(jm, tm, jp, to_port(jp), _j_hw_step(jm, j_un), tstep, rng,
                f"decode_step(hw) {'w8' if quantized else 'fp'}")


@pytest.mark.parametrize("path", ["block", "model", "model_bb2"])
def test_kernel_paths_hw_match_jax(models, path, rng):
    """decode_step_fused(hw=True) and decode_step_fused_model(hw=True) on
    packed W8 against JAX's same calls (the Pallas kernels in interpret
    mode, the model path on JAX's own prepared hw stack); bb = 2 tiles
    against JAX's bb = 2 (each tile its own A9 scale)."""
    jm, tm, params = models
    jp = j_pack(params)
    tp = to_port(jp)
    if path == "block":
        jstep = exact_jit(lambda p, s, t: J4.decode_step_fused(
            p, s, t, jnp.int32(0), jm.cfg, hw=True))
        tstep = lambda p, s, t: T4.decode_step_fused(p, s, t, 0, tm.cfg,
                                                     hw=True)
        _trajectory(jm, tm, jp, tp, jstep, tstep, rng, path)
        return
    bb = 2 if path == "model_bb2" else None
    jprep = jm.prepare_fused_model_params(jp, hw=True)
    tprep = tm.prepare_fused_model_params(tp, hw=True)
    jstep = exact_jit(lambda p, s, t: J4.decode_step_fused_model(
        p, s, t, jnp.int32(0), jm.cfg, hw=True, bb=bb))
    tstep = lambda p, s, t: T4.decode_step_fused_model(p, s, t, 0, tm.cfg,
                                                       hw=True, bb=bb)
    _trajectory(jm, tm, jprep, tprep, jstep, tstep, rng, path)


def test_kernel_paths_equal_per_op_on_cpu(models, rng):
    """On the CPU the K3-hw and K4-hw paths (prepared and raw) run their
    plain versions over the per-op body: bit for bit equal to
    decode_step(hw=True).  With bb = 2 the model path equals the per-op
    step run on each 2-lane tile alone."""
    _, tm, params = models
    tp = t_pack(to_port(params))
    plain = tm.cast_params(t_unpack_params(tp))
    prep = tm.prepare_fused_model_params(tp, hw=True)
    s = [tm.init_decode_state(B, 0, device="cpu") for _ in range(5)]
    for _ in range(3):
        toks = torch.from_numpy(
            rng.integers(0, tm.cfg.vocab, (B, 1)).astype(np.int32))
        ref = T4.decode_step(plain, s[0], toks, 0, tm.cfg, hw=True)
        outs = [T4.decode_step_fused(tp, s[1], toks, 0, tm.cfg, hw=True),
                T4.decode_step_fused_model(prep, s[2], toks, 0, tm.cfg,
                                           hw=True),
                T4.decode_step_fused_model(tp, s[3], toks, 0, tm.cfg,
                                           hw=True)]
        for lg, st in outs:
            assert torch.equal(lg, ref[0])
            assert all(torch.equal(st[k], ref[1][k]) for k in STATE_KEYS)
        lg4, st4 = T4.decode_step_fused_model(prep, s[4], toks, 0, tm.cfg,
                                              hw=True, bb=2)
        for i in range(0, B, 2):
            tile = {k: v[:, i:i + 2] for k, v in s[4].items()}
            lt, stt = T4.decode_step(plain, tile, toks[i:i + 2], 0, tm.cfg,
                                     hw=True)
            assert torch.equal(lg4[i:i + 2], lt)
            assert all(torch.equal(st4[k][:, i:i + 2], stt[k])
                       for k in STATE_KEYS)
        s = [ref[1], outs[0][1], outs[1][1], outs[2][1], st4]


def _random_state(tm, rng):
    st = tm.init_decode_state(B, 0, device="cpu")
    out = {}
    for k, v in st.items():
        vals = torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
        out[k] = (vals - 1.0 if k == "wkv_o" else vals).to(v.dtype)
    return out


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "w8"])
def test_prefill_chunk_hw_equals_masked_scan(models, quantized, rng):
    """prefill_chunk(hw=True) (K5, K5 f32-x on wo, K2-hw and K9's σ; plain
    on the CPU) against the per-op hw step scanned over the chunk with
    masked commits, from a random state, prefix lengths 0, 1, ..., C: bit
    for bit."""
    _, tm, params = models
    tp = to_port(params)
    if quantized:
        tp = t_pack(tp)
    plain = tm.cast_params(t_unpack_params(tp) if quantized else tp)
    state = _random_state(tm, rng)
    toks = torch.from_numpy(
        rng.integers(0, tm.cfg.vocab, (B, C)).astype(np.int32))
    valid = torch.zeros((B, C), dtype=torch.bool)
    for i, n in enumerate(PREFIX_LENS):
        valid[i, :n] = True
    st, lg = T4.prefill_chunk(tp, state, toks, valid, 0, tm.cfg, hw=True)
    so, last = state, torch.zeros_like(lg)
    for t in range(C):
        lt, sn = T4.decode_step(plain, so, toks[:, t:t + 1], 0, tm.cfg,
                                hw=True)
        ok = valid[:, t]
        so = {k: torch.where(ok[None, :, None], sn[k], so[k]) for k in so}
        last = torch.where(ok[:, None, None], lt, last)
    assert torch.equal(lg, last)
    assert all(torch.equal(st[k], so[k]) for k in STATE_KEYS)
    assert not lg[PREFIX_LENS.index(0)].any()


def test_k2_hw_plain_is_the_lut_step_loop(rng):
    """K2's plain version with both tables against a loop written here of
    the port's wkv4_step(exp=exp_lut, div=div_lut), each step committed
    where valid and the carry snapped through bf16: bit for bit.  Against
    JAX's wkv4_step with its own LUT units (jax.jit) the port_helpers
    rule holds (XLA's exp2)."""
    from repro.core.approx import div_lut as j_div, exp_lut as j_exp
    from repro.core.wkv.wkv4 import WKV4State as JState
    from repro.core.wkv.wkv4 import wkv4_step as j_step
    Bk, T, Ck = 4, 12, 64
    k, v = (rng.normal(size=(Bk, T, Ck)).astype(np.float32) for _ in "kv")
    w = np.exp(0.5 * rng.normal(size=Ck)).astype(np.float32)
    u = (0.5 * rng.normal(size=Ck)).astype(np.float32)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).float()
    a0 = bf(rng.normal(size=(Bk, Ck)).astype(np.float32))
    b0 = bf(np.abs(rng.normal(size=(Bk, Ck))).astype(np.float32) + 0.5)
    o0 = bf(rng.normal(size=(Bk, Ck)).astype(np.float32) - 1)
    valid = torch.zeros((Bk, T), dtype=torch.bool)
    for i, n in enumerate((T, 5, 0, 1)):
        valid[i, :n] = True
    tk, tv, tw, tu = map(torch.from_numpy, (k, v, w, u))
    tabs = {"exp_table": lut_tensor("exp", "cpu"),
            "div_table": lut_tensor("div", "cpu")}
    y, (af, bf_, of) = wkv4_seq(tk, tv, tw, tu, a0, b0, o0, valid=valid,
                                carry_dtype="bfloat16", **tabs)
    snap = lambda t: t.to(torch.bfloat16).float()
    a, b, o = a0, b0, o0
    for t in range(T):
        (na, nb, no), yt = wkv4_step(WKV4State(a, b, o), tk[:, t], tv[:, t],
                                     tw, tu, exp=exp_lut, div=div_lut)
        assert torch.equal(y[:, t], yt)
        ok = valid[:, t, None]
        a = snap(torch.where(ok, na, a))
        b = snap(torch.where(ok, nb, b))
        o = snap(torch.where(ok, no, o))
    assert torch.equal(af, a) and torch.equal(bf_, b) and torch.equal(of, o)

    @jax.jit
    def j_loop(k, v, a, b, o, valid):
        ys = []
        for t in range(T):
            (na, nb, no), yt = j_step(JState(a, b, o), k[:, t], v[:, t], w,
                                      u, exp=j_exp, div=j_div)
            ys.append(yt)
            ok = valid[:, t, None]
            sn = lambda n, c: jnp.where(ok, n, c).astype(
                jnp.bfloat16).astype(jnp.float32)
            a, b, o = sn(na, a), sn(nb, b), sn(no, o)
        return jnp.stack(ys, 1), (a, b, o)
    jy, jfin = j_loop(k, v, a0.numpy(), b0.numpy(), o0.numpy(),
                      valid.numpy())
    assert_close(jy, y, "y")
    for r, g in zip(jfin, (af, bf_, of)):
        assert_close(r, g, "final state")


def test_k2_tables_travel_together(rng):
    t = torch.zeros(2, 3, 8)
    s = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="together"):
        wkv4_seq(t, t, s[0], s[0], s, s, s,
                 exp_table=lut_tensor("exp", "cpu"))


def test_hw_stack_bridged_equals_port(models):
    """JAX's prepare_fused_model_params(hw=True), bridged across, equals
    the port's hw stack byte for byte in slabs, aux (the `_luts` tables
    first, as sorted keys put them) and manifest."""
    jm, tm, params = models
    jstack = jm.prepare_fused_model_params(j_pack(params), hw=True)["blocks"]
    tstack = tm.prepare_fused_model_params(t_pack(to_port(params)),
                                           hw=True)["blocks"]
    js, ja, jmf = fused_stack_to_numpy(jstack)
    ts, ta, tmf = fused_stack_to_numpy(tstack)
    assert tmf == jmf
    assert sorted(ts) == sorted(js)
    for k in js:
        assert ts[k].tobytes() == js[k].tobytes(), k
    assert len(ta) == len(ja)
    for a, b in zip(ja, ta):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    # K4's table takes the hw stack as it takes the exact one: the same
    # slab offsets and planes, the tables aside
    std = tm.prepare_fused_model_params(t_pack(to_port(params)))["blocks"]
    D = tm.cfg.d_model
    (F, vec, mats), (F0, vec0, mats0) = (stack_table(tstack, D),
                                         stack_table(std, D))
    assert (F, vec) == (F0, vec0)
    assert [(m.offset, m.plane) for m in mats] == [
        (m.offset, m.plane) for m in mats0]
    assert all(torch.equal(m.aux, m0.aux) for m, m0 in zip(mats, mats0))
    luts = stack_luts(tstack)
    assert torch.equal(luts["exp"][0], lut_tensor("exp", "cpu"))
    assert torch.equal(luts["div"][0], lut_tensor("div", "cpu"))
    assert tstack.tdef[:2] == (("_luts", "div"), ("_luts", "exp"))


def test_prepared_hw_mismatch_raises(models):
    _, tm, params = models
    tp = t_pack(to_port(params))
    st = tm.init_decode_state(B, 0, device="cpu")
    toks = torch.zeros((B, 1), dtype=torch.int32)
    prep_std = tm.prepare_fused_model_params(tp)
    prep_hw = tm.prepare_fused_model_params(tp, hw=True)
    assert stack_luts(prep_std["blocks"]) is None
    with pytest.raises(ValueError, match="hw="):
        T4.decode_step_fused_model(prep_std, st, toks, 0, tm.cfg, hw=True)
    with pytest.raises(ValueError, match="hw="):
        T4.decode_step_fused_model(prep_hw, st, toks, 0, tm.cfg, hw=False)


def test_hw_tile_needs_more_shared_memory():
    """Under hw a K3 or K4 block takes 2,444 B more shared memory (the LUTs
    and reductions; the f32 y fits the room of the tile's four bf16 input
    rows), which K3's plan takes from the ring of weight stages: at
    rwkv4-169m and bb 8 both numerics hold 17 slots, 2,444 B apart; at
    rwkv4-7b's widths and bb 3 the hw block holds one slot fewer."""
    ex = tile_plan(8, 8, 768, 3072, False, False)
    hw = tile_plan(8, 8, 768, 3072, False, True)
    assert (hw.kc, hw.stages) == (ex.kc, ex.stages) == (128, 17)
    assert hw.smem - ex.smem == HW_SCRATCH_FLOATS * 4 == 2444
    ex = tile_plan(3, 3, 4096, 16384, False, False)
    hw = tile_plan(3, 3, 4096, 16384, False, True)
    assert (ex.kc, ex.stages, hw.kc, hw.stages) == (64, 4, 64, 3)


def test_hw_wrappers_cpu_are_plain(models, rng):
    """On CPU tensors K3 with tables, K4 on an hw stack, K2 with tables,
    K5 f32-x and K9 run their plain versions and launch nothing."""
    _, tm, params = models
    tp = t_pack(to_port(params))
    prep = tm.prepare_fused_model_params(tp, hw=True)
    counters = (rwkv4_block_decode, rwkv4_model_decode, wkv4_seq,
                dpot_w8_matmul_f32x, sigmoid_kernel)
    before = [f.launches for f in counters]
    toks = torch.from_numpy(
        rng.integers(0, tm.cfg.vocab, (B, 1)).astype(np.int32))
    st = tm.init_decode_state(B, 0, device="cpu")
    T4.decode_step_fused(tp, st, toks, 0, tm.cfg, hw=True)
    T4.decode_step_fused_model(prep, st, toks, 0, tm.cfg, hw=True)
    valid = torch.ones((B, C), dtype=torch.bool)
    T4.prefill_chunk(tp, st, toks.expand(B, C), valid, 0, tm.cfg, hw=True)
    assert [f.launches for f in counters] == before


def test_serve_legacy_hw_cli_runs(capsys):
    t_serve.main(["--legacy", "--hw-numerics", "--smoke", "--device", "cpu",
                  "--batch", "4", "--tokens", "4"])
    assert "hw numerics" in capsys.readouterr().out
    toks = t_serve.serve_legacy("rwkv4-169m", batch=2, n_tokens=3,
                                hw_numerics=True, device="cpu")
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    # quantized=True fake-quantizes the tree under QuantPolicy() (held to
    # JAX's fake_quantize_tree in tests/test_torch_quant_serve.py)
    capsys.readouterr()
    toks = t_serve.serve_legacy("rwkv4-169m", batch=2, n_tokens=3,
                                quantized=True, device="cpu")
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    assert "quantized (Δ-PoT W9/A9 policy)" in capsys.readouterr().out


def test_greedy_decode_hw_equals_per_op_loop(models):
    """The legacy loop under hw is the per-op hw step chained by argmax."""
    _, tm, params = models
    tp = to_port(params)
    first = torch.tensor([[3], [7]], dtype=torch.int32)
    st = tm.init_decode_state(2, 0, device="cpu")
    toks, _ = t_serve.greedy_decode(t_serve.HwModel(tm), tp, st, first, 4)
    tok, want = first, [first]
    for _ in range(4):
        lg, st = T4.decode_step(tm.cast_params(tp), st, tok, 0, tm.cfg,
                                hw=True)
        tok = lg[:, -1].float().argmax(-1)[:, None].to(torch.int32)
        want.append(tok)
    assert torch.equal(toks, torch.cat(want, dim=1))
