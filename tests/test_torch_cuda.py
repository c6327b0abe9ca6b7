"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test asks for the `cuda` fixture, which skips when
there is no GPU (decided at run time, never at import).  Run them on a
machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.

Tolerances: K5 (all three planes) and K2 outputs may move by one bf16
step against the plain version (both accumulate in f32 in another order,
then round to bf16 or snap a bf16 carry): |d| <= 2^-7 |ref| + 2^-20
max|ref|.  K3 chains bf16 roundings, so a flip can travel a few steps:
max|d| <= 2^-6 max|ref| and mean|d| <= 2^-11 mean|ref|.  K4 chains L
layers of them, and a flip in one layer moves every later one, so it
holds to the rule of the port's CPU tests (tests/port_helpers.py):
max|d| <= 2^-5 max|ref| and mean|d| <= 2^-8 mean|ref|.  Batch invariance,
the W4 and VQ decodes against unpack_leaf, and K4 against L launches of
K3 are bit for bit.  K13 (flash attention) holds to one bf16 step (2^-22
relative for f32) plus the f32 summation bound of each output, (Skv + d +
8)·2^-24·(p @ |v|) / l (`_attn_floor`); its backward, K13-dq and K13-dkv,
to `bwd_bounds` (one step, the summation floor of what each gradient
sums, and for bf16 dk and dv the plain version's per-head roundings), and
bit for bit run to run, on random inputs and where a few keys dominate
each row; rows that are not 16-byte aligned (the element-load path) give
the aligned call's bits; a K13 row's bits do not depend on the batch.
K7 at B = 16 (two 8-lane tiles) equals two 8-lane calls bit for bit,
and K3 and K4 on a grid of 1 or 7 blocks equal themselves on every
resident block.
The smollm-smoke train step on the card holds each gradient leaf within
1.25·√2x the CPU bf16 step's gap to an f32 witness.  K10 (chunked
WKV-6) holds y and the final state to `_wkv6_chunked_bound` (the f32
summation bound of each output over the whole sequence, and the log's
last-bit term); K11 (LayerNorm) to one
step of the output's type plus `_ln_floor` (the f32 sum-order bound of
the row's mean, variance and rsqrt, carried to each output).  The RWKV
smoke forwards on the card hold their logits to the plain path on the
card by the CPU tests' rule (max |d| <= 2^-5 max|ref|, mean |d| <= 2^-8
mean|ref|).  The other weight forms (K3 and K4 on plain bf16 weights,
K7 on MIXED, W4, VQ and plain bf16 trees, K5-W4 and K5-VQ with an f32 x)
hold the rules of their kernel's W8 form; their model forms equal L
block launches bit for bit.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core.quant.delta_pot import (
    FORMAT_W8, dpot_pack_int8, dpot_quantize)
from repro_torch.core.quant.serving import (
    broadcast_packed_scales, pack_params, unpack_leaf)
from repro_torch.core.quant.policy import PlanePolicy
from repro_torch.core.quant.serving import unfuse_layer
from repro_torch.kernels.flash_attention import bwd_bounds
from repro_torch.kernels.fused_decode import (
    rwkv4_block_decode, rwkv4_block_decode_plain, rwkv4_model_decode,
    rwkv4_model_decode_plain)
from repro_torch.kernels.fused_prefill import (
    dpot_w4_matmul, dpot_w4_matmul_plain, dpot_w8_matmul,
    dpot_w8_matmul_plain, vq_matmul, vq_matmul_plain)
from repro_torch.kernels.wkv4 import wkv4_seq, wkv4_seq_plain
from repro_torch.models.registry import get_model
from repro_torch.models.rwkv4 import (
    STATE_KEYS, _layer, prepare_fused_model_params)

pytestmark = pytest.mark.cuda

# W4 for att.wk and the head, VQ for ffn.wv, W8 elsewhere
MIXED = PlanePolicy(default="w8", overrides=(
    (r"\['att'\]\['wk'\]", "w4"), (r"\['ffn'\]\['wv'\]", "vq"),
    (r"\['head'\]", "w4")))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _elementwise(out, ref):
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    assert bool((d <= 2.0 ** -7 * r + 2.0 ** -20 * r.max()).all()), \
        float(d.max())


def _spread(out, ref):
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    assert float(d.max()) <= 2.0 ** -6 * float(r.max())
    assert float(d.mean()) <= 2.0 ** -11 * float(r.mean())


# K5's shapes: M across one 16-row tile, several, one 128-row tile and
# two; K not a multiple of the slice (96 one slice, 200 and 4160 several,
# chunk_matmul_plan) and K = 100 (x rows not whole 16-byte chunks); N =
# 203 (ragged: the byte-loading producer) and 384 (the cp.async producer)
K5_M = [1, 8, 16, 17, 128, 200]
K5_KN = [(96, 203), (200, 203), (4160, 203), (96, 384), (4160, 384),
         (100, 203)]


def _unaligned(t):
    """t's values one element past a 16-byte boundary: the wrapper then
    takes the producer that loads single elements."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def _batch_invariant(fn, x, codes, aux, out):
    """A row's bits do not depend on the other rows: x[:1] and x[:8] give
    the first rows of the whole call; a second call gives the same bits,
    and so do x and the codes at unaligned addresses (the other
    producers)."""
    assert torch.equal(fn(x[:1], codes, aux), out[:1])
    if x.shape[0] >= 8:
        assert torch.equal(fn(x[:8], codes, aux), out[:8])
    assert torch.equal(fn(x, codes, aux), out)
    assert torch.equal(fn(_unaligned(x), codes, aux), out)
    assert torch.equal(fn(x, _unaligned(codes), aux), out)


@pytest.mark.parametrize("K,N", K5_KN)
@pytest.mark.parametrize("M", K5_M)
def test_dpot_w8_matmul(cuda, M, K, N):
    g = torch.Generator(device=cuda).manual_seed(M * 7919 + K + N)
    q = dpot_quantize(torch.randn((K, N), generator=g, device=cuda),
                      FORMAT_W8, axis=-1)
    wq, scale = dpot_pack_int8(q), q.scale.reshape(-1)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    before = dpot_w8_matmul.launches
    out = dpot_w8_matmul(x, wq, scale)
    torch.cuda.synchronize()
    assert dpot_w8_matmul.launches == before + 1
    _elementwise(out, dpot_w8_matmul_plain(x, wq, scale))
    eye = torch.eye(K, dtype=torch.bfloat16, device=cuda)
    assert torch.equal(dpot_w8_matmul(eye, wq, scale),
                       unpack_leaf({"packed": wq, "scale": scale[None]}))
    # batch invariance: a row's result does not depend on the other rows
    _batch_invariant(dpot_w8_matmul, x, wq, scale, out)


@pytest.mark.parametrize("carry", ["bfloat16", None])
def test_wkv4_seq(cuda, carry):
    g = torch.Generator(device=cuda).manual_seed(2)
    B, T, C = 4, 9, 160
    rn = lambda *s: torch.randn(s, generator=g, device=cuda)
    bf = lambda t: t.to(torch.bfloat16).float()
    args = (rn(B, T, C), rn(B, T, C), torch.exp(0.5 * rn(C)), 0.5 * rn(C),
            bf(rn(B, C)), bf(rn(B, C).abs() + 0.5), bf(rn(B, C) - 1))
    valid = torch.zeros((B, T), dtype=torch.bool, device=cuda)
    for i, n in enumerate((T, 3, 0, 1)):
        valid[i, :n] = True
    y, fin = wkv4_seq(*args, valid=valid, carry_dtype=carry)
    y_p, fin_p = wkv4_seq_plain(*args, valid=valid, carry_dtype=carry)
    for o, r in zip((y, *fin), (y_p, *fin_p)):
        _elementwise(o, r)
    for o, a0 in zip(fin, args[4:]):      # the empty lane keeps its state
        assert torch.equal(o[2], a0[2])


def _layer0(cuda):
    model = get_model("rwkv4-169m", smoke=True)
    params = model.cast_params(pack_params(model.init_params(0, cuda)))
    blocks = broadcast_packed_scales(params["blocks"], model.cfg.n_layers)
    return model, _layer(blocks, 0)


@pytest.mark.parametrize("bb", [1, 2, 4])
def test_rwkv4_block_decode(cuda, bb):
    model, lp = _layer0(cuda)
    B, D = 4, model.cfg.d_model
    g = torch.Generator(device=cuda).manual_seed(3)
    rn = lambda: torch.randn((B, D), generator=g, device=cuda)
    st = {k: rn().to(torch.bfloat16) for k in STATE_KEYS}
    st["wkv_b"] = (st["wkv_b"].float().abs() + 0.5).to(torch.bfloat16)
    x = rn().to(torch.bfloat16)
    x2, new = rwkv4_block_decode(lp, st, x, bb=bb)
    x2_p, new_p = rwkv4_block_decode_plain(lp, st, x)
    _spread(x2, x2_p)
    for k in STATE_KEYS:
        _spread(new[k], new_p[k])
    # batch invariance: any tile size, and a lane alone, bit for bit
    x2_full, new_full = rwkv4_block_decode(lp, st, x, bb=B)
    assert torch.equal(x2, x2_full)
    one, one_st = rwkv4_block_decode(
        lp, {k: v[1:2] for k, v in st.items()}, x[1:2], bb=1)
    assert torch.equal(one[0], x2_full[1])
    assert all(torch.equal(one_st[k][0], new_full[k][1]) for k in STATE_KEYS)


def test_engine_kernel_path(cuda):
    """The engine's kernel path launches all three kernels and serves each
    request as it would alone."""
    from repro_torch.serving import ServingEngine
    eng = ServingEngine("rwkv4-169m", smoke=True, quantized=True,
                        fused_decode="block", fused_prefill=True,
                        max_batch=4, prefill_chunk=4, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, eng.model.cfg.vocab, int(n)).tolist()
               for n in (3, 9, 1, 6)]
    counters = (dpot_w8_matmul, wkv4_seq, rwkv4_block_decode)
    before = [c.launches for c in counters]
    handles = [eng.submit(p, max_new_tokens=5) for p in prompts]
    eng.run()
    assert all(c.launches > b for c, b in zip(counters, before))
    for p, h in zip(prompts, handles):
        solo = eng.submit(p, max_new_tokens=5)
        eng.run()
        assert solo.tokens == h.tokens


@pytest.mark.parametrize("K,N", K5_KN)
@pytest.mark.parametrize("M", K5_M)
@pytest.mark.parametrize("plane", ["w4", "vq"])
def test_w4_vq_matmul(cuda, plane, M, K, N):
    """K5-W4 and K5-VQ against their plain versions; identity rows pick
    out the decoded plane, which must equal unpack_leaf bit for bit."""
    from repro_torch.core.quant.delta_pot import (
        FORMAT_W4, dpot_pack_nibbles)
    from repro_torch.core.quant.vq import vq_quantize
    g = torch.Generator(device=cuda).manual_seed(10 + M * 7919 + K + N)
    w = torch.randn((K, N), generator=g, device=cuda)
    if plane == "w4":
        q = dpot_quantize(w, FORMAT_W4, axis=-1)
        leaf = {"packed4": dpot_pack_nibbles(q), "scale": q.scale}
        codes, aux = leaf["packed4"], q.scale.reshape(-1)
        fn, plain = dpot_w4_matmul, dpot_w4_matmul_plain
    else:
        idx, cb = vq_quantize(w * w * w, 256)          # heavy tails
        leaf = {"vq_idx": idx, "codebook": cb}
        codes, aux = idx, cb
        fn, plain = vq_matmul, vq_matmul_plain
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    before = fn.launches
    out = fn(x, codes, aux)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    _elementwise(out, plain(x, codes, aux))
    eye = torch.eye(K, dtype=torch.bfloat16, device=cuda)
    assert torch.equal(fn(eye, codes, aux), unpack_leaf(leaf))
    _batch_invariant(fn, x, codes, aux, out)


def _packed(cuda, policy=MIXED, cfg="rwkv4-169m"):
    model = get_model(cfg, smoke=isinstance(cfg, str))
    return model, pack_params(model.init_params(0, cuda), policy)


def _state(cuda, shape, seed):
    """Random bf16 state leaves of `shape` and a residual x (B, D)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=cuda).to(
        torch.bfloat16)
    st = {k: rn(*shape) for k in STATE_KEYS}
    st["wkv_b"] = (st["wkv_b"].float().abs() + 0.5).to(torch.bfloat16)
    return st, rn(*shape[-2:])


@pytest.mark.parametrize("bb", [1, 2, 4])
def test_rwkv4_block_decode_mixed(cuda, bb):
    """K3 on a layer with W8, W4 (att.wk) and VQ (ffn.wv) planes."""
    model, params = _packed(cuda)
    lp = _layer(broadcast_packed_scales(model.cast_params(params)["blocks"],
                                        model.cfg.n_layers), 0)
    B, D = 4, model.cfg.d_model
    st, x = _state(cuda, (B, D), 4)
    x2, new = rwkv4_block_decode(lp, st, x, bb=bb)
    x2_p, new_p = rwkv4_block_decode_plain(lp, st, x)
    _spread(x2, x2_p)
    for k in STATE_KEYS:
        _spread(new[k], new_p[k])
    x2_full, _ = rwkv4_block_decode(lp, st, x, bb=B)
    assert torch.equal(x2, x2_full)


def _k4_policy(which):
    """The plane policy of a K4 test tree: W8, MIXED, all W4 or all VQ."""
    from repro_torch.core.quant.policy import PLANE_VQ, PLANE_W4
    return {"w8": None, "mixed": MIXED, "w4": PLANE_W4,
            "vq": PLANE_VQ}[which]


def _model_case(cuda, which, B=4):
    model, packed = _packed(cuda, _k4_policy(which))
    stack = prepare_fused_model_params(packed, model.cfg)["blocks"]
    L, D = model.cfg.n_layers, model.cfg.d_model
    st, x = _state(cuda, (L, B, D), 5)
    return stack, st, x


# K4's grids: one block, seven, and every block that fits (None)
K4_GRIDS = [1, 7, None]


@pytest.mark.parametrize("grid", K4_GRIDS)
@pytest.mark.parametrize("which", ["w8", "mixed", "w4", "vq"])
def test_model_decode_equals_block_launches(cuda, which, grid):
    """One K4 launch, on any grid, equals L K3 launches on the same layers
    bit for bit (the residual is rounded to bf16 between layers either
    way), and holds to its plain version."""
    stack, st, x = _model_case(cuda, which)
    before = (rwkv4_model_decode.launches, rwkv4_block_decode.launches)
    x4, new4 = rwkv4_model_decode(stack, st, x, grid=grid)
    aux = [a[0] for a in stack.aux]
    x3, new3 = x, []
    for l in range(stack.n_layers):
        lp = unfuse_layer({k: s[l] for k, s in stack.slabs.items()}, aux,
                          stack.manifest, stack.tdef)
        x3, s3 = rwkv4_block_decode(lp, {k: st[k][l] for k in STATE_KEYS},
                                    x3)
        new3.append(s3)
    torch.cuda.synchronize()
    assert (rwkv4_model_decode.launches, rwkv4_block_decode.launches) == (
        before[0] + 1, before[1] + stack.n_layers)
    assert torch.equal(x4, x3)
    for k in STATE_KEYS:
        assert torch.equal(new4[k], torch.stack([s[k] for s in new3]))
    xp, newp = rwkv4_model_decode_plain(stack, st, x)
    for o, r in [(x4, xp)] + [(new4[k], newp[k]) for k in STATE_KEYS]:
        d = (o.float() - r.float()).abs()
        assert float(d.max()) <= 2.0 ** -5 * float(r.float().abs().max())
        assert float(d.mean()) <= 2.0 ** -8 * float(r.float().abs().mean())


def test_model_decode_batch_invariance(cuda):
    """K4 at bb in {1, 2, 4, 8} and for a lone lane, bit for bit."""
    stack, st, x = _model_case(cuda, "mixed", B=8)
    full, full_st = rwkv4_model_decode(stack, st, x, bb=8)
    for bb in (1, 2, 4):
        got, got_st = rwkv4_model_decode(stack, st, x, bb=bb)
        assert torch.equal(got, full)
        assert all(torch.equal(got_st[k], full_st[k]) for k in STATE_KEYS)
    one, one_st = rwkv4_model_decode(
        stack, {k: v[:, 2:3].contiguous() for k, v in st.items()}, x[2:3])
    assert torch.equal(one[0], full[2])
    assert all(torch.equal(one_st[k][:, 0], full_st[k][:, 2])
               for k in STATE_KEYS)


def test_model_decode_raises_on_oversized_bb(cuda):
    """A batch tile over 8 lanes, one that does not divide B, or one whose
    inputs leave no room for K3's weight stages in 227 KB of shared memory
    raises before launching (rwkv4-7b's widths, D 4096 and F 16384, at
    bb = 4; bb = 1 runs)."""
    import dataclasses
    stack, st, x = _model_case(cuda, "mixed")
    before = rwkv4_model_decode.launches
    for bb in (16, 3):
        with pytest.raises(ValueError, match="bb"):
            rwkv4_model_decode(stack, st, x, bb=bb)
    cfg = dataclasses.replace(get_model("rwkv4-7b").cfg, n_layers=2,
                              vocab=64)
    _, params = _packed(cuda, None, cfg)
    wide = prepare_fused_model_params(params, cfg)["blocks"]
    st7, x7 = _state(cuda, (2, 4, cfg.d_model), 6)
    with pytest.raises(ValueError, match="shared memory"):
        rwkv4_model_decode(wide, st7, x7, bb=4)
    rwkv4_model_decode(wide, st7, x7, bb=1)   # 128-row stages, 8 slots
    torch.cuda.synchronize()
    assert rwkv4_model_decode.launches == before + 1


def test_engine_model_path(cuda):
    """The engine's model path with MIXED planes launches K4, K5-W4, K5-VQ
    (and K5, K2) and serves each request as it would alone."""
    from repro_torch.serving import ServingEngine
    from repro_torch.kernels.wkv4 import wkv4_seq as k2
    eng = ServingEngine("rwkv4-169m", smoke=True, quantized=True,
                        plane_policy=MIXED, fused_decode="model",
                        fused_prefill=True, max_batch=4, prefill_chunk=4,
                        device="cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, eng.model.cfg.vocab, int(n)).tolist()
               for n in (3, 9, 1, 6)]
    counters = (dpot_w8_matmul, dpot_w4_matmul, vq_matmul, k2,
                rwkv4_model_decode)
    before = [c.launches for c in counters]
    handles = [eng.submit(p, max_new_tokens=5) for p in prompts]
    eng.run()
    assert all(c.launches > b for c, b in zip(counters, before))
    for p, h in zip(prompts, handles):
        solo = eng.submit(p, max_new_tokens=5)
        eng.run()
        assert solo.tokens == h.tokens


# --- RWKV-6: K6 and both forms of K7 --------------------------------------

from repro_torch.kernels.fused_decode import (
    rwkv6_block_decode, rwkv6_block_decode_plain, rwkv6_model_decode,
    rwkv6_model_decode_plain)
from repro_torch.kernels.wkv6 import (
    wkv6_seq, wkv6_seq_inorder, wkv6_seq_plain)

STATE6 = ("att_x", "ffn_x", "wkv_s")


@pytest.mark.parametrize("carry", ["bfloat16", None])
def test_wkv6_seq(cuda, carry):
    """K6 against its plain version: the state bit for bit (its update has
    no sum), y by K2's elementwise rule (it sums n in another order) and
    bit for bit against the in-order reference; the bf16 pool state reads
    as its f32 widening; the empty lane keeps its state."""
    g = torch.Generator(device=cuda).manual_seed(7)
    B, T, H, N = 4, 9, 8, 64
    rn = lambda *s: torch.randn(s, generator=g, device=cuda)
    args = (rn(B, T, H, N), rn(B, T, H, N), rn(B, T, H, N),
            torch.exp(-torch.exp(0.5 * rn(B, T, H, N))), 0.5 * rn(H, N))
    s0 = rn(B, H, N, N).to(torch.bfloat16)
    valid = torch.zeros((B, T), dtype=torch.bool, device=cuda)
    for i, n in enumerate((T, 3, 0, 1)):
        valid[i, :n] = True
    before = wkv6_seq.launches
    y, sf = wkv6_seq(*args, s0, valid=valid, carry_dtype=carry)
    y32, sf32 = wkv6_seq(*args, s0.float(), valid=valid, carry_dtype=carry)
    torch.cuda.synchronize()
    assert wkv6_seq.launches == before + 2
    y_p, sf_p = wkv6_seq_plain(*args, s0, valid=valid, carry_dtype=carry)
    _elementwise(y, y_p)
    assert torch.equal(sf, sf_p)
    assert torch.equal(y, y32) and torch.equal(sf, sf32)
    assert torch.equal(sf[2], s0[2].float())
    y_o, _ = wkv6_seq_inorder(*args, s0, valid=valid, carry_dtype=carry)
    assert torch.equal(y.view(torch.int32), y_o.view(torch.int32))


def test_wkv6_snap_is_bf16r(cuda):
    """K6's snap (`csrc/wkv6_seq.cu:snap`, one cvt.rn.bf16x2.f32 of (x,
    0)) gives bf16r's bits for every one of the 2^32 f32 bit patterns,
    NaNs, infinities and subnormals included."""
    from repro_torch.kernels.build import check, load_library, stream_ptr
    out = torch.tensor([0, -1], dtype=torch.int64, device=cuda)
    check(load_library().wkv6_snap_check(out.data_ptr(), stream_ptr(out)),
          "wkv6_snap_check")
    bad, first = out.tolist()
    assert bad == 0, f"{bad} patterns differ, the least {first & 0xffffffff:#x}"


# K6's plan cases: the prefill chunk, the forward at S 40, B 1, wide B,
# the smoke heads and a ragged N
K6_CASES = [(8, 16, 64, 64), (2, 40, 64, 64), (1, 7, 64, 64),
            (16, 16, 64, 64), (4, 9, 8, 16), (3, 5, 4, 32), (2, 6, 3, 37)]


@pytest.mark.parametrize("B,T,H,N", K6_CASES)
def test_k6_plan_is_the_source(cuda, B, T, H, N):
    """`k6_plan`, which the CPU plan tests hold to the card's limits, is
    the source's plan (the C query `wkv6_seq_plan`, from the same
    `plan_of` as the launch)."""
    import ctypes

    from repro_torch.kernels.build import check, load_library
    from repro_torch.kernels.wkv6 import K6Plan, k6_plan
    out = (ctypes.c_longlong * len(K6Plan._fields))()
    check(load_library().wkv6_seq_plan(B, T, H, N, out), "wkv6_seq_plan")
    assert tuple(out) == tuple(k6_plan(B, T, H, N))


def _k6_case(cuda, B, T, H, N, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=cuda)
    args = (rn(B, T, H, N), rn(B, T, H, N), rn(B, T, H, N),
            torch.exp(-torch.exp(0.5 * rn(B, T, H, N))), 0.5 * rn(H, N),
            rn(B, H, N, N).to(torch.bfloat16))
    valid = torch.zeros((B, T), dtype=torch.bool, device=cuda)
    for i in range(B):
        valid[i, :(T, 3, 0, 1)[i % 4]] = True
    return args, valid


@pytest.mark.parametrize("B,T,H,N", K6_CASES)
@pytest.mark.parametrize("form", ["masked", "masked-f32", "plain"])
def test_wkv6_seq_bits(cuda, B, T, H, N, form):
    """K6 gives the in-order reference's y and the plain version's state
    bit for bit at the lanes its plan takes (`K6_CASES` reach each), under
    the mask and the bf16 carry (from the bf16 pool state, or from an f32
    state off the bf16 grid, which a window whose first step is not valid
    snaps there) or neither, and on operands whose rows are not 16-byte
    aligned (the 4-byte copies)."""
    args, valid = _k6_case(cuda, B, T, H, N, B * T + N)
    if form == "masked-f32":
        g = torch.Generator(device=cuda).manual_seed(N)
        args = args[:5] + (torch.randn(args[5].shape, generator=g,
                                       device=cuda),)
    kw = {} if form == "plain" else {"valid": valid,
                                     "carry_dtype": "bfloat16"}
    y_o, s_p = wkv6_seq_inorder(*args, **kw)
    _, s_p2 = wkv6_seq_plain(*args, **kw)
    assert torch.equal(s_p, s_p2)
    y, sf = wkv6_seq(*args, **kw)
    assert torch.equal(y.view(torch.int32), y_o.view(torch.int32))
    assert torch.equal(sf, s_p)
    # r, k, v, w one float past a 16-byte boundary
    off = [_unaligned(t) for t in args[:4]]
    y, sf = wkv6_seq(*off, *args[4:], **kw)
    assert torch.equal(y.view(torch.int32), y_o.view(torch.int32))
    assert torch.equal(sf, s_p)


def test_wkv6_seq_refusals(cuda):
    """N past 64 raises before a launch."""
    before = wkv6_seq.launches
    big, _ = _k6_case(cuda, 1, 2, 1, 65, 0)
    with pytest.raises(ValueError):
        wkv6_seq(*big)
    assert wkv6_seq.launches == before


@pytest.fixture(scope="module")
def wide6():
    """rwkv6-7b at full width (D 4096, H 64, N 64, F 14336) cut to two
    layers and a 256-token vocabulary, W8 weights drawn on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import dataclasses
    from repro_torch.core.quant.serving import pack_leaf
    from repro_torch.tree import keystr
    cfg = dataclasses.replace(get_model("rwkv6-7b").cfg, n_layers=2,
                              vocab=256)
    model = get_model(cfg)
    params = model.init_params(0, "cuda", leaf_fn=lambda p, t: pack_leaf(
        keystr(p), t, None))
    return model, params


def _state6(cfg, lead, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device="cuda").to(
        torch.bfloat16)
    D, H, N = cfg.d_model, cfg.n_heads, cfg.rwkv_head_dim
    st = {"att_x": rn(*lead, D), "ffn_x": rn(*lead, D),
          "wkv_s": rn(*lead, H, N, N)}
    return st, rn(lead[-1], D)


def _layers6(model, params):
    blocks = broadcast_packed_scales(model.cast_params(params)["blocks"],
                                     model.cfg.n_layers)
    return [_layer(blocks, l) for l in range(model.cfg.n_layers)]


def test_rwkv6_block_decode(cuda, wide6):
    """K7-block on layer 0 at full width against its plain version: per
    output, max|d| <= 2^-6 max|ref| (K3's) and a mean gap no more than
    1.25x the plain version's own gap between the CPU and the card on the
    same inputs (K3's 2^-11 mean does not hold here: the bf16 rounding of
    a 14336-term sum flips under another summation order on a sizeable
    share of the outputs, PERF.md §6, K7); bit for bit whatever the grid,
    and for a lane alone."""
    from repro_torch.tree import tree_map
    model, params = wide6
    cfg = model.cfg
    lp = _layers6(model, params)[0]
    st, x = _state6(cfg, (4,), 8)
    before = rwkv6_block_decode.launches
    x2, new = rwkv6_block_decode(lp, st, x, cfg)
    torch.cuda.synchronize()
    assert rwkv6_block_decode.launches == before + 1
    ref = rwkv6_block_decode_plain(lp, st, x, cfg)
    cpu = lambda t: t.cpu()
    on_cpu = rwkv6_block_decode_plain(tree_map(cpu, lp), tree_map(cpu, st),
                                      cpu(x), cfg)
    pick = lambda out, k: out[0] if k == "x" else out[1][k]
    for k in ("x",) + STATE6:
        r = pick(ref, k).float()
        d = (pick((x2, new), k).float() - r).abs()
        dc = (pick(on_cpu, k).float().to(cuda) - r).abs()
        assert float(d.max()) <= 2.0 ** -6 * float(r.abs().max()), k
        assert float(d.mean()) <= 1.25 * float(dc.mean()) + \
            2.0 ** -16 * float(r.abs().mean()), k
    small, small_st = rwkv6_block_decode(lp, st, x, cfg, grid=37)
    assert torch.equal(small, x2)
    assert all(torch.equal(small_st[k], new[k]) for k in STATE6)
    one, one_st = rwkv6_block_decode(
        lp, {k: v[1:2] for k, v in st.items()}, x[1:2], cfg)
    assert torch.equal(one[0], x2[1])
    assert all(torch.equal(one_st[k][0], new[k][1]) for k in STATE6)


def test_rwkv6_model_decode_equals_block_launches(cuda, wide6):
    """One K7-model launch equals L K7-block launches bit for bit, and
    holds to its plain version by the port_helpers rule (a flip in one
    layer moves every later one)."""
    from repro_torch.models.rwkv6 import prepare_fused_model_params
    model, params = wide6
    cfg = model.cfg
    stack = prepare_fused_model_params(params, cfg)["blocks"]
    st, x = _state6(cfg, (cfg.n_layers, 4), 9)
    before = (rwkv6_model_decode.launches, rwkv6_block_decode.launches)
    xm, newm = rwkv6_model_decode(stack, st, x, cfg)
    xb, newb = x, []
    for l, lp in enumerate(_layers6(model, params)):
        xb, sb = rwkv6_block_decode(lp, {k: st[k][l] for k in STATE6}, xb,
                                    cfg)
        newb.append(sb)
    torch.cuda.synchronize()
    assert (rwkv6_model_decode.launches, rwkv6_block_decode.launches) == (
        before[0] + 1, before[1] + cfg.n_layers)
    assert torch.equal(xm, xb)
    for k in STATE6:
        assert torch.equal(newm[k], torch.stack([s[k] for s in newb]))
    xp, newp = rwkv6_model_decode_plain(stack, st, x, cfg)
    for o, r in [(xm, xp)] + [(newm[k], newp[k]) for k in STATE6]:
        d = (o.float() - r.float()).abs()
        assert float(d.max()) <= 2.0 ** -5 * float(r.float().abs().max())
        assert float(d.mean()) <= 2.0 ** -8 * float(r.float().abs().mean())


def test_rwkv6_kernels_take_w8_only(cuda):
    """K7 takes every plane and plain bf16 weights now; what it still
    refuses, on card tensors and before launching: a plain matrix in f32,
    a W4 leaf whose nibbles pair two layers (PLANE_W4's time_maa_x) and a
    slab stack with a leaf it does not know."""
    from repro_torch.core.quant.policy import PLANE_W4
    from repro_torch.core.quant.serving import fuse_layer_stack
    model = get_model("rwkv6-7b", smoke=True)
    cfg = model.cfg
    st, x = _state6(cfg, (cfg.n_layers, 2), 10)
    st0 = {k: v[0] for k, v in st.items()}
    before = (rwkv6_block_decode.launches, rwkv6_model_decode.launches)
    plain = model.cast_params(model.init_params(0, cuda))
    att = {**plain["blocks"]["att"], "wg": plain["blocks"]["att"]["wg"].float()}
    f32 = {**plain["blocks"], "att": att}
    with pytest.raises(TypeError, match="att.wg is torch.float32"):
        rwkv6_block_decode(_layer(f32, 0), st0, x, cfg)
    with pytest.raises(TypeError, match="att.wg is float32"):
        rwkv6_model_decode(fuse_layer_stack(f32, cfg.n_layers), st, x, cfg)
    w4 = model.cast_params(pack_params(model.init_params(0, cuda), PLANE_W4))
    lp = _layer(broadcast_packed_scales(w4["blocks"], cfg.n_layers), 0)
    with pytest.raises(ValueError, match="time_maa_x.*pairs contraction"):
        rwkv6_block_decode(lp, st0, x, cfg)
    with pytest.raises(ValueError, match="time_maa_x.*pairs contraction"):
        rwkv6_model_decode(fuse_layer_stack(w4["blocks"], cfg.n_layers), st,
                           x, cfg)
    params = model.cast_params(pack_params(model.init_params(0, cuda)))
    extra = fuse_layer_stack(
        {**params["blocks"],
         "_luts": {"exp": torch.zeros(1, 256, device=cuda)}}, cfg.n_layers)
    with pytest.raises(ValueError, match="_luts"):
        rwkv6_model_decode(extra, st, x, cfg)
    assert (rwkv6_block_decode.launches,
            rwkv6_model_decode.launches) == before


def test_rwkv6_raises_when_the_grid_cannot_launch(cuda):
    """A cooperative grid larger than the blocks resident at once (or
    empty) raises before launching; there is no smaller silent grid."""
    from repro_torch.kernels.fused_decode import (
        PLANE_IDS, RWKV6_MAT_KEYS, _coop_grid, _k7_info)
    from repro_torch.models.rwkv6 import prepare_fused_model_params
    model = get_model("rwkv6-7b", smoke=True)
    cfg = model.cfg
    params = pack_params(model.init_params(0, cuda))
    stack = prepare_fused_model_params(params, cfg)["blocks"]
    st, x = _state6(cfg, (cfg.n_layers, 2), 11)
    lp = _layers6(model, params)[0]
    w8 = _k7_info([PLANE_IDS["w8"]] * len(RWKV6_MAT_KEYS),
                  [None] * len(RWKV6_MAT_KEYS))
    most = _coop_grid("model", None, w8, x.device)
    assert most >= torch.cuda.get_device_properties(0).multi_processor_count
    before = (rwkv6_block_decode.launches, rwkv6_model_decode.launches)
    for grid in (most + 1, 0):
        with pytest.raises(ValueError, match="cooperative grid"):
            rwkv6_model_decode(stack, st, x, cfg, grid=grid)
        with pytest.raises(ValueError, match="cooperative grid"):
            rwkv6_block_decode(lp, {k: v[0] for k, v in st.items()}, x, cfg,
                               grid=grid)
    assert (rwkv6_block_decode.launches,
            rwkv6_model_decode.launches) == before


@pytest.mark.parametrize("path", ["block", "model"])
def test_engine_rwkv6_paths(cuda, path):
    """The engine's rwkv6 kernel paths launch K5, K6 and their K7 form and
    serve each request as it would alone."""
    from repro_torch.serving import ServingEngine
    eng = ServingEngine("rwkv6-7b", smoke=True, quantized=True,
                        fused_decode=path, fused_prefill=True, max_batch=4,
                        prefill_chunk=4, device="cuda")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, eng.model.cfg.vocab, int(n)).tolist()
               for n in (3, 9, 1, 6)]
    k7 = rwkv6_block_decode if path == "block" else rwkv6_model_decode
    counters = (dpot_w8_matmul, wkv6_seq, k7)
    before = [c.launches for c in counters]
    handles = [eng.submit(p, max_new_tokens=5) for p in prompts]
    eng.run()
    assert all(c.launches > b for c, b in zip(counters, before))
    for p, h in zip(prompts, handles):
        solo = eng.submit(p, max_new_tokens=5)
        eng.run()
        assert solo.tokens == h.tokens


# --- the paper's hardware numerics: K9, K2-hw, K5 f32-x, K3-hw, K4-hw ---
#
# K9 and K2-hw are bit for bit against their plain versions: their math is
# IEEE operations rounded once each (hw_units.cuh), the powers of two are
# built exactly, and no sum changes order.  K5 f32-x accumulates f32
# products of f32 x and bf16-exact weights in another order than the plain
# matmul: the f32 summation bound K·2^-24·(|x| @ |w|) per output.  K3-hw and
# K4-hw hold the port_helpers rule (2^-5 max, 2^-8 mean): a LayerNorm sum
# in another order can flip a bf16 rounding at the element that sets a
# tensor's A9 scale, which then moves the whole tensor's codes.  Tiles are
# bit for bit: a bb-lane tile of a launch equals a launch of those lanes
# alone (each tile takes its own A9 scale), and K4-hw equals L K3-hw
# launches.

from repro_torch.core.approx.units import lut_tensor
from repro_torch.kernels.expsig import (
    exp_kernel, exp_kernel_plain, sigmoid_kernel, sigmoid_kernel_plain)
from repro_torch.kernels.fused_prefill import dpot_w8_matmul_f32x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expsig(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(9)
    x = 8 * torch.randn((37, 1001), generator=g, device=cuda)
    x[0, :8] = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), 1e-40,
                             2.375, -5.0, 1e30], device=cuda)
    x = x.to(dtype)
    before = (exp_kernel.launches, sigmoid_kernel.launches)
    e, s = exp_kernel(x), sigmoid_kernel(x)
    torch.cuda.synchronize()
    assert (exp_kernel.launches, sigmoid_kernel.launches) == (
        before[0] + 1, before[1] + 1)
    assert e.dtype == s.dtype == dtype and e.shape == x.shape
    assert torch.equal(e, exp_kernel_plain(x))
    assert torch.equal(s, sigmoid_kernel_plain(x))
    # a strided view is taken whole
    assert torch.equal(exp_kernel(x.t()), exp_kernel_plain(x.t()))


def _hw_tabs(cuda):
    return {"exp_table": lut_tensor("exp", cuda),
            "div_table": lut_tensor("div", cuda)}


def test_wkv4_seq_hw(cuda):
    g = torch.Generator(device=cuda).manual_seed(12)
    B, T, C = 4, 9, 160
    rn = lambda *s: torch.randn(s, generator=g, device=cuda)
    bf = lambda t: t.to(torch.bfloat16).float()
    args = (rn(B, T, C), rn(B, T, C), torch.exp(0.5 * rn(C)), 0.5 * rn(C),
            bf(rn(B, C)), bf(rn(B, C).abs() + 0.5), bf(rn(B, C) - 1))
    valid = torch.zeros((B, T), dtype=torch.bool, device=cuda)
    for i, n in enumerate((T, 3, 0, 1)):
        valid[i, :n] = True
    kw = dict(valid=valid, carry_dtype="bfloat16", **_hw_tabs(cuda))
    before = wkv4_seq.launches
    y, fin = wkv4_seq(*args, **kw)
    torch.cuda.synchronize()
    assert wkv4_seq.launches == before + 1
    y_p, fin_p = wkv4_seq_plain(*args, **kw)
    for o, r in zip((y, *fin), (y_p, *fin_p)):
        assert torch.equal(o, r)


# K5 f32-x's cases: K = 96 (one slice), 98 (f32 x rows not whole 16-byte
# chunks: the producer that loads elements; even, as W4 needs), 4160
# (several slices, summed by the f32 combine pass), and an x of wide
# exponent (`_f32x_x`); M = 200 spans two 128-row tiles
F32X_M = [1, 8, 37, 128, 200]
F32X_CASES = {"k96": (96, False), "k98": (98, False), "k4160": (4160, False),
              "wide": (96, True)}


def _f32x_x(M, K, wide, g, device):
    """randn, or for `wide` randn · 2^e with e in [-60, 60] an entry and
    every seventh entry below 2^-120 (bits under bf16's least subnormal,
    which the kernel's split cuts: their share of each output is far
    under the bound)."""
    x = torch.randn((M, K), generator=g, device=device)
    if wide:
        e = torch.randint(-60, 61, (M, K), generator=g, device=device)
        x = x * torch.exp2(e.float())
        x.view(-1)[::7] = torch.randn((x.numel() + 6) // 7, generator=g,
                                      device=device) * 2.0 ** -126
    return x


@pytest.mark.parametrize("case", list(F32X_CASES))
@pytest.mark.parametrize("M", F32X_M)
def test_dpot_w8_matmul_f32x(cuda, M, case):
    g = torch.Generator(device=cuda).manual_seed(13 + M)
    (K, wide), N = F32X_CASES[case], 203
    q = dpot_quantize(torch.randn((K, N), generator=g, device=cuda),
                      FORMAT_W8, axis=-1)
    wq, scale = dpot_pack_int8(q), q.scale.reshape(-1)
    x = _f32x_x(M, K, wide, g, cuda)
    before = (dpot_w8_matmul.launches, dpot_w8_matmul_f32x.launches)
    out = dpot_w8_matmul_f32x(x, wq, scale)
    torch.cuda.synchronize()
    assert (dpot_w8_matmul.launches, dpot_w8_matmul_f32x.launches) == (
        before[0], before[1] + 1)
    assert out.dtype == torch.float32
    w = unpack_leaf({"packed": wq, "scale": scale[None]})
    ref = dpot_w8_matmul_plain(x, wq, scale)
    bound = K * 2.0 ** -24 * (x.abs() @ w.float().abs())
    assert bool(((out - ref).abs() <= bound).all())
    eye = torch.eye(K, device=cuda)
    assert torch.equal(dpot_w8_matmul_f32x(eye, wq, scale), w.float())
    assert torch.equal(dpot_w8_matmul_f32x(x[:1], wq, scale), out[:1])
    with pytest.raises(TypeError):
        dpot_w8_matmul(x, wq, scale)


def _close(out, ref):
    d = (out.float() - ref.float()).abs()
    assert float(d.max()) <= 2.0 ** -5 * float(ref.float().abs().max())
    assert float(d.mean()) <= 2.0 ** -8 * float(ref.float().abs().mean())


def _luts(cuda):
    return {"exp": lut_tensor("exp", cuda), "div": lut_tensor("div", cuda)}


@pytest.mark.parametrize("bb", [2, 4])
def test_rwkv4_block_decode_hw(cuda, bb):
    from repro_torch.models.rwkv4 import _hw_numerics_with_tables
    model, lp = _layer0(cuda)
    B, D = 4, model.cfg.d_model
    st, x = _state(cuda, (B, D), 14)
    luts = _luts(cuda)
    before = rwkv4_block_decode.launches
    x2, new = rwkv4_block_decode(lp, st, x, bb=bb, luts=luts)
    torch.cuda.synchronize()
    assert rwkv4_block_decode.launches == before + 1
    nm = _hw_numerics_with_tables(luts["exp"], luts["div"])
    x2_p, new_p = rwkv4_block_decode_plain(lp, st, x, nm, bb=bb)
    _close(x2, x2_p)
    for k in STATE_KEYS:
        _close(new[k], new_p[k])
    # each tile alone gives its lanes' bits
    for i in range(0, B, bb):
        one, one_st = rwkv4_block_decode(
            lp, {k: v[i:i + bb] for k, v in st.items()}, x[i:i + bb],
            luts=luts)
        assert torch.equal(one, x2[i:i + bb])
        assert all(torch.equal(one_st[k], new[k][i:i + bb])
                   for k in STATE_KEYS)


@pytest.mark.parametrize("grid", K4_GRIDS)
@pytest.mark.parametrize("which", ["w8", "mixed"])
@pytest.mark.parametrize("bb", [2, 4])
def test_model_decode_hw_equals_block_launches(cuda, bb, which, grid):
    """K4-hw on any grid equals L K3-hw launches bit for bit (W8 and
    MIXED planes, tiles of 2 and 4 lanes), and holds its plain version."""
    model, packed = _packed(cuda, _k4_policy(which))
    stack = prepare_fused_model_params(packed, model.cfg, hw=True)["blocks"]
    L, B, D = model.cfg.n_layers, 4, model.cfg.d_model
    st, x = _state(cuda, (L, B, D), 15)
    x4, new4 = rwkv4_model_decode(stack, st, x, bb=bb, grid=grid)
    aux = [a[0] for a in stack.aux]
    x3, new3 = x, []
    for l in range(L):
        lp = unfuse_layer({k: s[l] for k, s in stack.slabs.items()}, aux,
                          stack.manifest, stack.tdef)
        luts = lp.pop("_luts")
        x3, s3 = rwkv4_block_decode(lp, {k: st[k][l] for k in STATE_KEYS},
                                    x3, bb=bb, luts=luts)
        new3.append(s3)
    torch.cuda.synchronize()
    assert torch.equal(x4, x3)
    for k in STATE_KEYS:
        assert torch.equal(new4[k], torch.stack([s[k] for s in new3]))
    xp, newp = rwkv4_model_decode_plain(stack, st, x, bb=bb)
    for o, r in [(x4, xp)] + [(new4[k], newp[k]) for k in STATE_KEYS]:
        _close(o, r)


def test_hw_paths_on_card(cuda):
    """Prefill under hw launches K5, K5 f32-x, K2-hw and K9; the block and
    model decode paths give the same logits bit for bit."""
    from repro_torch.models import rwkv4
    model, packed = _packed(cuda, None)
    cfg = model.cfg
    prep = model.prepare_fused_model_params(packed, hw=True)
    B, C = 4, 6
    g = torch.Generator(device=cuda).manual_seed(16)
    toks = torch.randint(0, cfg.vocab, (B, C), generator=g, device=cuda,
                         dtype=torch.int32)
    valid = torch.zeros((B, C), dtype=torch.bool, device=cuda)
    for i, n in enumerate((C, 3, 0, 1)):
        valid[i, :n] = True
    counters = (dpot_w8_matmul, dpot_w8_matmul_f32x, wkv4_seq,
                sigmoid_kernel)
    before = [c.launches for c in counters]
    st = model.init_decode_state(B, 0, device=cuda)
    st, lg = rwkv4.prefill_chunk(packed, st, toks, valid, 0, cfg, hw=True)
    assert all(c.launches > b for c, b in zip(counters, before))
    assert bool(torch.isfinite(lg.float()).all())
    s1 = s2 = st
    for j in range(4):
        t = toks[:, j:j + 1]
        l1, s1 = rwkv4.decode_step_fused(packed, s1, t, 0, cfg, hw=True)
        l2, s2 = rwkv4.decode_step_fused_model(prep, s2, t, 0, cfg, hw=True)
        assert torch.equal(l1, l2)


# --- K13: flash attention forward ----------------------------------------


def _attn_floor(q, k, v, causal):
    """The f32 summation bound of each output: (Skv + d + 8)·2^-24 times
    (p @ |v|) / l, the most that summing the scores and p·v in another
    order (and an exp a few ulps off) can move it, which near a zero output
    passes any bound relative to that output."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    Skv, d = k.shape[1], q.shape[-1]
    mag = flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                causal=causal)
    return (Skv + d + 8) * 2.0 ** -24 * mag


def _attn_ok(out, ref, floor):
    """bf16 outputs within one bf16 step plus the floor, f32 outputs within
    2^-22 relative plus the floor."""
    rel = 2.0 ** -7 if out.dtype == torch.bfloat16 else 2.0 ** -22
    d = (out.float() - ref.float()).abs()
    assert bool((d <= rel * ref.float().abs() + floor).all()), float(d.max())


@pytest.mark.parametrize("B,Sq,Skv,H,KVH,d,causal,dtype", [
    (1, 512, 512, 9, 3, 64, True, torch.bfloat16),     # smollm's heads
    (2, 200, 200, 9, 3, 64, True, torch.bfloat16),     # ragged tiles
    (1, 130, 130, 4, 4, 96, False, torch.float32),     # MHA, hd 96
    (1, 70, 150, 8, 2, 128, True, torch.bfloat16),     # Sq != Skv, hd 128
    (3, 1, 33, 6, 2, 24, True, torch.float32),         # one query row
    # the bf16 tensor-core instance where it is fragile: d padded to k16
    (2, 100, 100, 4, 2, 16, True, torch.bfloat16),
    (2, 130, 130, 6, 3, 32, False, torch.bfloat16),
    (1, 300, 300, 8, 4, 96, True, torch.bfloat16),
    (1, 50, 50, 4, 2, 24, True, torch.bfloat16),       # a zero-filled chunk
    (2, 40, 17, 6, 2, 64, False, torch.bfloat16),      # short Skv
    (2, 40, 17, 6, 2, 16, True, torch.bfloat16),
    (3, 1, 33, 6, 2, 64, True, torch.bfloat16),        # one query row
    (3, 1, 90, 6, 2, 128, False, torch.bfloat16),
    (1, 70, 300, 9, 3, 64, False, torch.bfloat16),     # Skv > Sq, full
])
def test_flash_attention(cuda, B, Sq, Skv, H, KVH, d, causal, dtype):
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    g = torch.Generator(device=cuda).manual_seed(Sq + d)
    rn = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)
    q, k, v = rn(B, Sq, H, d), rn(B, Skv, KVH, d), rn(B, Skv, KVH, d)
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref, lse_p = flash_attention_plain(q, k, v, causal=causal,
                                       return_lse=True)
    _attn_ok(out, ref, _attn_floor(q, k, v, causal))
    dl = (lse - lse_p).abs()
    assert float(dl.max()) <= (Skv + d + 8) * 2.0 ** -24 * (
        1.0 + float(lse_p.abs().max()))
    assert torch.equal(flash_attention(q, k, v, causal=causal), out)


@pytest.mark.parametrize("d,causal", [(64, True), (128, False)])
def test_flash_attention_rows_do_not_depend_on_batch(cuda, d, causal):
    """out[b] and lse[b] of a B = 3 call equal the call on batch b alone,
    bit for bit."""
    from repro_torch.kernels.flash_attention import flash_attention
    g = torch.Generator(device=cuda).manual_seed(7 + d)
    rn = lambda *s: torch.randn(s, generator=g, device=cuda).to(
        torch.bfloat16)
    q, k, v = rn(3, 300, 9, d), rn(3, 300, 3, d), rn(3, 300, 3, d)
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    for b in range(3):
        ob, lb = flash_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                 causal=causal, return_lse=True)
        assert torch.equal(ob, out[b:b + 1])
        assert torch.equal(lb, lse[b:b + 1])


def test_flash_attention_refusals(cuda):
    """On the card the wrapper raises on what the kernel does not take:
    fp16, mixed devices, a head count that is not a multiple of the kv
    heads, a head dim past 128."""
    from repro_torch.kernels.flash_attention import flash_attention
    z = lambda *s, dt=torch.bfloat16, dev=cuda: torch.zeros(
        s, dtype=dt, device=dev)
    before = flash_attention.launches
    with pytest.raises(TypeError):
        flash_attention(z(1, 8, 2, 16, dt=torch.float16),
                        z(1, 8, 2, 16, dt=torch.float16),
                        z(1, 8, 2, 16, dt=torch.float16))
    with pytest.raises(ValueError, match="devices"):
        flash_attention(z(1, 8, 2, 16), z(1, 8, 2, 16, dev="cpu"),
                        z(1, 8, 2, 16))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(z(1, 8, 6, 16), z(1, 8, 4, 16), z(1, 8, 4, 16))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(z(1, 8, 2, 192), z(1, 8, 2, 192), z(1, 8, 2, 192))
    assert flash_attention.launches == before


# --- K7 over more than 8 lanes ---------------------------------------------


def test_rwkv6_block_decode_b16_equals_two_tiles(cuda, wide6):
    """K7-block at B = 16 runs two 8-lane tiles and equals two 8-lane calls
    bit for bit: a lane's bits do not depend on its tile."""
    model, params = wide6
    cfg = model.cfg
    lp = _layers6(model, params)[0]
    st, x = _state6(cfg, (16,), 12)
    before = rwkv6_block_decode.launches
    x2, new = rwkv6_block_decode(lp, st, x, cfg)
    torch.cuda.synchronize()
    assert rwkv6_block_decode.launches == before + 2
    for i in (0, 8):
        xt, st_t = rwkv6_block_decode(
            lp, {k: v[i:i + 8] for k, v in st.items()}, x[i:i + 8], cfg)
        assert torch.equal(xt, x2[i:i + 8])
        assert all(torch.equal(st_t[k], new[k][i:i + 8]) for k in STATE6)
    x4, new4 = rwkv6_block_decode(lp, st, x, cfg, bb=4)
    assert torch.equal(x4, x2)
    assert all(torch.equal(new4[k], new[k]) for k in STATE6)
    with pytest.raises(ValueError, match="batch tile"):
        rwkv6_block_decode(lp, st, x, cfg, bb=16)


def test_rwkv6_model_decode_b16_equals_two_tiles(cuda, wide6):
    """K7-model at B = 16 runs two 8-lane tiles in place in the whole
    (L, 16, ...) state and equals two 8-lane calls bit for bit; a
    6-lane batch takes one tile, a 12-lane one two tiles of 6."""
    from repro_torch.models.rwkv6 import prepare_fused_model_params
    model, params = wide6
    cfg = model.cfg
    stack = prepare_fused_model_params(params, cfg)["blocks"]
    st, x = _state6(cfg, (cfg.n_layers, 16), 13)
    before = rwkv6_model_decode.launches
    xm, newm = rwkv6_model_decode(stack, st, x, cfg)
    torch.cuda.synchronize()
    assert rwkv6_model_decode.launches == before + 2
    for i in (0, 8):
        xt, st_t = rwkv6_model_decode(
            stack, {k: v[:, i:i + 8] for k, v in st.items()}, x[i:i + 8],
            cfg)
        assert torch.equal(xt, xm[i:i + 8])
        assert all(torch.equal(st_t[k], newm[k][:, i:i + 8])
                   for k in STATE6)
    before = rwkv6_model_decode.launches
    x12, new12 = rwkv6_model_decode(
        stack, {k: v[:, :12] for k, v in st.items()}, x[:12], cfg)
    assert rwkv6_model_decode.launches == before + 2
    assert torch.equal(x12, xm[:12])
    assert all(torch.equal(new12[k], newm[k][:, :12]) for k in STATE6)


def test_engine_rwkv6_sixteen_lanes(cuda):
    """An rwkv6 engine with 16 slots serves through both K7 forms (each
    tick two tiles of 8) and each request as it would alone."""
    from repro_torch.serving import ServingEngine
    rng = np.random.default_rng(5)
    for path, k7 in (("block", rwkv6_block_decode),
                     ("model", rwkv6_model_decode)):
        eng = ServingEngine("rwkv6-7b", smoke=True, quantized=True,
                            fused_decode=path, fused_prefill=True,
                            max_batch=16, prefill_chunk=4, device="cuda")
        prompts = [rng.integers(0, eng.model.cfg.vocab, int(n)).tolist()
                   for n in rng.integers(1, 9, 16)]
        before = k7.launches
        handles = [eng.submit(p, max_new_tokens=3) for p in prompts]
        eng.run()
        assert k7.launches > before
        for p, h in list(zip(prompts, handles))[:3]:
            solo = eng.submit(p, max_new_tokens=3)
            eng.run()
            assert solo.tokens == h.tokens


# --- K7's launch plan and its new edges -------------------------------------


@pytest.mark.parametrize("form", ["w8", "mixed", "bf16"])
def test_rwkv6_decode_plan_is_the_source(cuda, form):
    """K7's launch plan has one owner, the source's plan_of: the C query
    reports it, and k7_plan (the CPU tests' twin) equals it at rwkv6-7b's,
    the smoke and a ragged width, on 1, 37 and 132 blocks, B 1 and 8."""
    from repro_torch.kernels.fused_decode import k7_plan, k7_plan_of_source
    for D, F, H, N in ((4096, 14336, 64, 64), (64, 128, 4, 16),
                       (80, 176, 5, 16)):
        for grid in (1, 37, 132):
            for B in (1, 8):
                assert k7_plan(D, F, H, N, form, grid, B).ints() == \
                    k7_plan_of_source(D, F, H, N, form, grid, B)


def _k7_smoke(cuda, policy=None, **widths):
    """An rwkv6 smoke model (two layers; `widths` replace the config's)
    packed under `policy` (None: all W8), drawn on the card."""
    import dataclasses
    from repro_torch.core.quant.serving import pack_leaf
    from repro_torch.tree import keystr
    cfg = dataclasses.replace(get_model("rwkv6-7b", smoke=True).cfg,
                              **widths)
    model = get_model(cfg)
    params = model.init_params(3, cuda, leaf_fn=lambda p, t: pack_leaf(
        keystr(p), t, policy))
    return model, params


def _k7_holds(model, params, B, seed):
    """K7-block on layer 0 against its plain version (the K7 rule of
    test_rwkv6_block_decode), bit for bit on 1, 37 and every resident block
    and for each lane alone; K7-model equals L K7-block launches."""
    from repro_torch.models.rwkv6 import prepare_fused_model_params
    from repro_torch.tree import tree_map
    cfg = model.cfg
    layers = _layers6(model, params)
    st, x = _state6(cfg, (cfg.n_layers, B), seed)
    st0 = {k: v[0] for k, v in st.items()}
    x2, new = rwkv6_block_decode(layers[0], st0, x, cfg)
    ref = rwkv6_block_decode_plain(layers[0], st0, x, cfg)
    cpu = lambda t: t.cpu()
    on_cpu = rwkv6_block_decode_plain(tree_map(cpu, layers[0]),
                                      tree_map(cpu, st0), cpu(x), cfg)
    pick = lambda out, k: out[0] if k == "x" else out[1][k]
    for k in ("x",) + STATE6:
        r = pick(ref, k).float()
        d = (pick((x2, new), k).float() - r).abs()
        dc = (pick(on_cpu, k).float().to(x.device) - r).abs()
        assert float(d.max()) <= 2.0 ** -6 * float(r.abs().max()), k
        assert float(d.mean()) <= 1.25 * float(dc.mean()) + \
            2.0 ** -16 * float(r.abs().mean()), k
    from repro_torch.kernels.fused_decode import (
        _coop_grid, _k7_info, rwkv6_layer_table)
    D, F, H, N = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.rwkv_head_dim
    mats = rwkv6_layer_table(layers[0], D, F, H, N)
    most = _coop_grid("block", None,
                      _k7_info([m[2] for m in mats], [m[1] for m in mats]),
                      x.device)
    for grid in (1, 37, most):
        xg, sg = rwkv6_block_decode(layers[0], st0, x, cfg, grid=grid)
        assert torch.equal(xg, x2), grid
        assert all(torch.equal(sg[k], new[k]) for k in STATE6), grid
    for i in range(B):
        one, one_st = rwkv6_block_decode(
            layers[0], {k: v[i:i + 1] for k, v in st0.items()}, x[i:i + 1],
            cfg)
        assert torch.equal(one[0], x2[i])
        assert all(torch.equal(one_st[k][0], new[k][i]) for k in STATE6)
    stack = prepare_fused_model_params(params, cfg)["blocks"]
    xm, newm = rwkv6_model_decode(stack, st, x, cfg)
    xb, newb = x, []
    for l, lp in enumerate(layers):
        xb, sb = rwkv6_block_decode(lp, {k: st[k][l] for k in STATE6}, xb,
                                    cfg)
        newb.append(sb)
    assert torch.equal(xm, xb)
    for k in STATE6:
        assert torch.equal(newm[k], torch.stack([s[k] for s in newb]))


def test_rwkv6_ragged_strips(cuda):
    """D 80 and F 176, no multiple of K7's 32-column strips (the last strip
    of every matrix half empty), all W8."""
    model, params = _k7_smoke(cuda, d_model=80, d_ff=176, n_heads=5)
    _k7_holds(model, params, 8, 21)


def test_rwkv6_w4_and_a_short_codebook(cuda):
    """A W4 att.wk and ffn.wk and a VQ ffn.wv of 37 codebook entries
    (fewer than the 256 a code byte can name), the rest W8."""
    policy = PlanePolicy(default="w8", vq_codes=37, overrides=(
        (r"\['att'\]\['wk'\]", "w4"), (r"\['ffn'\]\['wk'\]", "w4"),
        (r"\['ffn'\]\['wv'\]", "vq")))
    model, params = _k7_smoke(cuda, policy)
    _k7_holds(model, params, 6, 22)


@pytest.mark.parametrize("B", list(range(1, 9)))
def test_rwkv6_block_decode_every_batch(cuda, wide6, B):
    """At full width, K7-block on B lanes (1 to 8) gives the bits of the
    same lanes of an 8-lane call."""
    model, params = wide6
    cfg = model.cfg
    lp = _layers6(model, params)[0]
    st, x = _state6(cfg, (8,), 23)
    x8, new8 = rwkv6_block_decode(lp, st, x, cfg)
    xb, newb = rwkv6_block_decode(lp, {k: v[:B] for k, v in st.items()},
                                  x[:B], cfg)
    assert torch.equal(xb, x8[:B])
    assert all(torch.equal(newb[k], new8[k][:B]) for k in STATE6)


@pytest.mark.parametrize("grid", ["one", "thirty-seven", "all"])
def test_rwkv6_model_decode_any_grid(cuda, wide6, grid):
    """At full width, K7-model on 1, 37 or every resident block gives the
    default grid's bits."""
    from repro_torch.kernels.fused_decode import (
        PLANE_IDS, RWKV6_MAT_KEYS, _coop_grid, _k7_info)
    from repro_torch.models.rwkv6 import prepare_fused_model_params
    model, params = wide6
    cfg = model.cfg
    stack = prepare_fused_model_params(params, cfg)["blocks"]
    st, x = _state6(cfg, (cfg.n_layers, 8), 24)
    xm, newm = rwkv6_model_decode(stack, st, x, cfg)
    w8 = _k7_info([PLANE_IDS["w8"]] * len(RWKV6_MAT_KEYS),
                  [None] * len(RWKV6_MAT_KEYS))
    g = {"one": 1, "thirty-seven": 37,
         "all": _coop_grid("model", None, w8, x.device)}[grid]
    xg, newg = rwkv6_model_decode(stack, st, x, cfg, grid=g)
    assert torch.equal(xg, xm)
    assert all(torch.equal(newg[k], newm[k]) for k in STATE6)


# --- K13's backward: K13-dq and K13-dkv ------------------------------------


@pytest.mark.parametrize("B,Sq,Skv,H,KVH,d,causal,dtype", [
    (1, 512, 512, 9, 3, 64, True, torch.bfloat16),     # smollm's heads
    (2, 200, 200, 9, 3, 64, True, torch.bfloat16),     # ragged tiles
    (1, 130, 130, 4, 4, 96, False, torch.float32),     # MHA, hd 96
    (1, 70, 150, 8, 2, 128, True, torch.bfloat16),     # Sq != Skv, hd 128
    (1, 150, 70, 6, 2, 32, True, torch.float32),       # keys past the rows
    (3, 1, 33, 6, 2, 24, False, torch.float32),        # one query row
    # the bf16 tensor-core instances: Sq and Skv on both sides of the
    # 64-row ring tile, causal and full
    (2, 40, 130, 6, 2, 64, True, torch.bfloat16),
    (1, 130, 40, 6, 2, 64, True, torch.bfloat16),
    (2, 40, 130, 6, 3, 128, False, torch.bfloat16),
    (1, 150, 70, 6, 3, 128, False, torch.bfloat16),
    # ragged edges at d 64 and 128, rep 1 and rep 3
    (2, 100, 100, 4, 4, 64, True, torch.bfloat16),
    (1, 100, 100, 8, 8, 128, True, torch.bfloat16),
    (1, 200, 200, 6, 2, 128, True, torch.bfloat16),
    # d padded to k16 (16, 24, 32, 96); d 36 loads rows by elements
    (2, 100, 100, 4, 2, 16, True, torch.bfloat16),
    (2, 130, 130, 6, 3, 32, False, torch.bfloat16),
    (1, 300, 300, 8, 4, 96, True, torch.bfloat16),
    (1, 90, 90, 6, 2, 36, True, torch.bfloat16),
    (2, 70, 70, 3, 3, 24, False, torch.bfloat16),
    (3, 1, 33, 6, 2, 64, True, torch.bfloat16),        # one query row
])
def test_flash_attention_bwd(cuda, B, Sq, Skv, H, KVH, d, causal, dtype):
    """K13-dq and K13-dkv against the plain backward within `bwd_bounds`;
    deterministic bit for bit; through the autograd Function too."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_dkv, flash_attention_dq)
    g = torch.Generator(device=cuda).manual_seed(Sq + 3 * d)
    rn = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)
    q, k, v = rn(B, Sq, H, d), rn(B, Skv, KVH, d), rn(B, Skv, KVH, d)
    do = rn(B, Sq, H, d)
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    before = (flash_attention_dq.launches, flash_attention_dkv.launches)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert (flash_attention_dq.launches, flash_attention_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    ref = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    bounds = bwd_bounds(q, k, v, o, lse, do, causal, ref)
    for name, x, r, bnd in zip(("dq", "dk", "dv"), got, ref, bounds):
        assert x.dtype == dtype and x.shape == r.shape, name
        dd = (x.float() - r.float()).abs()
        assert bool((dd <= bnd).all()), (name, float(dd.max()))
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = flash_attention(qg, kg, vg, causal=causal)
    assert torch.equal(out.detach(), o)
    auto = torch.autograd.grad(out, (qg, kg, vg), do)
    assert all(torch.equal(a, b) for a, b in zip(auto, got))


def test_flash_attention_bwd_unaligned_rows(cuda):
    """q, k, v and dout contiguous but one element into their storage (rows
    not 16-byte aligned): the kernels take the element-load path, which
    stages the same tiles, so the forward and both backward kernels give
    the aligned call's bits."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd)
    g = torch.Generator(device=cuda).manual_seed(11)
    rn = lambda *s: torch.randn(s, generator=g, device=cuda).to(
        torch.bfloat16)
    for B, S, H, KVH, d in ((2, 150, 9, 3, 64), (1, 100, 8, 4, 128)):
        q, k, v, do = rn(B, S, H, d), rn(B, S, KVH, d), rn(B, S, KVH, d), \
            rn(B, S, H, d)
        o, lse = flash_attention(q, k, v, return_lse=True)
        got = flash_attention_bwd(q, k, v, o, lse, do)
        uq, uk, uv, udo = (_unaligned(t) for t in (q, k, v, do))
        assert all(t.is_contiguous() and t.data_ptr() % 16
                   for t in (uq, uk, uv, udo))
        uo, ulse = flash_attention(uq, uk, uv, return_lse=True)
        assert torch.equal(uo, o) and torch.equal(ulse, lse)
        again = flash_attention_bwd(uq, uk, uv, _unaligned(o), lse, udo)
        assert all(torch.equal(a, b) for a, b in zip(again, got))


def _dominated(B, Sq, Skv, H, KVH, d, seed, device="cpu"):
    """bf16 (q, k, v, dout) where a few keys take most of each row's
    weight: every query leans on one direction u (|u| = 1) and keys 0,
    Skv / 3 and 2·Skv / 3 lie along it, so their scores sit ~8 above the
    others' N(0, 5); key 0 is in every causal row.  Drawn with numpy, as
    tests/test_torch_flash.py draws its own."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, d))
    k = rng.normal(size=(B, Skv, KVH, d))
    v = rng.normal(size=(B, Skv, KVH, d))
    do = rng.normal(size=(B, Sq, H, d))
    u = rng.normal(size=d)
    u /= np.linalg.norm(u)
    q += 2.0 * np.sqrt(d) * u
    for j in (0, Skv // 3, 2 * Skv // 3):
        k[:, j] = 0.25 * k[:, j] + 4.0 * u
    return tuple(torch.from_numpy(a.astype(np.float32)).to(
        device=device, dtype=torch.bfloat16) for a in (q, k, v, do))


@pytest.mark.parametrize("B,Sq,Skv,H,KVH,d,causal", [
    (2, 512, 512, 9, 3, 64, True),        # smollm's heads
    (1, 300, 300, 8, 4, 96, True),
    (1, 200, 200, 8, 2, 128, False),
    (1, 130, 70, 6, 2, 64, True),
])
def test_flash_attention_dominated_keys(cuda, B, Sq, Skv, H, KVH, d,
                                        causal):
    """K13, K13-dq and K13-dkv on inputs where a few keys dominate each
    row, against the plain versions: the forward within one bf16 step plus
    `_attn_floor`, the lse as test_flash_attention, the backward within
    `bwd_bounds`."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain)
    q, k, v, do = _dominated(B, Sq, Skv, H, KVH, d, Sq + d, cuda)
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    ref, lse_p = flash_attention_plain(q, k, v, causal=causal,
                                       return_lse=True)
    _attn_ok(o, ref, _attn_floor(q, k, v, causal))
    assert float((lse - lse_p).abs().max()) <= (Skv + d + 8) * 2.0 ** -24 \
        * (1.0 + float(lse_p.abs().max()))
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    for name, x, r, bnd in zip(("dq", "dk", "dv"), got, want,
                               bwd_bounds(q, k, v, o, lse, do, causal,
                                           want)):
        dd = (x.float() - r.float()).abs()
        assert bool((dd <= bnd).all()), (name, float(dd.max()))


def test_train_step_smollm_smoke_on_card(cuda):
    """One train step of smollm smoke at S = 512 with use_flash_kernel on
    the card: K13 twice a layer (the forward and its recompute under
    remat), K13-dq and K13-dkv once a layer; a finite loss; each leaf's
    gradient no farther from an f32 witness (the port's f32 config on the
    same weights, plain attention, on the CPU) than 1.25·√2 times the CPU
    bf16 step's own gap to it (two bf16 paths, each a bf16 noise distance
    from the witness)."""
    import dataclasses
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_dkv, flash_attention_dq)
    from repro_torch.launch.steps import build_train_step, loss_and_grads
    from repro_torch.tree import leaves_with_path, tree_map
    base = get_model("smollm-135m", smoke=True)
    mk = lambda **kw: type(base)(cfg=dataclasses.replace(base.cfg, **kw),
                                 module=base.module)
    flash, f32m = mk(use_flash_kernel=True), mk(dtype="float32")
    params = flash.init_params(0, "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, flash.cfg.vocab, (2, 513))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).int(),
             "labels": torch.from_numpy(toks[:, 1:]).int(),
             "mask": torch.ones((2, 512))}
    on = lambda t: tree_map(lambda a: a.to(cuda), t)
    (_, _), g_wit = loss_and_grads(f32m, params, batch)
    (_, _), g_cpu = loss_and_grads(flash, params, batch)
    step, _, (init_opt, _) = build_train_step(flash)
    p_card = on(params)
    (_, _), g_card = loss_and_grads(flash, p_card, on(batch))
    counters = (flash_attention, flash_attention_dq, flash_attention_dkv)
    before = [c.launches for c in counters]
    p_card, _, metrics = step(p_card, init_opt(p_card), on(batch))
    torch.cuda.synchronize()
    L = flash.cfg.n_layers
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [2 * L, L, L]
    assert bool(torch.isfinite(metrics["loss"]))
    wit, cpu = dict(leaves_with_path(g_wit)), dict(leaves_with_path(g_cpu))
    for path, g in leaves_with_path(g_card):
        w = wit[path].float()
        gap = lambda x: float((x.float().cpu() - w).abs().mean()
                              / w.abs().mean())
        assert gap(g) <= 1.25 * 2 ** 0.5 * gap(cpu[path]), path


# --- the RWKV whole-sequence forward: K10, K11 and the smoke forwards -----

from repro_torch.kernels.expsig import sigmoid_kernel, sigmoid_kernel_plain
from repro_torch.kernels.fused_layernorm import (
    fused_layernorm, fused_layernorm_plain)
from repro_torch.kernels.wkv6 import (
    chunk_length, wkv6_chunked_kernel, wkv6_chunked_plain, wkv6_seq,
    wkv6_seq_plain)


def _wkv6_chunked_bound(r, k, v, w, u, s0, chunk=64):
    """The most that two f32 evaluations of the chunked WKV-6 in other
    orders may differ by, per output of y and S: (8·G + 2C + 2N + 16)·2^-24
    times the output's magnitude (the recurrence on |r|, |k|, |v|, |u|,
    |s0|: each sum's absolute terms; the state's error is carried through
    G chunks), plus 2C·2^-23·max|log w| of the magnitude, for a log of the
    card's plain version a last bit off the kernel's logf, which moves
    every L after it."""
    B, T, H, N = r.shape
    C = chunk_length(T, chunk)
    G = T // C
    mag = wkv6_chunked_plain(r.float().abs(), k.float().abs(),
                             v.float().abs(), w, u.abs(),
                             None if s0 is None else s0.abs(), chunk=chunk)
    logw = float(torch.log(torch.clamp(w.float(), min=1e-38)).abs().max())
    rel = (8 * G + 2 * C + 2 * N + 16) * 2.0 ** -24 + 2 * C * 2.0 ** -23 * logw
    return rel * mag[0], rel * mag[1]


# (B, T, H, N, s0, decay shift, bf16 r/k/v; "w": bf16 r, k, v and w)
K10_CASES = [
    (1, 64, 1, 64, False, 0.0, False),
    (2, 256, 4, 64, True, 0.0, False),
    (2, 96, 4, 64, True, 0.0, False),     # ragged: C halves to 32
    (2, 128, 4, 16, True, 0.0, True),     # the smoke model's head size
    (1, 128, 2, 32, False, 0.5, True),
    (1, 128, 4, 64, True, 3.0, False),    # strong decay: e^L underflows
    (1, 4096, 64, 64, False, 0.0, True),  # the forward's types, mid size
    (1, 256, 4, 64, True, 0.0, "w"),      # a bf16 w
    (3, 96, 4, 64, True, 0.0, True),      # B 3, ragged C 32
    (1, 100, 2, 16, True, 0.0, False),    # C 4: one padded sub-chunk
    (2, 40, 2, 32, False, 0.0, True),     # C 40: three sub-chunks, padded
]


@pytest.mark.parametrize("B,T,H,N,with_s0,shift,bf", K10_CASES)
def test_wkv6_chunked(cuda, B, T, H, N, with_s0, shift, bf):
    g = torch.Generator(device=cuda).manual_seed(T + N)
    rn = lambda *s: torch.randn(s, generator=g, device=cuda)
    dt = torch.bfloat16 if bf else torch.float32
    r, k, v = (rn(B, T, H, N).to(dt) for _ in range(3))
    w = torch.exp(-torch.exp(0.5 * rn(B, T, H, N) + shift))
    if bf == "w":
        w = w.to(torch.bfloat16)
    u, s0 = 0.5 * rn(H, N), rn(B, H, N, N) if with_s0 else None
    before = wkv6_chunked_kernel.launches
    y, S = wkv6_chunked_kernel(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert wkv6_chunked_kernel.launches == before + 1
    y_p, S_p = wkv6_chunked_plain(r, k, v, w, u, s0)
    by, bS = _wkv6_chunked_bound(r, k, v, w, u, s0)
    for o, ref, bound in ((y, y_p, by), (S, S_p, bS)):
        assert o.dtype == torch.float32 and bool(torch.isfinite(o).all())
        assert bool(((o - ref).abs() <= bound).all()), \
            float((o - ref).abs().max())
    # repeatable bit for bit
    y2, S2 = wkv6_chunked_kernel(r, k, v, w, u, s0)
    assert torch.equal(y, y2) and torch.equal(S, S2)


def test_wkv6_chunked_refusals(cuda):
    rn = lambda *s: torch.randn(s, device=cuda)
    before = wkv6_chunked_kernel.launches
    with pytest.raises(ValueError, match="head dim"):
        wkv6_chunked_kernel(*(rn(1, 64, 2, 24) for _ in range(4)),
                            rn(2, 24))
    with pytest.raises(ValueError, match="chunk"):
        wkv6_chunked_kernel(*(rn(1, 256, 2, 16) for _ in range(4)),
                            rn(2, 16), chunk=128)
    assert wkv6_chunked_kernel.launches == before


@pytest.mark.parametrize("B,T,H,N,bf", [
    (1, 32768, 64, 64, True), (1, 4096, 64, 64, False), (3, 96, 4, 64, True),
    (1, 100, 2, 16, False), (2, 40, 2, 32, True), (1, 1, 2, 16, False)])
def test_wkv6_chunked_plan_is_the_source(cuda, B, T, H, N, bf):
    """`k10_plan`'s passes, which the CPU plan tests hold to the card's
    limits, are the blocks, threads and shared bytes that the C entry
    launches (`wkv6_chunked_plan`, from the same `plan_of` as the launch)."""
    import ctypes

    from repro_torch.kernels.build import check, load_library
    from repro_torch.kernels.wkv6 import k10_plan
    out = (ctypes.c_int * 9)()
    check(load_library().wkv6_chunked_plan(B, T, H, N, chunk_length(T),
                                           int(bf), out),
          "wkv6_chunked_plan")
    plan = k10_plan(B, T, H, N, rkv_bytes=2 if bf else 4)
    assert [tuple(out[3 * i:3 * i + 3]) for i in range(3)] == \
        [p[1:] for p in plan.passes]


def _ln_floor(x, gamma, beta, eps=1e-5):
    """The f32 sum-order bound of each LayerNorm output: the row's mean and
    E[x²] summed in another order move by up to (D + 2)·2^-24 of their
    absolute sums, which moves var, then rsqrt (a few ulps apart on the
    two sides), then (x − μ)·rs·γ + β, each op one more rounding."""
    u = 2.0 ** -24
    x32 = x.float()
    D = x.shape[-1]
    mu = x32.mean(-1, keepdim=True)
    ex2 = (x32 * x32).mean(-1, keepdim=True)
    var = ex2 - mu * mu
    em = (D + 2) * u * x32.abs().mean(-1, keepdim=True)
    e_var = (D + 2) * u * ex2 + 2 * mu.abs() * em + 2 * u * (ex2 + mu * mu)
    rs = torch.rsqrt(var + eps)
    rel_rs = 0.5 * e_var / (var + eps) + 4 * u
    yn = (x32 - mu).abs() * rs
    g, b = gamma.float().abs(), beta.float().abs()
    return g * (em * rs + yn * rel_rs) + 4 * u * (yn * g + b)


def _ln_ok(out, ref, x, gamma, beta):
    step = 2.0 ** -7 if out.dtype == torch.bfloat16 else 2.0 ** -22
    d = (out.float() - ref.float()).abs()
    return bool((d <= step * ref.float().abs()
                 + 1.01 * _ln_floor(x, gamma, beta)).all()), float(d.max())


@pytest.mark.parametrize("R,D", [(64, 4096), (37, 768), (5, 100), (3, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_layernorm(cuda, R, D, dtype):
    """K11 against its plain version: rows ragged against nothing (one
    block a row), D a multiple of 16 bytes (vector loads) or not."""
    g = torch.Generator(device=cuda).manual_seed(R * D)
    rn = lambda *s: torch.randn(s, generator=g, device=cuda)
    x = (2 * rn(R, D) + 0.5).to(dtype)
    gamma, beta = rn(D).to(dtype), rn(D).to(dtype)
    before = fused_layernorm.launches
    out = fused_layernorm(x, gamma, beta)
    torch.cuda.synchronize()
    assert fused_layernorm.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    ok, err = _ln_ok(out, fused_layernorm_plain(x, gamma, beta), x, gamma,
                     beta)
    assert ok, err
    # a (B, S, D) view and f32 gamma on bf16 x, as the f32 witness mixes
    x3 = x.reshape(1, R, D)
    g32, b32 = gamma.float(), beta.float()
    ok, err = _ln_ok(fused_layernorm(x3, g32, b32),
                     fused_layernorm_plain(x3, g32, b32), x3, g32, b32)
    assert ok, err


def _plain_kernels(monkeypatch):
    """Send the RWKV forwards through the plain versions on the card: the
    plain path every kernel path is held to."""
    from repro_torch.models import layers, rwkv4, rwkv6
    for mod, name, fn in (
            (rwkv6, "wkv6_chunked_kernel", wkv6_chunked_plain),
            (rwkv6, "wkv6_seq", wkv6_seq_plain),
            (rwkv4, "wkv4_seq", wkv4_seq_plain),
            (layers, "fused_layernorm", fused_layernorm_plain),
            (rwkv4, "sigmoid_kernel", sigmoid_kernel_plain)):
        monkeypatch.setattr(mod, name, fn)


@pytest.mark.parametrize("arch,S,hw", [("rwkv6-7b", 128, False),
                                       ("rwkv6-7b", 40, False),
                                       ("rwkv4-169m", 64, False),
                                       ("rwkv4-169m", 64, True)])
def test_rwkv_forward_smoke_on_card(cuda, monkeypatch, arch, S, hw):
    """The smoke forward of each RWKV family on the card through
    build_prefill_step: K11 2L + 2 times; K10 L times (S % 64 == 0, S >
    64) or K6 L times for rwkv6; K2 L times for rwkv4, and under hw K9 2L
    times; its logits against the plain path on the card."""
    from repro_torch.launch.steps import build_prefill_step
    model = get_model(arch, smoke=True)
    params = model.cast_params(model.init_params(0, cuda))
    L = model.cfg.n_layers
    toks = torch.randint(0, model.cfg.vocab, (2, S), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    counters = (fused_layernorm, wkv6_chunked_kernel, wkv6_seq, wkv4_seq,
                sigmoid_kernel)
    for c in counters:
        c.launches = 0
    logits = build_prefill_step(model, hw=hw)(params, {"tokens": toks})
    torch.cuda.synchronize()
    got = {c.__name__: c.launches for c in counters}
    rwkv6 = arch == "rwkv6-7b"
    want = {"fused_layernorm": 2 * L + 2,
            "wkv6_chunked_kernel": L if rwkv6 and S == 128 else 0,
            "wkv6_seq": L if rwkv6 and S == 40 else 0,
            "wkv4_seq": 0 if rwkv6 else L,
            "sigmoid_kernel": 2 * L if hw else 0}
    assert got == want
    assert logits.shape == (2, S, model.cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    _plain_kernels(monkeypatch)
    ref = build_prefill_step(model, hw=hw)(params, {"tokens": toks}).float()
    d = (logits.float() - ref).abs()
    assert float(d.max()) <= 2.0 ** -5 * float(ref.abs().max())
    assert float(d.mean()) <= 2.0 ** -8 * float(ref.abs().mean())


def test_rwkv_forward_refuses_grad_on_card(cuda):
    """With grad enabled and params that require grad, what has no backward
    kernel raises on the card before it launches, and never takes the plain
    versions: rwkv4's hw forward at K2-hw, K10 and K6 from an initial state
    that requires grad, K6 from a bf16 one, with a valid mask or a carry
    snap, and K9, K2
    with the LUT tables or a valid mask alone.  rwkv6's forward itself goes
    through K10 and its autograd Function (K10-bwd, K6-bwd cover the
    forward's own calls)."""
    from repro_torch.tree import tree_map
    grad = lambda p: tree_map(lambda t: t.requires_grad_(), p)
    model6 = get_model("rwkv6-7b", smoke=True)
    params6 = grad(model6.init_params(0, cuda))
    toks = torch.zeros((1, 128), dtype=torch.int32, device=cuda)
    counters = (wkv4_seq, wkv6_chunked_kernel, wkv6_seq, sigmoid_kernel)
    before = [c.launches for c in counters]
    logits, _ = model6.forward(params6, {"tokens": toks})
    assert logits.requires_grad
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [0, model6.cfg.n_layers, 0, 0]
    before = [c.launches for c in counters]
    model4 = get_model("rwkv4-169m", smoke=True)
    params4 = grad(model4.init_params(0, cuda))
    with pytest.raises(NotImplementedError, match="hardware numerics"):
        model4.forward(params4, {"tokens": toks[:, :8]}, hw=True)
    rq = torch.randn((1, 64, 2, 16), device=cuda, requires_grad=True)
    rn = lambda *s: torch.randn(s, device=cuda)
    s0g = torch.zeros((1, 2, 16, 16), device=cuda, requires_grad=True)
    luts = {"exp_table": lut_tensor("exp", cuda),
            "div_table": lut_tensor("div", cuda)}
    k2 = lambda **kw: wkv4_seq(rq.reshape(1, 64, 32), rn(1, 64, 32),
                               rn(32), rn(32), rn(1, 32), rn(1, 32),
                               rn(1, 32), **kw)
    k6 = lambda s0, **kw: wkv6_seq(rq, rq, rq, rn(1, 64, 2, 16), rn(2, 16),
                                   s0, **kw)
    own = "initial state that takes no gradient"
    for call, why in (
            (lambda: wkv6_chunked_kernel(rq, rq, rq, rn(1, 64, 2, 16),
                                         rn(2, 16), s0g), own),
            (lambda: k6(s0g), own),
            (lambda: k6(rn(1, 2, 16, 16).to(torch.bfloat16)), own),
            (lambda: k6(rn(1, 2, 16, 16),
                        valid=torch.ones((1, 64), device=cuda)), own),
            (lambda: k6(rn(1, 2, 16, 16), carry_dtype="bfloat16"), own),
            (lambda: sigmoid_kernel(rq), "hardware numerics"),
            (lambda: k2(**luts), "hardware numerics"),
            (lambda: k2(valid=torch.ones((1, 64), device=cuda)),
             "valid mask")):
        with pytest.raises(NotImplementedError, match=why):
            call()
    assert [c.launches for c in counters] == before
    with torch.no_grad():       # no grad mode: the forward serves
        logits, _ = model6.forward(params6, {"tokens": toks})
    assert bool(torch.isfinite(logits).all())


# --- the RWKV training slice: K12, K12-bwd, K11-bwd, K2-bwd ---------------

from repro_torch.kernels.fused_ce import (
    fused_cross_entropy, fused_cross_entropy_bwd, fused_cross_entropy_plain)
from repro_torch.kernels.fused_layernorm import fused_layernorm_bwd
from repro_torch.kernels.wkv4 import wkv4_seq_bwd, wkv4_seq_bwd_plain


def _ce_inputs(cuda, N, V, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (3 * torch.randn((N, V), generator=g, device=cuda)).to(dtype)
    lbl = torch.randint(0, V, (N,), generator=g, device=cuda,
                        dtype=torch.int32)
    lbl[:4] = torch.tensor([0, V - 1, min(127, V - 1), min(128, V - 1)],
                           device=cuda, dtype=torch.int32)[:min(4, N)]
    return x, lbl, torch.rand((N,), generator=g, device=cuda)


@pytest.mark.parametrize("N,V,dtype", [
    (64, 50277, torch.bfloat16), (37, 50277, torch.float32),
    (16, 49152, torch.bfloat16), (9, 1000, torch.float32),
    (5, 129, torch.bfloat16), (3, 1, torch.float32)])
def test_fused_cross_entropy(cuda, N, V, dtype):
    """K12 against its plain version (the f32 log-softmax and the label's
    entry): |d| <= 2^-16 + 2^-21 |ref| (the sum-exp taken in another order
    moves the lse by up to ~2^-17 absolute at V = 50277: ~100 sequential
    f32 adds a thread, the tree, the exp's argument rounding; then the
    lse and nll roundings).  K12-bwd against the plain version's autograd
    gradient, through the autograd Function: |d| <= one step of the
    output's type (2^-7 |ref| in bf16, 2^-22 in f32) plus 2^-16 |g|·p,
    p = exp(x − lse) the entry's probability: p taken from another lse
    (Δlse up to ~2^-17) and from x − lse rounded in f32 (2^-20 relative
    at |x − lse| < 32) moves p·g by that fraction of itself, and the
    floor scales with p, so an entry written wrong fails however small
    its probability; at the label, p − 1 cancels, and the floor's p·g
    still covers the error of p.  Labels at both ends of the row and at a
    128-block edge; V = 50277 and 129 take a ragged tail, V = 1 no vector
    at all; the backward twice, bit for bit."""
    x, lbl, gr = _ce_inputs(cuda, N, V, dtype, N * V)
    b0, b1 = fused_cross_entropy.launches, fused_cross_entropy_bwd.launches
    with torch.no_grad():
        nll = fused_cross_entropy(x, lbl)
    ref = fused_cross_entropy_plain(x, lbl)
    d = (nll - ref).abs()
    assert bool((d <= 2.0 ** -16 + 2.0 ** -21 * ref.abs()).all()), \
        float(d.max())
    xa = x.clone().requires_grad_()
    (fused_cross_entropy(xa, lbl) * gr).sum().backward()
    xr = x.clone().requires_grad_()
    (fused_cross_entropy_plain(xr, lbl) * gr).sum().backward()
    torch.cuda.synchronize()
    assert (fused_cross_entropy.launches - b0,
            fused_cross_entropy_bwd.launches - b1) == (2, 1)
    assert xa.grad.dtype == dtype
    step = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
    lse = torch.logsumexp(x.float(), dim=-1)
    p = torch.exp(x.float() - lse[:, None])
    d = (xa.grad.float() - xr.grad.float()).abs()
    ok = d <= step * xr.grad.float().abs() + 2.0 ** -16 * gr[:, None] * p
    assert bool(ok.all()), float(d.max())
    again = [fused_cross_entropy_bwd(x, lbl, lse, gr) for _ in range(2)]
    assert torch.equal(again[0], again[1])


def test_fused_cross_entropy_batched_and_offset(cuda):
    """(B, S, V) logits through the wrapper equal the (B·S, V) call; a row
    view at an odd element offset (the head peeled to reach 16 bytes) gives
    the aligned copy's bits."""
    x, lbl, _ = _ce_inputs(cuda, 12, 333, torch.bfloat16, 5)
    with torch.no_grad():
        flat = fused_cross_entropy(x, lbl)
        batched = fused_cross_entropy(x.reshape(3, 4, 333),
                                      lbl.reshape(3, 4))
        assert torch.equal(batched.reshape(-1), flat)
        big = torch.zeros(12 * 333 + 1, dtype=torch.bfloat16, device=cuda)
        big[1:] = x.reshape(-1)
        off = big[1:].view(12, 333)
        assert off.data_ptr() % 16 != 0
        assert torch.equal(fused_cross_entropy(off, lbl), flat)


def _layernorm_grads(fn, x, gamma, beta, dy):
    xa, ga, ba = (t.clone().requires_grad_() for t in (x, gamma, beta))
    fn(xa, ga, ba).backward(dy)
    return xa.grad, ga.grad, ba.grad


@pytest.mark.parametrize("R,D", [(8192, 768), (64, 4096), (37, 768),
                                 (5, 100), (3, 1), (256, 4096), (8192, 576)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_layernorm_bwd(cuda, R, D, dtype):
    """K11-bwd through the autograd Function against the plain version's
    autograd gradient: dx within one step of its type plus (D + 64)·2^-24
    rs·(|dx̂| + mean|dx̂| + |x̂|·mean|dx̂·x̂|) (the row means summed in
    another order, and autograd's other graph for the same derivative);
    dγ and dβ within one step plus (R + 16)·2^-24 of Σ|dy·x̂| and Σ|dy|
    (the sums over rows in another order).  Twice, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(R + D)
    rn = lambda *s: torch.randn(s, generator=g, device=cuda)
    x = (2 * rn(R, D) + 0.5).to(dtype)
    gamma, beta, dy = rn(D).to(dtype), rn(D).to(dtype), rn(R, D).to(dtype)
    before = (fused_layernorm.launches, fused_layernorm_bwd.launches)
    got = _layernorm_grads(fused_layernorm, x, gamma, beta, dy)
    torch.cuda.synchronize()
    assert (fused_layernorm.launches - before[0],
            fused_layernorm_bwd.launches - before[1]) == (1, 1)
    ref = _layernorm_grads(fused_layernorm_plain, x, gamma, beta, dy)
    step = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
    x32, dy32 = x.float(), dy.float()
    mu = x32.mean(-1, keepdim=True)
    rs = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) - mu * mu + 1e-5)
    xh = (x32 - mu) * rs
    dxh = dy32 * gamma.float()
    floors = (
        (D + 64) * 2.0 ** -24 * rs * (
            dxh.abs() + dxh.abs().mean(-1, keepdim=True)
            + xh.abs() * (dxh * xh).abs().mean(-1, keepdim=True)),
        (R + 16) * 2.0 ** -24 * (dy32 * xh).abs().sum(0),
        (R + 16) * 2.0 ** -24 * dy32.abs().sum(0))
    for name, a, b, fl in zip(("dx", "dgamma", "dbeta"), got, ref, floors):
        assert a.dtype == b.dtype
        d = (a.float() - b.float()).abs()
        assert bool((d <= step * b.float().abs() + fl).all()), \
            (name, float(d.max()))
    again = fused_layernorm_bwd(x, gamma, beta, dy)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def _wkv4_case(cuda, B, T, C, zero_state, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=cuda)
    k, v, gy = 2 * rn(B, T, C), rn(B, T, C), rn(B, T, C)
    w = torch.exp(0.5 * rn(C) - 1)
    u = rn(C)
    if zero_state:
        a0, b0 = torch.zeros((B, C), device=cuda), torch.zeros((B, C),
                                                               device=cuda)
        o0 = torch.full((B, C), -1e38, device=cuda)
    else:
        a0, b0, o0 = rn(B, C), rn(B, C).abs() + 0.5, rn(B, C)
    return k, v, w, u, a0, b0, o0, gy


def _gap_ok(out, ref, max_rel, mean_rel):
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    return (bool(d.max() <= max_rel * r.max())
            and bool(d.mean() <= mean_rel * r.mean())), float(d.max())


@pytest.mark.parametrize("B,T,C,zero_state", [
    (8, 1024, 768, True), (2, 64, 37, True), (3, 100, 64, False),
    (1, 1, 8, True)])
def test_wkv4_seq_bwd(cuda, B, T, C, zero_state):
    """K2-bwd through the autograd Function against the plain version's
    autograd gradient (the step loop differentiated by torch): per output,
    max |d| <= 2^-10 max|ref| and mean |d| <= 2^-13 mean|ref| (f32 sums
    of up to T decayed terms in another order, T·2^-24 = 2^-14 at T 1024,
    and the running-max rescalings rounded elsewhere; a wrong term moves
    outputs by their own size).  Against the plain version of its own
    passes within 2^-18 of each output's max (the same operations, gw
    and gu summed over B in another order).  The forward's zero state
    (o0 = -1e38: no NaN) and a random state; twice, bit for bit."""
    k, v, w, u, a0, b0, o0, gy = _wkv4_case(cuda, B, T, C, zero_state,
                                           B * T + C)
    before = (wkv4_seq.launches, wkv4_seq_bwd.launches)
    ka, va, wa, ua = (t.clone().requires_grad_() for t in (k, v, w, u))
    y, _ = wkv4_seq(ka, va, wa, ua, a0, b0, o0)
    got = torch.autograd.grad(y, (ka, va, wa, ua), gy)
    torch.cuda.synchronize()
    assert (wkv4_seq.launches - before[0],
            wkv4_seq_bwd.launches - before[1]) == (1, 1)
    kr, vr, wr, ur = (t.clone().requires_grad_() for t in (k, v, w, u))
    yr, _ = wkv4_seq_plain(kr, vr, wr, ur, a0, b0, o0)
    ref = torch.autograd.grad(yr, (kr, vr, wr, ur), gy, allow_unused=True)
    # at T = 1 no decay is applied before the only output: w unused
    ref = [torch.zeros_like(t) if g is None else g
           for g, t in zip(ref, (k, v, w, u))]
    twin = wkv4_seq_bwd_plain(k, v, w, u, a0, b0, o0, gy)
    for name, a, b, t in zip("kvwu", got, ref, twin):
        assert bool(torch.isfinite(a).all()), name
        ok, err = _gap_ok(a, b, 2.0 ** -10, 2.0 ** -13)
        assert ok, (name, err)
        assert float((a - t).abs().max()) <= 2.0 ** -18 * float(
            t.abs().max()), name
    again = wkv4_seq_bwd(k, v, w, u, a0, b0, o0, gy)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


# K2's and K2-bwd's plan cases: the train and forward shape, ragged C (37)
# with T no multiple of the tile or Lc, T 1, and C a multiple of 4 but
# not of 32 (the 16-byte copies' ragged warp)
K2_CASES = [(8, 1024, 768), (3, 100, 37), (2, 1, 37), (4, 33, 160)]


@pytest.mark.parametrize("B,T,C", K2_CASES)
@pytest.mark.parametrize("hw", [False, True])
def test_k2_plan_is_the_source(cuda, B, T, C, hw):
    """`k2_plan`, which the CPU plan tests hold to the card's limits, is
    the source's plan (the C query `wkv4_plan`, from the same `plan_of`
    as both launches), at the defaults and at other tiles, blocks and
    chunks."""
    import ctypes

    from repro_torch.kernels.build import check, load_library
    from repro_torch.kernels.wkv4 import K2Plan, k2_plan
    for tile, warps, chunk in ((None, None, None), (7, 3, 16), (64, 2, 64)):
        out = (ctypes.c_longlong * len(K2Plan._fields))()
        check(load_library().wkv4_plan(B, T, C, int(hw), tile or 0,
                                       warps or 0, chunk or 0, out),
              "wkv4_plan")
        assert tuple(out) == tuple(k2_plan(B, T, C, hw=hw, tile=tile,
                                           warps=warps, chunk=chunk))


@pytest.mark.parametrize("spread", ["wide", "near_one", "k2"])
def test_wkv4_div_fast_is_the_division(cuda, spread):
    """K2's and K2-bwd's branch-free division (`csrc/wkv4_common.cuh:
    div_rn_fast`) equals the compiled `/` bit for bit wherever it says its
    operands are in range (|x|, |y| in [2^-47, 2^48)), and says so exactly
    there:
    2^24 random pairs, exponents over ±60 (`wide`), divisors within a few
    ulps of powers of two and dividends near multiples of them, where
    rounding is hardest (`near_one`), or K2's own numerators and
    denominators (`k2`: a bf16 state, N(0, 1) k and v)."""
    from repro_torch.kernels.build import check, load_library, stream_ptr
    n = 1 << 24
    g = torch.Generator(device=cuda).manual_seed(len(spread))
    rn = lambda: torch.randn(n, generator=g, device=cuda)
    sign = lambda: torch.where(rn() < 0, -1.0, 1.0)
    if spread == "wide":
        e = lambda: torch.randint(-60, 61, (n,), generator=g, device=cuda)
        x = sign() * (1 + torch.rand(n, generator=g, device=cuda)) * \
            torch.exp2(e().float())
        y = sign() * (1 + torch.rand(n, generator=g, device=cuda)) * \
            torch.exp2(e().float())
    elif spread == "near_one":
        ulp = torch.randint(-4, 5, (n,), generator=g, device=cuda).float()
        y = sign() * (1 + ulp * 2.0 ** -23) * torch.exp2(
            torch.randint(-8, 9, (n,), generator=g, device=cuda).float())
        m = torch.randint(1, 1 << 20, (n,), generator=g, device=cuda)
        x = (m.float() + (rn() * 2.0 ** -20)) * y
    else:
        A, Bu = torch.rand(n, generator=g, device=cuda), torch.exp(-rn().abs())
        a = rn().to(torch.bfloat16).float()
        b = (rn().abs() + 0.5).to(torch.bfloat16).float()
        x, y = A * a + Bu * rn(), A * b + Bu
    q, ref = torch.empty_like(x), torch.empty_like(x)
    inr = torch.empty(n, dtype=torch.int8, device=cuda)
    check(load_library().wkv4_div_fast(x.data_ptr(), y.data_ptr(),
                                       q.data_ptr(), inr.data_ptr(),
                                       ref.data_ptr(), n, stream_ptr(x)),
          "wkv4_div_fast")
    ex = (x.view(torch.int32) >> 23) & 255
    ey = (y.view(torch.int32) >> 23) & 255
    want = (ex >= 80) & (ex <= 174) & (ey >= 80) & (ey <= 174)
    assert torch.equal(inr.bool(), want)
    assert int(want.sum()) > n // 4
    ok = inr.bool()
    assert torch.equal(q[ok].view(torch.int32), ref[ok].view(torch.int32))


def _k2_form(cuda, B, T, C, form, seed):
    """K2's operands and keywords: `exact` (the forward's call), `masked`
    (prefix masks, the bf16 carry, a bf16 pool state) or `hw` (masked with
    the LUT tables)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=cuda)
    bf = lambda t: t.to(torch.bfloat16).float()
    args = (2 * rn(B, T, C), rn(B, T, C), torch.exp(0.5 * rn(C)),
            0.5 * rn(C), bf(rn(B, C)), bf(rn(B, C).abs() + 0.5),
            bf(rn(B, C) - 1))
    if form == "exact":
        return args, {}
    valid = torch.zeros((B, T), dtype=torch.bool, device=cuda)
    for i in range(B):
        valid[i, :(T, T // 2, 0, 1)[i % 4]] = True
    kw = {"valid": valid, "carry_dtype": "bfloat16"}
    return args, {**kw, **_hw_tabs(cuda)} if form == "hw" else kw


@pytest.mark.parametrize("B,T,C", K2_CASES)
@pytest.mark.parametrize("form", ["exact", "masked", "hw"])
def test_wkv4_seq_plan_invariant(cuda, B, T, C, form):
    """K2's outputs do not depend on its ring stage (tile) or block
    (warps), bit for bit; against the plain version by the module's K2
    rule (hw: bit for bit), at ragged C and T (T no multiple of the tile,
    T 1)."""
    args, kw = _k2_form(cuda, B, T, C, form, B * T + C)
    y, fin = wkv4_seq(*args, **kw)
    for tile, warps in ((1, 1), (7, 3), (64, 2), (16, 8)):
        y2, fin2 = wkv4_seq(*args, **kw, tile=tile, warps=warps)
        assert torch.equal(y2, y), (tile, warps)
        assert all(torch.equal(a, b) for a, b in zip(fin2, fin))
    y_p, fin_p = wkv4_seq_plain(*args, **kw)
    for o, r in zip((y, *fin), (y_p, *fin_p)):
        if form == "hw":
            assert torch.equal(o, r)
        else:
            _elementwise(o, r)


@pytest.mark.parametrize("B,T,C", K2_CASES + [(2, 50, 64)])
def test_wkv4_seq_bwd_chunk_invariant(cuda, B, T, C):
    """K2-bwd's outputs do not depend on Lc (16, 64 and, where T <= 64, one
    chunk of T steps), bit for bit, from the zero state (even cases) or a
    random one; held to the plain version of its passes as
    `test_wkv4_seq_bwd` holds them."""
    ops_ = _wkv4_case(cuda, B, T, C, B % 2 == 0, B * T + C + 1)
    got = wkv4_seq_bwd(*ops_)
    for chunk in (16, 64) + ((T,) if T <= 64 else ()):
        again = wkv4_seq_bwd(*ops_, chunk=chunk)
        assert all(torch.equal(a, b) for a, b in zip(again, got)), chunk
    twin = wkv4_seq_bwd_plain(*ops_)
    for name, a, t in zip("kvwu", got, twin):
        assert bool(torch.isfinite(a).all()), name
        assert float((a - t).abs().max()) <= 2.0 ** -18 * float(
            t.abs().max()), name


def test_train_step_rwkv4_smoke_on_card(cuda):
    """One train step of rwkv4 smoke (L2 D64, B 2, S 64) on the card: K11
    2L + 2 + 2L (remat's recompute) and K11-bwd 2L + 2, K2 2L and K2-bwd L,
    K12 and K12-bwd once; a finite loss; each leaf's gradient no farther
    from an f32 witness (the f32 config on the same weights, on the CPU)
    than 1.25·√2 times the CPU bf16 step's own gap to it."""
    import dataclasses
    from repro_torch.launch.steps import build_train_step, loss_and_grads
    from repro_torch.tree import leaves_with_path, tree_map
    base = get_model("rwkv4-169m", smoke=True)
    f32m = type(base)(cfg=dataclasses.replace(base.cfg, dtype="float32"),
                      module=base.module)
    params = base.init_params(0, "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, base.cfg.vocab, (2, 65))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).int(),
             "labels": torch.from_numpy(toks[:, 1:]).int(),
             "mask": torch.ones((2, 64))}
    on = lambda t: tree_map(lambda a: a.to(cuda), t)
    (_, _), g_wit = loss_and_grads(f32m, params, batch)
    (_, _), g_cpu = loss_and_grads(base, params, batch)
    counters = (fused_layernorm, fused_layernorm_bwd, wkv4_seq, wkv4_seq_bwd,
                fused_cross_entropy, fused_cross_entropy_bwd)
    before = [c.launches for c in counters]
    (_, _), g_card = loss_and_grads(base, on(params), on(batch))
    torch.cuda.synchronize()
    L = base.cfg.n_layers
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [4 * L + 2, 2 * L + 2, 2 * L, L, 1, 1]
    step, _, (init_opt, _) = build_train_step(base)
    p_card = on(params)
    p_card, _, metrics = step(p_card, init_opt(p_card), on(batch))
    assert bool(torch.isfinite(metrics["loss"]))
    wit, cpu = dict(leaves_with_path(g_wit)), dict(leaves_with_path(g_cpu))
    for path, g in leaves_with_path(g_card):
        w = wit[path].float()
        gap = lambda x: float((x.float().cpu() - w).abs().mean()
                              / w.abs().mean())
        assert gap(g) <= 1.25 * 2 ** 0.5 * gap(cpu[path]), path


# --- rwkv6's training: K10-bwd and K6-bwd -----------------------------------

from repro_torch.kernels.wkv6 import (
    _chunked_forward, wkv6_chunked_bwd, wkv6_chunked_bwd_plain,
    wkv6_seq_bwd, wkv6_seq_bwd_plain)


def _wkv6_bwd_case(cuda, B, T, H, N, dtype, seed, shift=0.0):
    """r, k, v (dtype), w f32 = exp(-exp(x + shift)), u, dy f32, from a
    seeded generator on the card."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    n = lambda *s: torch.randn(s, generator=g, device=cuda)
    r, k, v = (n(B, T, H, N).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(n(B, T, H, N) + shift))
    return r, k, v, w, n(H, N), n(B, T, H, N)


def _bwd_ok(got, ref, mag, w, C, bf16_outputs=0):
    """Per output: max |d| <= (2^-10 + λ)·max M and mean |d| <= (2^-13 +
    λ)·mean M, M the output's magnitude (the plain passes on |r|, |k|,
    |v|, |u|, |dy|: the sum of its absolute terms), λ = 2C·2^-23·max|log
    w| for a log a last bit apart moving every L after it (the forward's
    `_wkv6_chunked_bound`).  The first `bf16_outputs` outputs are bf16,
    each side rounding its f32 value once: their max may move by one bf16
    step, 2^-7 of M."""
    lam = 2 * C * 2.0 ** -23 * float(
        torch.log(torch.clamp(w.float(), min=1e-38)).abs().max())
    for i, (a, b, m) in enumerate(zip(got, ref, mag)):
        d = (a.float() - b.float()).abs()
        m = m.float()
        mx = (2.0 ** -7 if i < bf16_outputs else 2.0 ** -10) + lam
        assert bool(torch.isfinite(a).all()), i
        assert float(d.max()) <= mx * float(m.max()), (i, float(d.max()))
        assert float(d.mean()) <= (2.0 ** -13 + lam) * float(m.mean()), i


def _abs_ops(r, k, v, w, u, dy):
    return r.abs(), k.abs(), v.abs(), w, u.abs(), dy.abs()


@pytest.mark.parametrize("N", [16, 32, 64])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,T,H,chunk", [(2, 256, 4, 64), (1, 96, 2, 64),
                                          (2, 128, 2, 16), (2, 40, 2, 64),
                                          (3, 1, 2, 64)])
def test_wkv6_chunked_bwd(cuda, B, T, H, chunk, dtype, N):
    """K10-bwd through the autograd Function (K10 once, K10-bwd once)
    against K10-bwd's plain version on the card within `_bwd_ok` (each f32
    sum in another order; T 96 takes chunks of 32, T 40 one chunk of 40,
    no multiple of the sub-chunk, T 1 a chunk of 1); twice, bit for bit."""
    dt = getattr(torch, dtype)
    r, k, v, w, u, dy = _wkv6_bwd_case(cuda, B, T, H, N, dt, B * T + N)
    before = (wkv6_chunked_kernel.launches, wkv6_chunked_bwd.launches)
    ins = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    y, _ = wkv6_chunked_kernel(*ins, chunk=chunk)
    got = torch.autograd.grad(y, ins, dy)
    torch.cuda.synchronize()
    assert (wkv6_chunked_kernel.launches - before[0],
            wkv6_chunked_bwd.launches - before[1]) == (1, 1)
    assert [g.dtype for g in got] == [dt] * 3 + [torch.float32] * 2
    ref = wkv6_chunked_bwd_plain(r, k, v, w, u, dy, chunk=chunk)
    mag = wkv6_chunked_bwd_plain(*_abs_ops(r, k, v, w, u, dy), chunk=chunk)
    _bwd_ok(got, ref, mag, w, chunk_length(T, chunk),
            3 if dt == torch.bfloat16 else 0)
    ws = _chunked_forward(r, k, v, w, u, chunk=chunk)[2]
    again = wkv6_chunked_bwd(r, k, v, w, u, dy, chunk=chunk, workspace=ws)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_wkv6_chunked_bwd_strong_decay(cuda):
    """Strong decay (w = exp(-exp(x + 3)), most e^L underflow in a chunk):
    K10-bwd stays finite and within `_bwd_ok` of its plain version, whose
    dw walks the chunk's running state (no dℓ / w)."""
    r, k, v, w, u, dy = _wkv6_bwd_case(cuda, 1, 128, 4, 64, torch.float32,
                                       7, shift=3.0)
    ws = _chunked_forward(r, k, v, w, u)[2]
    got = wkv6_chunked_bwd(r, k, v, w, u, dy, workspace=ws)
    ref = wkv6_chunked_bwd_plain(r, k, v, w, u, dy)
    mag = wkv6_chunked_bwd_plain(*_abs_ops(r, k, v, w, u, dy))
    _bwd_ok(got, ref, mag, w, 64)


def test_wkv6_chunked_bwd_strong_decay_bf16(cuda):
    """Strong decay on the forward's types (bf16 r, k, v; w = exp(-exp(x +
    3)), f32) through the Function, T 120 in chunks of 40 (three
    sub-chunks, the last padded): finite, within `_bwd_ok` of the plain
    version (dr, dk, dv bf16), twice bit for bit."""
    r, k, v, w, u, dy = _wkv6_bwd_case(cuda, 2, 120, 4, 64, torch.bfloat16,
                                       8, shift=3.0)
    ins = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    y, _ = wkv6_chunked_kernel(*ins, chunk=40)
    got = torch.autograd.grad(y, ins, dy)
    ref = wkv6_chunked_bwd_plain(r, k, v, w, u, dy, chunk=40)
    mag = wkv6_chunked_bwd_plain(*_abs_ops(r, k, v, w, u, dy), chunk=40)
    _bwd_ok(got, ref, mag, w, 40, 3)
    ws = _chunked_forward(r, k, v, w, u, chunk=40)[2]
    again = wkv6_chunked_bwd(r, k, v, w, u, dy, chunk=40, workspace=ws)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("B,T,H,N,bf", [
    (4, 1024, 64, 64, True), (4, 1024, 64, 64, False), (3, 96, 4, 64, True),
    (1, 100, 2, 16, False), (2, 40, 2, 32, True), (1, 1, 2, 16, False)])
def test_wkv6_chunked_bwd_plan_is_the_source(cuda, B, T, H, N, bf):
    """`k10_bwd_plan`'s passes, which the CPU plan tests hold to the
    card's limits, are the blocks, threads and shared bytes that the C
    entry launches (`wkv6_chunked_bwd_plan`, from the same `plan_of` as
    the launch)."""
    import ctypes

    from repro_torch.kernels.build import check, load_library
    from repro_torch.kernels.wkv6 import k10_bwd_plan
    out = (ctypes.c_int * 12)()
    check(load_library().wkv6_chunked_bwd_plan(B, T, H, N, chunk_length(T),
                                               int(bf), out),
          "wkv6_chunked_bwd_plan")
    plan = k10_bwd_plan(B, T, H, N, rkv_bytes=2 if bf else 4)
    assert [tuple(out[3 * i:3 * i + 3]) for i in range(4)] == \
        [p[1:] for p in plan.passes]


@pytest.mark.parametrize("B,T,H,N", [(2, 40, 64, 64), (1, 1, 2, 16),
                                     (3, 13, 5, 32), (1, 100, 2, 16)])
def test_wkv6_seq_bwd_plan_is_the_source(cuda, B, T, H, N):
    """`k6_bwd_plan` is the source's plan (the C query
    `wkv6_seq_bwd_plan`, from the same `plan_of` as the launch)."""
    import ctypes

    from repro_torch.kernels.build import check, load_library
    from repro_torch.kernels.wkv6 import K6BwdPlan, k6_bwd_plan
    out = (ctypes.c_longlong * len(K6BwdPlan._fields))()
    check(load_library().wkv6_seq_bwd_plan(B, T, H, N, out),
          "wkv6_seq_bwd_plan")
    assert tuple(out) == tuple(k6_bwd_plan(B, T, H, N))


@pytest.mark.parametrize("form", ["s0", "bf16_w"])
def test_wkv6_chunked_bwd_forms(cuda, form):
    """The forms the forward's own call does not take, through the
    Function: a random initial state that takes no gradient (the
    workspace then holds the states from it), and a bf16 w (its gradient
    in bf16), against the plain version within `_bwd_ok` (B2 T256 H4
    N64, bf16 r, k, v)."""
    r, k, v, w, u, dy = _wkv6_bwd_case(cuda, 2, 256, 4, 64, torch.bfloat16,
                                       11)
    s0 = None
    if form == "s0":
        s0 = torch.randn((2, 4, 64, 64), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(
                             12))
    else:
        w = w.to(torch.bfloat16)
    ins = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    y, _ = wkv6_chunked_kernel(*ins, s0)
    got = torch.autograd.grad(y, ins, dy)
    assert got[3].dtype == w.dtype
    ref = wkv6_chunked_bwd_plain(r, k, v, w, u, dy, s0)
    mag = wkv6_chunked_bwd_plain(*_abs_ops(r, k, v, w, u, dy),
                                 None if s0 is None else s0.abs())
    _bwd_ok(got, ref, mag, w, 64, 4 if form == "bf16_w" else 3)


@pytest.mark.parametrize("N", [16, 32, 64])
@pytest.mark.parametrize("B,T,H", [(2, 40, 4), (1, 100, 2), (2, 1, 2),
                                   (2, 13, 3)])
def test_wkv6_seq_bwd(cuda, B, T, H, N):
    """K6-bwd through the autograd Function (K6 once, K6-bwd once) against
    K6-bwd's plain version on the card, per output max |d| <= 2^-10 and
    mean |d| <= 2^-13 of its magnitude (f32 sums of N terms and of up to
    T decayed steps in another order); T 100 and T 13 end inside a group
    of steps, T 1 is a lone step; twice, bit for bit."""
    r, k, v, w, u, dy = _wkv6_bwd_case(cuda, B, T, H, N, torch.float32,
                                       B * T + N + 1)
    s0 = torch.zeros((B, H, N, N), device=cuda)
    before = (wkv6_seq.launches, wkv6_seq_bwd.launches)
    ins = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    y, _ = wkv6_seq(*ins, s0)
    got = torch.autograd.grad(y, ins, dy, allow_unused=True)
    torch.cuda.synchronize()
    assert (wkv6_seq.launches - before[0],
            wkv6_seq_bwd.launches - before[1]) == (1, 1)
    ref = wkv6_seq_bwd_plain(r, k, v, w, u, s0, dy)
    mag = wkv6_seq_bwd_plain(*_abs_ops(r, k, v, w, u, dy)[:5], s0,
                             dy.abs())
    _bwd_ok(got, ref, mag, torch.ones(1), 1)
    again = wkv6_seq_bwd(r, k, v, w, u, s0, dy)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("S", [128, 40])
def test_train_step_rwkv6_smoke_on_card(cuda, S):
    """One train step of rwkv6 smoke (L2 D64 H4 N16, B 2) on the card: at
    S 128 K10 2L (remat's recompute) and K10-bwd L, at S 40 K6 2L and
    K6-bwd L; K11 4L + 2 and K11-bwd 2L + 2; K12 and K12-bwd once; a
    finite loss; each leaf's gradient no farther from an f32 witness (the
    f32 config on the same weights, on the CPU) than 1.25·√2 times the CPU
    bf16 step's own gap to it, as the rwkv4 step is held."""
    import dataclasses
    from repro_torch.launch.steps import build_train_step, loss_and_grads
    from repro_torch.tree import leaves_with_path, tree_map
    base = get_model("rwkv6-7b", smoke=True)
    f32m = type(base)(cfg=dataclasses.replace(base.cfg, dtype="float32"),
                      module=base.module)
    params = base.init_params(0, "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, base.cfg.vocab, (2, S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).int(),
             "labels": torch.from_numpy(toks[:, 1:]).int(),
             "mask": torch.ones((2, S))}
    on = lambda t: tree_map(lambda a: a.to(cuda), t)
    (_, _), g_wit = loss_and_grads(f32m, params, batch)
    (_, _), g_cpu = loss_and_grads(base, params, batch)
    counters = (fused_layernorm, fused_layernorm_bwd, wkv6_chunked_kernel,
                wkv6_chunked_bwd, wkv6_seq, wkv6_seq_bwd,
                fused_cross_entropy, fused_cross_entropy_bwd)
    before = [c.launches for c in counters]
    (_, _), g_card = loss_and_grads(base, on(params), on(batch))
    torch.cuda.synchronize()
    L = base.cfg.n_layers
    wkv = [2 * L, L, 0, 0] if S == 128 else [0, 0, 2 * L, L]
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [4 * L + 2, 2 * L + 2, *wkv, 1, 1]
    step, _, (init_opt, _) = build_train_step(base)
    p_card = on(params)
    p_card, _, metrics = step(p_card, init_opt(p_card), on(batch))
    assert bool(torch.isfinite(metrics["loss"]))
    wit, cpu = dict(leaves_with_path(g_wit)), dict(leaves_with_path(g_cpu))
    for path, g in leaves_with_path(g_card):
        w = wit[path].float()
        gap = lambda x: float((x.float().cpu() - w).abs().mean()
                              / w.abs().mean())
        assert gap(g) <= 1.25 * 2 ** 0.5 * gap(cpu[path]), path


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """AsyncCheckpointer on card tensors: f32 and bf16 leaves restored onto
    the card bit for bit, and a Python scalar as its type."""
    from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint
    g = torch.Generator(device=cuda).manual_seed(3)
    tree = {"w": torch.randn((64, 32), generator=g, device=cuda),
            "b": torch.randn((32,), generator=g,
                             device=cuda).to(torch.bfloat16),
            "n": 7}
    w0 = tree["w"].clone()
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, tree)
    tree["w"].add_(1.0)             # the snapshot was taken at save
    ck.wait()
    like = {"w": torch.empty_like(tree["w"]),
            "b": torch.empty_like(tree["b"]), "n": 0}
    out = restore_checkpoint(str(tmp_path), 1, like)
    assert out["w"].device.type == "cuda" and out["n"] == 7
    assert torch.equal(out["w"], w0)
    assert torch.equal(out["b"], tree["b"])


# --- K1 and K8: the Δ-PoT matmuls with f32 weights (kernels/dpot_matmul.py)
#
# Tolerance: each output within K·2^-24·(|x| @ |w|) of the plain version
# (the same exact products summed in f32 in other orders, the kernel's
# scale applied once after the sum) plus one step of the output's type at
# the larger of the two (each side rounds its f32 sum once); the decoded
# f32 plane, over every code, bit for bit (identity rows pick it out); a
# row's result bit for bit whatever rows share the call.  The shapes take
# M past 128 (more row tiles), K not a multiple of the 32-row stage, N
# not a multiple of the 128-column tile, and several K slices at M 128
# (the combine pass applies the scale).

from repro_torch.core.quant.delta_pot import (
    FORMAT_W4, dpot_dequantize, dpot_pack_nibbles, dpot_unpack_int8,
    dpot_unpack_nibbles)
from repro_torch.kernels import ops
from repro_torch.kernels.dpot_matmul import (
    dpot_matmul_plain, dpot_matmul_w4_plain)

K1K8_SHAPES = [(1, 96, 203), (37, 96, 203), (8, 1024, 1024),
               (128, 4096, 4096), (8, 4096, 14336), (128, 14336, 4096),
               (8, 4096, 65536), (128, 768, 50277), (300, 1000, 515),
               (300, 998, 515), (128, 3000, 512)]


def _k1k8_operands(cuda, M, K, N, w4, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.randn((K, N), generator=g, device=cuda) * 0.05
    q = dpot_quantize(w, FORMAT_W4 if w4 else FORMAT_W8, axis=-1)
    codes = dpot_pack_nibbles(q) if w4 else dpot_pack_int8(q)
    x = torch.randn((M, K), generator=g, device=cuda).to(dtype)
    return x, codes, q.scale.reshape(-1)


def _k1k8_plane(codes, scale, w4):
    unpack = dpot_unpack_nibbles if w4 else dpot_unpack_int8
    return dpot_dequantize(unpack(codes, scale[None, :],
                                  FORMAT_W4.ks if w4 else FORMAT_W8.ks))


def _k1k8_within(out, ref, x, w32):
    from repro_torch.device import exact_matmuls
    with exact_matmuls():
        mag = x.double().abs() @ w32.double().abs()
    eps = torch.finfo(out.dtype).eps
    o, r = out.double(), ref.double()
    bound = x.shape[1] * 2.0 ** -24 * mag + eps * torch.maximum(o.abs(),
                                                                r.abs())
    assert bool(((o - r).abs() <= bound).all()), float(
        ((o - r).abs() - bound).max())


@pytest.mark.parametrize("w4", [False, True], ids=["k1", "k8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", K1K8_SHAPES)
def test_dpot_matmul_k1_k8(cuda, M, K, N, dtype, w4):
    x, codes, scale = _k1k8_operands(cuda, M, K, N, w4, dtype, M + K + N)
    fn = ops.dpot_matmul_w4 if w4 else ops.dpot_matmul
    plain = dpot_matmul_w4_plain if w4 else dpot_matmul_plain
    before = fn.launches
    out = fn(x, codes, scale)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert out.dtype == dtype and tuple(out.shape) == (M, N)
    _k1k8_within(out, plain(x, codes, scale), x,
                 _k1k8_plane(codes, scale, w4))
    assert torch.equal(fn(x[:1], codes, scale), out[:1])


@pytest.mark.parametrize("w4", [False, True], ids=["k1", "k8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dpot_matmul_rows_bitwise_across_m(cuda, dtype, w4):
    """At (300, 3000, 512), planned with several K slices, a row's bits do
    not depend on the rows sharing the call: calls on 1, 8, 16, 17, 128
    and 129 rows (both row tiles), on rows 128-299 and on the last ten
    give the whole call's rows."""
    from repro_torch.kernels.fused_prefill import chunk_matmul_plan
    M, K, N = 300, 3000, 512
    assert chunk_matmul_plan(M, K, N, "w4" if w4 else "w8").slices > 1
    x, codes, scale = _k1k8_operands(cuda, M, K, N, w4, dtype, 11)
    fn = ops.dpot_matmul_w4 if w4 else ops.dpot_matmul
    out = fn(x, codes, scale)
    for a, b in ((0, 1), (0, 8), (0, 16), (0, 17), (0, 128), (0, 129),
                 (128, 300), (290, 300)):
        assert torch.equal(fn(x[a:b], codes, scale), out[a:b]), (a, b)


@pytest.mark.parametrize("w4", [False, True], ids=["k1", "k8"])
def test_dpot_matmul_decode_every_code(cuda, w4):
    """Every code (256 W8 bytes, 16 W4 nibbles in both halves of a byte)
    at 4096 random column scales: identity rows through the kernel give
    the plain version's decoded f32 plane bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(7)
    N = 4096
    scale = torch.rand(N, generator=g, device=cuda) * 2.0 ** torch.randint(
        -12, 4, (N,), generator=g, device=cuda)
    if w4:
        lo = torch.arange(16, dtype=torch.uint8, device=cuda)
        codes = (lo | (lo.flip(0) << 4))[:, None].expand(16, N).contiguous()
        K = 32
    else:
        codes = torch.arange(256, dtype=torch.uint8, device=cuda)[
            :, None].expand(256, N).contiguous()
        K = 256
    eye = torch.eye(K, device=cuda)
    fn = ops.dpot_matmul_w4 if w4 else ops.dpot_matmul
    got = fn(eye, codes, scale)
    plane = _k1k8_plane(codes, scale, w4)
    assert torch.equal(got, plane)


def test_dpot_matmul_refuses_grad_and_bad_operands(cuda):
    x, codes, scale = _k1k8_operands(cuda, 4, 64, 32, False,
                                     torch.float32, 0)
    with pytest.raises(NotImplementedError):
        ops.dpot_matmul(x.requires_grad_(), codes, scale)
    with torch.no_grad():
        assert ops.dpot_matmul(x, codes, scale).shape == (4, 32)
    with pytest.raises(ValueError):
        ops.dpot_matmul_w4(x[:, :63].detach(), codes[:32], scale)
    with pytest.raises(TypeError):
        ops.dpot_matmul(x.detach().half(), codes, scale)


# --- every weight form of the decode kernels: K3 and K4 on plain bf16
# weights (exact and hw), K7 on MIXED, W4, VQ and plain bf16 trees, and
# K5-W4 / K5-VQ with an f32 x.  Each holds its form's plain version by the
# rule of the same kernel's other forms above; the model forms equal L
# block launches bit for bit, and a lane's bits do not depend on B.

from repro_torch.kernels.fused_prefill import (
    dpot_w4_matmul_f32x, vq_matmul_f32x)


def _plain_tree(cuda, arch="rwkv4-169m"):
    model = get_model(arch, smoke=True)
    return model, model.cast_params(model.init_params(0, cuda))


@pytest.mark.parametrize("hw", [False, True], ids=["exact", "hw"])
def test_rwkv4_block_decode_bf16(cuda, hw):
    """K3 on layer 0 of a plain bf16 tree against its plain version (K3's
    rule, or K3-hw's port_helpers rule under hw); a 2-lane tile and a lane
    alone give their lanes' bits."""
    from repro_torch.models.rwkv4 import _hw_numerics_with_tables
    model, params = _plain_tree(cuda)
    lp = _layer(params["blocks"], 0)
    B, D = 4, model.cfg.d_model
    st, x = _state(cuda, (B, D), 21)
    luts = _luts(cuda) if hw else None
    nm = _hw_numerics_with_tables(luts["exp"], luts["div"]) if hw else None
    before = rwkv4_block_decode.launches
    x2, new = rwkv4_block_decode(lp, st, x, bb=2, luts=luts)
    torch.cuda.synchronize()
    assert rwkv4_block_decode.launches == before + 1
    x2_p, new_p = rwkv4_block_decode_plain(lp, st, x, nm, bb=2)
    check = _close if hw else _spread
    check(x2, x2_p)
    for k in STATE_KEYS:
        check(new[k], new_p[k])
    lanes = 2 if hw else 1       # under hw a tile shares its A9 scales
    one, one_st = rwkv4_block_decode(
        lp, {k: v[2:2 + lanes] for k, v in st.items()}, x[2:2 + lanes],
        luts=luts)
    assert torch.equal(one, x2[2:2 + lanes])
    assert all(torch.equal(one_st[k], new[k][2:2 + lanes])
               for k in STATE_KEYS)


@pytest.mark.parametrize("grid", K4_GRIDS)
@pytest.mark.parametrize("hw", [False, True], ids=["exact", "hw"])
def test_model_decode_bf16_equals_block_launches(cuda, hw, grid):
    """K4 over a plain bf16 stack (no uint8 slab), on any grid, equals L K3
    launches bit for bit and holds its plain version by the port_helpers
    rule."""
    model, params = _plain_tree(cuda)
    stack = prepare_fused_model_params(params, model.cfg, hw=hw)["blocks"]
    assert "uint8" not in stack.slabs
    L, B, D = model.cfg.n_layers, 4, model.cfg.d_model
    st, x = _state(cuda, (L, B, D), 22)
    before = rwkv4_model_decode.launches
    x4, new4 = rwkv4_model_decode(stack, st, x, grid=grid)
    aux = [a[0] for a in stack.aux]
    x3, new3 = x, []
    for l in range(L):
        lp = unfuse_layer({k: s[l] for k, s in stack.slabs.items()}, aux,
                          stack.manifest, stack.tdef)
        luts = lp.pop("_luts", None)
        x3, s3 = rwkv4_block_decode(lp, {k: st[k][l] for k in STATE_KEYS},
                                    x3, luts=luts)
        new3.append(s3)
    torch.cuda.synchronize()
    assert rwkv4_model_decode.launches == before + 1
    assert torch.equal(x4, x3)
    for k in STATE_KEYS:
        assert torch.equal(new4[k], torch.stack([s[k] for s in new3]))
    xp, newp = rwkv4_model_decode_plain(stack, st, x)
    for o, r in [(x4, xp)] + [(new4[k], newp[k]) for k in STATE_KEYS]:
        _close(o, r)


def test_engine_rwkv4_bf16_model_path(cuda):
    """ServingEngine(quantized=False, fused_decode="model",
    fused_prefill=True) decodes through K4 on bf16 matrices (K2 in the
    prefill) and serves each request as it would alone."""
    from repro_torch.serving import ServingEngine
    eng = ServingEngine("rwkv4-169m", smoke=True, quantized=False,
                        fused_decode="model", fused_prefill=True,
                        max_batch=4, prefill_chunk=4, device="cuda")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, eng.model.cfg.vocab, int(n)).tolist()
               for n in (3, 9, 1, 6)]
    counters = (wkv4_seq, rwkv4_model_decode)
    before = [c.launches for c in counters]
    handles = [eng.submit(p, max_new_tokens=5) for p in prompts]
    eng.run()
    assert all(c.launches > b for c, b in zip(counters, before))
    for p, h in zip(prompts, handles):
        solo = eng.submit(p, max_new_tokens=5)
        eng.run()
        assert solo.tokens == h.tokens


# the rwkv6 trees of every form: (default plane, overrides), None plain;
# PLANE_W4 pairs time_maa_x along the layer axis, so it stays W8 here
K7_FORMS = {"mixed": ("w8", (
    (r"\['att'\]\['wk'\]", "w4"), (r"\['ffn'\]\['wv'\]", "vq"),
    (r"\['head'\]", "w4"))),
    "w4": ("w4", ((r"time_maa_x", "w8"),)), "vq": ("vq", ()), "plain": None}


def _k7_tree(cuda, form, cfg="rwkv6-7b"):
    model = get_model(cfg, smoke=isinstance(cfg, str))
    if K7_FORMS[form] is None:
        return model, model.cast_params(model.init_params(0, cuda))
    default, over = K7_FORMS[form]
    return model, model.cast_params(pack_params(
        model.init_params(0, cuda),
        PlanePolicy(default=default, overrides=over)))


@pytest.mark.parametrize("form", list(K7_FORMS))
def test_rwkv6_forms_model_equals_block_launches(cuda, form):
    """K7 on each form (smoke widths): K7-model equals L K7-block launches
    bit for bit, each holds its plain version by the port_helpers rule,
    and a lane alone (B 1) gives the bits it gives at B 8."""
    from repro_torch.models.rwkv6 import prepare_fused_model_params
    model, params = _k7_tree(cuda, form)
    cfg = model.cfg
    stack = prepare_fused_model_params(params, cfg)["blocks"]
    st, x = _state6(cfg, (cfg.n_layers, 8), 23)
    before = (rwkv6_model_decode.launches, rwkv6_block_decode.launches)
    xm, newm = rwkv6_model_decode(stack, st, x, cfg)
    xb, newb = x, []
    for l, lp in enumerate(_layers6(model, params)):
        st_l = {k: st[k][l] for k in STATE6}
        out = rwkv6_block_decode(lp, st_l, xb, cfg)
        ref = rwkv6_block_decode_plain(lp, st_l, xb, cfg)
        for o, r in [(out[0], ref[0])] + [(out[1][k], ref[1][k])
                                          for k in STATE6]:
            _close(o, r)
        xb, sb = out
        newb.append(sb)
    torch.cuda.synchronize()
    assert (rwkv6_model_decode.launches, rwkv6_block_decode.launches) == (
        before[0] + 1, before[1] + cfg.n_layers)
    assert torch.equal(xm, xb)
    for k in STATE6:
        assert torch.equal(newm[k], torch.stack([s[k] for s in newb]))
    xp, newp = rwkv6_model_decode_plain(stack, st, x, cfg)
    for o, r in [(xm, xp)] + [(newm[k], newp[k]) for k in STATE6]:
        _close(o, r)
    one, one_st = rwkv6_model_decode(
        stack, {k: v[:, 5:6] for k, v in st.items()}, x[5:6], cfg)
    assert torch.equal(one[0], xm[5])
    assert all(torch.equal(one_st[k][:, 0], newm[k][:, 5]) for k in STATE6)


@pytest.fixture(scope="module")
def wide6_mixed():
    """rwkv6-7b at full width cut to two layers and a 256-token vocabulary,
    MIXED planes (W4 att.wk, VQ ffn.wv) drawn on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import dataclasses
    from repro_torch.core.quant.serving import pack_leaf
    from repro_torch.tree import keystr
    cfg = dataclasses.replace(get_model("rwkv6-7b").cfg, n_layers=2,
                              vocab=256)
    model = get_model(cfg)
    params = model.init_params(0, "cuda", leaf_fn=lambda p, t: pack_leaf(
        keystr(p), t, PlanePolicy(default="w8",
                                  overrides=K7_FORMS["mixed"][1])))
    return model, params


def test_rwkv6_block_decode_mixed_wide(cuda, wide6_mixed):
    """K7-block at full width on a MIXED layer against its plain version
    by test_rwkv6_block_decode's rule (2^-6 of max|ref|, a mean gap within
    1.25x the plain version's own CPU-vs-card gap); K7-model equals the
    two K7-block launches bit for bit, and a lane alone its bits."""
    from repro_torch.models.rwkv6 import prepare_fused_model_params
    from repro_torch.tree import tree_map
    model, params = wide6_mixed
    cfg = model.cfg
    layers = _layers6(model, params)
    st, x = _state6(cfg, (cfg.n_layers, 8), 24)
    st0 = {k: v[0] for k, v in st.items()}
    out = rwkv6_block_decode(layers[0], st0, x, cfg)
    ref = rwkv6_block_decode_plain(layers[0], st0, x, cfg)
    cpu = lambda t: t.cpu()
    on_cpu = rwkv6_block_decode_plain(tree_map(cpu, layers[0]),
                                      tree_map(cpu, st0), cpu(x), cfg)
    pick = lambda o, k: o[0] if k == "x" else o[1][k]
    for k in ("x",) + STATE6:
        r = pick(ref, k).float()
        d = (pick(out, k).float() - r).abs()
        dc = (pick(on_cpu, k).float().to(cuda) - r).abs()
        assert float(d.max()) <= 2.0 ** -6 * float(r.abs().max()), k
        assert float(d.mean()) <= 1.25 * float(dc.mean()) + \
            2.0 ** -16 * float(r.abs().mean()), k
    one, one_st = rwkv6_block_decode(
        layers[0], {k: v[3:4] for k, v in st0.items()}, x[3:4], cfg)
    assert torch.equal(one[0], out[0][3])
    assert all(torch.equal(one_st[k][0], out[1][k][3]) for k in STATE6)
    stack = prepare_fused_model_params(params, cfg)["blocks"]
    xm, newm = rwkv6_model_decode(stack, st, x, cfg)
    xb, newb = x, []
    for l, lp in enumerate(layers):
        xb, sb = rwkv6_block_decode(lp, {k: st[k][l] for k in STATE6}, xb,
                                    cfg)
        newb.append(sb)
    assert torch.equal(xm, xb)
    for k in STATE6:
        assert torch.equal(newm[k], torch.stack([s[k] for s in newb]))


def test_engine_rwkv6_mixed_model_path(cuda):
    """The rwkv6 engine on MIXED planes: the prefill through K5, K5-W4,
    K5-VQ and K6, the decode through K7-model (the head K5-W4), each
    request served as it would be alone."""
    from repro_torch.serving import ServingEngine
    eng = ServingEngine("rwkv6-7b", smoke=True, quantized=True,
                        plane_policy=PlanePolicy(
                            default="w8", overrides=K7_FORMS["mixed"][1]),
                        fused_decode="model", fused_prefill=True,
                        max_batch=4, prefill_chunk=4, device="cuda")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, eng.model.cfg.vocab, int(n)).tolist()
               for n in (3, 9, 1, 6)]
    counters = (dpot_w8_matmul, dpot_w4_matmul, vq_matmul, wkv6_seq,
                rwkv6_model_decode)
    before = [c.launches for c in counters]
    handles = [eng.submit(p, max_new_tokens=5) for p in prompts]
    eng.run()
    assert all(c.launches > b for c, b in zip(counters, before))
    for p, h in zip(prompts, handles):
        solo = eng.submit(p, max_new_tokens=5)
        eng.run()
        assert solo.tokens == h.tokens


@pytest.mark.parametrize("case", list(F32X_CASES))
@pytest.mark.parametrize("M", F32X_M)
@pytest.mark.parametrize("plane", ["w4", "vq"])
def test_w4_vq_matmul_f32x(cuda, plane, M, case):
    """K5-W4 and K5-VQ with an f32 x against their plain versions within
    the f32 summation bound; the decode bit for bit on identity rows; a
    row's bits do not depend on M; the bf16 forms refuse an f32 x."""
    from repro_torch.core.quant.delta_pot import (
        FORMAT_W4, dpot_pack_nibbles)
    from repro_torch.core.quant.vq import vq_quantize
    g = torch.Generator(device=cuda).manual_seed(31 + M)
    (K, wide), N = F32X_CASES[case], 203
    w = torch.randn((K, N), generator=g, device=cuda)
    if plane == "w4":
        q = dpot_quantize(w, FORMAT_W4, axis=-1)
        codes, aux = dpot_pack_nibbles(q), q.scale.reshape(-1)
        leaf = {"packed4": codes, "scale": aux[None]}
        fn, bf, plain = dpot_w4_matmul_f32x, dpot_w4_matmul, \
            dpot_w4_matmul_plain
    else:
        codes, aux = vq_quantize(w, 256)
        leaf = {"vq_idx": codes, "codebook": aux}
        fn, bf, plain = vq_matmul_f32x, vq_matmul, vq_matmul_plain
    x = _f32x_x(M, K, wide, g, cuda)
    before = (bf.launches, fn.launches)
    out = fn(x, codes, aux)
    torch.cuda.synchronize()
    assert (bf.launches, fn.launches) == (before[0], before[1] + 1)
    assert out.dtype == torch.float32
    wd = unpack_leaf(leaf)
    ref = plain(x, codes, aux)
    bound = K * 2.0 ** -24 * (x.abs() @ wd.float().abs())
    assert bool(((out - ref).abs() <= bound).all())
    assert torch.equal(fn(torch.eye(K, device=cuda), codes, aux),
                       wd.float())
    assert torch.equal(fn(x[:1], codes, aux), out[:1])
    with pytest.raises(TypeError):
        bf(x, codes, aux)


@pytest.mark.parametrize("plane", ["w4", "vq"])
def test_prefill_chunk_hw_planes_on_card(cuda, plane):
    """prefill_chunk(hw=True) on a PLANE_W4 / PLANE_VQ tree launches the
    f32-x form once a layer (att.wo) and gives finite logits within the
    port_helpers rule of its plain version on the card."""
    from repro_torch.models import rwkv4
    from repro_torch.tree import tree_map
    model, packed = _packed(cuda, PlanePolicy(default=plane))
    cfg = model.cfg
    B, C = 4, 6
    g = torch.Generator(device=cuda).manual_seed(25)
    toks = torch.randint(0, cfg.vocab, (B, C), generator=g, device=cuda,
                         dtype=torch.int32)
    valid = torch.zeros((B, C), dtype=torch.bool, device=cuda)
    for i, n in enumerate((C, 3, 0, 1)):
        valid[i, :n] = True
    f32x = dpot_w4_matmul_f32x if plane == "w4" else vq_matmul_f32x
    before = f32x.launches
    st0 = model.init_decode_state(B, 0, device=cuda)
    st, lg = rwkv4.prefill_chunk(packed, st0, toks, valid, 0, cfg, hw=True)
    torch.cuda.synchronize()
    assert f32x.launches == before + cfg.n_layers
    assert bool(torch.isfinite(lg.float()).all())
    cpu = lambda t: t.cpu()
    st_c, lg_c = rwkv4.prefill_chunk(tree_map(cpu, packed),
                                     tree_map(cpu, st0), cpu(toks),
                                     cpu(valid), 0, cfg, hw=True)
    _close(lg[valid.any(1)], lg_c.to(cuda)[valid.any(1)])
    for k in STATE_KEYS:
        _close(st[k], st_c[k].to(cuda))


# ---------------------------------------------------------------------------
# K3 over the whole card: its bits do not depend on the grid
# ---------------------------------------------------------------------------

def _k3_layer(cuda, form, arch="rwkv4-169m", smoke=True):
    """Layer 0 of a compute-cast tree packed W8 or MIXED, or plain bf16."""
    model = get_model(arch, smoke=smoke)
    params = model.init_params(0, cuda)
    if form != "bf16":
        params = pack_params(params, MIXED if form == "mixed" else None)
    blocks = model.cast_params(params)["blocks"]
    if form != "bf16":
        blocks = broadcast_packed_scales(blocks, model.cfg.n_layers)
    return model, _layer(blocks, 0)


def _k3_grids_equal(lp, st, x, bb, luts, grids):
    full = rwkv4_block_decode(lp, st, x, bb=bb, luts=luts)
    for grid in grids:
        got = rwkv4_block_decode(lp, st, x, bb=bb, luts=luts, grid=grid)
        assert torch.equal(got[0], full[0]), grid
        assert all(torch.equal(got[1][k], full[1][k]) for k in STATE_KEYS)
    return full


@pytest.mark.parametrize("bb", [8, 4])
@pytest.mark.parametrize("hw", [False, True], ids=["exact", "hw"])
@pytest.mark.parametrize("form", ["w8", "mixed", "bf16"])
def test_rwkv4_block_decode_grid_invariant(cuda, form, hw, bb):
    """K3 on 1, 7 and every resident block gives the same bits, for each
    weight form, numerics and tile (B 8: one tile of 8, two of 4), and
    holds its plain version by K3's rule (K3-hw's under hw)."""
    from repro_torch.models.rwkv4 import _hw_numerics_with_tables
    model, lp = _k3_layer(cuda, form)
    B, D = 8, model.cfg.d_model
    st, x = _state(cuda, (B, D), 31)
    luts = _luts(cuda) if hw else None
    x2, new = _k3_grids_equal(lp, st, x, bb, luts, (1, 7))
    nm = _hw_numerics_with_tables(luts["exp"], luts["div"]) if hw else None
    x2_p, new_p = rwkv4_block_decode_plain(lp, st, x, nm, bb=bb)
    check = _close if hw else _spread
    check(x2, x2_p)
    for k in STATE_KEYS:
        check(new[k], new_p[k])


@pytest.mark.parametrize("hw", [False, True], ids=["exact", "hw"])
def test_rwkv4_block_decode_full_width_grids(cuda, hw):
    """At rwkv4-169m's widths (W8, B 8) K3 spreads over more than 100
    blocks of an H100 and gives the bits of grids of 1 and 7 blocks."""
    from repro_torch.kernels.fused_decode import _COOP_GRIDS
    model, lp = _k3_layer(cuda, "w8", smoke=False)
    st, x = _state(cuda, (8, model.cfg.d_model), 32)
    _k3_grids_equal(lp, st, x, 8, _luts(cuda) if hw else None, (1, 7))
    assert max(v for k, v in _COOP_GRIDS.items() if k[0] == "k3") > 100


def test_rwkv4_block_decode_raises_when_the_grid_cannot_launch(cuda):
    """A grid larger than the blocks resident at once (or empty) raises
    before launching; there is no smaller silent grid."""
    from repro_torch.kernels.fused_decode import _COOP_GRIDS
    model, lp = _k3_layer(cuda, "w8")
    st, x = _state(cuda, (4, model.cfg.d_model), 33)
    rwkv4_block_decode(lp, st, x)
    most = max(v for k, v in _COOP_GRIDS.items() if k[0] == "k3")
    before = rwkv4_block_decode.launches
    for grid in (most + 1, 0):
        with pytest.raises(ValueError, match="cooperative grid"):
            rwkv4_block_decode(lp, st, x, grid=grid)
    assert rwkv4_block_decode.launches == before


def test_model_decode_raises_when_the_grid_cannot_launch(cuda):
    """K4: a grid larger than the blocks resident at once (or empty) raises
    before launching; there is no smaller silent grid.  The full grid is
    one block an SM."""
    from repro_torch.kernels.fused_decode import _COOP_GRIDS
    stack, st, x = _model_case(cuda, "w8")
    rwkv4_model_decode(stack, st, x)
    most = max(v for k, v in _COOP_GRIDS.items() if k[0] == "k4")
    props = torch.cuda.get_device_properties(cuda)
    assert rwkv4_model_decode.grid == most == props.multi_processor_count
    before = rwkv4_model_decode.launches
    for grid in (most + 1, 0):
        with pytest.raises(ValueError, match="cooperative grid"):
            rwkv4_model_decode(stack, st, x, grid=grid)
    assert rwkv4_model_decode.launches == before


# --- the rest of the engine, plan and registry: a given tree, the counters,
# --- cancel, f32 state, truncated models, all-position prefill logits

def _all_counters():
    from repro_torch.kernels.fused_decode import (
        rwkv6_block_decode, rwkv6_model_decode)
    from repro_torch.kernels.wkv6 import wkv6_seq
    return (dpot_w8_matmul, dpot_w4_matmul, vq_matmul, wkv4_seq, wkv6_seq,
            rwkv4_block_decode, rwkv4_model_decode, rwkv6_block_decode,
            rwkv6_model_decode)


@pytest.mark.parametrize("arch", ["rwkv4-169m", "rwkv6-7b"])
def test_all_logits_last_row_is_prefill_chunk(cuda, arch):
    """prefill_chunk_logits on a W8 tree: the head is one K5 call at
    M = B·C; row n_valid - 1 equals prefill_chunk's logits bit for bit,
    invalid rows are zero and the states equal bit for bit."""
    from repro_torch.serving import build_plan
    plan = build_plan(arch, smoke=True, quantized=True, fused_prefill=True,
                      device="cuda")
    model, params = plan.model, plan.prepared.prefill
    lens = (6, 3, 0, 1)
    B, C = len(lens), 6
    g = torch.Generator(device=cuda).manual_seed(41)
    toks = torch.randint(0, model.cfg.vocab, (B, C), device=cuda,
                         dtype=torch.int32, generator=g)
    valid = torch.arange(C, device=cuda)[None, :] < torch.tensor(
        lens, device=cuda)[:, None]
    state = model.init_decode_state(B, 0, device=cuda)
    s1, last = model.prefill_chunk(params, state, toks, valid)
    before = dpot_w8_matmul.launches
    s2, rows = model.prefill_chunk_logits(params, state, toks, valid)
    assert dpot_w8_matmul.launches > before
    for b, n in enumerate(lens):
        if n:
            assert torch.equal(rows[b, n - 1], last[b, 0])
    assert not rows[~valid].any()
    for k in s1:
        assert torch.equal(s1[k], s2[k])


def test_truncated_model_decode_state_is_the_full_models(cuda):
    """rwkv6 smoke at 3 layers cut to its first 2 (a one-layer stack keeps
    its shared scales in its slabs, which K7's table does not take): one
    prefill chunk (K5 + K6) and 4 K7-model steps on truncate_params give
    truncate_state of the full model's state after the same tokens, bit
    for bit."""
    import dataclasses
    from repro_torch.kernels.fused_decode import rwkv6_model_decode
    from repro_torch.serving import build_plan
    model = get_model(dataclasses.replace(
        get_model("rwkv6-7b", smoke=True).cfg, n_layers=3))
    plan = build_plan(model, quantized=True, fused_decode="model",
                      fused_prefill=True, device="cuda")
    prep = plan.prepared
    B, C, depth = 4, 6, 2
    toks = torch.randint(0, model.cfg.vocab, (B, C + 4), device=cuda,
                         dtype=torch.int32,
                         generator=torch.Generator(device=cuda).manual_seed(
                             43))
    valid = torch.ones((B, C), dtype=torch.bool, device=cuda)

    def run(m, prefill, decode):
        s = m.init_decode_state(B, 0, device=cuda)
        s, _ = m.prefill_chunk(prefill, s, toks[:, :C], valid)
        for j in range(C, C + 4):
            _, s = m.decode_step_fused_model(decode, s, toks[:, j:j + 1], 0)
        return s
    full = run(model, prep.prefill, prep.decode)
    tm = model.truncated(depth)
    tp = model.truncate_params(prep.raw, depth)
    before = rwkv6_model_decode.launches
    cut = run(tm, tm.prepare_path_params(tm.prefill_paths()["chunked"], tp),
              tm.prepare_fused_model_params(tp))
    assert rwkv6_model_decode.launches == before + 4
    want = model.truncate_state(full, depth)
    for k in cut:
        assert torch.equal(cut[k], want[k]), k


def test_f32_state_on_a_fused_path_raises_before_a_launch(cuda):
    from repro_torch.serving import ServingEngine, build_plan
    counters = _all_counters()
    before = [c.launches for c in counters]
    for kw in (dict(fused_decode="model"), dict(fused_decode="block"),
               dict(fused_prefill=True)):
        with pytest.raises(ValueError, match="bf16 state"):
            build_plan("rwkv4-169m", smoke=True, quantized=True,
                       state_dtype=torch.float32, device="cuda", **kw)
    assert [c.launches for c in counters] == before
    # the per-op path serves an f32 pool on the card
    eng = ServingEngine("rwkv4-169m", smoke=True, max_batch=2,
                        prefill_chunk=4, state_dtype=torch.float32,
                        device="cuda")
    assert all(v.dtype == torch.float32 for v in eng.pool.state.values())
    h = eng.submit([1, 2, 3, 4, 5], max_new_tokens=4)
    eng.run()
    assert h.outcome == "finished" and len(h.tokens) == 4


def test_a_given_tree_on_the_cpu_raises_for_a_cuda_plan(cuda):
    from repro_torch.serving import build_plan
    model = get_model("rwkv4-169m", smoke=True)
    tree = model.init_params(0, "cpu")
    with pytest.raises(ValueError, match=r"params\['blocks'\]"):
        build_plan(model, tree, quantized=True, fused_decode="model",
                   device="cuda")


def test_engine_serves_a_given_tree_with_counters_and_cancel(cuda):
    """A given tree through the model path (K5 + K2 + K4): the packed raw
    tree is pack_params of it, the counters count the run, each program is
    built once, and cancelling one request leaves the others' streams as
    they were."""
    from repro_torch.runtime.monitor import ServingCounters
    from repro_torch.serving import ServingEngine
    model = get_model("rwkv4-169m", smoke=True)
    tree = model.init_params(7, "cuda")
    eng = ServingEngine(model, params=tree, quantized=True,
                        fused_decode="model", fused_prefill=True,
                        max_batch=4, prefill_chunk=4,
                        counters=ServingCounters(), device="cuda")
    ref = pack_params(tree)
    assert torch.equal(eng.plan.prepared.raw["head"]["packed"],
                       ref["head"]["packed"])
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, model.cfg.vocab, int(n)).tolist()
               for n in (3, 9, 1, 6)]
    counters = (dpot_w8_matmul, wkv4_seq, rwkv4_model_decode)
    before = [c.launches for c in counters]
    hs = [eng.submit(p, max_new_tokens=5) for p in prompts]
    snap = eng.run()
    assert all(c.launches > b for c, b in zip(counters, before))
    assert (snap["admitted"], snap["finished"], snap["decode_tokens"],
            snap["prefill_tokens"]) == (4, 4, 20, 19)
    assert eng.trace_counts == {"decode": 1, "prefill": 1}
    again = [eng.submit(p, max_new_tokens=5) for p in prompts]
    eng.step()
    assert eng.cancel(again[1]) and again[1].outcome == "cancelled"
    snap = eng.run()
    assert snap["cancelled"] == 1
    assert [h.tokens for i, h in enumerate(again) if i != 1] == \
        [h.tokens for i, h in enumerate(hs) if i != 1]


def test_greedy_decode_sampling_on_the_card(cuda):
    from repro_torch.launch.serve import greedy_decode
    model = get_model("rwkv4-169m", smoke=True)
    params = model.cast_params(model.init_params(0, "cuda"))
    first = torch.tensor([[1], [2]], dtype=torch.int32, device=cuda)
    run = lambda **kw: greedy_decode(
        model, params, model.init_decode_state(2, 0, device=cuda), first, 8,
        **kw)[0]
    gen = lambda: torch.Generator(device=cuda).manual_seed(5)
    a, b = run(sample_temp=0.8, rng=gen()), run(sample_temp=0.8, rng=gen())
    assert torch.equal(a, b)
    assert torch.equal(run(sample_temp=0.0, rng=gen()), run())


# ---------------------------------------------------------------------------
# The prefix cache and self-speculative decode on the card: the verify
# windows' K2 and K6 shapes, the host tier's round trip, identities (a) and
# (b), and the rollback snapshot
# ---------------------------------------------------------------------------

from repro_torch.serving import PrefixCache, PrefixCacheConfig
from repro_torch.serving.prefix_cache import CacheVariant


@pytest.mark.parametrize("T", [1, 2, 4])
def test_wkv4_seq_verify_windows(cuda, T):
    """K2 at the verify windows' T (B 8, prefix masks, a bf16 pool state
    and carry) against its plain version."""
    g = torch.Generator(device=cuda).manual_seed(40 + T)
    B, C = 8, 768
    rn = lambda *s: torch.randn(s, generator=g, device=cuda)
    bf = lambda t: t.to(torch.bfloat16).float()
    args = (rn(B, T, C), rn(B, T, C), torch.exp(0.5 * rn(C)), 0.5 * rn(C),
            bf(rn(B, C)), bf(rn(B, C).abs() + 0.5), bf(rn(B, C) - 1))
    valid = torch.zeros((B, T), dtype=torch.bool, device=cuda)
    for i, n in enumerate((T, T - 1, 0, 1, T, T, T // 2, T)):
        valid[i, :n] = True
    y, fin = wkv4_seq(*args, valid=valid, carry_dtype="bfloat16")
    y_p, fin_p = wkv4_seq_plain(*args, valid=valid, carry_dtype="bfloat16")
    for o, r in zip((y, *fin), (y_p, *fin_p)):
        _elementwise(o, r)
    for o, a0 in zip(fin, args[4:]):      # the empty lane keeps its state
        assert torch.equal(o[2], a0[2])


@pytest.mark.parametrize("T", [1, 2, 4])
def test_wkv6_seq_verify_windows(cuda, T):
    """K6 at the verify windows' T (B 8, H 64, N 64, prefix masks, a bf16
    pool state and carry): the state bit for bit with the plain version, y
    by K2's rule and bit for bit against the in-order reference."""
    g = torch.Generator(device=cuda).manual_seed(50 + T)
    B, H, N = 8, 64, 64
    rn = lambda *s: torch.randn(s, generator=g, device=cuda)
    args = (rn(B, T, H, N), rn(B, T, H, N), rn(B, T, H, N),
            torch.exp(-torch.exp(0.5 * rn(B, T, H, N))), 0.5 * rn(H, N),
            rn(B, H, N, N).to(torch.bfloat16))
    valid = torch.zeros((B, T), dtype=torch.bool, device=cuda)
    for i, n in enumerate((T, T - 1, 0, 1, T, T, T // 2, T)):
        valid[i, :n] = True
    y, sf = wkv6_seq(*args, valid=valid, carry_dtype="bfloat16")
    y_p, sf_p = wkv6_seq_plain(*args, valid=valid, carry_dtype="bfloat16")
    _elementwise(y, y_p)
    assert torch.equal(sf, sf_p)
    y_o, _ = wkv6_seq_inorder(*args, valid=valid, carry_dtype="bfloat16")
    assert torch.equal(y.view(torch.int32), y_o.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prefix_cache_host_tier_round_trip(cuda, dtype):
    """A lane state spilled to the host tier and promoted back (and one
    handed out by a lease while it stays on the host) keeps its bits."""
    g = torch.Generator(device=cuda).manual_seed(9)
    lane = lambda: {k: torch.randn((2, 1, 96), generator=g, device=cuda)
                    .to(dtype) for k in ("att_x", "wkv_a")}
    var = CacheVariant("a", "fp", "exact", "chunked")
    cache = PrefixCache(4, config=PrefixCacheConfig(device_slots=1,
                                                    host_slots=2))
    a, b = lane(), lane()
    want = {k: v.clone() for k, v in a.items()}
    pa, pb = [1, 2, 3, 4, 5], [6, 7, 8, 9, 10]
    assert cache.insert(var, pa, 4, a) and cache.insert(var, pb, 4, b)
    assert cache.n_host == 1 and cache.stats["spills"] == 1
    assert all(v.device.type == "cpu" for v in cache._host[next(iter(
        cache._host))].state.values())
    held = cache.probe(var, pb)         # pins the device slot: no promotion
    lease = cache.probe(var, pa)
    assert cache.stats["host_hits"] == 1 and cache.n_host == 1
    got = lease.state
    assert all(torch.equal(got[k], want[k]) and got[k].device.type == cuda.type
               for k in want)
    lease.release()
    held.release()
    lease = cache.probe(var, pa)        # promoted this time
    assert cache.n_device == 1 and cache.stats["host_hits"] == 2
    got = lease.state
    assert all(torch.equal(got[k], want[k]) and got[k].device.type == cuda.type
               for k in want)
    lease.release()
    cache.check_state()


def _spec_prompts(vocab, lens=(5, 9, 3, 12)):
    r = np.random.default_rng(7)
    return [r.integers(0, vocab, n).tolist() for n in lens]


@functools.lru_cache(maxsize=None)
def _smoke():
    """chip_smoke.py as a module (its serving helpers), loaded by path."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "_cuda_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _spec_serve(eng, prompts, n_new=12, temperature=0.0, sequential=False):
    """chip_smoke's `_serve`: (streams, snapshot)."""
    return _smoke()._serve(eng, prompts, n_new, temperature=temperature,
                           sequential=sequential)[:2]


@pytest.mark.parametrize("arch,decode", [("rwkv4-169m", "model"),
                                         ("rwkv4-169m", "block"),
                                         ("rwkv6-7b", "model")])
def test_speculative_stream_does_not_depend_on_the_drafter(cuda, arch,
                                                           decode):
    """Identity (a): for a fixed k the real drafter, an all-reject and an
    all-accept stub give the same tokens bit for bit, greedy and sampled;
    the rollback snapshot is untouched by the draft and verify calls."""
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(arch, smoke=True, quantized=True,
                        plane_policy=MIXED if arch == "rwkv4-169m" else None,
                        fused_decode=decode, fused_prefill=True, max_batch=4,
                        prefill_chunk=4, speculative=3, device=cuda)
    prompts = _spec_prompts(eng.model.cfg.vocab)
    sched, smoke = eng.scheduler, _smoke()
    draft, verify = sched.draft_fn, sched.verify_fn
    seen = smoke._snapshot_guard(eng)
    greedy, snap = _spec_serve(eng, prompts)
    sched.draft_fn, sched.verify_fn = draft, verify
    assert seen["checks"] > 0 and seen["intact"]
    assert snap["drafted_tokens"] == snap["accepted_tokens"] + \
        snap["rejected_tokens"]
    sampled, _ = _spec_serve(eng, prompts, temperature=0.8)
    for kind in ("reject", "accept"):
        for temp, want in ((0.0, greedy), (0.8, sampled)):
            real = smoke._stub_drafter(eng, want, kind)
            got, _ = _spec_serve(eng, prompts, temperature=temp)
            sched.draft_fn = real
            assert got == want, (kind, temp)
    assert eng.trace_counts == {"decode": 0, "prefill": 1, "verify": 1,
                                "rollback": 1, "draft": 1}


@pytest.mark.parametrize("arch", ["rwkv4-169m", "rwkv6-7b"])
@pytest.mark.parametrize("slots", [8, 1], ids=["device", "host"])
def test_cached_resume_streams_the_uncached_tokens(cuda, arch, slots):
    """Identity (b): requests resumed from cache hits, from the device
    tier or (one device slot) the host tier, stream the same tokens bit
    for bit as the same engine without a cache."""
    from repro_torch.serving import ServingEngine
    kw = dict(smoke=True, quantized=True, fused_decode="model",
              fused_prefill=True, max_batch=4, prefill_chunk=4, device=cuda)
    r = np.random.default_rng(3)
    V = get_model(arch, smoke=True).cfg.vocab
    prefix = r.integers(0, V, 8).tolist()
    prompts = [prefix + r.integers(0, V, n).tolist() for n in (1, 6, 5, 3)]
    ref, _ = _spec_serve(ServingEngine(arch, **kw), prompts,
                         sequential=True)
    eng = ServingEngine(arch, prefix_cache=PrefixCacheConfig(
        device_slots=slots, host_slots=8), **kw)
    got, snap = _spec_serve(eng, prompts, sequential=True)
    assert got == ref
    assert snap["cache_hits"] == 3 and snap["cached_tokens"] == 24
    if slots == 1:
        assert eng.prefix_cache.stats["host_hits"] > 0
    eng.prefix_cache.check_state()


# --- crash-safe snapshots and the sentinel (the SLO layer's slice) ---------------

def _drill_kw(cuda):
    return dict(smoke=True, quantized=True, plane_policy=MIXED,
                fused_decode="model", fused_prefill=True, max_batch=4,
                prefill_chunk=4, device=cuda)


def _drill_traffic(eng, arch):
    V = get_model(arch, smoke=True).cfg.vocab
    r = np.random.default_rng(5)
    return [eng.submit(r.integers(0, V, n).tolist(), max_new_tokens=8,
                       temperature=0.8 if i % 2 else 0.0, seed=40 + i)
            for i, n in enumerate((3, 9, 6, 13))]


@pytest.mark.parametrize("arch", ["rwkv4-169m", "rwkv6-7b"])
@pytest.mark.parametrize("crash", [3, 6])
@pytest.mark.parametrize("spec", [None, 2], ids=["plain", "speculative"])
def test_crash_resume_is_bit_for_bit_on_the_card(cuda, arch, crash, spec,
                                                 tmp_path):
    """K4 / K7-model decode, K5 + K2 / K6 prefill (and verify): a crash at
    the top of a tick, a restore rebuilt from the seed, and every stream
    equals the run that never crashed, bit for bit."""
    from repro_torch.runtime.monitor import (EngineCrash,
                                             ServingFaultInjector)
    from repro_torch.serving import ServingEngine, SnapshotConfig
    kw = dict(_drill_kw(cuda), speculative=spec)
    ref = ServingEngine(arch, **kw)
    want = _drill_traffic(ref, arch)
    ref.run()
    inj = ServingFaultInjector(schedule={crash: [("crash_at_tick", None)]})
    eng = ServingEngine(arch, fault_injector=inj,
                        snapshot=SnapshotConfig(str(tmp_path), every=2), **kw)
    hs = _drill_traffic(eng, arch)
    with pytest.raises(EngineCrash):
        eng.run()
    eng.snapshot_manager.wait()
    restored = ServingEngine.restore(str(tmp_path), snapshot=None)
    assert restored.plan.device.type == cuda.type
    handles = restored.handles
    restored.run()
    got = [handles[h.rid].resumed + handles[h.rid].tokens
           if h.rid in handles else h.tokens for h in hs]
    assert got == [h.tokens for h in want]


@pytest.mark.parametrize("arch", ["rwkv4-169m", "rwkv6-7b"])
def test_quarantine_replay_is_bit_for_bit_on_the_card(cuda, arch):
    """A lane poisoned with NaN is quarantined by the sentinel (one sweep
    on the card) and replayed beside the other lanes: every stream equals
    the clean run's bit for bit, and no slot leaks."""
    from repro_torch.runtime.monitor import ServingFaultInjector
    from repro_torch.serving import ServingEngine
    ref = ServingEngine(arch, **_drill_kw(cuda))
    want = _drill_traffic(ref, arch)
    ref.run()
    inj = ServingFaultInjector(schedule={3: [("corrupt_state_leaf", 1)]})
    eng = ServingEngine(arch, fault_injector=inj, sentinel_every=1,
                        **_drill_kw(cuda))
    hs = _drill_traffic(eng, arch)
    eng.run()
    assert eng.counters.quarantined_lanes == 1
    assert [h.tokens for h in hs] == [h.tokens for h in want]
    assert eng.pool.n_free == eng.pool.max_slots


def test_lane_finite_on_the_card(cuda):
    from repro_torch.serving import ServingEngine
    eng = ServingEngine("rwkv4-169m", **_drill_kw(cuda))
    assert eng.pool.lane_finite().tolist() == [True] * 4
    eng.pool.poison_slot(2, float("inf"))
    assert eng.pool.lane_finite().tolist() == [True, True, False, True]


def _kernel_wrappers():
    from repro_torch.kernels import (
        expsig, fused_ce, fused_decode, fused_layernorm, fused_prefill,
        flash_attention as fa, wkv4, wkv6)
    return {w.__name__: w for w in (
        fused_layernorm.fused_layernorm, fused_layernorm.fused_layernorm_bwd,
        wkv4.wkv4_seq, wkv4.wkv4_seq_bwd, fused_ce.fused_cross_entropy,
        fused_ce.fused_cross_entropy_bwd, wkv6.wkv6_chunked_kernel,
        wkv6.wkv6_chunked_bwd, wkv6.wkv6_seq, wkv6.wkv6_seq_bwd,
        fa.flash_attention, fa.flash_attention_dq, fa.flash_attention_dkv,
        fused_prefill.dpot_w8_matmul, expsig.sigmoid_kernel,
        fused_decode.rwkv4_block_decode, fused_decode.rwkv6_block_decode)}


@pytest.mark.parametrize("arch,S,flash", [
    ("rwkv4-169m", 64, False), ("rwkv6-7b", 128, False),
    ("rwkv6-7b", 40, False), ("smollm-135m", 512, True)])
def test_op_count_launches_are_the_counters(cuda, arch, S, flash):
    """A smoke train step on the card under `OpCount`: each kernel's
    recorded launches equal the rise of its wrapper's `.launches`, and the
    count equals the same step's count on meta tensors, op for op."""
    import dataclasses
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.op_analysis import analyze_call
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.registry import Model, get_model
    m = get_model(arch, smoke=True)
    if flash:
        m = Model(cfg=dataclasses.replace(m.cfg, use_flash_kernel=True),
                  module=m.module)
    step, meta_args, (init_opt, _) = build_train_step(
        m, ShapeConfig("c", S, 2, "train"))
    p = m.init_params(0, cuda)
    toks = torch.randint(0, m.cfg.vocab, (2, S), dtype=torch.int32,
                         device=cuda)
    wrappers = _kernel_wrappers()
    before = {n: w.launches for n, w in wrappers.items()}
    got = analyze_call(step, p, init_opt(p),
                       {"tokens": toks, "labels": toks})
    torch.cuda.synchronize()
    rise = {n: w.launches - before[n] for n, w in wrappers.items()
            if w.launches != before[n]}
    assert rise == got.kernels and rise
    meta = analyze_call(step, *meta_args[:2], {
        k: torch.empty((2, S), dtype=torch.int32, device="meta")
        for k in ("tokens", "labels")})
    assert got.ops == meta.ops


def test_op_count_decode_launches_are_the_counters(cuda):
    """The fused decode steps under `OpCount` on the card: K3 a layer,
    K7 a layer at B 16 (two tiles each), as their counters rise."""
    from repro_torch.launch.op_analysis import analyze_call
    from repro_torch.models.registry import get_model
    wrappers = _kernel_wrappers()
    for arch, kernel, B in (("rwkv4-169m", "rwkv4_block_decode", 8),
                            ("rwkv6-7b", "rwkv6_block_decode", 16)):
        m = get_model(arch, smoke=True)
        p = m.cast_params(m.init_params(0, cuda, torch.bfloat16))
        st = m.init_decode_state(B, 0, device=cuda)
        before = wrappers[kernel].launches
        got = analyze_call(m.decode_step_fused, p, st,
                           torch.zeros((B, 1), dtype=torch.int32,
                                       device=cuda), 0)
        assert got.kernels[kernel] == wrappers[kernel].launches - before \
            == m.cfg.n_layers * (B // 8 if arch == "rwkv6-7b" else 1)
