"""The port's serving stack on the CPU: engine, plan, scheduler and pool,
plus the rules the port keeps — no JAX, no fallback, no quiet CPU run.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.bridge import from_jax_tree
from repro_torch.device import exact_matmuls
from repro_torch.kernels.fused_prefill import dpot_w8_matmul
from repro_torch.kernels.wkv4 import wkv4_seq
from repro_torch.launch.serve import sequential_decode
from repro_torch.models.registry import get_model
from repro_torch.serving import ServingEngine, build_plan
from repro_torch.serving.plan import ExecutionPlan, masked_state_commit
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.serving.state_pool import SlotStatePool

ROOT = pathlib.Path(__file__).resolve().parent.parent
PATHS = {"kernel": dict(fused_decode="block", fused_prefill=True),
         "per_op": dict(fused_decode=False, fused_prefill=False)}


def _engine(path, **kw):
    return ServingEngine("rwkv4-169m", smoke=True, quantized=True,
                         max_batch=4, prefill_chunk=4, device="cpu",
                         **PATHS[path], **kw)


def _prompts(n, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(k)).tolist()
            for k in rng.integers(1, 11, n)]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_engine_solo_equals_batched(path):
    """Each request's stream is the same whether it shares the pool with
    five others (ragged prompts, chunk splits, slot reuse) or runs alone."""
    eng = _engine(path)
    prompts = _prompts(6, eng.model.cfg.vocab)
    handles = [eng.submit(p, max_new_tokens=6) for p in prompts]
    stats = eng.run()
    assert stats["decode_tokens"] == 36 and all(h.done for h in handles)
    for p, h in zip(prompts, handles):
        solo = eng.submit(p, max_new_tokens=6)
        eng.run()
        assert solo.tokens == h.tokens


def test_engine_matches_sequential_decode():
    """The per-op engine against batch-1 greedy decode of each request."""
    eng = _engine("per_op")
    prompts = _prompts(3, eng.model.cfg.vocab, seed=1)
    handles = [eng.submit(p, max_new_tokens=5) for p in prompts]
    eng.run()
    for p, h in zip(prompts, handles):
        assert h.tokens == sequential_decode(
            eng.model, eng.plan.prepared.raw, p, 5, device="cpu")


def test_stream_yields_every_token():
    eng = _engine("kernel")
    h = eng.submit([1, 2, 3], max_new_tokens=4)
    other = eng.submit([4, 5], max_new_tokens=7)
    assert list(eng.stream(h)) == h.tokens and len(h.tokens) == 4
    eng.run()
    assert other.done and len(other.tokens) == 7


def test_cuda_engine_raises_without_gpu(monkeypatch):
    """device="cuda" (the default of every entry point) never quietly runs
    on the CPU: the engine, the plan, the registry's constructors, the
    pool, the sequential decode and the bridge all raise without a GPU."""
    model = get_model("rwkv4-169m", smoke=True)
    params = model.init_params(0, device="cpu")
    plan = build_plan(model, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
            lambda: ServingEngine("rwkv4-169m", smoke=True, quantized=True,
                                  fused_decode="block", fused_prefill=True),
            lambda: build_plan("rwkv4-169m", smoke=True),
            lambda: ExecutionPlan(model, plan.prepared, plan.decode_desc,
                                  plan.prefill_desc),
            lambda: model.init_params(0),
            lambda: model.init_decode_state(2),
            lambda: model.init_slot_state(2),
            lambda: SlotStatePool(model, 2),
            lambda: sequential_decode(model, params, [1, 2], 1),
            lambda: from_jax_tree({"w": np.zeros(3, np.float32)})):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def test_exact_matmuls_is_scoped():
    """The plain versions switch TF32 and reduced-precision bf16 reductions
    off only while they run; serving leaves the caller's settings as they
    were."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    flags = lambda: (mm.allow_tf32, dnn.allow_tf32,
                     mm.allow_bf16_reduced_precision_reduction)
    saved = flags()
    try:
        mm.allow_tf32 = dnn.allow_tf32 = True
        mm.allow_bf16_reduced_precision_reduction = True
        with exact_matmuls():
            assert flags() == (False, False, False)
        assert flags() == (True, True, True)
        eng = _engine("per_op")
        eng.submit([1, 2, 3], max_new_tokens=2)
        eng.run()
        assert flags() == (True, True, True)
    finally:
        (mm.allow_tf32, dnn.allow_tf32,
         mm.allow_bf16_reduced_precision_reduction) = saved


def test_kernel_wrappers_raise_off_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises; it
    never falls back to the plain version (meta tensors stand in for a
    device here: without nvcc the build raises)."""
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,
                                                    device="meta")
    before = (dpot_w8_matmul.launches, wkv4_seq.launches)
    with pytest.raises((RuntimeError, NotImplementedError)):
        dpot_w8_matmul(meta(4, 8, dt=torch.bfloat16),
                       meta(8, 6, dt=torch.uint8), meta(6))
    with pytest.raises((RuntimeError, NotImplementedError)):
        wkv4_seq(meta(2, 3, 8), meta(2, 3, 8), meta(8), meta(8),
                 meta(2, 8), meta(2, 8), meta(2, 8))
    assert (dpot_w8_matmul.launches, wkv4_seq.launches) == before


def test_scheduler_has_no_path_demotion():
    """A failing decode program raises out of tick(): the scheduler never
    swaps in a plain twin behind the caller's back."""
    model = get_model("rwkv4-169m", smoke=True)
    pool = SlotStatePool(model, 2, device="cpu")
    calls = []

    def prefill(state, toks, valid, fresh):
        calls.append("prefill")
        return state, torch.zeros((2, 1, model.cfg.vocab))

    def decode(state, toks, mask):
        calls.append("decode")
        raise RuntimeError("kernel failed")
    sched = Scheduler(pool, decode, prefill, prefill_chunk=4)
    sched.enqueue(Request(rid=0, prompt=[1, 2], max_new_tokens=3))
    # the tick prefills the prompt, emits its first token and decodes
    with pytest.raises(RuntimeError, match="kernel failed"):
        sched.tick()
    assert calls == ["prefill", "decode"]
    assert not hasattr(sched, "fallback_decode")


def test_state_pool_slots():
    model = get_model("rwkv4-169m", smoke=True)
    pool = SlotStatePool(model, 3, device="cpu")
    assert [pool.acquire() for _ in range(3)] == [0, 1, 2]
    assert pool.acquire() is None
    pool.release(1)
    with pytest.raises(ValueError):
        pool.release(1)
    lane = {k: torch.full_like(v, 3.0) for k, v in pool.read_slot(2).items()}
    pool.write_slot(1, lane)
    assert all(bool((pool.read_slot(1)[k] == 3.0).all()) for k in lane)
    assert all(bool((pool.state[k][:, 0] != 3.0).all()) for k in lane)
    pool.reset_slot(1)
    assert bool((pool.read_slot(1)["wkv_o"] < -1e30).all())
    assert pool.acquire() == 1


def test_masked_state_commit_broadcasts_fresh_lane():
    model = get_model("rwkv4-169m", smoke=True)
    state = model.init_slot_state(3, dtype=torch.float32, device="cpu")
    state = {k: torch.ones_like(v) for k, v in state.items()}
    fresh = model.init_slot_state(1, dtype=torch.float32, device="cpu")
    mask = torch.tensor([True, False, True])
    out = masked_state_commit(state, fresh, mask,
                              model.decode_state_batch_axes())
    for k in out:
        assert bool((out[k][:, 0] == 1).all()) and bool(
            (out[k][:, 2] == 1).all())
        assert torch.equal(out[k][:, 1], fresh[k][:, 0])


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    kernels = ROOT / "src" / "repro_torch" / "kernels"
    assert {kernels / "fused_layernorm.py", kernels / "wkv6.py"} <= set(files)
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)


# --- the whole-model decode path "model" with mixed W8 / W4 / VQ planes ---

from repro_torch.core.quant.policy import PlanePolicy
from repro_torch.core.quant.serving import FusedLayerStack
from repro_torch.kernels.fused_decode import rwkv4_model_decode
from repro_torch.kernels.fused_prefill import dpot_w4_matmul, vq_matmul
from repro_torch.launch.serve import weights_label
from repro_torch.models.rwkv4 import prepare_fused_model_params

# W4 for att.wk and the head, VQ for ffn.wv, W8 elsewhere
MIXED = PlanePolicy(default="w8", overrides=(
    (r"\['att'\]\['wk'\]", "w4"), (r"\['ffn'\]\['wv'\]", "vq"),
    (r"\['head'\]", "w4")))


def _model_engine(fused_prefill=True):
    return ServingEngine("rwkv4-169m", smoke=True, quantized=True,
                         plane_policy=MIXED, fused_decode="model",
                         fused_prefill=fused_prefill, max_batch=4,
                         prefill_chunk=4, device="cpu")


def test_model_path_solo_equals_batched():
    """The model path with MIXED planes: each request's stream is the
    same shared or alone (ragged prompts, chunk splits, slot reuse)."""
    eng = _model_engine()
    prompts = _prompts(6, eng.model.cfg.vocab, seed=2)
    handles = [eng.submit(p, max_new_tokens=6) for p in prompts]
    assert eng.run()["decode_tokens"] == 36
    for p, h in zip(prompts, handles):
        solo = eng.submit(p, max_new_tokens=6)
        eng.run()
        assert solo.tokens == h.tokens


@pytest.mark.parametrize("fused_prefill", [False, True],
                         ids=["per_op_prefill", "chunked_prefill"])
def test_model_path_matches_sequential_decode(fused_prefill):
    """The model path with MIXED planes against batch-1 greedy per-op
    decode of each request on the unpacked tree."""
    eng = _model_engine(fused_prefill)
    prompts = _prompts(3, eng.model.cfg.vocab, seed=3)
    handles = [eng.submit(p, max_new_tokens=5) for p in prompts]
    eng.run()
    for p, h in zip(prompts, handles):
        assert h.tokens == sequential_decode(
            eng.model, eng.plan.prepared.raw, p, 5, device="cpu")


def test_build_plan_prepares_each_path_once():
    """build_plan packs under the policy once and prepares each path's
    form: the model path's slabs for decode, the raw tree for prefill."""
    plan = build_plan("rwkv4-169m", smoke=True, quantized=True,
                      plane_policy=MIXED, fused_decode="model",
                      fused_prefill=True, device="cpu")
    prep = plan.prepared
    assert (prep.decode_path, prep.prefill_path) == ("model", "chunked")
    assert isinstance(prep.decode["blocks"], FusedLayerStack)
    assert prep.prefill is prep.raw
    assert prep.raw["head"].keys() == {"packed4", "scale"}
    assert prep.raw["blocks"]["ffn"]["wv"].keys() == {"vq_idx", "codebook"}
    assert weights_label(prep.raw) == "planes W8×5 W4×2 VQ×1"
    ref = prepare_fused_model_params(prep.raw, plan.model.cfg)["blocks"]
    for k, slab in prep.decode["blocks"].slabs.items():
        assert torch.equal(slab, ref.slabs[k])
    block = build_plan("rwkv4-169m", smoke=True, quantized=True,
                       fused_decode="block", device="cpu").prepared
    assert block.decode is block.raw and block.decode_path == "block"
    assert weights_label(block.raw) == "Δ-PoT W8"


def test_plane_policy_needs_quantized():
    with pytest.raises(ValueError, match="quantized"):
        build_plan("rwkv4-169m", smoke=True, quantized=False,
                   plane_policy=MIXED, device="cpu")
    with pytest.raises(ValueError, match="fused_decode"):
        build_plan("rwkv4-169m", smoke=True, fused_decode="stream",
                   device="cpu")


def test_new_kernel_wrappers_raise_off_cpu():
    """K5-W4, K5-VQ, K4, K6 and both forms of K7 on tensors that are not
    on the CPU go to their kernels or raise; they never fall back to the
    plain versions."""
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,
                                                    device="meta")
    model = get_model("rwkv4-169m", smoke=True)
    tp = model.cast_params(
        build_plan(model, quantized=True, plane_policy=MIXED,
                   device="cpu").prepared.raw)
    stack = prepare_fused_model_params(tp, model.cfg)["blocks"]
    stack = FusedLayerStack({k: v.to("meta") for k, v in stack.slabs.items()},
                            tuple(a.to("meta") for a in stack.aux),
                            stack.manifest, stack.tdef)
    L, D = model.cfg.n_layers, model.cfg.d_model
    state = {k: meta(L, 2, D, dt=torch.bfloat16)
             for k in ("att_x", "ffn_x", "wkv_a", "wkv_b", "wkv_o")}
    counters = (dpot_w4_matmul, vq_matmul, rwkv4_model_decode)
    before = [c.launches for c in counters]
    with pytest.raises((RuntimeError, NotImplementedError)):
        dpot_w4_matmul(meta(4, 8, dt=torch.bfloat16),
                       meta(4, 6, dt=torch.uint8), meta(6))
    with pytest.raises((RuntimeError, NotImplementedError)):
        vq_matmul(meta(4, 8, dt=torch.bfloat16), meta(8, 6, dt=torch.uint8),
                  meta(1, 256, dt=torch.bfloat16))
    with pytest.raises((RuntimeError, NotImplementedError)):
        rwkv4_model_decode(stack, state, meta(2, D, dt=torch.bfloat16))
    assert [c.launches for c in counters] == before
    # RWKV-6: K6, and K7 on a layer's W8 tree and on the slab stack
    from repro_torch.core.quant.serving import broadcast_packed_scales
    from repro_torch.kernels.fused_decode import (
        rwkv6_block_decode, rwkv6_model_decode)
    from repro_torch.kernels.wkv6 import wkv6_seq
    from repro_torch.models.rwkv4 import _layer
    from repro_torch.models.rwkv6 import prepare_fused_model_params as prep6
    from repro_torch.tree import tree_map
    m6 = get_model("rwkv6-7b", smoke=True)
    cfg = m6.cfg
    L, D, H, N = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.rwkv_head_dim
    tp6 = m6.cast_params(build_plan(m6, quantized=True,
                                    device="cpu").prepared.raw)
    to_meta = lambda t: t.to("meta")
    lp = tree_map(to_meta, _layer(broadcast_packed_scales(tp6["blocks"], L),
                                  0))
    stack6 = prep6(tp6, cfg)["blocks"]
    stack6 = FusedLayerStack(tree_map(to_meta, stack6.slabs),
                             tuple(map(to_meta, stack6.aux)),
                             stack6.manifest, stack6.tdef)
    bf = torch.bfloat16
    st_l = {"att_x": meta(2, D, dt=bf), "ffn_x": meta(2, D, dt=bf),
            "wkv_s": meta(2, H, N, N, dt=bf)}
    st6 = {k: meta(L, *v.shape, dt=bf) for k, v in st_l.items()}
    counters = (wkv6_seq, rwkv6_block_decode, rwkv6_model_decode)
    before = [c.launches for c in counters]
    with pytest.raises((RuntimeError, NotImplementedError)):
        wkv6_seq(*(meta(2, 3, H, N) for _ in range(4)), meta(H, N),
                 meta(2, H, N, N, dt=bf), carry_dtype="bfloat16")
    with pytest.raises((RuntimeError, NotImplementedError)):
        rwkv6_block_decode(lp, st_l, meta(2, D, dt=bf), cfg)
    with pytest.raises((RuntimeError, NotImplementedError)):
        rwkv6_model_decode(stack6, st6, meta(2, D, dt=bf), cfg)
    assert [c.launches for c in counters] == before
