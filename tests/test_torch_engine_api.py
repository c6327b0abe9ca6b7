"""The port's engine, plan, registry and serving counters against the JAX
package, on the CPU at smoke sizes: `ServingCounters`, a given tree
(`params=`) on every path, cancellation (`evict`), `drain` / `handles` /
`trace_counts` / `astream`, an f32 state, the truncated models and the
all-position prefill logits, and `greedy_decode`'s sampling.

JAX's chunked prefill does not run under jax >= 0.5 (ROADMAP "Reference
status"), so the engines meet on the per-op path; streams are compared
only inside the port, against its `sequential_decode`, because JAX's
batched engine no longer rounds as its own sequential decode does.
Logits and states hold to the port_helpers rule; identities inside the
port are bit for bit.
"""
import asyncio
import inspect

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from port_helpers import assert_bitwise, assert_close, to_port
from repro.core.quant.serving import pack_params as j_pack
from repro.core.quant.serving import unpack_params as j_unpack
from repro.kernels.common import exact_jit
from repro.models.registry import get_model as j_get_model
from repro.runtime.monitor import ServingCounters as JCounters
from repro.serving import ServingEngine as JEngine
from repro.serving.plan import build_plan as j_build_plan
from repro.serving.plan import masked_state_commit as j_commit
from repro_torch.core.quant.policy import PlanePolicy
from repro_torch.core.quant.serving import pack_params, unpack_params
from repro_torch.launch.serve import greedy_decode, sequential_decode
from repro_torch.models.registry import get_model
from repro_torch.runtime.monitor import ServingCounters
from repro_torch.serving import ServingEngine, build_plan
from repro_torch.serving.scheduler import Request, Scheduler
from test_prefill import _prefix_valid, _random_state

ARCHS = ("rwkv4-169m", "rwkv6-7b")
MIXED = PlanePolicy(default="w8", overrides=(
    (r"\['att'\]\['wk'\]", "w4"), (r"\['ffn'\]\['wv'\]", "vq"),
    (r"\['head'\]", "w4")))


@pytest.fixture(scope="module")
def trees():
    """Per arch: (JAX model, port model, a JAX f32 tree from seed 3)."""
    out = {}
    for arch in ARCHS:
        jm = j_get_model(arch, smoke=True)
        out[arch] = (jm, get_model(arch, smoke=True),
                     jm.init_params(jax.random.PRNGKey(3)))
    return out


def _prompts(n, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(k)).tolist()
            for k in rng.integers(1, 11, n)]


# --- ServingCounters ---------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _drive(counters):
    """Every hook of the class, in a fixed order."""
    c = counters
    for rid in range(4):
        c.on_enqueue(rid)
    c.on_admit(0)
    c.on_admit(1)
    c.on_cache_probe(0, hit=True, n_cached=8, probe_s=0.01, copy_s=0.02)
    c.on_cache_probe(1, hit=False, probe_s=0.03)
    c.on_cache_insert()
    c.on_cache_evict()
    c.on_cache_spill()
    c.on_prefill(0, 8)
    c.on_prefill(1, 5)
    c.on_prefill(1, 3)
    c.on_tick(active=2, queued=2)
    for rid in (0, 1):
        c.on_token(rid, first=True)
    c.on_speculate(0, drafted=3, accepted=2)
    c.on_token(0)
    c.on_token(0)
    c.on_token(1)
    c.on_budget_defer(7)
    c.on_tick(active=2, queued=2)
    c.on_finish(0)
    c.on_cancel(1)
    c.on_shed(2)
    c.on_deadline_evict(3)
    c.on_backpressure()
    c.on_cache_error()
    c.on_snapshot(0.5)
    c.on_restore(resumed_lanes=2)
    c.on_quarantine(5)
    c.on_checksum_failure(2)
    c.on_path_fallback({"path": "decode", "reason": "x"})
    c.on_tick(active=0, queued=0)


def test_serving_counters_match_jax():
    """The same hook sequence under the same fake clock: every key of
    `snapshot()` and of `state_dict()` equal, and `load_state` continues
    the telemetry on another clock."""
    jc, tc = JCounters(clock=_Clock()), ServingCounters(clock=_Clock())
    _drive(jc)
    _drive(tc)
    js, ts = jc.snapshot(), tc.snapshot()
    assert list(ts) == list(js)
    assert ts == js
    assert tc.state_dict() == jc.state_dict()
    back = ServingCounters(clock=_Clock())
    back.load_state(tc.state_dict())
    jback = JCounters(clock=_Clock())
    jback.load_state(jc.state_dict())
    assert back.snapshot() == jback.snapshot()


# --- signatures ----------------------------------------------------------------

def test_build_plan_and_engine_signatures_match_jax():
    """build_plan and ServingEngine take JAX's arguments in JAX's order,
    apart from the mesh (not ported yet), path demotion (which the port
    never makes) and the port's `device`."""
    later = {"mesh", "path_fallback", "path_fault_limit"}
    for jf, tf in ((j_build_plan, build_plan),
                   (JEngine.__init__, ServingEngine.__init__)):
        jn = [n for n in inspect.signature(jf).parameters if n not in later]
        tn = [n for n in inspect.signature(tf).parameters if n != "device"]
        assert tn == jn, (tf, tn, jn)
    jplan = j_build_plan("rwkv4-169m", smoke=True)
    tplan = build_plan("rwkv4-169m", smoke=True, device="cpu")
    assert tplan.build_config == jplan.build_config
    assert build_plan("rwkv6-7b", smoke=True, device="cpu").build_config[
        "arch"] == "rwkv6-7b"


# --- the engines on one tree -----------------------------------------------------

COUNT_KEYS = ("ticks", "admitted", "finished", "cancelled",
              "prefill_tokens", "decode_tokens", "peak_active_slots",
              "peak_queue_depth", "mean_active_slots", "mean_queue_depth",
              "mean_prefill_ticks")


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "w8"])
def test_engine_counts_match_jax(trees, quantized):
    """The port's per-op engine and JAX's serve the same requests from the
    same tree: equal counts; each port stream is its sequential decode on
    that tree, bit for bit."""
    jm, tm, params = trees["rwkv4-169m"]
    kw = dict(max_batch=3, prefill_chunk=4, quantized=quantized)
    jeng = JEngine(jm, params=params, **kw)
    teng = ServingEngine(tm, params=to_port(params), device="cpu", **kw)
    prompts = _prompts(5, jm.cfg.vocab, seed=7)
    budgets = [3, 5, 2, 4, 6]
    jh = [jeng.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    th = [teng.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    js, ts = jeng.run(), teng.run()
    assert {k: ts[k] for k in COUNT_KEYS} == {k: js[k] for k in COUNT_KEYS}
    assert len(teng.counters.ttft_s) == len(jeng.counters.ttft_s) == 5
    assert [len(h.tokens) for h in th] == [len(h.tokens) for h in jh] \
        == budgets
    assert all(h.outcome == "finished" for h in th + jh)
    for p, n, h in zip(prompts, budgets, th):
        assert h.tokens == sequential_decode(
            tm, teng.plan.prepared.raw, p, n, device="cpu")


def test_evict_matches_jax(trees):
    """Cancelling a queued request and an active one: the same outcomes,
    counts and surviving stream lengths as JAX's engine; a retired
    request cannot be cancelled again."""
    jm, tm, params = trees["rwkv4-169m"]
    kw = dict(max_batch=1, prefill_chunk=4)
    engines = (JEngine(jm, params=params, **kw),
               ServingEngine(tm, params=to_port(params), device="cpu", **kw))
    seen = []
    for eng in engines:
        a = eng.submit([1, 2, 3], max_new_tokens=6)
        b = eng.submit([4, 5], max_new_tokens=3)
        c = eng.submit([6], max_new_tokens=2)
        eng.step()
        eng.step()
        got = [eng.cancel(c), eng.cancel(a)]
        snap = eng.run()
        got += [eng.cancel(a), eng.cancel(b)]
        seen.append((got, [h.outcome for h in (a, b, c)],
                     [len(h.tokens) for h in (a, b, c)],
                     {k: snap[k] for k in COUNT_KEYS},
                     len(eng.counters.latency_s)))
    assert seen[1] == seen[0]
    assert seen[1][1] == ["cancelled", "finished", "cancelled"]
    assert seen[1][3]["cancelled"] == 2 and seen[1][3]["finished"] == 1


def test_drain_handles_trace_counts_match_jax(trees):
    jm, tm, params = trees["rwkv4-169m"]
    kw = dict(max_batch=2, prefill_chunk=4)
    results = []
    for eng in (JEngine(jm, params=params, **kw),
                ServingEngine(tm, params=to_port(params), device="cpu",
                              **kw)):
        hs = [eng.submit([1, 2, 3, 4, 5], max_new_tokens=4),
              eng.submit([7], max_new_tokens=2)]
        live = eng.handles
        assert set(live) == {0, 1} and live is not eng.handles
        eng.step()
        first = [h.drain() for h in hs]
        assert [h.drain() for h in hs] == [[], []]
        eng.run()
        rest = [h.drain() for h in hs]
        assert [f + r for f, r in zip(first, rest)] == [h.tokens for h in hs]
        assert eng.handles == {} and set(live) == {0, 1}
        results.append(([len(f) for f in first], dict(eng.trace_counts)))
    assert results[1] == results[0]
    assert results[1][1] == {"decode": 1, "prefill": 1}


def test_astream_interleaves():
    eng = ServingEngine("rwkv4-169m", smoke=True, max_batch=2,
                        prefill_chunk=4, device="cpu")
    hs = [eng.submit([1, 2, 3], max_new_tokens=3),
          eng.submit([4, 5, 6, 7, 8], max_new_tokens=5)]

    async def take(h):
        return [t async for t in eng.astream(h)]

    async def both():
        return await asyncio.gather(*(take(h) for h in hs))
    got = asyncio.run(both())
    assert got == [h.tokens for h in hs] and [len(g) for g in got] == [3, 5]


# --- a given tree on every path ------------------------------------------------

PATHS = {"per_op": dict(fused_decode=False, fused_prefill=False),
         "block": dict(fused_decode="block", fused_prefill=True),
         "model": dict(fused_decode="model", fused_prefill=True)}
FORMS = {"w8": dict(quantized=True), "mixed": dict(quantized=True,
                                                   plane_policy=MIXED),
         "bf16": dict(quantized=False)}


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("path", sorted(PATHS))
def test_given_tree_serves_on_every_path(path, form):
    """`params=` is what the plan serves, packed in one pass under the
    policy (or as given), on each decode and prefill path: the raw form
    is pack_params of the given tree, and each stream its sequential
    decode on that form."""
    tm = get_model("rwkv4-169m", smoke=True)
    tree = tm.init_params(11, "cpu")
    if form == "bf16":
        tree = tm.cast_params(tree)
    eng = ServingEngine(tm, params=tree, max_batch=3, prefill_chunk=4,
                        device="cpu", **PATHS[path], **FORMS[form])
    raw = eng.plan.prepared.raw
    if form == "bf16":
        assert raw is tree
    else:
        ref = pack_params(tree, FORMS[form].get("plane_policy"))
        for (_, a), (_, b) in zip(_leaves(raw), _leaves(ref)):
            assert torch.equal(a, b)
    drawn = build_plan(tm, device="cpu", **PATHS[path], **FORMS[form])
    assert not torch.equal(drawn.prepared.raw["embed"], raw["embed"])
    assert eng.plan.build_config["from_seed"] is False
    prompts = _prompts(4, tm.cfg.vocab, seed=3)
    hs = [eng.submit(p, max_new_tokens=4) for p in prompts]
    eng.run()
    for p, h in zip(prompts, hs):
        assert h.tokens == sequential_decode(tm, raw, p, 4, device="cpu")


def _leaves(tree):
    from repro_torch.tree import leaves_with_path
    return leaves_with_path(tree)


def test_given_tree_on_another_device_raises():
    """A leaf that is not on the plan's device raises, naming the leaf; it
    is never copied over quietly (meta stands in for the card here)."""
    tm = get_model("rwkv4-169m", smoke=True)
    tree = tm.init_params(0, "cpu")
    tree["blocks"]["att"]["wk"] = tree["blocks"]["att"]["wk"].to("meta")
    with pytest.raises(ValueError, match=r"\['blocks'\]\['att'\]\['wk'\]"):
        build_plan(tm, tree, quantized=True, device="cpu")


def test_f32_state_on_a_fused_path_raises_on_the_card(monkeypatch):
    """On a CUDA device an f32 state with a fused decode or the chunked
    prefill raises before anything is drawn or launched (a CUDA call here
    would fail differently); bf16 and the CPU pass the check."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for kw in (dict(fused_decode="model"), dict(fused_decode="block"),
               dict(fused_prefill=True)):
        with pytest.raises(ValueError, match="bf16 state"):
            build_plan("rwkv4-169m", smoke=True, state_dtype=torch.float32,
                       device="cuda", **kw)
    with pytest.raises(ValueError, match="float"):
        build_plan("rwkv4-169m", smoke=True, state_dtype=torch.int32,
                   device="cpu")
    plan = build_plan("rwkv4-169m", smoke=True, state_dtype=torch.float32,
                      fused_decode="model", fused_prefill=True, device="cpu")
    assert plan.state_dtype == torch.float32


# --- f32 state ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_f32_state_matches_jax(trees, arch, rng):
    """An f32 pool: the pool's dtype, its fresh lanes, and the decode
    program's teacher-forced logits and state against JAX's per-op step
    on an f32 state."""
    jm, tm, params = trees[arch]
    B = 2
    eng = ServingEngine(tm, params=to_port(params), max_batch=B,
                        prefill_chunk=4, state_dtype=torch.float32,
                        device="cpu")
    assert all(v.dtype == torch.float32 for v in eng.pool.state.values())
    assert eng.plan.build_config["state_dtype"] == "float32"
    js = jm.init_decode_state(B, 0, jnp.float32)
    ts = eng.pool.state
    jstep = exact_jit(lambda p, s, t: jm.decode_step(p, s, t, jnp.int32(0)))
    decode = eng.plan.decode_fn(B)
    mask = np.ones((B,), bool)
    for i in range(12):
        t = rng.integers(0, jm.cfg.vocab, (B, 1)).astype(np.int32)
        jl, js = jstep(params, js, jnp.asarray(t))
        tl, ts = decode(ts, t, mask)
        assert_close(jl, tl, f"logits step {i}")
        for k in ts:
            assert ts[k].dtype == torch.float32
            assert_close(js[k], ts[k], f"{k} step {i}")
    h = eng.submit([3, 1, 4, 1, 5], max_new_tokens=4)
    eng.run()
    assert len(h.tokens) == 4


# --- the truncated models ----------------------------------------------------------

@pytest.mark.parametrize("packed", [False, True], ids=["fp", "w8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_truncation_matches_jax(trees, arch, packed, rng):
    jm, tm, params = trees[arch]
    depth = 1
    jp = j_pack(params) if packed else params
    tp = to_port(jp)
    assert tm.decode_state_layer_axes() == jm.decode_state_layer_axes()
    assert tm.draft_paths().keys() == jm.draft_paths().keys() \
        == {"truncated"}
    jt, tt = jm.truncated(depth), tm.truncated(depth)
    assert tt.cfg.n_layers == jt.cfg.n_layers == depth
    jtp, ttp = jm.truncate_params(jp, depth), tm.truncate_params(tp, depth)
    for k in ttp:
        if k != "blocks":
            assert ttp[k] is tp[k]           # aliased, not copied
    for (_, a), (_, b) in zip(_leaves(ttp["blocks"]),
                              _leaves(to_port(jtp["blocks"]))):
        assert torch.equal(a, b)
    full = _random_state(jm, rng, batch=2)
    assert_bitwise_tree(jm.truncate_state(full, depth),
                        tm.truncate_state(to_port(full), depth))
    # the truncated model decodes as JAX's does, from the full model's
    # state cut to its depth
    un_j = j_unpack if packed else (lambda p: p)
    un_t = unpack_params if packed else (lambda p: p)
    jstep = exact_jit(lambda p, s, t: jt.decode_step(un_j(p), s, t,
                                                     jnp.int32(0)))
    js = jm.truncate_state(full, depth)
    ts = tm.truncate_state(to_port(full), depth)
    for i in range(6):
        t = rng.integers(0, jm.cfg.vocab, (2, 1)).astype(np.int32)
        jl, js = jstep(jtp, js, jnp.asarray(t))
        tl, ts = tt.decode_step(un_t(ttp), ts, torch.from_numpy(t), 0)
        assert_close(jl, tl, f"{arch} truncated logits step {i}")
        for k in ts:
            assert_close(js[k], ts[k], f"{k} step {i}")


def assert_bitwise_tree(jtree, ttree):
    for k in ttree:
        assert_bitwise(np.asarray(jtree[k]), ttree[k], k)


@pytest.mark.parametrize("arch", ARCHS)
def test_truncated_depth_out_of_range_raises(trees, arch):
    jm, tm, _ = trees[arch]
    for depth in (0, tm.cfg.n_layers + 1):
        with pytest.raises(ValueError) as jerr:
            jm.truncated(depth)
        with pytest.raises(ValueError) as terr:
            tm.truncated(depth)
        assert str(terr.value) == str(jerr.value)
    assert tm.truncated(tm.cfg.n_layers).cfg == tm.cfg


def test_registry_predicates_match_jax():
    for arch in ARCHS + ("smollm-135m",):
        jm, tm = j_get_model(arch, smoke=True), get_model(arch, smoke=True)
        for name in ("has_decode", "has_fused_decode",
                     "has_fused_model_decode", "has_fused_prefill"):
            assert getattr(tm, name) == getattr(jm, name), (arch, name)
        assert tm.draft_paths().keys() == jm.draft_paths().keys()


# --- all-position prefill logits ---------------------------------------------------

B, C = 4, 6
PREFIX_LENS = (C, 3, 0, 1)


def _rows_oracle(jm, params, state, tokens, valid, quantized):
    """JAX's per-op decode_step position by position with the engine's
    masked commit: row j the logits after token j, zero where invalid."""
    p = j_unpack(params) if quantized else params
    axes = jm.decode_state_batch_axes()
    rows = []
    for j in range(tokens.shape[1]):
        logits, stepped = jm.decode_step(p, state, tokens[:, j:j + 1],
                                         jnp.int32(0))
        ok = valid[:, j]
        state = j_commit(stepped, state, ok, axes)
        rows.append(jnp.where(ok[:, None], logits[:, 0],
                              jnp.zeros_like(logits[:, 0])))
    return state, jnp.stack(rows, 1)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "w8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_logits_matches_jax(trees, arch, quantized, rng):
    """`prefill_chunk_logits` against JAX's per-op step run position by
    position (prefix masks full, partial, empty, one token); invalid rows
    are zero, and row n_valid - 1 and the state equal `prefill_chunk`'s
    bit for bit."""
    jm, tm, params = trees[arch]
    jp = j_pack(params) if quantized else params
    tp = to_port(jp)
    state = _random_state(jm, rng)
    tokens = jnp.asarray(rng.integers(0, jm.cfg.vocab, (B, C)), jnp.int32)
    valid = _prefix_valid(PREFIX_LENS)
    js, jrows = exact_jit(lambda p, s: _rows_oracle(
        jm, p, s, tokens, valid, quantized))(jp, state)
    ts, trows = tm.prefill_chunk_logits(tp, to_port(state), to_port(tokens),
                                        to_port(valid))
    assert tuple(trows.shape) == (B, C, jm.cfg.vocab)
    v = np.array(valid)
    assert_close(np.asarray(jrows, np.float32)[v], trows.float()[
        torch.from_numpy(v)], "valid rows")
    assert not trows[torch.from_numpy(~v)].any()
    for k in ts:
        assert_close(js[k], ts[k], k)
    ls, last = tm.prefill_chunk(tp, to_port(state), to_port(tokens),
                                to_port(valid))
    for b, n in enumerate(PREFIX_LENS):
        if n:
            assert torch.equal(trows[b, n - 1], last[b, 0])
    for k in ts:
        assert torch.equal(ts[k], ls[k])


# --- greedy_decode's sampling ---------------------------------------------------------

def test_greedy_decode_sampling():
    """The same generator seed gives the same tokens; temperature 0, or no
    generator, is the argmax chain."""
    tm = get_model("rwkv4-169m", smoke=True)
    params = tm.init_params(0, "cpu")
    first = torch.tensor([[1], [2]], dtype=torch.int32)
    run = lambda **kw: greedy_decode(
        tm, params, tm.init_decode_state(2, 0, device="cpu"), first, 8,
        **kw)[0]
    gen = lambda: torch.Generator().manual_seed(5)
    a, b = run(sample_temp=0.8, rng=gen()), run(sample_temp=0.8, rng=gen())
    greedy = run()
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert a.shape == greedy.shape == (2, 9)
    assert not torch.equal(a, greedy)
    assert torch.equal(run(sample_temp=0.0, rng=gen()), greedy)
    assert torch.equal(run(sample_temp=0.8), greedy)


def test_scheduler_evict_unknown_and_outcomes():
    """`evict` of a rid that is neither queued nor in flight is False;
    on_finish receives the outcome."""
    model = get_model("rwkv4-169m", smoke=True)
    eng = ServingEngine(model, max_batch=1, prefill_chunk=4, device="cpu")
    seen = []
    sched = Scheduler(eng.pool, eng.plan.decode_fn(1),
                      eng.plan.prefill_fn(1), prefill_chunk=4,
                      counters=ServingCounters(),
                      on_finish=lambda req, outcome: seen.append(
                          (req.rid, outcome)))
    sched.enqueue(Request(rid=0, prompt=[1, 2], max_new_tokens=2))
    sched.enqueue(Request(rid=1, prompt=[3], max_new_tokens=2))
    assert not sched.evict(9)
    assert sched.evict(1)
    sched.run()
    assert seen == [(1, "cancelled"), (0, "finished")]
    assert sched.counters.snapshot()["cancelled"] == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_truncated_model_path_state_is_the_full_models(arch):
    """The model path of `truncated(2)` on `truncate_params` of a 3-layer
    stack gives `truncate_state` of the full model path's state after the
    same prefill chunk and decode steps, bit for bit (the plain versions
    here; tests/test_torch_cuda.py on the card).  A one-layer stack is
    not taken by the decode kernels' tables (its shared scales sit in its
    slabs: tests/test_torch_model_decode.py)."""
    import dataclasses
    tm = get_model(dataclasses.replace(get_model(arch, smoke=True).cfg,
                                       n_layers=3))
    plan = build_plan(tm, quantized=True, fused_decode="model",
                      fused_prefill=True, device="cpu")
    prep = plan.prepared
    cut, tp = tm.truncated(2), tm.truncate_params(prep.raw, 2)
    B, C = 2, 4
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tm.cfg.vocab, (B, C + 3)).astype(np.int32))
    valid = torch.ones((B, C), dtype=torch.bool)

    def run(m, prefill, decode):
        s = m.init_decode_state(B, 0, device="cpu")
        s, _ = m.prefill_chunk(prefill, s, toks[:, :C], valid)
        for j in range(C, C + 3):
            _, s = m.decode_step_fused_model(decode, s, toks[:, j:j + 1], 0)
        return s
    full = tm.truncate_state(run(tm, prep.prefill, prep.decode), 2)
    got = run(cut, cut.prepare_path_params(cut.prefill_paths()["chunked"],
                                           tp),
              cut.prepare_fused_model_params(tp))
    for k in got:
        assert torch.equal(got[k], full[k]), k
