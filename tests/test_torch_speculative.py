"""The port's self-speculative decode against the JAX package's, on the CPU
at smoke sizes: `greedy_accept` on JAX's examples and a property, the
verifier's rows against JAX's per-op `verify_fn`, the rollback and the
re-advance, the drafter against the port's own truncated greedy chain on
every decode form, engine streams for k 1, 2, 4 on both families, fp and
W8, per-op and chunked verify (real drafter, stub drafters, sampling, a
cache hit, a cancel mid-tick), `trace_counts` equal to JAX's, and
`build_plan`'s refusals with JAX's messages.

JAX's chunked prefill does not run under jax >= 0.5 (ROADMAP "Reference
status"), so the JAX verifier and engine are the per-op ones.  On the CPU
the port's chunked verify rows equal its per-op decode step bit for bit,
so every speculative stream equals the plain engine's; streams and
acceptance counts are compared inside the port only (tokens flip between
the frameworks), logits to JAX's by the port_helpers rule.
"""
import functools
import importlib.util
import inspect
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from port_helpers import assert_close, to_port
from repro.models.registry import get_model as j_get_model
from repro.serving import ServingEngine as JEngine
from repro.serving.plan import build_plan as j_build_plan
from repro.serving.scheduler import Scheduler as JScheduler
from repro.serving.scheduler import greedy_accept as j_accept
from repro_torch.core.quant.serving import unpack_params
from repro_torch.models.registry import get_model
from repro_torch.serving import ServingEngine, build_plan
from repro_torch.serving.plan import draft_path
from repro_torch.serving.scheduler import Scheduler, greedy_accept
from test_prefill import _random_state

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                                   # pragma: no cover
    from conftest import hypothesis_stubs
    given, settings, st = hypothesis_stubs()

ARCHS = ("rwkv4-169m", "rwkv6-7b")


@pytest.fixture(scope="module")
def trees():
    """Per arch: (JAX model, port model, a JAX f32 tree from seed 1)."""
    out = {}
    for arch in ARCHS:
        jm = j_get_model(arch, smoke=True)
        out[arch] = (jm, get_model(arch, smoke=True),
                     jm.init_params(jax.random.PRNGKey(1)))
    return out


# --- the acceptance rule -----------------------------------------------------------

@pytest.mark.parametrize("window,argmax", [
    ([5, 7, 9], [7, 9, 2]), ([5, 7, 9], [1, 9, 2]), ([5, 7, 9], [7, 4, 2]),
    ([5], [3]), ([1, 2, 3, 4], [2, 3, 4, 5])])
def test_greedy_accept_examples_equal_jax(window, argmax):
    assert greedy_accept(window, argmax) == j_accept(window, argmax)


@settings(max_examples=200, deadline=None)
@given(st.data())
def test_greedy_accept_property_equals_jax(data):
    pytest.importorskip("hypothesis")
    k = data.draw(st.integers(min_value=1, max_value=6))
    window = data.draw(st.lists(st.integers(0, 9), min_size=k, max_size=k))
    argmax = data.draw(st.lists(st.integers(0, 9), min_size=k, max_size=k))
    emitted, consumed = greedy_accept(window, argmax)
    assert (emitted, consumed) == j_accept(window, argmax)
    assert emitted == argmax[:consumed]
    assert window[1:consumed] == argmax[:consumed - 1]
    if consumed < k:
        assert argmax[consumed - 1] != window[consumed]


# --- the programs ----------------------------------------------------------------

K, S = 3, 3
PREFIXES = (K, 1, 0)


def _window(vocab, rng):
    toks = rng.integers(0, vocab, (S, K)).astype(np.int32)
    valid = np.zeros((S, K), bool)
    for i, n in enumerate(PREFIXES):
        valid[i, :n] = True
    return toks, valid


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "w8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_verify_rows_match_jax(trees, arch, quantized, rng):
    """The verifier's rows and state, chunked and per-op, against JAX's
    per-op verify_fn from the same state and window; invalid rows zero,
    the two port forms equal bit for bit."""
    jm, tm, params = trees[arch]
    state = _random_state(jm, rng, batch=S)
    toks, valid = _window(jm.cfg.vocab, rng)
    jplan = j_build_plan(jm, params, quantized=quantized, speculative=K)
    jrows, jstate = jplan.verify_fn(S)(state, jnp.asarray(toks),
                                       jnp.asarray(valid))
    got = []
    for chunked in (False, True):
        plan = build_plan(tm, to_port(params), quantized=quantized,
                          fused_prefill=chunked, speculative=K,
                          device="cpu")
        rows, st_ = plan.verify_fn(S)(to_port(state), toks, valid)
        assert tuple(rows.shape) == (S, K, jm.cfg.vocab)
        assert not bool(rows[torch.as_tensor(~valid)].any())
        assert_close(jrows, rows, f"rows chunked={chunked}")
        for key in st_:
            assert_close(jstate[key], st_[key], key)
        got.append((rows, st_))
    assert torch.equal(got[0][0], got[1][0])
    assert all(torch.equal(got[0][1][k], got[1][1][k]) for k in got[0][1])


def _unpacked(plan):
    raw = plan.prepared.raw
    return unpack_params(raw) if plan.prepared.quantized else raw


@pytest.mark.parametrize("chunked", [False, True], ids=["per_op", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rollback_and_readvance(trees, arch, chunked, rng):
    """Rejected lanes take the snapshot bit for bit, the others keep the
    commit; re-advancing by an accepted prefix equals a lane that never
    speculated (the per-op decode step over the same tokens)."""
    jm, tm, params = trees[arch]
    plan = build_plan(tm, to_port(params), fused_prefill=chunked,
                      speculative=K, device="cpu")
    snap = to_port(_random_state(jm, rng, batch=S))
    keep = {k: v.clone() for k, v in snap.items()}
    toks, _ = _window(jm.cfg.vocab, rng)
    full = np.ones((S, K), bool)
    _, committed = plan.verify_fn(S)(snap, toks, full)
    reject = np.array([True, False, True])
    rolled = plan.rollback_fn(S)(committed, snap, reject)
    axes = dict(zip(sorted(snap), tm.decode_state_batch_axes()))
    for k, v in rolled.items():
        for lane in range(S):
            src = snap if reject[lane] else committed
            assert torch.equal(v.narrow(axes[k], lane, 1),
                               src[k].narrow(axes[k], lane, 1))
    assert all(torch.equal(keep[k], snap[k]) for k in snap)   # untouched
    accepted = np.zeros((S, K), bool)
    accepted[0, :2] = accepted[2, :1] = True
    _, readv = plan.verify_fn(S)(rolled, toks, accepted)
    for lane, n in ((0, 2), (2, 1)):
        st_ = {k: v.narrow(axes[k], lane, 1) for k, v in snap.items()}
        with torch.inference_mode():
            for j in range(n):
                _, st_ = tm.decode_step(_unpacked(plan), st_,
                                        torch.as_tensor(toks[lane:lane + 1,
                                                             j:j + 1]), 0)
        for k in st_:
            assert torch.equal(readv[k].narrow(axes[k], lane, 1), st_[k])
    assert plan.trace_counts == {"decode": 0, "prefill": 0, "verify": 1,
                                 "rollback": 1, "draft": 0}


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("decode", [False, "block", "model"])
@pytest.mark.parametrize("arch", ARCHS)
def test_draft_fn_is_the_truncated_greedy_chain(trees, arch, decode, depth,
                                                rng):
    """The drafter on each decode form (per-op; K3 / K7-block; K4 /
    K7-model, or K3 / K7-block at one layer) equals the port's own
    per-op truncated greedy chain bit for bit, and leaves its input
    state untouched."""
    jm, tm, params = trees[arch]
    plan = build_plan(tm, to_port(params), quantized=True,
                      fused_decode=decode, speculative=4,
                      draft_depth=depth, device="cpu")
    assert draft_path(plan.decode_desc.name, depth) == (
        "block" if decode == "model" and depth == 1
        else plan.decode_desc.name)
    state = to_port(_random_state(jm, rng, batch=S))
    keep = {k: v.clone() for k, v in state.items()}
    toks = rng.integers(0, jm.cfg.vocab, (S, 1)).astype(np.int32)
    drafted = plan.draft_fn(S)(state, toks)
    assert tuple(drafted.shape) == (S, 3) and drafted.dtype == torch.int32
    assert all(torch.equal(keep[k], state[k]) for k in state)
    dm, p = tm.truncated(depth), unpack_params(tm.truncate_params(
        plan.prepared.raw, depth))
    st_, tok, chain = tm.truncate_state(state, depth), torch.as_tensor(
        toks), []
    with torch.inference_mode():
        for _ in range(3):
            logits, st_ = dm.decode_step(p, st_, tok, 0)
            tok = torch.argmax(logits[:, 0].float(), -1).to(
                torch.int32)[:, None]
            chain.append(tok)
    assert torch.equal(drafted, torch.cat(chain, 1))


def _deep_state(tm, batch, seed):
    """A random bf16 decode state of the port model `tm` (running maxima
    shifted down by 1, as test_prefill's `_random_state`)."""
    g = torch.Generator().manual_seed(seed)
    state = tm.init_decode_state(batch, 0, device="cpu")
    return {k: (torch.randn(v.shape, generator=g)
                - float(bool((v < -1e30).all()))).to(v.dtype)
            for k, v in state.items()}


@pytest.mark.parametrize("decode", [False, "block", "model"])
@pytest.mark.parametrize("arch", ARCHS)
def test_draft_fn_on_a_deeper_stack(arch, decode):
    """A 3-layer stack drafted on its first 2 layers, so that the "model"
    form's truncated slab table and the state narrowing are exercised: the
    drafter's tokens equal the per-op truncated greedy chain bit for bit,
    and one step of the drafter's own form (`prepared.draft`) leaves
    `truncate_state` of the full stack's step on the plan's decode form,
    bit for bit."""
    import dataclasses
    tm = get_model(dataclasses.replace(get_model(arch, smoke=True).cfg,
                                       n_layers=3))
    plan = build_plan(tm, quantized=True, fused_decode=decode,
                      fused_prefill=bool(decode), speculative=3,
                      draft_depth=2, device="cpu")
    assert draft_path(plan.decode_desc.name, 2) == plan.decode_desc.name
    state = _deep_state(tm, S, 5)
    keep = {k: v.clone() for k, v in state.items()}
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, tm.cfg.vocab, (S, 1)).astype(np.int32))
    drafted = plan.draft_fn(S)(state, toks)
    assert all(torch.equal(keep[k], state[k]) for k in state)
    dm = tm.truncated(2)
    p = unpack_params(tm.truncate_params(plan.prepared.raw, 2))
    st_, tok, chain = tm.truncate_state(state, 2), toks, []
    with torch.inference_mode():
        for _ in range(2):
            logits, st_ = dm.decode_step(p, st_, tok, 0)
            tok = torch.argmax(logits[:, 0].float(), -1).to(
                torch.int32)[:, None]
            chain.append(tok)
        assert torch.equal(drafted, torch.cat(chain, 1))
        step = plan._decode_step()
        full = tm.truncate_state(step(plan.prepared.decode, state, toks)[1],
                                 2)
        cut = plan._decode_step(model=dm)(plan.prepared.draft,
                                          tm.truncate_state(state, 2),
                                          toks)[1]
    for k in cut:
        assert torch.equal(cut[k], full[k]), k


# --- engines --------------------------------------------------------------------

LENS = (5, 9, 3, 12)
MAX_NEW = 9


def _prompts(vocab, lens=LENS, seed=7):
    r = np.random.default_rng(seed)
    return [r.integers(0, vocab, n).tolist() for n in lens]


@functools.lru_cache(maxsize=None)
def _smoke():
    """chip_smoke.py as a module (its serving helpers), loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "_spec_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _serve(eng, prompts, temperature=0.0, sequential=False, n_new=MAX_NEW):
    """chip_smoke's `_serve` (fresh counters): (streams, snapshot)."""
    return _smoke()._serve(eng, prompts, n_new, temperature=temperature,
                           sequential=sequential)[:2]


def _stub(eng, streams, kind):
    """chip_smoke's stub drafter: "accept", "reject" or "ragged"."""
    return _smoke()._stub_drafter(eng, streams, kind)


def _engine(tm, params, quantized, chunked, **kw):
    return ServingEngine(
        tm, params=to_port(params), quantized=quantized, max_batch=3,
        prefill_chunk=4, fused_decode="model" if chunked else False,
        fused_prefill=chunked, device="cpu", **kw)


@pytest.fixture(scope="module")
def baselines(trees):
    """The port's plain engine streams, greedy and sampled, per (arch,
    quantized)."""
    out = {}
    for arch in ARCHS:
        _, tm, params = trees[arch]
        for q in (False, True):
            eng = _engine(tm, params, q, False)
            prompts = _prompts(tm.cfg.vocab)
            out[arch, q] = (_serve(eng, prompts)[0],
                            _serve(eng, prompts, temperature=0.8)[0])
    return out


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("chunked", [False, True], ids=["per_op", "chunked"])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "w8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_streams_equal_plain(trees, baselines, arch, quantized, chunked,
                                  k):
    _, tm, params = trees[arch]
    eng = _engine(tm, params, quantized, chunked, speculative=k)
    prompts = _prompts(tm.cfg.vocab)
    greedy, snap = _serve(eng, prompts)
    sampled, s_snap = _serve(eng, prompts, temperature=0.8)
    assert (greedy, sampled) == baselines[arch, quantized]
    for sn in (snap, s_snap):
        assert sn["drafted_tokens"] == sn["accepted_tokens"] + \
            sn["rejected_tokens"]
        assert sn["drafted_tokens"] == 0 if k == 1 else \
            sn["drafted_tokens"] > 0
        assert sn["decode_tokens"] == MAX_NEW * len(prompts)
    want = {"decode": 0, "prefill": 1, "verify": 1,
            "rollback": int(k > 1)}
    if k > 1:
        want["draft"] = 1
    assert eng.trace_counts == want
    assert eng.speculative == k
    assert eng.plan.build_config["speculative"] == k
    assert eng.plan.build_config["draft_depth"] == 1


@pytest.mark.parametrize("k", [1, 2, 4])
def test_trace_counts_and_acceptance_match_jax_shape(trees, k):
    """trace_counts equal JAX's per-op speculative engine's dicts; the
    acceptance counts agree between the port's verify forms and drafter
    forms (compared inside the port only)."""
    jm, tm, params = trees["rwkv4-169m"]
    prompts = _prompts(tm.cfg.vocab)
    jeng = JEngine(jm, params=params, max_batch=3, prefill_chunk=4,
                   speculative=k)
    _serve(jeng, prompts)
    snaps = []
    for decode, chunked in ((False, False), ("block", True),
                            ("model", True)):
        eng = ServingEngine(tm, params=to_port(params), max_batch=3,
                            prefill_chunk=4, fused_decode=decode,
                            fused_prefill=chunked, speculative=k,
                            device="cpu")
        _, snap = _serve(eng, prompts)
        assert eng.trace_counts == jeng.trace_counts
        snaps.append({n: snap[n] for n in (
            "drafted_tokens", "accepted_tokens", "rejected_tokens",
            "spec_ticks", "ticks")})
    assert snaps[0] == snaps[1] == snaps[2]
    assert jeng.plan.build_config["draft_depth"] == \
        eng.plan.build_config["draft_depth"]


@pytest.mark.parametrize("kind", ["accept", "reject", "ragged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_stub_drafters_keep_the_stream(trees, baselines, arch, kind):
    _, tm, params = trees[arch]
    prompts = _prompts(tm.cfg.vocab)
    for temp, base in zip((0.0, 0.8), baselines[arch, True]):
        eng = _engine(tm, params, True, True, speculative=3)
        _stub(eng, base, kind)
        got, snap = _serve(eng, prompts, temperature=temp)
        assert got == base, (kind, temp)
        rate = snap["acceptance_rate"]
        if kind == "reject":
            assert rate == 0.0 and snap["drafted_tokens"] > 0
        elif kind == "accept":      # only windows cut by a retirement
            assert rate > 0.5
        else:
            assert 0.0 < rate < 1.0


def test_all_accept_stub_never_rolls_back(trees, baselines):
    """max_new = 1 + 2k with equal prompt lengths: every window fills,
    acceptance 1.0, the rollback never runs (its count stays 0, as
    JAX's)."""
    _, tm, params = trees["rwkv4-169m"]
    prompts = _prompts(tm.cfg.vocab, lens=(5, 5, 5))
    plain = _engine(tm, params, False, True)
    base, _ = _serve(plain, prompts, n_new=7)
    eng = _engine(tm, params, False, True, speculative=3)
    _stub(eng, base, "accept")
    got, snap = _serve(eng, prompts, n_new=7)
    assert got == base
    assert snap["acceptance_rate"] == 1.0 and snap["rejected_tokens"] == 0
    assert eng.trace_counts["rollback"] == 0


def test_aligned_weights_accept_every_draft(trees):
    """att.wo and ffn.wv zero past layer 0 (bench_speculative's aligned
    weights): the depth-1 drafter (K3's plain version) predicts the full
    model, acceptance 1.0 on the CPU."""
    _, tm, params = trees["rwkv4-169m"]
    p = to_port(params)
    for leaf in (p["blocks"]["att"]["wo"], p["blocks"]["ffn"]["wv"]):
        leaf[1:] = 0.0
    kw = dict(params=p, quantized=True, max_batch=3, prefill_chunk=4,
              fused_decode="model", fused_prefill=True, device="cpu")
    prompts = _prompts(tm.cfg.vocab, lens=(5, 5, 5))
    base, _ = _serve(ServingEngine(tm, **kw), prompts)
    got, snap = _serve(ServingEngine(tm, speculative=4, draft_depth=1,
                                     **kw), prompts)
    assert got == base
    assert snap["acceptance_rate"] == 1.0


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_hit_then_speculative(trees, arch):
    _, tm, params = trees[arch]
    r = np.random.default_rng(23)
    prefix = r.integers(0, tm.cfg.vocab, 8).tolist()
    prompts = [prefix + [3], prefix + [5, 9]]
    outs = []
    for spec, cache in ((None, False), (2, False), (2, True)):
        eng = _engine(tm, params, True, True, speculative=spec,
                      prefix_cache=cache)
        got, snap = _serve(eng, prompts, sequential=True, n_new=6)
        outs.append(got)
    assert outs[0] == outs[1] == outs[2]
    assert snap["cache_hits"] == 1


def _quiescent(eng):
    sched = eng.scheduler
    assert sched._spec_snapshot is None and sched._spec_inflight == {}
    assert all(m.drafted == [] for m in sched.slots.values())


@pytest.mark.parametrize("victim", ["self", "other"])
def test_cancel_mid_speculation_tick(trees, baselines, victim):
    """An on_token callback cancelling its own lane or a lane whose walk
    has not run yet: the lane's drafts never emit, nothing stays in
    flight, the other streams keep their tokens."""
    _, tm, params = trees["rwkv4-169m"]
    base = baselines["rwkv4-169m", True][0]
    eng = _engine(tm, params, True, True, speculative=3)
    prompts = _prompts(tm.cfg.vocab)
    hs = [eng.submit(p, max_new_tokens=MAX_NEW, seed=11 + i)
          for i, p in enumerate(prompts)]
    sched, orig, fired = eng.scheduler, eng.scheduler.on_token, []
    target = hs[0 if victim == "self" else 1]

    def on_token(req, tok):
        orig(req, tok)
        if (req.rid == hs[0].rid and len(hs[0].tokens) == 3 and not fired
                and sched._spec_snapshot is not None):
            fired.append(True)
            assert eng.cancel(target)
    sched.on_token = on_token
    eng.run()
    assert fired and target.outcome == "cancelled"
    assert target.tokens == base[target.rid][:len(target.tokens)]
    assert len(target.tokens) < MAX_NEW
    for h in hs:
        if h is not target:
            assert h.tokens == base[h.rid] and h.outcome == "finished"
    _quiescent(eng)
    assert eng.pool.n_free == 3 and sched.slots == {}


def test_churn_keeps_speculation_quiescent(trees):
    _, tm, params = trees["rwkv4-169m"]
    eng = _engine(tm, params, True, True, speculative=2, prefix_cache=True)
    r = np.random.default_rng(0)
    pool = [r.integers(0, tm.cfg.vocab, n).tolist() for n in (3, 6, 9, 13)]
    live = []
    for _ in range(120):
        if r.random() < 0.5 and len(live) < 6:
            live.append(eng.submit(pool[r.integers(len(pool))],
                                   max_new_tokens=int(r.integers(2, 8))))
        if live and r.random() < 0.15:
            h = live.pop(r.integers(len(live)))
            if not h.done:
                eng.cancel(h)
        eng.step()
        _quiescent(eng)
        assert len(eng.scheduler.slots) + eng.pool.n_free == 3
        eng.prefix_cache.check_state()
    eng.run()
    snap = eng.counters.snapshot()
    assert snap["cache_hits"] > 0 and snap["drafted_tokens"] > 0


# --- validation ----------------------------------------------------------------

def _msg(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("kw", [dict(speculative=0), dict(speculative=-1),
                                dict(draft_depth=1),
                                dict(speculative=2, draft_depth=99),
                                dict(speculative=2, draft_depth=0)])
def test_build_plan_refusals_match_jax(trees, kw):
    jm, tm, params = trees["rwkv4-169m"]
    assert _msg(lambda: build_plan(tm, to_port(params), device="cpu",
                                   **kw)) == \
        _msg(lambda: j_build_plan(jm, params, **kw))


def test_build_plan_without_a_drafter_raises(trees, monkeypatch):
    from repro_torch.models import registry
    _, tm, params = trees["rwkv4-169m"]
    monkeypatch.setattr(registry.Model, "draft_paths", lambda self: {})
    with pytest.raises(ValueError, match="truncated-stack drafter"):
        build_plan(tm, to_port(params), speculative=2, device="cpu")


def test_scheduler_refusals_match_jax():
    dummy = lambda *a: None
    for kw in (dict(speculative=2), dict(speculative=2, verify_fn=dummy,
                                         rollback_fn=dummy)):
        assert _msg(lambda: Scheduler(None, dummy, dummy, prefill_chunk=4,
                                      **kw)) == \
            _msg(lambda: JScheduler(None, dummy, dummy, prefill_chunk=4,
                                    **kw))
    Scheduler(None, dummy, dummy, prefill_chunk=4, speculative=1,
              verify_fn=dummy, rollback_fn=dummy)


def test_signatures_carry_jax_arguments():
    from repro.serving.engine import ServingEngine as J
    for fn, jfn in ((ServingEngine.__init__, J.__init__),
                    (build_plan, j_build_plan)):
        got = inspect.signature(fn).parameters
        want = inspect.signature(jfn).parameters
        for name in ("speculative", "draft_depth"):
            assert got[name].default == want[name].default is None
    assert inspect.signature(ServingEngine.__init__).parameters[
        "prefix_cache"].default is None


def test_nonspec_plan_keeps_two_counts_and_default_depth(trees):
    jm, tm, params = trees["rwkv6-7b"]
    assert set(build_plan(tm, to_port(params), device="cpu").trace_counts) \
        == {"decode", "prefill"}
    plan = build_plan(tm, to_port(params), speculative=2, device="cpu")
    jplan = j_build_plan(jm, params, speculative=2)
    assert plan.speculative.draft_depth == jplan.speculative.draft_depth \
        == max(1, tm.cfg.n_layers // 2)
    assert plan.speculative.k == 2
    assert plan.build_config["speculative"] == \
        jplan.build_config["speculative"]
    assert plan.build_config["draft_depth"] == \
        jplan.build_config["draft_depth"]
