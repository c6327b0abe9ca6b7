"""The port's recurrent-state prefix cache against the JAX package's, on the
CPU at smoke sizes: the rolling digests byte for byte, a seeded churn of
insert / probe / release / contains / hit_length over tiny tiers (stats,
lease lengths and tier membership equal JAX's every step, `check_state`
after each, collisions forced through `hash_fn`), the plan's
`cache_variant()` fields, cached engines (per-op and chunked prefill,
rwkv4 and rwkv6) streaming the cacheless engine's tokens bit for bit with
the cache counts of JAX's per-op cached engine, and the refusals.

JAX's chunked prefill does not run under jax >= 0.5 (ROADMAP "Reference
status"), so the JAX engine is the per-op one; the counts depend only on
the prompts and the chunk, never on the tokens.
"""
import dataclasses
import inspect

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from port_helpers import mixed_policies, to_port
from repro.models.registry import get_model as j_get_model
from repro.serving import ServingEngine as JEngine
from repro.serving.plan import build_plan as j_build_plan
from repro.serving.prefix_cache import CacheVariant as JVariant
from repro.serving.prefix_cache import PrefixCache as JCache
from repro.serving.prefix_cache import PrefixCacheConfig as JConfig
from repro_torch.models.registry import get_model
from repro_torch.serving import (CacheVariant, PrefixCache,
                                 PrefixCacheConfig, ServingEngine,
                                 build_plan)
from repro_torch.serving.prefix_cache import default_chunk_hash

ARCHS = ("rwkv4-169m", "rwkv6-7b")
COUNT_KEYS = ("cache_hits", "cache_misses", "cache_inserts",
              "cached_tokens", "prefill_tokens", "finished")


@pytest.fixture(scope="module")
def trees():
    """Per arch: (JAX model, port model, a JAX f32 tree from seed 5)."""
    out = {}
    for arch in ARCHS:
        jm = j_get_model(arch, smoke=True)
        out[arch] = (jm, get_model(arch, smoke=True),
                     jm.init_params(jax.random.PRNGKey(5)))
    return out


# --- keying ------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 3, 4, 16])
def test_digests_equal_jax(chunk):
    rng = np.random.default_rng(chunk)
    j = JCache(chunk)
    t = PrefixCache(chunk)
    for n in (0, 1, chunk - 1, chunk, 2 * chunk + 1, 40):
        prompt = rng.integers(0, 1 << 20, max(n, 0)).tolist()
        assert t.digests(prompt) == j.digests(prompt)
    assert default_chunk_hash(b"", (1, 2, 3)) == \
        __import__("repro.serving.prefix_cache",
                   fromlist=["x"]).default_chunk_hash(b"", (1, 2, 3))


# --- a seeded churn against tiny tiers -----------------------------------------

def _membership(cache):
    """Each tier's entries as (n_tokens, tokens, refcount), in LRU order."""
    return [[(e.n_tokens, e.tokens, e.refcount) for e in store.values()]
            for store in (cache._device, cache._host)]


def _churn(seed, collide, steps=160):
    """One seeded op sequence on both caches; asserts equality each step."""
    rng = np.random.default_rng(seed)
    hash_fn = (lambda prev, toks: b"collide") if collide else None
    kw = {} if hash_fn is None else {"hash_fn": hash_fn}
    cfg_j, cfg_t = JConfig(device_slots=2, host_slots=3), \
        PrefixCacheConfig(device_slots=2, host_slots=3)
    jc, tc = JCache(2, config=cfg_j, **kw), PrefixCache(2, config=cfg_t,
                                                       **kw)
    jv = JVariant("a", "fp", "exact", "chunked")
    tv = CacheVariant("a", "fp", "exact", "chunked")
    stems = [rng.integers(0, 4, 8).tolist() for _ in range(3)]
    leases = []
    for step in range(steps):
        stem = stems[rng.integers(len(stems))]
        prompt = stem[:int(rng.integers(1, 9))] + \
            rng.integers(0, 4, int(rng.integers(0, 3))).tolist()
        op = rng.random()
        if op < 0.4:
            n = int(rng.integers(1, len(prompt) + 1))
            val = float(step)
            a = jc.insert(jv, prompt, n, {"s": jnp.full((1, 3), val)})
            b = tc.insert(tv, prompt, n, {"s": torch.full((1, 3), val)})
            assert a == b, step
        elif op < 0.65:
            a, b = jc.probe(jv, prompt), tc.probe(tv, prompt)
            assert (a is None) == (b is None), step
            if a is not None:
                assert a.n_tokens == b.n_tokens and a.tokens == b.tokens
                assert float(np.asarray(a.state["s"])[0, 0]) == \
                    float(b.state["s"][0, 0])
                leases.append((a, b))
        elif op < 0.8 and leases:
            a, b = leases.pop(int(rng.integers(len(leases))))
            a.release()
            b.release()
        elif op < 0.9:
            assert jc.hit_length(jv, prompt) == tc.hit_length(tv, prompt)
        else:
            n = int(rng.integers(1, len(prompt) + 1))
            assert jc.contains(jv, prompt, n) == tc.contains(tv, prompt, n)
        assert dict(tc.stats) == dict(jc.stats), step
        assert _membership(tc) == _membership(jc), step
        assert tc.snapshot() == jc.snapshot(), step
        tc.check_state()
        jc.check_state()
    return tc


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("collide", [False, True], ids=["blake2b", "collide"])
def test_churn_matches_jax(seed, collide):
    tc = _churn(seed, collide)
    s = tc.stats
    assert s["inserts"] > 0 and s["hits"] > 0 and s["spills"] > 0
    if collide:
        assert s["collisions"] > 0


def test_host_states_are_cpu_copies_and_promote_bit_for_bit():
    cache = PrefixCache(2, config=PrefixCacheConfig(device_slots=1,
                                                    host_slots=2))
    v = CacheVariant("a", "fp", "exact", "chunked")
    a = {"s": torch.randn(2, 1, 5).to(torch.bfloat16)}
    want = a["s"].clone()
    cache.insert(v, [1, 2, 3], 2, a)
    cache.insert(v, [4, 5, 6], 2, {"s": torch.zeros(2, 1, 5)})
    host = next(iter(cache._host.values()))
    assert host.state["s"] is not a["s"] and host.state["s"].dtype == \
        torch.bfloat16
    lease = cache.probe(v, [1, 2, 3])
    assert torch.equal(lease.state["s"], want)
    assert cache.stats["host_hits"] == 1 and cache.n_device == 1
    lease.release()
    lease.release()                    # idempotent
    cache.check_state()


def test_export_adopt_round_trip():
    tc = _churn(4, False, steps=60)
    entries = tc.export_entries()
    fresh = PrefixCache(2, config=tc.config)
    fresh.adopt_entries(entries)
    assert [[(e.n_tokens, e.tokens, e.tier) for e in s.values()]
            for s in (fresh._device, fresh._host)] == \
        [[(e.n_tokens, e.tokens, e.tier) for e in s.values()]
         for s in (tc._device, tc._host)]
    with pytest.raises(ValueError, match="empty cache"):
        fresh.adopt_entries(entries)


def test_bad_chunk_raises_like_jax():
    with pytest.raises(ValueError) as je:
        JCache(0)
    with pytest.raises(ValueError) as te:
        PrefixCache(0)
    assert str(te.value) == str(je.value)


# --- the plan's isolation key ----------------------------------------------------

@pytest.mark.parametrize("form", ["fp", "w8", "mixed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_variant_matches_jax(trees, arch, form):
    jm, tm, params = trees[arch]
    jpol, tpol = mixed_policies() if form == "mixed" else (None, None)
    q = form != "fp"
    jv = j_build_plan(jm, params, quantized=q, plane_policy=jpol,
                      fused_prefill=True).cache_variant()
    for prefill in (False, True):
        tv = build_plan(tm, to_port(params), quantized=q, plane_policy=tpol,
                        fused_prefill=prefill, device="cpu").cache_variant()
        want = dataclasses.asdict(jv)
        want["prefill"] = "chunked" if prefill else "per_op"
        assert dataclasses.asdict(tv) == want
    assert dataclasses.asdict(build_plan(
        tm, to_port(params), device="cpu").cache_variant(
            numerics="hw_lut"))["numerics"] == "hw_lut"


# --- engines --------------------------------------------------------------------

def _traffic(vocab, seed=2):
    """A 9-token shared prefix (chunk 4: boundaries 4 and 8), a warm-up
    request, then prompts that extend it, one that does not, one equal to
    the warm-up."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 9).tolist()
    other = rng.integers(0, vocab, 6).tolist()
    return [prefix[:5], prefix + rng.integers(0, vocab, 3).tolist(),
            prefix + rng.integers(0, vocab, 7).tolist(), other,
            prefix[:8] + [1], prefix[:5]]


def _serve(eng, prompts, sequential=True, n_new=4):
    hs = []
    for i, p in enumerate(prompts):
        hs.append(eng.submit(p, max_new_tokens=n_new, seed=i))
        if sequential:
            eng.run()
    snap = eng.run()
    return [h.tokens for h in hs], snap


@pytest.fixture(scope="module")
def jax_counts(trees):
    """JAX's per-op cached engine on `_traffic`, per arch."""
    out = {}
    for arch in ARCHS:
        jm, _, params = trees[arch]
        eng = JEngine(jm, params=params, max_batch=2, prefill_chunk=4,
                      prefix_cache=True)
        _, snap = _serve(eng, _traffic(jm.cfg.vocab))
        out[arch] = ({k: snap[k] for k in COUNT_KEYS},
                     eng.prefix_cache.snapshot())
    return out


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "w8"])
@pytest.mark.parametrize("path", ["per_op", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cached_engine_streams_and_counts(trees, jax_counts, arch, path,
                                          quantized):
    jm, tm, params = trees[arch]
    kw = dict(params=to_port(params), quantized=quantized, max_batch=2,
              prefill_chunk=4, device="cpu")
    if path == "chunked":
        kw.update(fused_decode="model", fused_prefill=True)
    prompts = _traffic(tm.cfg.vocab)
    ref, _ = _serve(ServingEngine(tm, **kw), prompts)
    eng = ServingEngine(tm, prefix_cache=True, **kw)
    got, snap = _serve(eng, prompts)
    assert got == ref
    counts, stats = jax_counts[arch]
    assert {k: snap[k] for k in COUNT_KEYS} == counts
    assert eng.prefix_cache.snapshot() == stats
    assert snap["cache_hits"] >= 3
    eng.prefix_cache.check_state()
    # batched admission too: every hit is probed in one tick
    eng2 = ServingEngine(tm, prefix_cache=True, **{**kw, "max_batch": 6})
    _serve(eng2, prompts[:1])
    got2, _ = _serve(eng2, prompts[1:], sequential=False)
    assert got2 == ref[1:]


def test_host_tier_engine_streams(trees):
    _, tm, params = trees["rwkv4-169m"]
    kw = dict(params=to_port(params), max_batch=2, prefill_chunk=4,
              fused_decode="model", fused_prefill=True, device="cpu")
    prompts = _traffic(tm.cfg.vocab)
    ref, _ = _serve(ServingEngine(tm, **kw), prompts)
    eng = ServingEngine(tm, prefix_cache=PrefixCacheConfig(
        device_slots=1, host_slots=4), **kw)
    got, snap = _serve(eng, prompts)
    assert got == ref
    assert eng.prefix_cache.stats["spills"] > 0
    assert eng.prefix_cache.stats["host_hits"] > 0


def test_shared_cache_variants_and_wrong_chunk(trees):
    jm, tm, params = trees["rwkv4-169m"]
    kw = dict(params=to_port(params), max_batch=2, prefill_chunk=4,
              device="cpu")
    shared = PrefixCache(4)
    a = ServingEngine(tm, prefix_cache=shared, **kw)
    b = ServingEngine(tm, prefix_cache=shared, quantized=True, **kw)
    assert a.prefix_cache is b.prefix_cache is shared
    prompts = _traffic(tm.cfg.vocab)
    _serve(a, prompts)
    _, snap = _serve(b, prompts[1:2])
    assert snap["cache_hits"] == 0          # W8 never reads fp entries
    with pytest.raises(ValueError) as je:
        JEngine(jm, params=params, max_batch=2, prefill_chunk=8,
                prefix_cache=JCache(4))
    with pytest.raises(ValueError) as te:
        ServingEngine(tm, **{**kw, "prefill_chunk": 8},
                      prefix_cache=PrefixCache(4))
    assert str(te.value) == str(je.value)


def test_cache_errors_raise(trees):
    """No fallback: a probe or insert that raises, raises out of the
    tick."""
    _, tm, params = trees["rwkv4-169m"]
    eng = ServingEngine(tm, params=to_port(params), max_batch=2,
                        prefill_chunk=4, prefix_cache=True, device="cpu")

    def boom(*a, **k):
        raise RuntimeError("probe failed")
    eng.prefix_cache.probe = boom
    eng.submit([1, 2, 3, 4, 5], max_new_tokens=2)
    with pytest.raises(RuntimeError, match="probe failed"):
        eng.run()
    eng = ServingEngine(tm, params=to_port(params), max_batch=2,
                        prefill_chunk=4, prefix_cache=True, device="cpu")
    eng.prefix_cache.insert = lambda *a, **k: boom()
    eng.submit([1, 2, 3, 4, 5], max_new_tokens=2)
    with pytest.raises(RuntimeError, match="probe failed"):
        eng.run()
    from repro_torch.serving.scheduler import Scheduler
    with pytest.raises(ValueError, match="cache_variant"):
        Scheduler(None, None, None, prefill_chunk=4,
                  prefix_cache=PrefixCache(4))


def test_engine_signature_has_jax_cache_argument():
    from repro_torch.serving.engine import ServingEngine as T
    params = inspect.signature(T.__init__).parameters
    assert params["prefix_cache"].default is None
    assert inspect.signature(JEngine.__init__).parameters[
        "prefix_cache"].default is None


def test_counters_split_probe_and_copy_from_prefill(trees):
    _, tm, params = trees["rwkv6-7b"]
    eng = ServingEngine(tm, params=to_port(params), max_batch=2,
                        prefill_chunk=4, prefix_cache=True, device="cpu")
    _, snap = _serve(eng, _traffic(tm.cfg.vocab))
    c = eng.counters
    assert len(c.cache_probe_s) == snap["cache_hits"] + snap["cache_misses"]
    assert len(c.state_copy_s) == snap["cache_hits"]
    assert snap["cache_inserts"] == eng.prefix_cache.stats["inserts"]
