"""The port's serving fault drills on the CPU (`ServingFaultInjector`,
the NaN/Inf sentinel and quarantine, cache-error handling).

The injector refuses what JAX's refuses.  A probe failure, injected or the
cache's own `CacheStorageError`, degrades to a counted miss; any other
exception raised by the cache or by a program raises out of `tick()` at
its first occurrence (the port has no path demotion).  Forced evictions
(mid-prefill, and from inside a token emission mid-speculation), forced
deadlines, torn snapshot writes and poisoned lanes keep the invariants:
the pool's free list restored, no cache lease held, no speculation state
between ticks, and every surviving or replayed stream equal to a
fault-free run's.  A churn of faults gives JAX's per-op engine's outcomes
and counts, and a SIGKILLed child process restores bit for bit.
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from port_helpers import to_port
from repro.models.registry import get_model as j_get_model
from repro.runtime.monitor import ServingFaultInjector as JInjector
from repro.serving import PrefixCache as JCache
from repro.serving import PrefixCacheConfig as JCacheConfig
from repro.serving import ServingEngine as JEngine
from repro_torch.runtime.monitor import EngineCrash, ServingFaultInjector
from repro_torch.serving import (CacheStorageError, PrefixCache,
                                 PrefixCacheConfig, ServingEngine,
                                 build_plan)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def plan4():
    return build_plan("rwkv4-169m", smoke=True, prefill_chunk=4,
                      device="cpu")


@pytest.fixture(scope="module")
def spec_plan():
    return build_plan("rwkv4-169m", smoke=True, prefill_chunk=4,
                      speculative=2, device="cpu")


def _engine(plan, **kw):
    return ServingEngine(plan.model, plan=plan, device="cpu", **kw)


def _refcounts(cache):
    return [e.refcount for e in
            list(cache._device.values()) + list(cache._host.values())]


def _fresh_cache(cls=PrefixCache, cfg=PrefixCacheConfig):
    return cls(4, config=cfg(device_slots=6, host_slots=6))


def _clean(eng, cache=None):
    """The invariants every drill must leave behind."""
    sch = eng.scheduler
    assert eng.pool.n_free == eng.pool.max_slots
    assert not sch.slots and not sch.queue and not sch._queued
    assert not eng.handles
    assert sch._spec_snapshot is None and sch._spec_inflight == {}
    assert sch._evict_on_token == set() and not sch._fail_next_probe
    if cache is not None:
        cache.check_state()
        assert all(r == 0 for r in _refcounts(cache))


# --- the injector ------------------------------------------------------------------

def test_injector_refuses_what_jax_refuses():
    assert ServingFaultInjector.KINDS == JInjector.KINDS
    msgs = []
    for cls in (JInjector, ServingFaultInjector):
        inj = cls(schedule={1: [("explode", None)]})
        with pytest.raises(ValueError) as ei:
            inj.pop(1)
        msgs.append(str(ei.value))
        off = cls(schedule={1: [("evict", 0)]}, enabled=False)
        assert off.pop(1) == [] and off.fired == []
        on = cls(schedule={3: [("evict", 2), ("deadline", 1)]})
        assert on.pop(2) == [] and on.pop(3) == [("evict", 2),
                                                 ("deadline", 1)]
        assert on.fired == [(3, "evict", 2), (3, "deadline", 1)]
    assert msgs[0] == msgs[1]


# --- cache errors ------------------------------------------------------------------

def test_cache_probe_error_degrades_to_a_miss(plan4):
    inj = ServingFaultInjector(schedule={1: [("cache_probe_error", None)]})
    cache = _fresh_cache()
    eng = _engine(plan4, max_batch=2, prefix_cache=cache,
                  fault_injector=inj)
    h = eng.submit([1, 2, 3, 4, 5, 6], max_new_tokens=3)
    eng.run()
    assert h.outcome == "finished" and len(h.tokens) == 3
    assert eng.counters.cache_errors == 1
    assert inj.fired == [(1, "cache_probe_error", None)]
    _clean(eng, cache)
    h2 = eng.submit([1, 2, 3, 4, 9], max_new_tokens=2)
    eng.run()
    assert h2.outcome == "finished" and eng.counters.cache_hits == 1


def test_a_damaged_cache_entry_degrades_to_a_miss(plan4):
    """The cache's own CacheStorageError: an entry whose stored state lost
    a leaf is dropped and the probe is a counted miss; the stream equals
    the uncached one."""
    prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    base = _engine(plan4, max_batch=1)
    want = base.submit(prompt, max_new_tokens=4)
    base.run()
    cache = _fresh_cache()
    eng = _engine(plan4, max_batch=1, prefix_cache=cache)
    eng.submit(prompt[:8] + [3], max_new_tokens=1)
    eng.run()
    entry = max(cache._device.values(), key=lambda e: e.n_tokens)
    entry.state.pop(sorted(entry.state)[0])
    n = cache.n_device
    h = eng.submit(prompt, max_new_tokens=4)
    eng.run()
    assert h.tokens == want.tokens
    assert eng.counters.cache_errors == 1
    assert eng.counters.cache_hits == 0
    assert cache.n_device == n          # dropped, then the boundary
    _clean(eng, cache)                  # republished by the new request
    with pytest.raises(CacheStorageError):
        bad = next(iter(cache._device.values()))
        bad.state = {"x": torch.zeros(1)}
        cache.probe(bad.key[0], list(bad.tokens) + [0])


@pytest.mark.parametrize("where", ["probe", "insert"])
def test_other_cache_exceptions_raise_out_of_the_tick(plan4, where):
    cache = _fresh_cache()
    eng = _engine(plan4, max_batch=1, prefix_cache=cache)

    def boom(*a, **k):
        raise RuntimeError(f"{where} fault")
    setattr(cache, where, boom)
    eng.submit([1, 2, 3, 4, 5, 6], max_new_tokens=1)
    with pytest.raises(RuntimeError, match=f"{where} fault"):
        eng.run()
    assert eng.counters.cache_errors == 0


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_a_raising_program_raises_out_of_the_first_tick(plan4, kind):
    """No path demotion: the first failure raises, the program is called
    once, and nothing falls back to another program."""
    eng = _engine(plan4, max_batch=2)
    calls = {"n": 0}
    attr = f"{kind}_fn"
    real = getattr(eng.scheduler, attr)

    def flaky(*args):
        calls["n"] += 1
        raise RuntimeError(f"{kind} launch failed")
    setattr(eng.scheduler, attr, flaky)
    eng.submit([1, 2, 3], max_new_tokens=4)
    with pytest.raises(RuntimeError, match="launch failed"):
        eng.run()
    assert calls["n"] == 1
    assert getattr(eng.scheduler, attr) is flaky and real is not flaky


# --- evictions and deadlines -------------------------------------------------------

def test_forced_evict_mid_prefill_frees_the_lane(plan4):
    inj = ServingFaultInjector()
    eng = _engine(plan4, max_batch=2, fault_injector=inj)
    victim = eng.submit(list(range(10, 22)), max_new_tokens=5)
    other = eng.submit([1, 2, 3], max_new_tokens=4)
    inj.schedule[2] = [("evict", victim.rid)]
    eng.run()
    assert victim.outcome == "cancelled" and victim.tokens == []
    assert other.outcome == "finished" and len(other.tokens) == 4
    snap = eng.counters.snapshot()
    assert snap["cancelled"] == 1 and snap["finished"] == 1
    _clean(eng)


def test_forced_deadline_evicts_without_a_deadline_set(plan4):
    inj = ServingFaultInjector()
    eng = _engine(plan4, max_batch=2, fault_injector=inj)
    victim = eng.submit([1, 2, 3, 4], max_new_tokens=20)
    queued = eng.submit([5, 6], max_new_tokens=2)
    inj.schedule[2] = [("deadline", victim.rid)]
    eng.run()
    assert victim.outcome == "deadline" and queued.outcome == "finished"
    assert eng.counters.deadline_evicted == 1
    _clean(eng)


def test_evict_on_token_mid_speculation(spec_plan):
    def run(faulted):
        inj = ServingFaultInjector() if faulted else None
        eng = _engine(spec_plan, max_batch=2, fault_injector=inj)
        victim = eng.submit([1, 2, 3, 4], max_new_tokens=10)
        survivor = eng.submit([5, 6, 7], max_new_tokens=6,
                              temperature=0.9, seed=7)
        if faulted:
            inj.schedule[2] = [("evict_on_token", victim.rid)]
        eng.run()
        return eng, inj, victim, survivor

    _, _, _, base = run(False)
    eng, inj, victim, survivor = run(True)
    assert inj.fired == [(2, "evict_on_token", victim.rid)]
    assert victim.outcome == "cancelled"
    assert 1 <= len(victim.tokens) < 10
    assert survivor.outcome == "finished"
    assert survivor.tokens == base.tokens
    _clean(eng)


# --- the churns --------------------------------------------------------------------

SURV, V1, V2, V3, V4 = ([1, 2, 3, 4, 5, 6, 7], list(range(10, 22)),
                        list(range(30, 38)), list(range(40, 46)),
                        [50, 51, 52, 53, 54])


def _churn(plan, faulted, tmp_path, *, spec=False):
    """Every fault kind but the crash in one run against a prefix-cached
    engine with the sentinel on: a probe error at the survivor's
    admission, an eviction mid-prefill, an eviction from inside a token
    emission (its first, from the prefill call; under `spec` one inside a
    later speculative tick), a forced deadline on a queued request,
    a poisoned lane and a torn snapshot write."""
    from repro_torch.serving import SnapshotConfig
    cache = _fresh_cache()
    inj = ServingFaultInjector() if faulted else None
    eng = _engine(plan, max_batch=2, prefix_cache=cache, fault_injector=inj,
                  sentinel_every=1,
                  snapshot=SnapshotConfig(str(tmp_path), every=0))
    hs = [eng.submit(SURV, max_new_tokens=6, temperature=0.8, seed=11)] + [
        eng.submit(p, max_new_tokens=6) for p in (V1, V2, V3, V4)]
    if faulted:
        for tick, fault in ((1, ("cache_probe_error", None)),
                            (2, ("evict", hs[1].rid)),
                            (3, ("torn_snapshot_write", None)),
                            (4 if spec else 3, ("evict_on_token",
                                                hs[2].rid)),
                            (5, ("deadline", hs[3].rid)),
                            (6, ("corrupt_state_leaf", hs[4].rid))):
            inj.schedule.setdefault(tick, []).append(fault)
    eng.run()
    eng.snapshot_manager.wait()
    return eng, cache, inj, hs


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "speculative"])
def test_churn_of_every_fault_kind_holds_the_invariants(plan4, spec_plan,
                                                        tmp_path, spec):
    plan = spec_plan if spec else plan4
    _, _, _, base = _churn(plan, False, tmp_path / "a", spec=spec)
    programs = dict(plan.trace_counts)
    eng, cache, inj, hs = _churn(plan, True, tmp_path / "b", spec=spec)
    assert len(inj.fired) == 6 and not inj.schedule
    assert [h.outcome for h in hs] == ["finished", "cancelled", "cancelled",
                                       "deadline", "finished"]
    assert hs[0].tokens == base[0].tokens       # the seeded survivor
    assert hs[4].tokens == base[4].tokens       # the quarantined replay
    assert hs[4].resumed == []
    # plain: evicted at its first token (the prefill call's); speculative:
    # at its third, the first the speculative tick of tick 4 emitted
    assert len(hs[2].tokens) == (3 if spec else 1)
    snap = eng.counters.snapshot()
    assert (snap["finished"], snap["cancelled"], snap["deadline_evicted"],
            snap["cache_errors"], snap["quarantined_lanes"]) == \
        (2, 2, 1, 1, 1)
    assert [n for n in os.listdir(tmp_path / "b")] == [".tmp-step_00000003"]
    assert eng.trace_counts == programs     # no program built anew
    _clean(eng, cache)


def test_churn_outcomes_and_counts_equal_jax(plan4):
    """The same churn through JAX's per-op engine and the port's: the
    outcomes, token counts and non-timing counters agree (tokens
    themselves may flip between the frameworks' roundings)."""
    jm = j_get_model("rwkv4-169m", smoke=True)
    jp = jm.init_params(jax.random.PRNGKey(0))

    def drive(eng, inj, cache_cls, cfg_cls):
        hs = [eng.submit(SURV, max_new_tokens=6)] + [
            eng.submit(p, max_new_tokens=6) for p in (V1, V2, V3, V4)]
        inj.schedule.update({
            1: [("cache_probe_error", None)], 2: [("evict", hs[1].rid)],
            3: [("evict_on_token", hs[2].rid)],
            4: [("deadline", hs[3].rid)]})
        eng.run()
        snap = eng.counters.snapshot()
        return ([(h.outcome, len(h.tokens)) for h in hs],
                {k: v for k, v in snap.items()
                 if not (k.endswith("_s") or "per_s" in k)}, inj.fired)

    jinj = JInjector()
    jeng = JEngine(jm, params=jp, max_batch=2, prefill_chunk=4,
                   prefix_cache=_fresh_cache(JCache, JCacheConfig),
                   fault_injector=jinj)
    tinj = ServingFaultInjector()
    teng = ServingEngine("rwkv4-169m", params=to_port(jp), smoke=True,
                         max_batch=2, prefill_chunk=4,
                         prefix_cache=_fresh_cache(), fault_injector=tinj,
                         device="cpu")
    assert drive(teng, tinj, PrefixCache, PrefixCacheConfig) == \
        drive(jeng, jinj, JCache, JCacheConfig)


# --- crashes -------------------------------------------------------------------------

def test_crash_fault_raises_a_typed_engine_crash(plan4):
    inj = ServingFaultInjector(schedule={3: [("crash_at_tick", "raise")]})
    eng = _engine(plan4, max_batch=2, fault_injector=inj)
    eng.submit([1, 2, 3, 4], max_new_tokens=8)
    with pytest.raises(EngineCrash) as ei:
        eng.run()
    assert ei.value.tick == 3 and eng.scheduler._tick_no == 3
    assert inj.fired == [(3, "crash_at_tick", "raise")]


def test_sigkilled_child_restores_bit_for_bit(tmp_path):
    """The SIGKILL drill on the CPU: a child process serves with
    snapshots and is killed by `crash_at_tick` "sigkill"; the parent
    restores the directory and the streams equal a run that never
    crashed."""
    child = textwrap.dedent(f"""
        from repro_torch.runtime.monitor import ServingFaultInjector
        from repro_torch.serving import ServingEngine, SnapshotConfig
        inj = ServingFaultInjector(schedule={{6: [("crash_at_tick",
                                                   "sigkill")]}})
        eng = ServingEngine("rwkv4-169m", smoke=True, max_batch=3,
                            prefill_chunk=4, seed=2, device="cpu",
                            fault_injector=inj,
                            snapshot=SnapshotConfig({str(tmp_path)!r},
                                                    every=2))
        for i in range(3):
            eng.submit([3 + i, 7, 11 + i, 2, 9, 5], max_new_tokens=8,
                       temperature=0.9 if i % 2 else 0.0, seed=11 + i)
        eng.run()
        raise SystemExit("the crash did not fire")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    rc = subprocess.run([sys.executable, "-c", child], env=env,
                        capture_output=True, timeout=300).returncode
    assert rc == -9
    ref = ServingEngine("rwkv4-169m", smoke=True, max_batch=3,
                        prefill_chunk=4, seed=2, device="cpu")
    want = [ref.submit([3 + i, 7, 11 + i, 2, 9, 5], max_new_tokens=8,
                       temperature=0.9 if i % 2 else 0.0, seed=11 + i)
            for i in range(3)]
    ref.run()
    restored = ServingEngine.restore(str(tmp_path), snapshot=None)
    # the kill may tear tick 4's write (its thread still writing): the
    # restore then takes tick 2's, as a torn write must
    assert restored.scheduler._tick_no in (2, 4)
    handles = restored.handles
    restored.run()
    assert {rid: h.resumed + h.tokens for rid, h in handles.items()} == \
        {h.rid: h.tokens for h in want}


# --- the sentinel ---------------------------------------------------------------------

def test_lane_finite_and_poison_slot(plan4):
    eng = _engine(plan4, max_batch=3)
    pool = eng.pool
    assert pool.lane_finite().tolist() == [True, True, True]
    before = {k: v.clone() for k, v in pool.state.items()}
    pool.poison_slot(1)
    assert pool.lane_finite().tolist() == [True, False, True]
    for k, v in pool.state.items():
        ax = pool._axis[k]
        assert torch.isnan(v.narrow(ax, 1, 1)).all()
        for s in (0, 2):
            assert torch.equal(v.narrow(ax, s, 1), before[k].narrow(ax, s, 1))
    pool.state = {k: v.to(torch.int32) for k, v in pool.state.items()}
    assert pool.lane_finite() is None


@pytest.mark.parametrize("arch", ["rwkv4-169m", "rwkv6-7b"])
def test_quarantine_replays_bit_for_bit_and_leaks_nothing(arch):
    plan = build_plan(arch, smoke=True, prefill_chunk=4, device="cpu")

    def run(faulted):
        cache = _fresh_cache()
        inj = ServingFaultInjector() if faulted else None
        eng = _engine(plan, max_batch=2, prefix_cache=cache,
                      fault_injector=inj, sentinel_every=1)
        victim = eng.submit([1, 2, 3, 4, 5, 6], max_new_tokens=6)
        surv = eng.submit([7, 8, 9], max_new_tokens=6, temperature=0.8,
                          seed=11)
        if faulted:
            inj.schedule[3] = [("corrupt_state_leaf", victim.rid)]
        eng.run()
        return eng, cache, victim, surv

    _, _, base_victim, base_surv = run(False)
    eng, cache, victim, surv = run(True)
    assert eng.counters.quarantined_lanes == 1
    assert victim.outcome == "finished" and victim.resumed == []
    assert victim.tokens == base_victim.tokens
    assert surv.tokens == base_surv.tokens
    _clean(eng, cache)


def test_sentinel_is_off_by_default(plan4):
    eng = _engine(plan4, max_batch=1)
    assert eng.scheduler.sentinel_every == 0
    eng.pool.poison_slot(0)
    eng.scheduler._sentinel_sweep()     # off: nothing judged, nothing raised
    assert eng.counters.quarantined_lanes == 0


# --- the CLI: flags and the supervisor ------------------------------------------------

@pytest.mark.parametrize("rcs,want_rc,want_calls", [
    ([0], 0, 1), ([-9, 0], 0, 2), ([1, -9, 0], 0, 3), ([1, 1, 1, 1], 1, 4),
    ([-9, -9, -9, -9, 0], -9, 4)])
def test_supervise_restarts_with_resume_then_gives_up(monkeypatch, rcs,
                                                      want_rc, want_calls):
    from repro_torch.launch import serve
    calls, it = [], iter(rcs)

    def call(argv):
        calls.append(list(argv))
        return next(it)
    monkeypatch.setattr(subprocess, "call", call)
    argv = ["--smoke", "--snapshot-dir", "d", "--supervise"]
    assert serve.supervise(argv, max_restarts=3) == want_rc
    assert len(calls) == want_calls
    head = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
            "--snapshot-dir", "d"]
    assert calls[0] == head
    assert all(c == head + ["--resume"] for c in calls[1:])


def test_cli_snapshots_resumes_and_refuses_supervise_without_a_dir(
        tmp_path, capsys):
    from repro_torch.launch import serve
    d = str(tmp_path / "snaps")
    base = ["--smoke", "--device", "cpu", "--batch", "3", "--tokens", "6"]
    serve.main(base + ["--snapshot-dir", d, "--snapshot-every", "2",
                       "--max-queue", "2", "--prefill-budget", "16",
                       "--sentinel-every", "1", "--deadline", "600"])
    out = capsys.readouterr().out
    assert "1/3 submissions backpressured" in out and "backpressured: 1" in out
    assert sorted(os.listdir(d))[-1].startswith("step_")
    serve.main(base + ["--snapshot-dir", d, "--resume"])
    out = capsys.readouterr().out
    assert "resumed 2 request(s)" in out and "restores: 1" in out
    with pytest.raises(SystemExit):
        serve.main(base + ["--supervise"])


def test_a_damaged_entry_met_by_a_spill_drops_the_insert(plan4):
    """An insert that must spill a damaged device entry raises the cache's
    CacheStorageError; the scheduler counts it, drops that insert and
    serves on, the streams unchanged and no lease held."""
    prompts = [[1, 2, 3, 4, 5], [6, 7, 8, 9, 10], [11, 12, 13, 14, 15]]
    base = _engine(plan4, max_batch=1)
    want = [base.submit(p, max_new_tokens=2) for p in prompts]
    base.run()
    cache = PrefixCache(4, config=PrefixCacheConfig(device_slots=1,
                                                    host_slots=4))
    eng = _engine(plan4, max_batch=1, prefix_cache=cache)
    first = eng.submit(prompts[0], max_new_tokens=2)
    eng.run()
    entry = next(iter(cache._device.values()))
    entry.state = {k: v[..., :1] for k, v in entry.state.items()}
    hs = [eng.submit(p, max_new_tokens=2) for p in prompts[1:]]
    eng.run()
    assert [h.tokens for h in [first] + hs] == [h.tokens for h in want]
    assert eng.counters.cache_errors == 1
    assert (cache.n_host, cache.n_device, cache.stats["drops"]) == (0, 1, 1)
    _clean(eng, cache)
