"""The port's SLO layer against the JAX package's, on the CPU.

Scheduler scenarios run through both packages' `Scheduler` on the same
fake pool and stub programs (no device work, so admission order and tick
counts are exact), the same requests and the same fake clock: priority
order, aging against a sustained high-priority stream, cache-hit
tie-breaking, backpressure with `retry_after_s`, shedding strictly less
urgent requests only, queued and in-flight deadlines, the prefill budget
deferring the lowest priority, and the hang watchdog on a leaked slot.
Each must give the same admission order, the same outcome per request,
the same raised signals and the same non-timing counter fields.  Then the
validation of `AdmissionPolicy` and `ServingSLO` against JAX's, the
plan's bucket-aware `prefill_quota`, and the port's engine on a smoke
rwkv4 (backpressure leaves no handle, shed and cancel, deadlines on a
cache-resumed lane, the budget's bit parity and program counts).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import repro.runtime.monitor as j_monitor
import repro.serving as j_serving
import repro.serving.scheduler as j_scheduler
import repro.serving.slo as j_slo
import repro_torch.runtime.monitor as t_monitor
import repro_torch.serving as t_serving
import repro_torch.serving.scheduler as t_scheduler
import repro_torch.serving.slo as t_slo
from repro.models.registry import get_model as j_get_model
from repro.serving.plan import build_plan as j_build_plan
from repro_torch.runtime.monitor import ServingCounters
from repro_torch.serving import (AdmissionPolicy, Overloaded, PrefixCache,
                                 PrefixCacheConfig, ServingEngine,
                                 ServingSLO, build_plan)

SIDES = {
    "jax": types.SimpleNamespace(
        Scheduler=j_scheduler.Scheduler, Request=j_scheduler.Request,
        SLO=j_slo.ServingSLO, Policy=j_slo.AdmissionPolicy,
        Overloaded=j_slo.Overloaded, Hang=j_slo.SchedulerHang,
        Counters=j_monitor.ServingCounters, Cache=j_serving.PrefixCache,
        CacheConfig=j_serving.PrefixCacheConfig,
        Variant=j_serving.CacheVariant, lane=lambda: np.zeros(2)),
    "port": types.SimpleNamespace(
        Scheduler=t_scheduler.Scheduler, Request=t_scheduler.Request,
        SLO=t_slo.ServingSLO, Policy=t_slo.AdmissionPolicy,
        Overloaded=t_slo.Overloaded, Hang=t_slo.SchedulerHang,
        Counters=t_monitor.ServingCounters, Cache=t_serving.PrefixCache,
        CacheConfig=t_serving.PrefixCacheConfig,
        Variant=t_serving.CacheVariant,
        lane=lambda: {"s": torch.zeros(1, 2)}),
}


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


class FakePool:
    """Slot bookkeeping without device state: the scheduler needs only
    acquire / release / write / read / sync here."""

    state = None

    def __init__(self, n: int, lane):
        self.max_slots = n
        self._free = list(range(n - 1, -1, -1))
        self._lane = lane

    @property
    def n_free(self) -> int:
        return len(self._free)

    def acquire(self):
        return self._free.pop() if self._free else None

    def release(self, slot: int):
        if slot in self._free:
            raise ValueError(f"double free of slot {slot}")
        self._free.append(slot)

    def write_slot(self, slot, state):
        pass

    def read_slot(self, slot):
        return self._lane()

    def sync(self):
        pass


def _stub_fns(n_slots: int, vocab: int = 5):
    def prefill_fn(state, toks, valid, fresh):
        return state, np.zeros((n_slots, 1, vocab), np.float32)

    def decode_fn(state, toks, mask):
        return np.zeros((n_slots, 1, vocab), np.float32), state

    return decode_fn, prefill_fn


class _Run:
    """One side's scheduler with a record of admissions and outcomes."""

    def __init__(self, side, n_slots=1, *, chunk=4, slo=None, clock=None,
                 cache=None, variant=None):
        self.side = side
        self.clock = clock or FakeClock()
        self.counters = side.Counters(clock=self.clock)
        self.admits, self.finishes = [], []
        admit = self.counters.on_admit

        def on_admit(rid):
            self.admits.append(rid)
            admit(rid)
        self.counters.on_admit = on_admit
        decode_fn, prefill_fn = _stub_fns(n_slots)
        self.sched = side.Scheduler(
            FakePool(n_slots, side.lane), decode_fn, prefill_fn,
            prefill_chunk=chunk, counters=self.counters,
            on_finish=lambda req, outcome: self.finishes.append(
                (req.rid, outcome)),
            prefix_cache=cache, cache_variant=variant, slo=slo)

    def req(self, rid, *, prompt=None, pri=0, mnt=1, deadline=None):
        return self.side.Request(rid=rid,
                                 prompt=prompt if prompt is not None else [1],
                                 max_new_tokens=mnt, priority=pri,
                                 deadline_s=deadline)

    def enqueue(self, rid, **kw):
        """Enqueue; a refusal is recorded as ("overloaded", depth, max,
        retry_after_s)."""
        try:
            self.sched.enqueue(self.req(rid, **kw))
        except self.side.Overloaded as e:
            self.finishes.append(("overloaded", e.queue_depth, e.max_queue,
                                  e.retry_after_s))

    def record(self) -> dict:
        snap = self.counters.snapshot()
        counts = {k: v for k, v in snap.items()
                  if not (k.endswith("_s") or "per_s" in k)}
        return {"admits": self.admits, "finishes": self.finishes,
                "counters": counts,
                "queue": [r.rid for r in self.sched.queue],
                "slots": sorted((s, m.req.rid, m.n_prefilled, m.phase)
                                for s, m in self.sched.slots.items()),
                "n_free": self.sched.pool.n_free}


# --- the scenarios: each drives one side and returns its record -------------

def s_fifo(side):
    r = _Run(side)
    for rid in (0, 1, 2):
        r.enqueue(rid)
    r.sched.run()
    return r


def s_priority(side):
    r = _Run(side)
    r.enqueue(0, pri=0)
    r.enqueue(1, pri=2)
    r.enqueue(2, pri=1)
    r.sched.run()
    return r


def s_aging(side, aging_ticks=3):
    r = _Run(side, slo=side.SLO(admission=side.Policy(
        aging_ticks=aging_ticks)))
    r.enqueue(0, pri=0)
    for t in range(1, 9):
        r.enqueue(100 + t, pri=1)
        r.sched.tick()
    return r


def s_no_aging(side):
    return s_aging(side, aging_ticks=0)


def s_cache_tie(side):
    C = 4
    cache = side.Cache(C, config=side.CacheConfig(device_slots=4,
                                                  host_slots=4))
    var = side.Variant(arch="stub", quant="fp", numerics="exact",
                       prefill="per_op")
    hitp = [1, 2, 3, 4, 9]
    cache.insert(var, hitp, 4, side.lane(), cache.digests(hitp))
    r = _Run(side, chunk=C, cache=cache, variant=var)
    r.enqueue(0, prompt=[7, 8, 9])
    r.enqueue(1, prompt=list(hitp))
    r.enqueue(2, prompt=[1, 2, 3, 4, 5], pri=0)
    r.sched.run()
    return r


def s_backpressure(side):
    r = _Run(side, slo=side.SLO(admission=side.Policy(max_queue=2)))
    r.enqueue(0)
    r.enqueue(1)
    r.enqueue(2)                        # refused: no estimate yet
    r.clock.t = 2.0
    r.sched.tick()                      # rid 0 finishes: latency 2.0 s
    r.enqueue(3, mnt=50)
    r.sched.tick()
    r.enqueue(4)
    r.enqueue(5)                        # refused: 2.0 x (2 + 1) / 1
    for rid in (3, 1, 4):
        r.sched.evict(rid)
    r.sched.run()
    return r


def s_shed(side):
    r = _Run(side, slo=side.SLO(admission=side.Policy(max_queue=2,
                                                      overload="shed")))
    r.enqueue(0, pri=0)
    r.enqueue(1, pri=1)
    r.enqueue(2, pri=1)                 # sheds rid 0 (0 < 1)
    r.enqueue(3, pri=1)                 # equal classes: backpressured
    r.enqueue(4, pri=2)                 # sheds the youngest of class 1
    r.sched.run()
    return r


def s_deadlines(side):
    r = _Run(side, 2, slo=side.SLO(default_deadline_s=30.0))
    r.enqueue(0, mnt=50)                # hogs slot 0 until its deadline
    r.enqueue(1, prompt=[1] * 8, mnt=50, deadline=5.0)
    r.sched.tick()                      # both admitted, 1 mid-prefill
    r.enqueue(2, deadline=5.0)          # queued
    r.clock.t += 10.0
    r.sched.tick()                      # 1 (in flight) and 2 (queued)
    r.enqueue(3, mnt=2)
    r.clock.t += 25.0
    r.sched.run()                       # 0 meets the default deadline
    return r


def s_budget(side):
    r = _Run(side, 4, slo=side.SLO(prefill_budget=4))
    r.enqueue(0, mnt=50)                # decoding from tick 1
    r.sched.tick()
    r.enqueue(1, prompt=[1] * 8)
    r.enqueue(2, prompt=[1] * 8)
    r.enqueue(3, prompt=[1] * 8, pri=1)
    r.sched.tick()
    r.sched.tick()
    r.sched.evict(0)
    r.sched.run()
    return r


def s_hang(side):
    r = _Run(side, slo=side.SLO(max_idle_ticks=3))
    r.sched.pool.acquire()              # leak the only slot
    r.enqueue(0)
    try:
        r.sched.run(max_idle_ticks=5)
    except side.Hang as e:
        r.finishes.append(("hang", e.idle_ticks, e.queued, e.active,
                           e.n_free, e.phases))
    try:
        r.sched.run()                   # the SLO's default limit
    except side.Hang as e:
        r.finishes.append(("hang", e.idle_ticks))
    return r


def s_watchdog_quiet(side):
    r = _Run(side, 2)
    for rid in range(4):
        r.enqueue(rid, prompt=[1] * 8, mnt=2)
    r.sched.run(max_idle_ticks=1)
    return r


SCENARIOS = {f.__name__[2:]: f for f in (
    s_fifo, s_priority, s_aging, s_no_aging, s_cache_tie, s_backpressure,
    s_shed, s_deadlines, s_budget, s_hang, s_watchdog_quiet)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduler_scenario_equals_jax(name):
    j = SCENARIOS[name](SIDES["jax"]).record()
    t = SCENARIOS[name](SIDES["port"]).record()
    assert t == j


# what each scenario must show, on the port's record (JAX's is equal)
EXPECT = {
    "fifo": lambda r: r["finishes"] == [(0, "finished"), (1, "finished"),
                                        (2, "finished")],
    "priority": lambda r: r["admits"] == [1, 2, 0],
    "aging": lambda r: (0, "finished") in r["finishes"]
    and r["admits"].index(0) <= 3,
    "no_aging": lambda r: (0, "finished") not in r["finishes"]
    and 0 in r["queue"],
    "cache_tie": lambda r: r["admits"] == [1, 2, 0]
    and r["counters"]["cache_hits"] == 2
    and r["counters"]["cached_tokens"] == 8,
    "backpressure": lambda r: ("overloaded", 2, 2, 0.0) in r["finishes"]
    and ("overloaded", 2, 2, pytest.approx(6.0)) in r["finishes"]
    and r["counters"]["backpressured"] == 2,
    "shed": lambda r: r["finishes"][:3] == [
        (0, "shed"), ("overloaded", 2, 2, 0.0), (2, "shed")]
    and r["counters"]["shed"] == 2,
    "deadlines": lambda r: {(1, "deadline"), (2, "deadline"),
                            (0, "deadline"), (3, "finished")}
    == set(r["finishes"]) and r["counters"]["deadline_evicted"] == 3
    and r["n_free"] == 2,
    "budget": lambda r: r["counters"]["budget_deferred_tokens"] == 16
    and r["n_free"] == 4,
    "hang": lambda r: r["finishes"] == [("hang", 5, 1, 0, 0, {}),
                                        ("hang", 3)],
    "watchdog_quiet": lambda r: len(r["finishes"]) == 4,
}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_scheduler_scenario_outcome(name):
    rec = SCENARIOS[name](SIDES["port"]).record()
    assert EXPECT[name](rec), rec


def test_budget_defers_the_lowest_priority_lanes():
    run = _Run(SIDES["port"], 4, slo=ServingSLO(prefill_budget=4))
    run.enqueue(0, mnt=50)
    run.sched.tick()
    for rid, pri in ((1, 0), (2, 0), (3, 1)):
        run.enqueue(rid, prompt=[1] * 8, pri=pri)
    run.sched.tick()
    by_rid = {m.req.rid: m for m in run.sched.slots.values()}
    assert by_rid[3].n_prefilled == 4
    assert by_rid[1].n_prefilled == by_rid[2].n_prefilled == 0
    run.sched.tick()
    assert by_rid[3].n_prefilled == 8


# --- validation ------------------------------------------------------------------

BAD = [("policy", {"overload": "drop"}), ("policy", {"max_queue": -1}),
       ("policy", {"aging_ticks": -1}), ("slo", {"prefill_budget": -1}),
       ("slo", {"default_deadline_s": 0.0}),
       ("slo", {"default_deadline_s": -2.0}),
       ("slo", {"max_idle_ticks": -1})]


@pytest.mark.parametrize("kind,kw", BAD, ids=[f"{k}-{next(iter(v))}"
                                              for k, v in BAD])
def test_validation_rejects_what_jax_rejects(kind, kw):
    msgs = []
    for side in (SIDES["jax"], SIDES["port"]):
        cls = side.Policy if kind == "policy" else side.SLO
        with pytest.raises(ValueError) as ei:
            cls(**kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_config_fields_and_defaults_equal_jax():
    for a, b in ((j_slo.AdmissionPolicy, t_slo.AdmissionPolicy),
                 (j_slo.ServingSLO, t_slo.ServingSLO)):
        ja, tb = a(), b()
        assert [f.name for f in dataclasses.fields(ja)] == \
            [f.name for f in dataclasses.fields(tb)]
        assert dataclasses.asdict(ja) == dataclasses.asdict(tb)
    e = (j_slo.Overloaded(queue_depth=3, max_queue=3, retry_after_s=1.5),
         t_slo.Overloaded(queue_depth=3, max_queue=3, retry_after_s=1.5))
    assert str(e[0]) == str(e[1])
    h = [c(idle_ticks=4, queued=1, active=0, n_free=0, phases={})
         for c in (j_slo.SchedulerHang, t_slo.SchedulerHang)]
    assert str(h[0]) == str(h[1])


# --- the plan's quota and the engine --------------------------------------------

@pytest.fixture(scope="module")
def plan4():
    return build_plan("rwkv4-169m", smoke=True, prefill_chunk=4,
                      device="cpu")


@pytest.mark.parametrize("budget,batch", [(0, 8), (4, 3), (11, 3),
                                          (100, 3), (1, 3), (-5, 2)])
def test_prefill_quota_equals_jax(plan4, budget, batch):
    jplan = j_build_plan(j_get_model("rwkv4-169m", smoke=True),
                         prefill_chunk=4)
    assert plan4.prefill_quota(budget, batch) == \
        jplan.prefill_quota(budget, batch)


def _engine(plan, **kw):
    return ServingEngine(plan.model, plan=plan, device="cpu", **kw)


def test_backpressured_submit_leaves_no_handle(plan4):
    eng = _engine(plan4, max_batch=2, slo=ServingSLO(
        admission=AdmissionPolicy(max_queue=1)))
    h1 = eng.submit([1, 2, 3], max_new_tokens=2)
    with pytest.raises(Overloaded) as ei:
        eng.submit([4, 5], max_new_tokens=2)
    assert (ei.value.queue_depth, ei.value.max_queue) == (1, 1)
    assert set(eng.handles) == {h1.rid}
    eng.run()
    assert h1.outcome == "finished" and len(h1.tokens) == 2
    assert eng.counters.snapshot()["backpressured"] == 1


def test_shed_is_observable_and_cancel_after_shed_is_graceful(plan4):
    eng = _engine(plan4, max_batch=2, slo=ServingSLO(
        admission=AdmissionPolicy(max_queue=1, overload="shed")))
    h1 = eng.submit([1, 2, 3], max_new_tokens=2)
    h2 = eng.submit([4, 5, 6], max_new_tokens=2, priority=1)
    assert h1.done and h1.outcome == "shed" and h1.tokens == []
    assert eng.cancel(h1) is False
    eng.run()
    assert h2.outcome == "finished" and len(h2.tokens) == 2
    assert eng.counters.snapshot()["shed"] == 1


def test_deadline_evicts_a_cache_resumed_lane(plan4):
    clk = FakeClock()
    cache = PrefixCache(4, config=PrefixCacheConfig(device_slots=8,
                                                    host_slots=8))
    eng = _engine(plan4, max_batch=2, prefix_cache=cache,
                  counters=ServingCounters(clock=clk))
    base = [1, 2, 3, 4, 5, 6, 7, 8]
    h0 = eng.submit(base, max_new_tokens=3)
    eng.run()
    assert h0.outcome == "finished" and cache.n_device > 0
    n_inserts = eng.counters.cache_inserts
    h = eng.submit(base + [9, 10], max_new_tokens=30, deadline_s=5.0)
    eng.step()                          # admitted through a cache hit
    assert eng.counters.cache_hits == 1
    clk.t += 10.0
    eng.step()
    assert h.done and h.outcome == "deadline"
    eng.run()
    assert eng.pool.n_free == 2
    cache.check_state()
    assert all(e.refcount == 0 for e in
               list(cache._device.values()) + list(cache._host.values()))
    assert eng.counters.snapshot()["deadline_evicted"] == 1
    assert eng.counters.cache_inserts == n_inserts


def test_budget_bit_parity_and_programs_built_once(plan4):
    """The budget changes when lanes prefill, never what they compute:
    streams equal the unlimited engine's and each program counts once."""
    rng = np.random.default_rng(2)
    V = plan4.model.cfg.vocab
    prompts = [rng.integers(0, V, size=n).tolist()
               for n in (9, 17, 4, 12, 6)]

    def run(slo):
        plan = build_plan("rwkv4-169m", smoke=True, prefill_chunk=4,
                          device="cpu")
        eng = _engine(plan, max_batch=3, slo=slo)
        hs = [eng.submit(p, max_new_tokens=5, temperature=0.7, seed=i)
              for i, p in enumerate(prompts)]
        eng.run()
        assert eng.trace_counts == {"decode": 1, "prefill": 1}
        return [h.tokens for h in hs], eng

    base, _ = run(ServingSLO())
    budgeted, eng = run(ServingSLO(prefill_budget=4))
    assert budgeted == base
    assert eng.scheduler._prefill_quota == 1
    assert eng.counters.budget_deferred_tokens > 0


def test_priorities_and_deadlines_reach_the_request(plan4):
    eng = _engine(plan4, max_batch=1)
    h = eng.submit([1, 2], max_new_tokens=1, priority=3, deadline_s=9.0)
    assert (h.request.priority, h.request.deadline_s) == (3, 9.0)
    assert h.resumed == []
    eng.run()
    assert h.outcome == "finished"
