"""Continuous-batching scheduler: admission, chunked prefill, batched
decode, the SLO layer, fault drills and the NaN/Inf sentinel (port of
`repro/serving/scheduler.py`).

One `tick()`:
  0. drains the fault injector's schedule for this tick (`_apply_faults`),
     sweeps the pool for non-finite lanes every `sentinel_every` ticks
     (`_sentinel_sweep`, quarantining and requeueing them) and evicts
     requests past their deadline (`_expire_deadlines`),
  1. ADMITS queued requests into free pool slots, highest effective
     priority first (class + aging), then the longest cached prefix, then
     FIFO (`_pop_next`); with a prefix cache it probes it: the longest
     cached proper prefix's state is written into the slot and only the
     suffix is prefilled (the slot starts at n_prefilled = hit length,
     its fresh reset suppressed),
  2. advances the prefilling slots by up to one prompt chunk in ONE
     prefill call, with a per-slot-per-token validity mask and a
     fresh-slot mask that resets newly admitted lanes inside the call;
     while any lane decodes, the prefill budget (a lane quota) may defer
     the least urgent lanes to a later tick; with a cache, a lane now
     holding a chunk boundary not yet cached stages a copy of its state,
     published when the request finishes,
  3. runs ONE decode step over the whole pool for all DECODE slots, with
     an active-slot mask selecting which lanes' states commit, or, under
     speculation, the draft -> verify -> accept tick (`_spec_tick`),
  4. calls `after_tick(tick)` (the snapshot cadence) with every boundary
     invariant holding: no speculation in flight, no lease held, every
     lane's state committed.

Inactive lanes are computed but their state is never committed, so a lane
mid-prefill or free is never disturbed by decode traffic.  `evict(rid)`
cancels a queued or in-flight request and frees its slot, from inside an
`on_token` callback too.  With a `ServingCounters` attached, the scheduler
calls its hooks where JAX's does.  `enqueue` bounds the queue: a full one
raises `Overloaded` or sheds a strictly less urgent request
(`repro_torch.serving.slo`); `run()` raises `SchedulerHang` after
`max_idle_ticks` ticks without progress.

Two kinds of cache trouble degrade to a counted miss: the injected
`cache_probe_error` and the cache's own `CacheStorageError`.  There is no
path demotion: any other failure, a failing kernel above all, raises out
of `tick()` at once and is never replaced by its plain twin behind the
caller's back.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import signal
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.runtime.monitor import EngineCrash
from repro_torch.serving.prefix_cache import CacheStorageError
from repro_torch.serving.slo import (SHED, Overloaded, SchedulerHang,
                                     ServingSLO)


@dataclasses.dataclass
class Request:
    """One generation request (host-side; tokens are python ints).

    priority   — admission class, higher = more urgent (ties FIFO); also
                 the shed-victim order under overload
    deadline_s — seconds from enqueue until the request is evicted with
                 outcome "deadline" (None = ServingSLO.default_deadline_s,
                 itself None by default: no deadline)"""
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    seed: int = 0
    eos_token: Optional[int] = None
    priority: int = 0
    deadline_s: Optional[float] = None


PREFILL, DECODE = "prefill", "decode"
# a request's outcome, passed to on_finish
FINISHED, CANCELLED, SHED_OUT, DEADLINE = \
    "finished", "cancelled", "shed", "deadline"


@dataclasses.dataclass
class _Slot:
    """Host metadata for one occupied pool slot."""
    req: Request
    phase: str = PREFILL
    fresh: bool = True              # lane still needs its state reset
    n_prefilled: int = 0
    next_token: int = -1            # token the next decode tick consumes
    generated: list[int] = dataclasses.field(default_factory=list)
    rng: Optional[np.random.Generator] = None
    # prefix cache: tokens restored from a hit, the prompt's boundary
    # digests (hashed at enqueue) and the boundary states captured during
    # prefill, published when the request finishes
    cached_tokens: int = 0
    digests: Optional[dict] = None
    pending_inserts: list = dataclasses.field(default_factory=list)
    # speculation: the drafts of the current tick's window (cleared at
    # emission or eviction; never output until the verifier confirms one)
    drafted: list[int] = dataclasses.field(default_factory=list)
    # SLO: the admission sequence number (the budget's tiebreak) and the
    # absolute deadline taken over from the queue entry
    seq: int = 0
    deadline_t: Optional[float] = None


@dataclasses.dataclass
class _Queued:
    """Host metadata for one QUEUED request: its enqueue order and tick
    (FIFO and aging), absolute deadline, and the prompt's cache digests
    (hashed once, so admission peeks never re-hash)."""
    seq: int
    enqueue_tick: int
    deadline_t: Optional[float] = None
    digests: Optional[dict] = None


def sample_token(logits_row: np.ndarray, temperature: float,
                 rng: Optional[np.random.Generator]) -> int:
    """Greedy argmax at temperature<=0 (ties -> first index); Gumbel-max
    sampling otherwise.  Single-row reference for `sample_tokens`."""
    if temperature <= 0.0 or rng is None:
        return int(np.argmax(logits_row))
    g = rng.gumbel(size=logits_row.shape)
    return int(np.argmax(logits_row.astype(np.float64) / temperature + g))


def greedy_accept(window_row, argmax_rows) -> tuple[list[int], int]:
    """The acceptance rule for one lane of a speculative tick.

    window_row  — the k verified tokens: the pending token, then k-1 drafts
    argmax_rows — the verifier's greedy choice after each window prefix

    Position j's choice e_j is emitted (it comes from verifier logits),
    and the walk goes on only while e_j confirms the next draft.  Returns
    (emitted tokens, window tokens consumed).  `Scheduler._spec_tick`
    walks the same way with sampling and retirement around it."""
    emitted, j, k = [], 0, len(window_row)
    while True:
        e = int(argmax_rows[j])
        emitted.append(e)
        if j + 1 < k and e == int(window_row[j + 1]):
            j += 1
            continue
        return emitted, j + 1


def sample_tokens(rows: np.ndarray, metas) -> np.ndarray:
    """Vectorized sampling for one tick's emitting slots.

    rows (n, V) are the slots' last-logits rows (f32), metas the matching
    `_Slot`s.  The Gumbel noise is drawn from EACH SLOT'S OWN Generator, so
    a seeded request's stream never depends on who shares the tick; greedy
    rows ride the same batched argmax (the f32 -> f64 cast is exact)."""
    n, V = rows.shape
    sampling = [i for i, meta in enumerate(metas)
                if meta.req.temperature > 0.0 and meta.rng is not None]
    if not sampling:
        return np.argmax(rows, axis=1)
    temps = np.ones((n, 1))
    noise = np.zeros((n, V))
    for i in sampling:
        temps[i, 0] = metas[i].req.temperature
        noise[i] = metas[i].rng.gumbel(size=V)
    return np.argmax(rows.astype(np.float64) / temps + noise, axis=1)


def _last_rows(logits) -> np.ndarray:
    """(S, 1, V) device logits -> (S, V) f32 numpy rows."""
    return _host(logits[:, -1])


def _host(a) -> np.ndarray:
    """A program's tokens or rows as a numpy array (f32 for floats)."""
    if isinstance(a, torch.Tensor):
        a = a.float() if a.is_floating_point() else a
        return a.cpu().numpy()
    return np.asarray(a)


class Scheduler:
    """Drives a SlotStatePool with two programs.

    decode_fn(pool_state, tokens (S,1) i32, mask (S,) bool)
        -> (logits (S,1,V), new_pool_state)
    prefill_fn(pool_state, tokens (S,C) i32, valid (S,C) bool,
               fresh (S,) bool)
        -> (new_pool_state, last_logits (S,1,V))

    With `speculative=k` the decode tick becomes draft -> verify ->
    accept, driven by three more programs instead of decode_fn:

    draft_fn(pool_state, tokens (S,1))            -> drafted (S, k-1)
    verify_fn(pool_state, tokens (S,k), valid (S,k))
        -> (logits (S,k,V), new_pool_state)       [its input state is the
                                                   rollback snapshot]
    rollback_fn(committed, snapshot, reject (S,)) -> pool_state

    `prefix_cache` (a PrefixCache) and `cache_variant` (the plan's
    CacheVariant) come together.  `on_token(req, tok)` fires per emitted
    token, `on_finish(req, outcome)` when a request leaves, with outcome
    "finished", "cancelled", "shed" or "deadline"; `counters` (a
    `ServingCounters`, or None) takes the telemetry hooks.

    `slo` (a ServingSLO) adds admission control: priority, aging,
    deadline and cache-aware selection, a bounded queue with `Overloaded`
    backpressure or shedding, a per-tick prefill lane quota
    (`prefill_quota`: the engine's `ExecutionPlan.prefill_quota`; left
    None it is derived from `slo.prefill_budget` the same way) and the
    `run()` watchdog.  `fault_injector` (a ServingFaultInjector) is
    drained at the top of every tick.  `sentinel_every` (0 = off) sweeps
    the pool for non-finite lanes every N ticks; a flagged lane is
    quarantined, `on_requeue(req)` lets the engine reset its handle, and
    the request replays from scratch.
    """

    def __init__(self, pool, decode_fn: Callable, prefill_fn: Callable, *,
                 prefill_chunk: int, counters=None,
                 on_token: Optional[Callable] = None,
                 on_finish: Optional[Callable] = None,
                 prefix_cache=None, cache_variant=None,
                 speculative: int = 0,
                 draft_fn: Optional[Callable] = None,
                 verify_fn: Optional[Callable] = None,
                 rollback_fn: Optional[Callable] = None,
                 slo: Optional[ServingSLO] = None,
                 prefill_quota: Optional[int] = None,
                 fault_injector=None, sentinel_every: int = 0,
                 on_requeue: Optional[Callable] = None):
        self.pool = pool
        self.decode_fn = decode_fn
        self.prefill_fn = prefill_fn
        self.prefill_chunk = int(prefill_chunk)
        self.counters = counters
        self.spec_k = int(speculative)
        self.draft_fn = draft_fn
        self.verify_fn = verify_fn
        self.rollback_fn = rollback_fn
        if self.spec_k:
            if verify_fn is None or rollback_fn is None:
                raise ValueError(
                    "speculative decode needs verify_fn and rollback_fn")
            if self.spec_k > 1 and draft_fn is None:
                raise ValueError(
                    f"speculative={self.spec_k} needs a draft_fn "
                    "(K=1 is the only drafterless window)")
        # tick-local speculation state, exposed for leak audits: the
        # rollback snapshot and the lanes whose drafts are in flight,
        # always empty between ticks
        self._spec_snapshot = None
        self._spec_inflight: dict[int, _Slot] = {}
        self.on_token = on_token or (lambda req, tok: None)
        self.on_finish = on_finish or (lambda req, outcome: None)
        self.slo = slo if slo is not None else ServingSLO()
        if prefill_quota is not None:
            self._prefill_quota: Optional[int] = int(prefill_quota)
        elif self.slo.prefill_budget > 0:
            self._prefill_quota = max(
                1, self.slo.prefill_budget // self.prefill_chunk)
        else:
            self._prefill_quota = None
        self.fault_injector = fault_injector
        self.sentinel_every = int(sentinel_every)
        self.on_requeue = on_requeue or (lambda req: None)
        # tick-boundary hooks, set by the engine: `after_tick(tick)` after
        # counters.on_tick (the snapshot cadence); `on_torn_snapshot(tick)`
        # for the torn-write fault drill
        self.after_tick: Optional[Callable] = None
        self.on_torn_snapshot: Optional[Callable] = None
        self._tick_no = 0
        self._seq = 0
        self._queued: dict[int, _Queued] = {}
        self._has_deadlines = False
        # admissions + prefill tokens + emitted tokens + retirements,
        # sheds and quarantines: the run() watchdog's progress measure
        self._progress = 0
        # armed faults (ServingFaultInjector)
        self._fail_next_probe = False
        self._evict_on_token: set[int] = set()
        # the cache's chunk must equal prefill_chunk (the engine checks):
        # cached boundaries are tick boundaries
        self.prefix_cache = prefix_cache
        self.cache_variant = cache_variant
        if prefix_cache is not None and cache_variant is None:
            raise ValueError("prefix_cache needs a cache_variant")
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: dict[int, _Slot] = {}

    # -- public ------------------------------------------------------------

    def enqueue(self, req: Request):
        """Queue a request for admission.  With a bounded queue
        (`AdmissionPolicy.max_queue`) a full queue either raises
        `Overloaded` (backpressure: the request was NOT accepted) or sheds
        the least urgent queued request when it is strictly less urgent
        than this one (else this one is backpressured)."""
        if not req.prompt:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the first token "
                             "is sampled from the prompt's last logits)")
        pol = self.slo.admission
        if pol.max_queue and len(self.queue) >= pol.max_queue:
            if pol.overload == SHED:
                victim = self._shed_victim(req)
                if victim is None:
                    self._backpressure()
                self._shed(victim)
            else:
                self._backpressure()
        self._push(req)

    def _push(self, req: Request):
        """Append `req` to the queue with a fresh sequence number, enqueue
        tick, deadline and digests (enqueue, and a quarantine's requeue,
        which bypasses the bounds)."""
        deadline_s = (req.deadline_s if req.deadline_s is not None
                      else self.slo.default_deadline_s)
        qm = _Queued(
            seq=self._next_seq(), enqueue_tick=self._tick_no,
            deadline_t=(None if deadline_s is None
                        else self._now() + deadline_s),
            digests=(self.prefix_cache.digests(req.prompt)
                     if self.prefix_cache is not None else None))
        if qm.deadline_t is not None:
            self._has_deadlines = True
        self._queued[req.rid] = qm
        self.queue.append(req)
        if self.counters is not None:
            self.counters.on_enqueue(req.rid)

    def tick(self) -> bool:
        """One scheduling round; returns True while work remains.  Ticks
        are numbered from 1 (the fault injector's schedule is keyed on
        this number and drained at the top of the tick)."""
        self._tick_no += 1
        if self.fault_injector is not None:
            self._apply_faults()
        self._sentinel_sweep()
        self._expire_deadlines()
        self._admit()
        self._prefill_tick()
        if self.spec_k:
            self._spec_tick()
        else:
            self._decode_tick()
        if self.counters is not None:
            self.counters.on_tick(active=len(self.slots),
                                  queued=len(self.queue))
        if self.after_tick is not None:
            self.after_tick(self._tick_no)
        return bool(self.queue or self.slots)

    def run(self, *, max_idle_ticks: Optional[int] = None):
        """Tick until no work remains.  The watchdog: `max_idle_ticks`
        (default `ServingSLO.max_idle_ticks`; 0 disables it) ticks in a
        row with work left and no progress (no admission, prefill token,
        emitted token or retirement) raise `SchedulerHang` with the
        scheduler's state, e.g. when a leaked slot leaves queued work
        unadmittable."""
        limit = (self.slo.max_idle_ticks if max_idle_ticks is None
                 else max_idle_ticks)
        idle, last = 0, self._progress
        while self.tick():
            if self._progress != last:
                idle, last = 0, self._progress
                continue
            idle += 1
            if limit and idle >= limit:
                phases = collections.Counter(
                    m.phase for m in self.slots.values())
                raise SchedulerHang(
                    idle_ticks=idle, queued=len(self.queue),
                    active=len(self.slots), n_free=self.pool.n_free,
                    phases=dict(phases))

    def evict(self, rid: int) -> bool:
        """Cancel an in-flight or queued request and free its slot; counted
        as a cancellation, not a completion (no latency sample).  False
        when no such request is queued or in flight."""
        for slot, meta in list(self.slots.items()):
            if meta.req.rid == rid:
                self._retire(slot, meta, outcome=CANCELLED)
                return True
        for req in list(self.queue):
            if req.rid == rid:
                self._dequeue(req)
                if self.counters is not None:
                    self.counters.on_cancel(rid)
                self.on_finish(req, CANCELLED)
                return True
        return False

    # -- SLO layer ---------------------------------------------------------

    def _backpressure(self):
        if self.counters is not None:
            self.counters.on_backpressure()
        raise Overloaded(queue_depth=len(self.queue),
                         max_queue=self.slo.admission.max_queue,
                         retry_after_s=self._retry_after())

    def _retry_after(self) -> float:
        """`Overloaded`'s hint: the mean finished-request latency times the
        queue-lengths of work ahead of a new arrival per slot (0.0 before
        any request has finished)."""
        c = self.counters
        if c is None or not getattr(c, "latency_s", None):
            return 0.0
        mean_lat = sum(c.latency_s) / len(c.latency_s)
        return mean_lat * (len(self.queue) + 1) / max(self.pool.max_slots, 1)

    def _eff_priority(self, req: Request, qm: _Queued) -> int:
        """Class + aging: one level per `aging_ticks` ticks queued."""
        aging = self.slo.admission.aging_ticks
        bonus = (self._tick_no - qm.enqueue_tick) // aging if aging else 0
        return req.priority + bonus

    def _shed_victim(self, incoming: Request) -> Optional[Request]:
        """The least urgent queued request (the youngest on ties: it has
        waited least) if strictly less urgent than `incoming`, else
        None."""
        best, best_key = None, None
        for r in self.queue:
            qm = self._queued[r.rid]
            key = (self._eff_priority(r, qm), -qm.seq)
            if best is None or key < best_key:
                best, best_key = r, key
        if best is not None and best_key[0] < incoming.priority:
            return best
        return None

    def _shed(self, req: Request):
        self._dequeue(req)
        self._progress += 1
        if self.counters is not None:
            self.counters.on_shed(req.rid)
        self.on_finish(req, SHED_OUT)

    def _dequeue(self, req: Request):
        self.queue.remove(req)
        self._queued.pop(req.rid, None)

    def _next_seq(self) -> int:
        s = self._seq
        self._seq += 1
        return s

    def _expire_deadlines(self):
        """Evict every queued or in-flight request past its deadline
        (outcome "deadline").  An in-flight lane leaves through `_retire`
        (slot released, drafts dropped); like a cancelled one, it
        publishes none of its captured boundary states."""
        if not self._has_deadlines:
            return
        now = self._now()
        for slot, meta in list(self.slots.items()):
            if meta.deadline_t is not None and now >= meta.deadline_t:
                self._retire(slot, meta, outcome=DEADLINE)
        expired = [r for r in self.queue
                   if (qm := self._queued[r.rid]).deadline_t is not None
                   and now >= qm.deadline_t]
        for r in expired:
            self._dequeue(r)
            self._progress += 1
            if self.counters is not None:
                self.counters.on_deadline_evict(r.rid)
            self.on_finish(r, DEADLINE)

    # -- fault drills --------------------------------------------------------

    def _apply_faults(self):
        """Apply this tick's `ServingFaultInjector` faults (its docstring
        lists the kinds)."""
        for kind, payload in self.fault_injector.pop(self._tick_no):
            if kind == "cache_probe_error":
                self._fail_next_probe = True
            elif kind == "evict":
                self.evict(int(payload))
            elif kind == "evict_on_token":
                self._evict_on_token.add(int(payload))
            elif kind == "deadline":
                self._force_deadline(int(payload))
            elif kind == "crash_at_tick":
                # die at the top of the tick, before any of its work: every
                # committed snapshot is consistent with this crash point
                if payload == "sigkill":
                    os.kill(os.getpid(), signal.SIGKILL)
                raise EngineCrash(self._tick_no)
            elif kind == "torn_snapshot_write":
                if self.on_torn_snapshot is not None:
                    self.on_torn_snapshot(self._tick_no)
            elif kind == "corrupt_state_leaf":
                for slot, m in self.slots.items():
                    if m.req.rid == int(payload):
                        self.pool.poison_slot(slot)
                        break

    def _force_deadline(self, rid: int):
        """Expire `rid`'s deadline now (whether or not it had one): this
        tick's deadline sweep evicts it."""
        for meta in self.slots.values():
            if meta.req.rid == rid:
                meta.deadline_t = float("-inf")
                self._has_deadlines = True
                return
        qm = self._queued.get(rid)
        if qm is not None:
            qm.deadline_t = float("-inf")
            self._has_deadlines = True

    def _check_token_fault(self, rid: int):
        """The "evict_on_token" drill: evict `rid` from inside its own
        token emission.  Callers re-check slot membership right after."""
        if rid in self._evict_on_token:
            self._evict_on_token.discard(rid)
            self.evict(rid)

    # -- sentinel and quarantine --------------------------------------------

    def _sentinel_sweep(self):
        """Every `sentinel_every` ticks: one finiteness sweep over the
        pool (`SlotStatePool.lane_finite`); every occupied lane holding a
        NaN or Inf is quarantined.  Free lanes may hold stale values and
        are not judged."""
        if (not self.sentinel_every or not self.slots
                or self._tick_no % self.sentinel_every):
            return
        ok = self.pool.lane_finite()
        if ok is None:              # no floating leaf: nothing to judge
            return
        for slot in [s for s in self.slots if not ok[s]]:
            self._quarantine(slot, self.slots[slot])

    def _quarantine(self, slot: int, meta: _Slot):
        """Evict a poisoned lane and requeue its request for a clean
        replay: its staged cache inserts and drafts are dropped (a
        poisoned lane never publishes), the slot is released (the next
        admission resets it in-call), the engine resets the request's
        handle (`on_requeue`), and the request re-enters the queue past
        the admission bounds, with a fresh generator and deadline at its
        admission.  Decode is deterministic, so the replay streams what an
        unpoisoned run would have."""
        req = meta.req
        meta.pending_inserts.clear()
        meta.drafted.clear()
        self._spec_inflight.pop(req.rid, None)
        del self.slots[slot]
        self.pool.release(slot)
        self._progress += 1
        if self.counters is not None:
            self.counters.on_quarantine(req.rid)
        self.on_requeue(req)
        self._push(req)

    # -- phases ------------------------------------------------------------

    def _pop_next(self) -> Request:
        """Admission's choice: the highest effective priority (class +
        aging), then the longest cached prefix
        (`AdmissionPolicy.prefer_cache_hits`, a side-effect-free
        `PrefixCache.hit_length` peek over the enqueue-time digests), then
        FIFO.  With equal priorities and no cache hits this is FIFO."""
        if len(self.queue) == 1:
            return self.queue.popleft()
        peek = (self.prefix_cache is not None
                and self.slo.admission.prefer_cache_hits)
        best, best_key = None, None
        for r in self.queue:
            qm = self._queued[r.rid]
            hit = (self.prefix_cache.hit_length(
                self.cache_variant, r.prompt, qm.digests) if peek else 0)
            key = (self._eff_priority(r, qm), hit, -qm.seq)
            if best is None or key > best_key:
                best, best_key = r, key
        self.queue.remove(best)
        return best

    def _admit(self):
        while self.queue and self.pool.n_free:
            req = self._pop_next()
            qm = self._queued.pop(req.rid)
            slot = self.pool.acquire()
            meta = _Slot(req=req, rng=np.random.default_rng(req.seed),
                         seq=qm.seq, deadline_t=qm.deadline_t,
                         digests=qm.digests)
            self.slots[slot] = meta
            self._progress += 1
            if self.counters is not None:
                self.counters.on_admit(req.rid)
            if self.prefix_cache is not None:
                self._cache_probe(slot, meta)

    def _now(self) -> float:
        return self.counters.now() if self.counters is not None \
            else time.monotonic()

    def _cache_probe(self, slot: int, meta: _Slot):
        """Probe for the longest cached proper prefix of the prompt and,
        on a hit, write its state into the new lane (synchronized, so that
        the copy's time is the copy's).  The slot then starts mid-prefill
        with `fresh=False`, so the next prefill call advances the restored
        state.  Probe and copy times go to `on_cache_probe`, apart from
        the prefill time.

        Two faults degrade to a miss, counted in `cache_errors`, with no
        lease held: the injected `cache_probe_error` and the cache's own
        `CacheStorageError`.  The lane then prefills from scratch.  Any
        other exception, a CUDA error above all, raises out of `tick()`."""
        req = meta.req
        if meta.digests is None:
            meta.digests = self.prefix_cache.digests(req.prompt)
        t0 = self._now()
        try:
            if self._fail_next_probe:
                self._fail_next_probe = False
                raise CacheStorageError("injected cache-probe failure")
            lease = self.prefix_cache.probe(self.cache_variant, req.prompt,
                                            meta.digests)
        except CacheStorageError:
            if self.counters is not None:
                self.counters.on_cache_error()
                self.counters.on_cache_probe(req.rid, hit=False,
                                             probe_s=self._now() - t0)
            return
        t_probe = self._now() - t0
        if lease is None:
            if self.counters is not None:
                self.counters.on_cache_probe(req.rid, hit=False,
                                             probe_s=t_probe)
            return
        t0 = self._now()
        self.pool.write_slot(slot, lease.state)
        self.pool.sync()
        t_copy = self._now() - t0
        meta.fresh = False
        meta.n_prefilled = meta.cached_tokens = lease.n_tokens
        if self.counters is not None:
            self.counters.on_cache_probe(req.rid, hit=True,
                                         n_cached=lease.n_tokens,
                                         probe_s=t_probe, copy_s=t_copy)
        lease.release()

    def _cache_capture(self, slot: int, meta: _Slot):
        """After a prefill tick: a lane holding a chunk boundary that is
        not cached yet stages a copy of its state (`read_slot` clones),
        published when the request finishes."""
        n = meta.n_prefilled
        if n == 0 or n % self.prefill_chunk or n <= meta.cached_tokens:
            return
        if self.prefix_cache.contains(self.cache_variant, meta.req.prompt,
                                      n, meta.digests):
            return
        meta.pending_inserts.append((n, self.pool.read_slot(slot)))

    def _prefill_tick(self):
        prefilling = [(s, m) for s, m in self.slots.items()
                      if m.phase == PREFILL]
        if not prefilling:
            return
        S, C = self.pool.max_slots, self.prefill_chunk
        quota = self._prefill_quota
        if (quota is not None and quota < len(prefilling)
                and any(m.phase == DECODE for m in self.slots.values())):
            # the prefill budget: while lanes decode, only `quota`
            # prefilling lanes join this call — highest priority, then
            # earliest deadline, then admission order.  The (S, C) program
            # is the same (deferred lanes keep empty validity rows); with
            # no lane decoding there is no inter-token latency to protect
            prefilling.sort(key=lambda sm: (
                -sm[1].req.priority,
                sm[1].deadline_t if sm[1].deadline_t is not None
                else float("inf"),
                sm[1].seq))
            deferred = prefilling[quota:]
            prefilling = prefilling[:quota]
            if self.counters is not None and deferred:
                self.counters.on_budget_defer(sum(
                    min(len(m.req.prompt) - m.n_prefilled, C)
                    for _, m in deferred))
        toks = np.zeros((S, C), np.int32)
        valid = np.zeros((S, C), bool)
        fresh = np.zeros((S,), bool)
        parts = {}
        for slot, meta in prefilling:
            part = meta.req.prompt[meta.n_prefilled:meta.n_prefilled + C]
            toks[slot, :len(part)] = part
            valid[slot, :len(part)] = True
            fresh[slot] = meta.fresh
            parts[slot] = len(part)
        self.pool.state, last_logits = self.prefill_fn(
            self.pool.state, toks, valid, fresh)
        finishing = []
        for slot, meta in prefilling:
            meta.fresh = False
            meta.n_prefilled += parts[slot]
            self._progress += parts[slot]
            if self.counters is not None:
                self.counters.on_prefill(meta.req.rid, parts[slot])
            if self.prefix_cache is not None:
                self._cache_capture(slot, meta)
            if meta.n_prefilled == len(meta.req.prompt):
                # the last prompt token's logits give the first generated
                # token; the slot joins the decode batch from now on
                meta.phase = DECODE
                finishing.append((slot, meta))
        if finishing:
            rows = _last_rows(last_logits)
            self._emit([(s, m, rows[s]) for s, m in finishing])

    def _decode_tick(self):
        active = [(s, m) for s, m in self.slots.items()
                  if m.phase == DECODE]
        if not active:
            return
        S = self.pool.max_slots
        toks = np.zeros((S, 1), np.int32)
        mask = np.zeros((S,), bool)
        for slot, meta in active:
            toks[slot, 0] = meta.next_token
            mask[slot] = True
        logits, self.pool.state = self.decode_fn(self.pool.state, toks, mask)
        rows = _last_rows(logits)
        self._emit([(s, m, rows[s]) for s, m in active])

    def _spec_tick(self):
        """The speculative decode tick: draft -> verify -> accept.

        One drafter call proposes k-1 tokens a lane, one verify call
        scores each lane's pending token and drafts and commits state
        through the whole window, and the host accepts the longest prefix
        the verifier agrees with, sampling every emitted token from
        verifier logits.  Live lanes that consumed fewer than k tokens
        roll back to the pre-verify snapshot and re-advance by their
        accepted prefix through the same verify program.  With every
        draft rejected a lane still emits one token a tick."""
        active = [(s, m) for s, m in self.slots.items()
                  if m.phase == DECODE]
        if not active:
            return
        S, K = self.pool.max_slots, self.spec_k
        toks = np.zeros((S, 1), np.int32)
        for slot, meta in active:
            toks[slot, 0] = meta.next_token
        # the pre-verify pool state is the rollback snapshot: neither the
        # drafter nor the verifier writes into its input state
        snapshot = self.pool.state
        window = np.zeros((S, K), np.int32)
        window[:, 0] = toks[:, 0]
        if K > 1:
            window[:, 1:] = _host(self.draft_fn(snapshot, toks))
        valid = np.zeros((S, K), bool)
        for slot, meta in active:
            valid[slot] = True
            meta.drafted = [int(t) for t in window[slot, 1:]]
        self._spec_snapshot = snapshot
        self._spec_inflight = {m.req.rid: m for _, m in active}
        try:
            logits, committed = self.verify_fn(snapshot, window, valid)
            rows = _host(logits)                          # (S, K, V) f32
            consumed = self._spec_emit(active, rows, window)
            # live lanes that consumed < K tokens: back to the snapshot,
            # then forward by the accepted prefix only (retired or evicted
            # lanes stay as committed: a reacquired lane is reset in-call)
            reject = np.zeros((S,), bool)
            readvance = np.zeros((S, K), bool)
            for slot, meta in active:
                if slot not in self.slots or self.slots[slot] is not meta:
                    continue
                n = consumed.get(slot, 0)
                if n < K:
                    reject[slot] = True
                    readvance[slot, :n] = True
            if reject.any():
                rolled = self.rollback_fn(committed, snapshot, reject)
                _, self.pool.state = self.verify_fn(rolled, window,
                                                    readvance)
            else:
                self.pool.state = committed
        finally:
            self._spec_snapshot = None
            self._spec_inflight = {}

    def _spec_emit(self, active, rows, window) -> dict[int, int]:
        """Each lane's acceptance walk over one verify window (the
        `greedy_accept` rule with sampling and retirement).  Returns
        {slot: window tokens consumed} for every lane that emitted.  Each
        token is sampled from the slot's own generator, one draw per
        emitted token, so a seeded stream does not depend on how many
        drafts were rejected.  `on_token` may evict lanes mid-tick: the
        membership checks keep a dead lane's drafts from emitting."""
        K = self.spec_k
        consumed: dict[int, int] = {}
        for slot, meta in active:
            if slot not in self.slots or self.slots[slot] is not meta:
                continue    # evicted by an earlier lane's callback
            req, j = meta.req, 0
            while True:
                tok = sample_token(rows[slot, j], req.temperature,
                                   meta.rng)
                consumed[slot] = j + 1
                meta.generated.append(tok)
                meta.next_token = tok
                self._progress += 1
                if self.counters is not None:
                    self.counters.on_token(
                        req.rid, first=len(meta.generated) == 1)
                self.on_token(req, tok)
                self._check_token_fault(req.rid)
                if slot not in self.slots or self.slots[slot] is not meta:
                    break   # evicted by its own token callback or a fault
                if (len(meta.generated) >= req.max_new_tokens or
                        (req.eos_token is not None and
                         tok == req.eos_token)):
                    self._retire(slot, meta)
                    break
                if j + 1 < K and tok == int(window[slot, j + 1]):
                    j += 1  # the verifier confirmed the next draft
                    continue
                break
            meta.drafted = []
            if self.counters is not None and K > 1:
                self.counters.on_speculate(req.rid, drafted=K - 1,
                                           accepted=consumed[slot] - 1)
        return consumed

    def _emit(self, emitting: list):
        """Sample and book-keep one tick's emitting slots."""
        toks = sample_tokens(
            np.stack([row for _, _, row in emitting]),
            [meta for _, meta, _ in emitting])
        for (slot, meta, _), tok in zip(emitting, toks):
            req, tok = meta.req, int(tok)
            meta.generated.append(tok)
            meta.next_token = tok
            self._progress += 1
            if self.counters is not None:
                self.counters.on_token(req.rid,
                                       first=len(meta.generated) == 1)
            self.on_token(req, tok)
            self._check_token_fault(req.rid)
            if slot not in self.slots or self.slots[slot] is not meta:
                continue    # evicted by its token callback or a fault
            if (len(meta.generated) >= req.max_new_tokens or
                    (req.eos_token is not None and tok == req.eos_token)):
                self._retire(slot, meta)

    def _retire(self, slot: int, meta: _Slot, *, outcome: str = FINISHED):
        """Release `slot` and report `meta.req` with `outcome` ("finished",
        "cancelled" or "deadline"; a queued request leaves as "shed" or
        "cancelled" without reaching here).  Only a finished request
        publishes its captured boundary states (write-once: the cache
        keeps the first state of a key); an insert that fails with the
        cache's `CacheStorageError` is counted and dropped, any other
        error raises.  Drafts and the in-flight marker go with the lane."""
        if outcome == FINISHED and self.prefix_cache is not None:
            for n, state in meta.pending_inserts:
                try:
                    self.prefix_cache.insert(self.cache_variant,
                                             meta.req.prompt, n, state,
                                             meta.digests)
                except CacheStorageError:
                    if self.counters is not None:
                        self.counters.on_cache_error()
        meta.pending_inserts.clear()
        meta.drafted.clear()
        self._spec_inflight.pop(meta.req.rid, None)
        del self.slots[slot]
        self.pool.release(slot)
        self._progress += 1
        if self.counters is not None:
            if outcome == CANCELLED:
                self.counters.on_cancel(meta.req.rid)
            elif outcome == DEADLINE:
                self.counters.on_deadline_evict(meta.req.rid)
            else:
                self.counters.on_finish(meta.req.rid)
        self.on_finish(meta.req, outcome)
