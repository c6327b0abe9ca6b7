"""Host-side runtime monitors (port of `repro/runtime/monitor.py`).

  ServingCounters   — the serving engine's telemetry: tokens/s, TTFT with
                      its prefill decomposition, inter-token latency,
                      per-request latency, p50/p90/p99 in `snapshot()`,
                      cancellations, slot occupancy, the prefix cache's
                      hits, copies and tiers, speculative decode's
                      acceptance, the SLO layer's outcomes (shed,
                      deadline, backpressure, budget deferrals), cache
                      errors, snapshots, restores and quarantines.  The
                      hook of path demotion, which the port never makes,
                      exists with its fields and keys, and nothing calls
                      it.
  EngineCrash, ServingFaultInjector
                    — the serving fault drills: a tick-indexed schedule
                      of faults the scheduler applies at the top of a
                      tick (`repro_torch.serving.scheduler`).
  StragglerDetector — per-host step-duration EMA; flags hosts slower than
                      `threshold` x the fleet median.
  HeartbeatMonitor  — per-host last-seen tracking with a dead-host
                      predicate, on an injectable clock.
  FailureInjector, HostFailure
                    — the training drill's deterministic fault schedule:
                      `check(step)` raises `HostFailure` at a scheduled
                      step, once.
  TrainingSupervisor— retry-with-restore loop around a step function:
                      on a `HostFailure` it restores (the caller's
                      `restore_fn`, e.g. the latest checkpoint) and
                      resumes, giving up after `max_restarts`
                      (`examples/train_rwkv4_torch.py --drill`).

JAX's `DegradedMode` event stays out: the port makes no path demotion.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Any, Callable


def percentile(xs: list, q: float) -> float:
    """Nearest-rank percentile (q in [0, 1]) — 0.0 on an empty sample.

    Nearest-rank (not interpolated) so a p99 over latency samples is an
    actually-observed latency, never an average of two."""
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))]


class ServingCounters:
    """Serving-engine telemetry. The engine calls the on_* hooks; callers
    read `snapshot()` — a plain dict safe to log/export.  Timestamps use an
    injectable clock so tests are deterministic."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self.t_start = clock()
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.ticks = 0
        self.admitted = 0
        self.finished = 0
        self.cancelled = 0
        self.peak_active = 0
        self.peak_queued = 0
        self._enqueue_t: dict[int, float] = {}
        self._admit_t: dict[int, float] = {}
        self._prefill_ticks: dict[int, int] = {}
        self.ttft_s: list[float] = []      # enqueue -> first token
        self.latency_s: list[float] = []   # enqueue -> completion
        # time-to-first-token decomposition: how many prefill calls each
        # request's prompt took, and the admit -> first-token wall time
        # (the part of TTFT the prefill path controls — queueing excluded).
        # prefill_s EXCLUDES the prefix-cache probe and state-copy time,
        # which land in their own lists below: attributing the whole admit
        # tick to "prefill" would make a cache hit look like prefill work.
        self.prefill_ticks: list[int] = []
        self.prefill_s: list[float] = []
        # prefix-cache telemetry (serving/prefix_cache.py): probe
        # outcomes + token accounting from the scheduler, eviction/spill
        # flow from the cache itself
        self.cache_hits = 0
        self.cache_misses = 0
        self.cache_inserts = 0
        self.cache_evictions = 0
        self.cache_spills = 0
        self.cached_tokens = 0          # prompt tokens restored, not run
        self.cache_probe_s: list[float] = []
        self.state_copy_s: list[float] = []
        self._admit_overhead: dict[int, float] = {}  # rid -> probe+copy s
        # self-speculative decode telemetry (the scheduler's speculative
        # tick): drafted counts every token the drafter proposed,
        # accepted the ones the verifier confirmed AND the lane consumed,
        # rejected the rest — acceptance_rate = accepted / drafted is the
        # one number that says whether a (K, draft_depth) choice pays
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        self.rejected_tokens = 0
        self.spec_ticks = 0             # per-lane window walks, not ticks
        # SLO-layer telemetry (serving/slo.py): per-token inter-token
        # latency samples (gap between a lane's consecutive emitted
        # tokens — THE user-visible jitter the prefill budget bounds),
        # explicit-overload outcome counters, and robustness counters.
        self.itl_s: list[float] = []
        self._last_token_t: dict[int, float] = {}
        self.shed = 0
        self.deadline_evicted = 0
        self.backpressured = 0
        self.cache_errors = 0
        self.budget_deferred_tokens = 0
        # crash-safety telemetry (serving/snapshot.py): snapshot writes
        # and their synchronous capture wall time, restores and the lanes
        # they resumed, sentinel quarantines, integrity-checksum failures,
        # and fused-path demotions, which the port never makes (a failing
        # kernel raises), so path_fallbacks stays 0
        self.snapshots_written = 0
        self.snapshot_wall_s: list[float] = []
        self.restores = 0
        self.resumed_lanes = 0
        self.quarantined_lanes = 0
        self.checksum_failures = 0
        self.path_fallbacks = 0
        self.degraded_events: list[dict] = []
        # occupancy accumulators: mean active lanes / queue depth per tick
        # give the bench its latency-vs-occupancy axis
        self._active_sum = 0
        self._queued_sum = 0

    def now(self) -> float:
        """The counters' clock (injectable) — the scheduler times its
        cache probe/copy slices on the same clock the latency samples
        use, so the decomposition is exact under a fake clock."""
        return self._clock()

    # -- hooks (called by the engine/scheduler) ----------------------------
    def on_enqueue(self, rid: int):
        self._enqueue_t[rid] = self._clock()

    def on_admit(self, rid: int):
        self.admitted += 1
        self._admit_t[rid] = self._clock()

    def on_prefill(self, rid: int, n_tokens: int):
        """One prefill call absorbed `n_tokens` of request `rid`'s prompt."""
        self.prefill_tokens += n_tokens
        self._prefill_ticks[rid] = self._prefill_ticks.get(rid, 0) + 1

    def on_cache_probe(self, rid: int, *, hit: bool, n_cached: int = 0,
                       probe_s: float = 0.0, copy_s: float = 0.0):
        """One prefix-cache probe at request `rid`'s admission: outcome,
        tokens restored from the hit state (0 on miss), and the wall time
        of the probe and of the state copy into the slot.  Probe+copy are
        subtracted from the request's `prefill_s` sample — they are cache
        time, not prefill time."""
        if hit:
            self.cache_hits += 1
            self.cached_tokens += n_cached
        else:
            self.cache_misses += 1
        self.cache_probe_s.append(probe_s)
        if hit:
            self.state_copy_s.append(copy_s)
        self._admit_overhead[rid] = \
            self._admit_overhead.get(rid, 0.0) + probe_s + copy_s

    def on_cache_insert(self):
        self.cache_inserts += 1

    def on_cache_evict(self):
        self.cache_evictions += 1

    def on_cache_spill(self):
        self.cache_spills += 1

    def on_speculate(self, rid: int, *, drafted: int, accepted: int):
        """One lane finished one speculative window walk: the drafter
        proposed `drafted` tokens, the verifier confirmed `accepted` of
        them (0 <= accepted <= drafted; the window's base token is not a
        draft and is not counted).  Emitted-token accounting stays with
        `on_token` — speculation changes how many decode tokens a tick
        produces, not what a token is."""
        del rid
        self.spec_ticks += 1
        self.drafted_tokens += drafted
        self.accepted_tokens += accepted
        self.rejected_tokens += drafted - accepted

    def on_token(self, rid: int, *, first: bool = False):
        self.decode_tokens += 1
        now = self._clock()
        if first:
            if rid in self._enqueue_t:
                self.ttft_s.append(now - self._enqueue_t[rid])
            t_admit = self._admit_t.pop(rid, None)
            if t_admit is not None:
                self.prefill_s.append(now - t_admit -
                                      self._admit_overhead.pop(rid, 0.0))
            self.prefill_ticks.append(self._prefill_ticks.pop(rid, 0))
        else:
            t_prev = self._last_token_t.get(rid)
            if t_prev is not None:
                self.itl_s.append(now - t_prev)
        self._last_token_t[rid] = now

    def on_finish(self, rid: int):
        self.finished += 1
        t0 = self._enqueue_t.pop(rid, None)
        if t0 is not None:
            self.latency_s.append(self._clock() - t0)
        self._last_token_t.pop(rid, None)

    def _drop(self, rid: int):
        """Forget a request that will never complete (cancel/shed/
        deadline): no latency sample, no stale per-rid state."""
        self._enqueue_t.pop(rid, None)
        self._admit_t.pop(rid, None)
        self._prefill_ticks.pop(rid, None)
        self._admit_overhead.pop(rid, None)
        self._last_token_t.pop(rid, None)

    def on_cancel(self, rid: int):
        """Evicted before completion: not a completion, no latency sample."""
        self.cancelled += 1
        self._drop(rid)

    def on_shed(self, rid: int):
        """Dropped from the queue by the shed overload policy."""
        self.shed += 1
        self._drop(rid)

    def on_deadline_evict(self, rid: int):
        """Deadline exceeded (queued or in-flight): evicted, not finished."""
        self.deadline_evicted += 1
        self._drop(rid)

    def on_backpressure(self):
        """An `enqueue` was refused with `Overloaded` (queue full)."""
        self.backpressured += 1

    def on_cache_error(self):
        """A prefix-cache probe or insert failed and degraded to a miss.
        The port degrades exactly two kinds: the injected
        `cache_probe_error` drill and the cache's own typed
        `CacheStorageError` (an entry whose stored state does not match
        what was inserted).  Any other exception, a CUDA error above all,
        raises out of `Scheduler.tick()` and is never counted here."""
        self.cache_errors += 1

    def on_budget_defer(self, n_tokens: int):
        """The prefill budget deferred `n_tokens` of ready prompt chunks
        to a later tick (lanes left out of this tick's prefill call)."""
        self.budget_deferred_tokens += n_tokens

    def on_snapshot(self, wall_s: float):
        """One engine snapshot committed to the store; `wall_s` is the
        SYNCHRONOUS capture time (host copies + checksum verify — the part
        decode actually waits on; the file write is async)."""
        self.snapshots_written += 1
        self.snapshot_wall_s.append(wall_s)

    def on_restore(self, *, resumed_lanes: int):
        """The engine was rebuilt from a snapshot, resuming
        `resumed_lanes` in-flight/queued requests."""
        self.restores += 1
        self.resumed_lanes += resumed_lanes

    def on_quarantine(self, rid: int):
        """A NaN/Inf state sentinel quarantined `rid`'s lane; the request
        is re-enqueued for a deterministic replay (its per-rid latency
        anchors reset with it — the requeue re-arms them)."""
        self.quarantined_lanes += 1
        self._drop(rid)

    def on_checksum_failure(self, n: int = 1):
        """Integrity sentinels found `n` corrupt weight planes."""
        self.checksum_failures += n

    def on_path_fallback(self, event):
        """JAX's hook for a fused path demoted to its per-op twin, kept
        so the telemetry's fields match; the port never demotes a path
        (a failing kernel raises), so nothing calls it."""
        self.path_fallbacks += 1
        self.degraded_events.append(dataclasses.asdict(event)
                                    if dataclasses.is_dataclass(event)
                                    else dict(event))

    def on_tick(self, *, active: int, queued: int):
        self.ticks += 1
        self.peak_active = max(self.peak_active, active)
        self.peak_queued = max(self.peak_queued, queued)
        self._active_sum += active
        self._queued_sum += queued

    # -- export ------------------------------------------------------------
    def snapshot(self) -> dict:
        dt = max(self._clock() - self.t_start, 1e-9)
        mean = lambda xs: sum(xs) / len(xs) if xs else 0.0
        return {
            "elapsed_s": dt,
            "ticks": self.ticks,
            "admitted": self.admitted,
            "finished": self.finished,
            "cancelled": self.cancelled,
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "decode_tokens_per_s": self.decode_tokens / dt,
            "total_tokens_per_s":
                (self.prefill_tokens + self.decode_tokens) / dt,
            "mean_ttft_s": mean(self.ttft_s),
            "ttft_p50_s": percentile(self.ttft_s, 0.50),
            "ttft_p90_s": percentile(self.ttft_s, 0.90),
            "ttft_p99_s": percentile(self.ttft_s, 0.99),
            "mean_itl_s": mean(self.itl_s),
            "itl_p50_s": percentile(self.itl_s, 0.50),
            "itl_p90_s": percentile(self.itl_s, 0.90),
            "itl_p99_s": percentile(self.itl_s, 0.99),
            "mean_latency_s": mean(self.latency_s),
            "latency_p99_s": percentile(self.latency_s, 0.99),
            "shed": self.shed,
            "deadline_evicted": self.deadline_evicted,
            "backpressured": self.backpressured,
            "cache_errors": self.cache_errors,
            "budget_deferred_tokens": self.budget_deferred_tokens,
            "mean_active_slots": self._active_sum / self.ticks
                if self.ticks else 0.0,
            "mean_queue_depth": self._queued_sum / self.ticks
                if self.ticks else 0.0,
            "mean_prefill_ticks": mean(self.prefill_ticks),
            "mean_prefill_s": mean(self.prefill_s),
            "peak_active_slots": self.peak_active,
            "peak_queue_depth": self.peak_queued,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "cache_hit_rate": self.cache_hits /
                (self.cache_hits + self.cache_misses)
                if self.cache_hits + self.cache_misses else 0.0,
            "cache_inserts": self.cache_inserts,
            "cache_evictions": self.cache_evictions,
            "cache_spills": self.cache_spills,
            "cached_tokens": self.cached_tokens,
            "mean_cache_probe_s": mean(self.cache_probe_s),
            "mean_state_copy_s": mean(self.state_copy_s),
            "spec_ticks": self.spec_ticks,
            "drafted_tokens": self.drafted_tokens,
            "accepted_tokens": self.accepted_tokens,
            "rejected_tokens": self.rejected_tokens,
            "acceptance_rate": self.accepted_tokens / self.drafted_tokens
                if self.drafted_tokens else 0.0,
            "snapshots_written": self.snapshots_written,
            "snapshot_wall_s": mean(self.snapshot_wall_s),
            "restores": self.restores,
            "resumed_lanes": self.resumed_lanes,
            "quarantined_lanes": self.quarantined_lanes,
            "checksum_failures": self.checksum_failures,
            "path_fallbacks": self.path_fallbacks,
        }

    # -- snapshot/restore (serving/snapshot.py) ----------------------------

    _COUNTER_FIELDS = (
        "prefill_tokens", "decode_tokens", "ticks", "admitted", "finished",
        "cancelled", "peak_active", "peak_queued", "cache_hits",
        "cache_misses", "cache_inserts", "cache_evictions", "cache_spills",
        "cached_tokens", "drafted_tokens", "accepted_tokens",
        "rejected_tokens", "spec_ticks", "shed", "deadline_evicted",
        "backpressured", "cache_errors", "budget_deferred_tokens",
        "snapshots_written", "restores", "resumed_lanes",
        "quarantined_lanes", "checksum_failures", "path_fallbacks",
        "_active_sum", "_queued_sum")
    _LIST_FIELDS = (
        "ttft_s", "latency_s", "prefill_ticks", "prefill_s",
        "cache_probe_s", "state_copy_s", "itl_s", "snapshot_wall_s",
        "degraded_events")
    _TIME_DICT_FIELDS = (    # rid -> absolute clock time, rebased on load
        "_enqueue_t", "_admit_t", "_last_token_t")

    def state_dict(self) -> dict:
        """Everything `load_state` needs to continue this telemetry in a
        NEW process: plain JSON.  Absolute clock anchors (the per-rid
        enqueue/admit/last-token times and the run start) are stored as
        seconds-before-capture, so a restore on a different monotonic
        clock keeps elapsed/latency math consistent."""
        now = self._clock()
        out = {f: getattr(self, f) for f in self._COUNTER_FIELDS}
        out.update({f: list(getattr(self, f)) for f in self._LIST_FIELDS})
        out["elapsed_s"] = now - self.t_start
        for f in self._TIME_DICT_FIELDS:
            out[f] = {str(rid): now - t
                      for rid, t in getattr(self, f).items()}
        out["_prefill_ticks"] = {str(r): n
                                 for r, n in self._prefill_ticks.items()}
        out["_admit_overhead"] = {str(r): v
                                  for r, v in self._admit_overhead.items()}
        return out

    def load_state(self, state: dict):
        """Install a `state_dict` capture, rebasing clock anchors onto
        this counters object's own clock."""
        now = self._clock()
        for f in self._COUNTER_FIELDS:
            setattr(self, f, state[f])
        for f in self._LIST_FIELDS:
            setattr(self, f, list(state[f]))
        self.t_start = now - state["elapsed_s"]
        for f in self._TIME_DICT_FIELDS:
            setattr(self, f, {int(r): now - ago
                              for r, ago in state[f].items()})
        self._prefill_ticks = {int(r): n
                               for r, n in state["_prefill_ticks"].items()}
        self._admit_overhead = {int(r): v
                                for r, v in state["_admit_overhead"].items()}


class EngineCrash(RuntimeError):
    """The injected in-process serving crash (`crash_at_tick`): raised at
    the top of the scheduled tick, before any of its work — the crash
    point every committed snapshot must be consistent with."""

    def __init__(self, tick: int):
        super().__init__(f"injected engine crash at tick {tick}")
        self.tick = tick


@dataclasses.dataclass
class ServingFaultInjector:
    """Tick-indexed fault schedule for the serving scheduler, which drains
    `pop(tick)` at the top of each tick and applies the faults:

      ("cache_probe_error", None) — the next prefix-cache probe fails; the
          scheduler degrades it to a counted miss and holds no lease.
      ("evict", rid)              — evict `rid` at the top of the tick
          (queued or in flight): mid-prefill cancellation.
      ("evict_on_token", rid)     — evict `rid` from inside its next token
          emission, i.e. mid-tick or mid-speculation.
      ("deadline", rid)           — expire `rid`'s deadline now, whether
          or not it had one.
      ("crash_at_tick", None|"raise"|"sigkill") — kill the engine at the
          top of the tick: raise `EngineCrash` (default), or SIGKILL the
          process ("sigkill": nothing gets to flush).
      ("torn_snapshot_write", None) — leave what a crash mid-save leaves:
          a partial `.tmp-step_X` without its COMMIT marker, which restore
          must skip.
      ("corrupt_state_leaf", rid) — fill `rid`'s lane state with NaN; the
          sentinel sweep must quarantine and requeue it.

    `fired` records (tick, kind, payload) of every fault delivered."""

    schedule: dict[int, list[tuple[str, Any]]] = \
        dataclasses.field(default_factory=dict)
    enabled: bool = True
    fired: list[tuple[int, str, Any]] = \
        dataclasses.field(default_factory=list)

    KINDS = ("cache_probe_error", "evict", "evict_on_token", "deadline",
             "crash_at_tick", "torn_snapshot_write", "corrupt_state_leaf")

    def pop(self, tick: int) -> list[tuple[str, Any]]:
        if not self.enabled:
            return []
        faults = self.schedule.pop(tick, [])
        for kind, _ in faults:
            if kind not in self.KINDS:
                raise ValueError(f"unknown serving fault kind {kind!r}")
        self.fired.extend((tick, k, p) for k, p in faults)
        return list(faults)


class StragglerDetector:
    """EMA of per-host step durations; flags hosts above threshold x
    median (after warmup_steps records, and only with 3 hosts or more)."""

    def __init__(self, hosts: list[int], *, alpha: float = 0.2,
                 threshold: float = 1.5, warmup_steps: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup_steps = warmup_steps
        self._ema = {h: None for h in hosts}
        self._n = collections.Counter()

    def record(self, host: int, duration_s: float):
        prev = self._ema[host]
        self._ema[host] = (duration_s if prev is None
                           else self.alpha * duration_s +
                           (1 - self.alpha) * prev)
        self._n[host] += 1

    def stragglers(self) -> list[int]:
        vals = [(h, e) for h, e in self._ema.items()
                if e is not None and self._n[h] >= self.warmup_steps]
        if len(vals) < 3:
            return []
        ordered = sorted(e for _, e in vals)
        median = ordered[len(ordered) // 2]
        return [h for h, e in vals if e > self.threshold * median]


class HeartbeatMonitor:
    """Per-host last-seen times; a host is dead once `timeout_s` passes
    without a beat."""

    def __init__(self, hosts: list[int], timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        self._last = {h: clock() for h in hosts}

    def beat(self, host: int, at: float | None = None):
        self._last[host] = self._clock() if at is None else at

    def dead_hosts(self) -> list[int]:
        now = self._clock()
        return [h for h, t in self._last.items()
                if now - t > self.timeout_s]

    def alive_hosts(self) -> list[int]:
        dead = set(self.dead_hosts())
        return [h for h in self._last if h not in dead]


@dataclasses.dataclass
class FailureInjector:
    """step -> host failures, for drills. `check(step)` raises HostFailure
    at a scheduled step and drops it from the schedule."""

    schedule: dict[int, list[int]] = dataclasses.field(default_factory=dict)
    enabled: bool = True

    def check(self, step: int):
        if self.enabled and step in self.schedule:
            hosts = self.schedule.pop(step)
            raise HostFailure(step=step, hosts=hosts)


class HostFailure(RuntimeError):
    def __init__(self, step: int, hosts: list[int]):
        super().__init__(f"hosts {hosts} failed at step {step}")
        self.step = step
        self.hosts = hosts


class TrainingSupervisor:
    """Retry-with-restore loop.

    run(n_steps) calls `step_fn(step)`; on HostFailure it invokes
    `restore_fn(failed_hosts)` (which reloads the latest checkpoint) and
    resumes from the step the restore reports.  Gives up after
    `max_restarts`, re-raising the failure.
    """

    def __init__(self, step_fn: Callable[[int], None],
                 restore_fn: Callable[[list[int]], int],
                 max_restarts: int = 3):
        self.step_fn = step_fn
        self.restore_fn = restore_fn
        self.max_restarts = max_restarts
        self.restarts = 0
        self.log: list[str] = []

    def run(self, n_steps: int, start_step: int = 0) -> int:
        step = start_step
        while step < n_steps:
            try:
                self.step_fn(step)
                step += 1
            except HostFailure as f:
                self.restarts += 1
                self.log.append(f"failure at step {f.step}: hosts {f.hosts}")
                if self.restarts > self.max_restarts:
                    raise
                step = self.restore_fn(f.hosts)
                self.log.append(f"restored, resuming at step {step}")
        return step
