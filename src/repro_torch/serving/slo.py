"""SLO layer for the serving engine (port of `repro/serving/slo.py`):
priorities, deadlines, a per-tick prefill budget and graceful overload.

This module is the configuration surface and the typed signals; the
mechanisms live in `repro_torch.serving.scheduler`:

  * PRIORITY CLASSES + DEADLINES — `Request.priority` (higher = more
    urgent) orders admission; `Request.deadline_s` (seconds from enqueue,
    or `ServingSLO.default_deadline_s`) bounds a request's life: a
    request past its deadline is evicted (slot released, drafts and
    staged cache inserts dropped) with outcome "deadline".
  * AGING — a queued request's effective priority rises one level every
    `aging_ticks` ticks, so a stream of urgent traffic can delay the
    background class but never starve it.
  * CACHE-AWARE ADMISSION — with `prefer_cache_hits` and a prefix cache,
    priority ties go to the request with the longest cached prefix (a
    side-effect-free `PrefixCache.hit_length` peek).
  * PER-TICK PREFILL BUDGET — `prefill_budget` bounds the prompt tokens
    prefilled per tick while any lane decodes.  It becomes a lane quota
    (`ExecutionPlan.prefill_quota`: whole chunks, a floor of one lane), so
    the (slots, chunk) prefill program never changes shape: the budget
    chooses which lanes' validity rows are filled, nothing else.
  * BOUNDED QUEUE + EXPLICIT OVERLOAD — `max_queue` bounds the queue.  When
    it is full, `overload="backpressure"` makes `submit` raise a typed
    `Overloaded` with retry hints, and `overload="shed"` drops the least
    urgent queued request (outcome "shed") to admit a strictly more urgent
    arrival.  Every submitted request ends finished, cancelled, shed,
    deadline, or as a raised `Overloaded`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

BACKPRESSURE, SHED = "backpressure", "shed"


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """How the scheduler picks from, and bounds, the admission queue.

    max_queue         — queued-request cap; 0 = unbounded.  With a full
                        queue, `overload` decides.
    overload          — "backpressure": `enqueue` raises `Overloaded`;
                        "shed": drop the least urgent queued request IF it
                        is strictly less urgent than the arrival (else the
                        arrival is backpressured: equal classes are FIFO)
    prefer_cache_hits — break priority ties toward the longest cached
                        prefix (a no-op without a prefix cache)
    aging_ticks       — every `aging_ticks` ticks queued raise a request's
                        effective priority by one (0 disables aging)
    """
    max_queue: int = 0
    overload: str = BACKPRESSURE
    prefer_cache_hits: bool = True
    aging_ticks: int = 32

    def __post_init__(self):
        if self.overload not in (BACKPRESSURE, SHED):
            raise ValueError(
                f"overload={self.overload!r}: expected "
                f"{BACKPRESSURE!r} or {SHED!r}")
        if self.max_queue < 0 or self.aging_ticks < 0:
            raise ValueError("max_queue and aging_ticks must be >= 0")


@dataclasses.dataclass(frozen=True)
class ServingSLO:
    """The engine's and scheduler's SLO configuration.

    prefill_budget     — prompt tokens prefilled per tick while any lane
                         decodes (0 = unlimited); whole chunks with a
                         floor of one lane, so prefill always progresses
    default_deadline_s — deadline (seconds from enqueue) of requests that
                         set none (None = no deadline)
    admission          — the AdmissionPolicy
    max_idle_ticks     — `Scheduler.run`'s watchdog: this many ticks in a
                         row with work left and no progress (no admission,
                         prefill token, emitted token or retirement) raise
                         `SchedulerHang` (0 disables it)
    """
    prefill_budget: int = 0
    default_deadline_s: Optional[float] = None
    admission: AdmissionPolicy = dataclasses.field(
        default_factory=AdmissionPolicy)
    max_idle_ticks: int = 10_000

    def __post_init__(self):
        if self.prefill_budget < 0 or self.max_idle_ticks < 0:
            raise ValueError(
                "prefill_budget and max_idle_ticks must be >= 0")
        if (self.default_deadline_s is not None
                and self.default_deadline_s <= 0):
            raise ValueError("default_deadline_s must be positive")


class Overloaded(RuntimeError):
    """Typed backpressure: the admission queue is full and the request was
    NOT accepted.  `queue_depth` / `max_queue` say how full, and
    `retry_after_s` estimates when a slot-width of queued work will have
    drained (0.0 before any request has finished)."""

    def __init__(self, *, queue_depth: int, max_queue: int,
                 retry_after_s: float = 0.0):
        super().__init__(
            f"admission queue full ({queue_depth}/{max_queue}); "
            f"retry after ~{retry_after_s:.3f}s")
        self.queue_depth = queue_depth
        self.max_queue = max_queue
        self.retry_after_s = retry_after_s


class SchedulerHang(RuntimeError):
    """`Scheduler.run`'s watchdog: work remains but no tick has made
    progress for `max_idle_ticks` (a wedged lane or a leaked slot).  It
    carries the scheduler's state, so the exception alone says what hung."""

    def __init__(self, *, idle_ticks: int, queued: int, active: int,
                 n_free: int, phases: dict):
        super().__init__(
            f"scheduler made no progress for {idle_ticks} ticks: "
            f"{queued} queued, {active} active slots ({phases}), "
            f"{n_free} free pool slots — wedged lane or leaked slot?")
        self.idle_ticks = idle_ticks
        self.queued = queued
        self.active = active
        self.n_free = n_free
        self.phases = dict(phases)
