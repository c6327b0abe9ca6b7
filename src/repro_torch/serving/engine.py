"""Serving engine front end: submit(prompt) -> token stream (port of
`repro/serving/engine.py`).

Wires the slotted state pool and the scheduler to an `ExecutionPlan`,
which owns path selection, weight preparation and the programs (decode
step, prefill chunk, and the drafter, verifier and rollback under
self-speculative decode).  The engine builds the prefix cache, when asked
for one, and owns request lifecycle: handles, streaming, cancellation,
the scheduler callbacks and the `ServingCounters` telemetry `run()`
returns.  Around it sit the SLO layer (`slo=`: priorities, deadlines, a
bounded queue, the prefill budget), the fault drills (`fault_injector=`),
the NaN/Inf sentinel (`sentinel_every=`) and crash safety (`snapshot=`
and `ServingEngine.restore`, `repro_torch.serving.snapshot`).
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
from typing import Any, Iterator, Optional

from repro_torch.core.quant.policy import PlanePolicy
from repro_torch.models.registry import Model
from repro_torch.runtime.monitor import ServingCounters
from repro_torch.serving.plan import STATE_DTYPE, ExecutionPlan, build_plan
from repro_torch.serving.prefix_cache import PrefixCache, PrefixCacheConfig
from repro_torch.serving.scheduler import FINISHED, Request, Scheduler
from repro_torch.serving.slo import ServingSLO
from repro_torch.serving.state_pool import SlotStatePool


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    max_new_tokens: int = 16
    temperature: float = 0.0
    seed: int = 0
    eos_token: Optional[int] = None


class RequestHandle:
    """Live view of one submitted request; tokens stream in as generated.

    `outcome` is None while in flight and then one of "finished",
    "cancelled", "shed" (dropped by the overload policy: resubmit) or
    "deadline" (evicted past its deadline).  A handle that
    `ServingEngine.restore` registers carries the tokens generated before
    the crash in `resumed`, so the request's whole stream is
    `resumed + tokens`; `resumed` is [] on a fresh submit."""

    def __init__(self, request: Request):
        self.request = request
        self.tokens: list[int] = []        # everything generated so far
        self.resumed: list[int] = []
        self.done = False
        self.outcome: Optional[str] = None
        self._pending: collections.deque[int] = collections.deque()

    @property
    def rid(self) -> int:
        return self.request.rid

    def drain(self) -> list[int]:
        """Take (and clear) the tokens generated since the last drain: the
        polling counterpart of `stream` / `astream` (mixing them on one
        handle splits the stream between them)."""
        out = list(self._pending)
        self._pending.clear()
        return out


class ServingEngine:
    """Continuous-batching RWKV serving.

    model         — a Model handle or an arch id (resolved with `smoke=`)
    params        — a given weight tree (f32 or bf16) on `device`; drawn
                    from `seed` when omitted
    quantized     — pack weights to quantized planes once at startup
    plane_policy  — a `PlanePolicy` choosing W8 / W4 / VQ per tensor
                    (needs quantized=True); None packs everything W8
    max_batch     — pool width: concurrent sequences
    prefill_chunk — prompt tokens absorbed per tick per prefilling slot
    max_len, state_dtype — the pool's (an f32 state serves on the per-op
                    paths; on the card the fused paths take bf16 only)
    fused_decode  — False (per-op plain path) | "block" (K3 or K7 per
                    layer) | "model" (one K4 or K7 launch for all layers)
    fused_prefill — False (per-op loop) | True (chunked: K5 + K2 or K6)
    speculative   — k >= 1: self-speculative decode, a k-token verify
                    window a tick (the drafter on the decode path's
                    kernel over the first `draft_depth` layers, the
                    verifier the chunked prefill with the head at every
                    position, or the per-op loop)
    draft_depth   — the drafter's layers (default: half the stack)
    plan          — a pre-built ExecutionPlan; it overrides every path,
                    weight, speculation and pool-dtype argument above
    counters      — the `ServingCounters` the scheduler reports to (a new
                    one when omitted); `run()` returns its snapshot
    prefix_cache  — None / False (off) | True (default sizes) | a
                    `PrefixCacheConfig` | a shared `PrefixCache`, whose
                    chunk must equal the plan's prefill_chunk.  Entries
                    file under `plan.cache_variant()`; a resumed request
                    streams the uncached tokens bit for bit
    slo           — a `ServingSLO`: priority, aging, deadline and
                    cache-aware admission, the per-tick prefill budget
                    (a lane quota, `ExecutionPlan.prefill_quota`), a
                    bounded queue with `Overloaded` backpressure or
                    shedding, and `run()`'s hang watchdog; the default
                    keeps an unbounded FIFO queue with no deadlines
    fault_injector — a `ServingFaultInjector` for fault drills (cache
                    probe errors, evictions mid-prefill and
                    mid-speculation, forced deadlines, crashes and
                    SIGKILL, torn snapshot writes, poisoned lanes)
    snapshot      — a `SnapshotConfig` (or a directory, at the default
                    cadence): tick-boundary snapshots; `restore(dir)`
                    resumes every stream bit for bit
    sentinel_every — every N ticks (0 = off) one sweep flags lanes holding
                    NaN or Inf; such a lane is quarantined and its request
                    replayed from scratch
    device        — "cuda" (default) or "cpu"; without a GPU "cuda" raises

    There is no path demotion: a program that raises inside a tick raises
    out of `step()` / `run()` at its first failure.
    """

    def __init__(self, model: Model | str, *, params: Any = None,
                 smoke: bool = True, max_batch: int = 8,
                 prefill_chunk: int = 16, max_len: int = 0,
                 state_dtype=STATE_DTYPE, quantized: bool = False,
                 plane_policy: PlanePolicy | None = None,
                 fused_decode: bool | str | None = False,
                 fused_prefill: bool = False, seed: int = 0,
                 speculative: Optional[int] = None,
                 draft_depth: Optional[int] = None,
                 plan: Optional[ExecutionPlan] = None,
                 counters: Optional[ServingCounters] = None,
                 prefix_cache=None, slo: Optional[ServingSLO] = None,
                 fault_injector=None, snapshot=None,
                 sentinel_every: int = 0, device="cuda"):
        if plan is None:
            plan = build_plan(model, params, smoke=smoke,
                              quantized=quantized,
                              plane_policy=plane_policy,
                              fused_decode=fused_decode,
                              fused_prefill=fused_prefill,
                              prefill_chunk=prefill_chunk, max_len=max_len,
                              state_dtype=state_dtype, seed=seed,
                              speculative=speculative,
                              draft_depth=draft_depth, device=device)
        self.plan = plan
        self.model = plan.model
        self.device = plan.device
        self.counters = counters if counters is not None else \
            ServingCounters()
        self.pool = SlotStatePool(self.model, max_batch,
                                  max_len=plan.max_len,
                                  dtype=plan.state_dtype,
                                  device=plan.device)
        self.prefix_cache = self._build_cache(prefix_cache)
        sp = plan.speculative
        self.speculative = 0 if sp is None else sp.k
        self.slo = slo if slo is not None else ServingSLO()
        self.scheduler = Scheduler(
            self.pool, plan.decode_fn(max_batch), plan.prefill_fn(max_batch),
            prefill_chunk=plan.prefill_chunk, counters=self.counters,
            on_token=self._on_token, on_finish=self._on_finish,
            prefix_cache=self.prefix_cache,
            cache_variant=None if self.prefix_cache is None
            else plan.cache_variant(),
            speculative=self.speculative,
            draft_fn=plan.draft_fn(max_batch)
            if sp is not None and sp.k > 1 else None,
            verify_fn=plan.verify_fn(max_batch) if sp is not None else None,
            rollback_fn=plan.rollback_fn(max_batch)
            if sp is not None else None,
            slo=self.slo,
            prefill_quota=plan.prefill_quota(self.slo.prefill_budget,
                                             max_batch)
            if self.slo.prefill_budget > 0 else None,
            fault_injector=fault_injector, sentinel_every=sentinel_every,
            on_requeue=self._on_requeue)
        self._handles: dict[int, RequestHandle] = {}
        self._next_rid = 0
        self.snapshot_manager = None
        if snapshot is not None and snapshot is not False:
            from repro_torch.serving.snapshot import SnapshotConfig
            self._attach_snapshots(
                snapshot if isinstance(snapshot, SnapshotConfig)
                else SnapshotConfig(directory=str(snapshot)))

    def _attach_snapshots(self, config, *, reference=None):
        """Wire tick-boundary snapshots (`config`, a SnapshotConfig) into
        the scheduler's `after_tick` hook and the torn-write drill into
        `on_torn_snapshot`; `reference` is the weights' checksums when the
        caller has just verified them (a restore)."""
        from repro_torch.serving.snapshot import SnapshotManager
        self.snapshot_manager = SnapshotManager(self, config,
                                                reference=reference)
        self.scheduler.after_tick = self.snapshot_manager.maybe_save
        self.scheduler.on_torn_snapshot = self.snapshot_manager.write_torn

    def _build_cache(self, prefix_cache) -> Optional[PrefixCache]:
        """The `prefix_cache=` argument as a cache whose chunk is the
        plan's (cached boundaries must be tick boundaries, or a resumed
        suffix would chunk differently from a full prefill)."""
        if prefix_cache is None or prefix_cache is False:
            return None
        if isinstance(prefix_cache, PrefixCache):
            if prefix_cache.chunk != self.plan.prefill_chunk:
                raise ValueError(
                    f"shared prefix cache has chunk={prefix_cache.chunk} but "
                    f"the plan prefills in chunks of {self.plan.prefill_chunk}"
                    " — boundary states would not land on tick boundaries")
            cache = prefix_cache
        else:
            cfg = prefix_cache if isinstance(prefix_cache, PrefixCacheConfig) \
                else PrefixCacheConfig()
            cache = PrefixCache(self.plan.prefill_chunk, config=cfg)
        if cache.counters is None:
            cache.counters = self.counters
        return cache

    @property
    def trace_counts(self) -> dict:
        """The plan's program counts: {"decode": 1, "prefill": 1} after any
        amount of serving (each program counted at its first call)."""
        return self.plan.trace_counts

    def submit(self, prompt: list[int],
               sampling: Optional[SamplingParams] = None, *,
               priority: int = 0, deadline_s: Optional[float] = None,
               **kw) -> RequestHandle:
        """Queue a request; `kw` overrides SamplingParams fields.
        `priority` and `deadline_s` are the SLO fields
        (`repro_torch.serving.slo`).  With a bounded queue a full queue
        raises `Overloaded` (the request was NOT accepted and leaves no
        handle behind) or, under the shed policy, drops a strictly less
        urgent queued request (its handle ends with outcome "shed")."""
        sp = sampling or SamplingParams()
        if kw:
            sp = dataclasses.replace(sp, **kw)
        rid, self._next_rid = self._next_rid, self._next_rid + 1
        req = Request(rid=rid, prompt=[int(t) for t in prompt],
                      max_new_tokens=sp.max_new_tokens,
                      temperature=sp.temperature, seed=sp.seed,
                      eos_token=sp.eos_token, priority=priority,
                      deadline_s=deadline_s)
        handle = RequestHandle(req)
        # registered before enqueue (a shed victim's on_finish fires inside
        # it and needs its own handle), dropped if THIS request is refused
        self._handles[rid] = handle
        try:
            self.scheduler.enqueue(req)
        except BaseException:
            self._handles.pop(rid, None)
            raise
        return handle

    def cancel(self, handle: RequestHandle) -> bool:
        """Cancel a queued or in-flight request and free its slot; its
        handle completes with outcome "cancelled".  False when it had
        already left."""
        return self.scheduler.evict(handle.rid)

    @property
    def handles(self) -> dict:
        """The live rid -> RequestHandle map (a copy).  Handles leave it as
        their requests retire, so take it before `run()` to keep them."""
        return dict(self._handles)

    def step(self) -> bool:
        """One scheduler tick; True while any request is in flight."""
        return self.scheduler.tick()

    def run(self) -> dict:
        """Drive until drained (with the scheduler's hang watchdog,
        `ServingSLO.max_idle_ticks`); returns the counters' snapshot."""
        self.scheduler.run()
        return self.counters.snapshot()

    def stream(self, handle: RequestHandle) -> Iterator[int]:
        """Synchronous token stream for one request; steps the engine
        (advancing ALL in-flight requests) whenever the stream runs dry."""
        while True:
            while handle._pending:
                yield handle._pending.popleft()
            if handle.done:
                return
            self.step()

    async def astream(self, handle: RequestHandle):
        """Async token stream; yields to the event loop between engine
        ticks so that concurrent consumers interleave."""
        while True:
            while handle._pending:
                yield handle._pending.popleft()
            if handle.done:
                return
            self.step()
            await asyncio.sleep(0)

    def _on_token(self, req: Request, tok: int):
        h = self._handles[req.rid]
        h.tokens.append(tok)
        h._pending.append(tok)

    def _on_finish(self, req: Request, outcome: str = FINISHED):
        h = self._handles.pop(req.rid)
        h.outcome = outcome
        h.done = True

    def _on_requeue(self, req: Request):
        """Quarantine callback: the request replays from scratch, so its
        handle forgets what the poisoned lane emitted; the replay delivers
        the same stream again."""
        h = self._handles.get(req.rid)
        if h is not None:
            h.tokens.clear()
            h.resumed = []
            h._pending.clear()

    @classmethod
    def restore(cls, directory: str, **kw) -> "ServingEngine":
        """Rebuild an engine from its newest committed snapshot and
        continue every stream bit for bit: each handle's `resumed` holds
        the pre-crash tokens, so `resumed + tokens` equals the stream of a
        run that never crashed.  Keywords: `restore_engine`'s (params,
        step, snapshot, fault_injector, verify_params, device)."""
        from repro_torch.serving.snapshot import restore_engine
        return restore_engine(directory, **kw)
