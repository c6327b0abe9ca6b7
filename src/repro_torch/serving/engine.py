"""Serving engine front end: submit(prompt) -> token stream (port of
`repro/serving/engine.py`; SLO admission, snapshots and fault drills wait
for ROADMAP Queue 1 item 6).

Wires the slotted state pool and the scheduler to an `ExecutionPlan`,
which owns path selection, weight preparation and the programs (decode
step, prefill chunk, and the drafter, verifier and rollback under
self-speculative decode).  The engine builds the prefix cache, when asked
for one, and owns request lifecycle: handles, streaming, cancellation,
the scheduler callbacks and the `ServingCounters` telemetry `run()`
returns.
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
from repro_torch.serving.state_pool import SlotStatePool


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    max_new_tokens: int = 16
    temperature: float = 0.0
    seed: int = 0
    eos_token: Optional[int] = None


class RequestHandle:
    """Live view of one submitted request; tokens stream in as generated.
    `outcome` is None while in flight, then "finished" or "cancelled"."""

    def __init__(self, request: Request):
        self.request = request
        self.tokens: list[int] = []        # everything generated so far
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
    device        — "cuda" (default) or "cpu"; without a GPU "cuda" raises
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
                 prefix_cache=None, device="cuda"):
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
            if sp is not None else None)
        self._handles: dict[int, RequestHandle] = {}
        self._next_rid = 0

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
               sampling: Optional[SamplingParams] = None,
               **kw) -> RequestHandle:
        """Queue a request; `kw` overrides SamplingParams fields."""
        sp = sampling or SamplingParams()
        if kw:
            sp = dataclasses.replace(sp, **kw)
        rid, self._next_rid = self._next_rid, self._next_rid + 1
        req = Request(rid=rid, prompt=[int(t) for t in prompt],
                      max_new_tokens=sp.max_new_tokens,
                      temperature=sp.temperature, seed=sp.seed,
                      eos_token=sp.eos_token)
        self.scheduler.enqueue(req)
        handle = RequestHandle(req)
        self._handles[rid] = handle
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
        """Drive until drained; returns the counters' snapshot."""
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
