"""Serving engine front end: submit(prompt) -> token stream (port of
`repro/serving/engine.py`).

Wires the slotted state pool and the scheduler to an `ExecutionPlan`,
which owns path selection, weight preparation and the two programs
(decode step, prefill chunk).  The engine's job is request lifecycle:
handles, streaming and the scheduler callbacks.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Iterator, Optional

import torch

from repro_torch.core.quant.policy import PlanePolicy
from repro_torch.models.registry import Model
from repro_torch.serving.plan import STATE_DTYPE, build_plan
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.serving.state_pool import SlotStatePool


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    max_new_tokens: int = 16
    temperature: float = 0.0
    seed: int = 0
    eos_token: Optional[int] = None


class RequestHandle:
    """Live view of one submitted request; tokens stream in as generated."""

    def __init__(self, request: Request):
        self.request = request
        self.tokens: list[int] = []        # everything generated so far
        self.done = False
        self._pending: collections.deque[int] = collections.deque()

    @property
    def rid(self) -> int:
        return self.request.rid


class ServingEngine:
    """Continuous-batching RWKV serving.

    model         — a Model handle or an arch id (resolved with `smoke=`)
    seed          — the weights are drawn from it on `device`
    quantized     — pack weights to quantized planes once at startup
    plane_policy  — a `PlanePolicy` choosing W8 / W4 / VQ per tensor
                    (needs quantized=True); None packs everything W8
    max_batch     — pool width: concurrent sequences
    prefill_chunk — prompt tokens absorbed per tick per prefilling slot
    fused_decode  — False (per-op plain path) | "block" (K3 or K7 per
                    layer) | "model" (one K4 or K7 launch for all layers)
    fused_prefill — False (per-op loop) | True (chunked: K5 + K2 or K6)
    device        — "cuda" (default) or "cpu"; without a GPU "cuda" raises
    """

    def __init__(self, model: Model | str, *, smoke: bool = True,
                 max_batch: int = 8, prefill_chunk: int = 16,
                 quantized: bool = False,
                 plane_policy: PlanePolicy | None = None,
                 fused_decode: str | None = None,
                 fused_prefill: bool = False, seed: int = 0,
                 device="cuda"):
        plan = build_plan(model, smoke=smoke, quantized=quantized,
                          plane_policy=plane_policy,
                          fused_decode=fused_decode,
                          fused_prefill=fused_prefill,
                          prefill_chunk=prefill_chunk, seed=seed,
                          device=device)
        self.plan = plan
        self.model = plan.model
        self.device = plan.device
        self.pool = SlotStatePool(self.model, max_batch, dtype=STATE_DTYPE,
                                  device=plan.device)
        self.scheduler = Scheduler(
            self.pool, plan.decode_fn(), plan.prefill_fn(),
            prefill_chunk=plan.prefill_chunk, on_token=self._on_token,
            on_finish=self._on_finish)
        self._handles: dict[int, RequestHandle] = {}
        self._next_rid = 0
        self._generated = 0         # tokens emitted over the engine's life

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

    def step(self) -> bool:
        """One scheduler tick; True while any request is in flight."""
        return self.scheduler.tick()

    def run(self) -> dict:
        """Drive until drained; returns counts and the wall time."""
        t0, ticks0 = time.perf_counter(), self.scheduler.ticks
        n0 = self._generated
        self.scheduler.run()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        n = self._generated - n0
        return {"ticks": self.scheduler.ticks - ticks0, "tokens": n,
                "seconds": dt, "tokens_per_s": n / dt if dt > 0 else 0.0}

    def stream(self, handle: RequestHandle) -> Iterator[int]:
        """Synchronous token stream for one request; steps the engine
        (advancing ALL in-flight requests) whenever the stream runs dry."""
        while True:
            while handle._pending:
                yield handle._pending.popleft()
            if handle.done:
                return
            self.step()

    def _on_token(self, req: Request, tok: int):
        h = self._handles[req.rid]
        h.tokens.append(tok)
        h._pending.append(tok)
        self._generated += 1

    def _on_finish(self, req: Request):
        self._handles.pop(req.rid).done = True
