"""Continuous-batching scheduler: admission, chunked prefill, batched decode
(port of `repro/serving/scheduler.py`; no SLO layer, prefix cache,
speculation, faults, snapshots or sentinels yet: ROADMAP Queue 1 item 6).

One `tick()`:
  1. ADMITS queued requests into free pool slots (FIFO),
  2. advances EVERY prefilling slot by up to one prompt chunk in ONE
     prefill call, with a per-slot-per-token validity mask and a
     fresh-slot mask that resets newly admitted lanes inside the call,
  3. runs ONE decode step over the whole pool for all DECODE slots, with
     an active-slot mask selecting which lanes' states commit.

Inactive lanes are computed but their state is never committed, so a lane
mid-prefill or free is never disturbed by decode traffic.  `evict(rid)`
cancels a queued or in-flight request and frees its slot.  With a
`ServingCounters` attached, the scheduler calls its hooks where JAX's
does: on_enqueue, on_admit, on_prefill, on_token(first=), on_finish,
on_cancel and on_tick.

There is no path demotion: a failing kernel raises out of `tick()`, it is
never replaced by its plain twin behind the caller's back.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request (host-side; tokens are python ints)."""
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    seed: int = 0
    eos_token: Optional[int] = None


PREFILL, DECODE = "prefill", "decode"
# a request's outcome, passed to on_finish (JAX's "shed" and "deadline"
# come with the SLO layer, item 6)
FINISHED, CANCELLED = "finished", "cancelled"


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


def sample_token(logits_row: np.ndarray, temperature: float,
                 rng: Optional[np.random.Generator]) -> int:
    """Greedy argmax at temperature<=0 (ties -> first index); Gumbel-max
    sampling otherwise.  Single-row reference for `sample_tokens`."""
    if temperature <= 0.0 or rng is None:
        return int(np.argmax(logits_row))
    g = rng.gumbel(size=logits_row.shape)
    return int(np.argmax(logits_row.astype(np.float64) / temperature + g))


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
    return logits[:, -1].float().cpu().numpy()


class Scheduler:
    """Drives a SlotStatePool with two programs.

    decode_fn(pool_state, tokens (S,1) i32, mask (S,) bool)
        -> (logits (S,1,V), new_pool_state)
    prefill_fn(pool_state, tokens (S,C) i32, valid (S,C) bool,
               fresh (S,) bool)
        -> (new_pool_state, last_logits (S,1,V))

    `on_token(req, tok)` fires per emitted token, `on_finish(req,
    outcome)` when a request leaves, with outcome "finished" or
    "cancelled"; `counters` (a `ServingCounters`, or None) takes the
    telemetry hooks.
    """

    def __init__(self, pool, decode_fn: Callable, prefill_fn: Callable, *,
                 prefill_chunk: int, counters=None,
                 on_token: Optional[Callable] = None,
                 on_finish: Optional[Callable] = None):
        self.pool = pool
        self.decode_fn = decode_fn
        self.prefill_fn = prefill_fn
        self.prefill_chunk = int(prefill_chunk)
        self.counters = counters
        self.on_token = on_token or (lambda req, tok: None)
        self.on_finish = on_finish or (lambda req, outcome: None)
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: dict[int, _Slot] = {}
        self.ticks = 0

    def enqueue(self, req: Request):
        if not req.prompt:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the first token "
                             "is sampled from the prompt's last logits)")
        self.queue.append(req)
        if self.counters is not None:
            self.counters.on_enqueue(req.rid)

    def tick(self) -> bool:
        """One scheduling round; returns True while work remains."""
        self.ticks += 1
        self._admit()
        self._prefill_tick()
        self._decode_tick()
        if self.counters is not None:
            self.counters.on_tick(active=len(self.slots),
                                  queued=len(self.queue))
        return bool(self.queue or self.slots)

    def run(self):
        """Tick until no work remains."""
        while self.tick():
            pass

    def evict(self, rid: int) -> bool:
        """Cancel an in-flight or queued request and free its slot; counted
        as a cancellation, not a completion (no latency sample).  False
        when no such request is queued or in flight."""
        for slot, meta in list(self.slots.items()):
            if meta.req.rid == rid:
                self._retire(slot, meta, outcome=CANCELLED)
                return True
        for req in self.queue:
            if req.rid == rid:
                self.queue.remove(req)
                if self.counters is not None:
                    self.counters.on_cancel(rid)
                self.on_finish(req, CANCELLED)
                return True
        return False

    def _admit(self):
        while self.queue and self.pool.n_free:
            req = self.queue.popleft()
            slot = self.pool.acquire()
            self.slots[slot] = _Slot(req=req,
                                     rng=np.random.default_rng(req.seed))
            if self.counters is not None:
                self.counters.on_admit(req.rid)

    def _prefill_tick(self):
        prefilling = [(s, m) for s, m in self.slots.items()
                      if m.phase == PREFILL]
        if not prefilling:
            return
        S, C = self.pool.max_slots, self.prefill_chunk
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
            if self.counters is not None:
                self.counters.on_prefill(meta.req.rid, parts[slot])
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

    def _emit(self, emitting: list):
        """Sample and book-keep one tick's emitting slots."""
        toks = sample_tokens(
            np.stack([row for _, _, row in emitting]),
            [meta for _, meta, _ in emitting])
        for (slot, meta, _), tok in zip(emitting, toks):
            req, tok = meta.req, int(tok)
            meta.generated.append(tok)
            meta.next_token = tok
            if self.counters is not None:
                self.counters.on_token(req.rid,
                                       first=len(meta.generated) == 1)
            self.on_token(req, tok)
            if (len(meta.generated) >= req.max_new_tokens or
                    (req.eos_token is not None and tok == req.eos_token)):
                self._retire(slot, meta)

    def _retire(self, slot: int, meta: _Slot, *, outcome: str = FINISHED):
        """Release `slot` and report `meta.req` with `outcome`."""
        del self.slots[slot]
        self.pool.release(slot)
        if self.counters is not None:
            if outcome == CANCELLED:
                self.counters.on_cancel(meta.req.rid)
            else:
                self.counters.on_finish(meta.req.rid)
        self.on_finish(meta.req, outcome)
