"""Continuous-batching scheduler: admission, chunked prefill, batched decode
(port of `repro/serving/scheduler.py`; no SLO layer, faults, snapshots or
sentinels yet: ROADMAP Queue 1 item 6).

One `tick()`:
  1. ADMITS queued requests into free pool slots (FIFO) and, with a prefix
     cache, probes it: the longest cached proper prefix's state is written
     into the slot and only the suffix is prefilled (the slot starts at
     n_prefilled = hit length, its fresh reset suppressed),
  2. advances EVERY prefilling slot by up to one prompt chunk in ONE
     prefill call, with a per-slot-per-token validity mask and a
     fresh-slot mask that resets newly admitted lanes inside the call;
     with a cache, a lane now holding a chunk boundary not yet cached
     stages a copy of its state, published when the request finishes,
  3. runs ONE decode step over the whole pool for all DECODE slots, with
     an active-slot mask selecting which lanes' states commit, or, under
     speculation, the draft -> verify -> accept tick (`_spec_tick`).

Inactive lanes are computed but their state is never committed, so a lane
mid-prefill or free is never disturbed by decode traffic.  `evict(rid)`
cancels a queued or in-flight request and frees its slot, from inside an
`on_token` callback too.  With a `ServingCounters` attached, the scheduler
calls its hooks where JAX's does: on_enqueue, on_admit, on_cache_probe,
on_prefill, on_token(first=), on_speculate, on_finish, on_cancel and
on_tick.  A cache probe or insert that raises, raises.

There is no path demotion: a failing kernel raises out of `tick()`, it is
never replaced by its plain twin behind the caller's back.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch


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
    # prefix cache: tokens restored from a hit, the prompt's boundary
    # digests (hashed at enqueue) and the boundary states captured during
    # prefill, published when the request finishes
    cached_tokens: int = 0
    digests: Optional[dict] = None
    pending_inserts: list = dataclasses.field(default_factory=list)
    # speculation: the drafts of the current tick's window (cleared at
    # emission or eviction; never output until the verifier confirms one)
    drafted: list[int] = dataclasses.field(default_factory=list)


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
    "finished" or "cancelled"; `counters` (a `ServingCounters`, or None)
    takes the telemetry hooks.
    """

    def __init__(self, pool, decode_fn: Callable, prefill_fn: Callable, *,
                 prefill_chunk: int, counters=None,
                 on_token: Optional[Callable] = None,
                 on_finish: Optional[Callable] = None,
                 prefix_cache=None, cache_variant=None,
                 speculative: int = 0,
                 draft_fn: Optional[Callable] = None,
                 verify_fn: Optional[Callable] = None,
                 rollback_fn: Optional[Callable] = None):
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
        # the cache's chunk must equal prefill_chunk (the engine checks):
        # cached boundaries are tick boundaries
        self.prefix_cache = prefix_cache
        self.cache_variant = cache_variant
        if prefix_cache is not None and cache_variant is None:
            raise ValueError("prefix_cache needs a cache_variant")
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: dict[int, _Slot] = {}
        # the prompt digests of queued requests, hashed at enqueue
        self._digests: dict[int, Optional[dict]] = {}
        self.ticks = 0

    def enqueue(self, req: Request):
        if not req.prompt:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the first token "
                             "is sampled from the prompt's last logits)")
        self._digests[req.rid] = (self.prefix_cache.digests(req.prompt)
                                  if self.prefix_cache is not None else None)
        self.queue.append(req)
        if self.counters is not None:
            self.counters.on_enqueue(req.rid)

    def tick(self) -> bool:
        """One scheduling round; returns True while work remains."""
        self.ticks += 1
        self._admit()
        self._prefill_tick()
        if self.spec_k:
            self._spec_tick()
        else:
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
        for req in list(self.queue):
            if req.rid == rid:
                self.queue.remove(req)
                self._digests.pop(rid, None)
                if self.counters is not None:
                    self.counters.on_cancel(rid)
                self.on_finish(req, CANCELLED)
                return True
        return False

    def _admit(self):
        while self.queue and self.pool.n_free:
            req = self.queue.popleft()
            slot = self.pool.acquire()
            meta = _Slot(req=req, rng=np.random.default_rng(req.seed),
                         digests=self._digests.pop(req.rid, None))
            self.slots[slot] = meta
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
        the prefill time."""
        req = meta.req
        if meta.digests is None:
            meta.digests = self.prefix_cache.digests(req.prompt)
        t0 = self._now()
        lease = self.prefix_cache.probe(self.cache_variant, req.prompt,
                                        meta.digests)
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
                if self.counters is not None:
                    self.counters.on_token(
                        req.rid, first=len(meta.generated) == 1)
                self.on_token(req, tok)
                if slot not in self.slots or self.slots[slot] is not meta:
                    break   # evicted by its own token callback
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
            if self.counters is not None:
                self.counters.on_token(req.rid,
                                       first=len(meta.generated) == 1)
            self.on_token(req, tok)
            if slot not in self.slots or self.slots[slot] is not meta:
                continue    # evicted by its token callback
            if (len(meta.generated) >= req.max_new_tokens or
                    (req.eos_token is not None and tok == req.eos_token)):
                self._retire(slot, meta)

    def _retire(self, slot: int, meta: _Slot, *, outcome: str = FINISHED):
        """Release `slot` and report `meta.req` with `outcome`.  Only a
        finished request publishes its captured boundary states (write-
        once: the cache keeps the first state of a key); a cancelled one
        drops them, and its drafts and in-flight marker with them."""
        if outcome == FINISHED and self.prefix_cache is not None:
            for n, state in meta.pending_inserts:
                self.prefix_cache.insert(self.cache_variant,
                                         meta.req.prompt, n, state,
                                         meta.digests)
        meta.pending_inserts.clear()
        meta.drafted.clear()
        self._spec_inflight.pop(meta.req.rid, None)
        del self.slots[slot]
        self.pool.release(slot)
        if self.counters is not None:
            if outcome == CANCELLED:
                self.counters.on_cancel(meta.req.rid)
            else:
                self.counters.on_finish(meta.req.rid)
        self.on_finish(meta.req, outcome)
