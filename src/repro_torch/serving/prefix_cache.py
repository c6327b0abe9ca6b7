"""Recurrent-state prefix cache (port of `repro/serving/prefix_cache.py`).

An RWKV prompt prefix collapses into one O(1) lane state, so a repeated
prefix (a system prompt) can skip prefill: probe on admit, install the
cached state into the slot, prefill only the suffix.

  * CONTENT-HASH KEYING — prompts are hashed at prefill-chunk granularity
    with a rolling hash (`digests`): the digest at boundary n covers tokens
    [0, n) and is derived from the digest at n - chunk.  blake2b-128 over
    the int64 token bytes, so the digests equal the JAX package's byte for
    byte.  A digest is a lookup key, never a proof: every hit re-compares
    the prefix tokens, and a hash-equal, token-unequal entry is rejected
    and counted.
  * VARIANT ISOLATION — entries are keyed by a `CacheVariant` (arch, quant
    form, numerics, prefill path, state dtype) beside the hash, so states
    of different weights or paths never alias; one cache may be shared
    between engines.
  * TWO TIERS — a device LRU (`device_slots` lane states, each a copy made
    by `SlotStatePool.read_slot`, never a view of the pool) over a host
    tier (`host_slots`, `.cpu()` copies).  Device eviction spills to the
    host; host eviction drops; a host hit is copied back to the device
    when room exists.  Both copies are blocking, so the round trip is bit
    for bit.
  * WRITE-ONCE + REFCOUNTS — `insert` never overwrites, and `probe` returns
    a `StateLease` that pins its entry against eviction and spill until
    released.  `check_state` asserts the tier and refcount invariants.

The scheduler probes on admit, captures chunk-boundary states after each
prefill tick and publishes them when the request finishes
(`repro_torch.serving.scheduler`).  A resumed request runs the same chunk
programs from the same state bits at the same chunk boundaries, so its
stream equals the uncached one bit for bit.

  * TYPED STORAGE FAULTS — every entry records its state's leaves, shapes
    and dtypes when it is inserted or adopted; an entry found to no longer
    match them, when a probe hits it or an insert spills it, is dropped
    and raises `CacheStorageError`.  The scheduler degrades that error
    (and its own injected probe fault) to a counted miss or a dropped
    insert; any other exception the cache meets, a CUDA error above all,
    propagates.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Any, Callable, Optional

import numpy as np

DEVICE, HOST = "device", "host"


class CacheStorageError(RuntimeError):
    """The cache's own storage fault: a cached entry whose stored lane
    state no longer has the leaves, shapes and dtypes it was inserted
    with.  The one error of the cache that the scheduler degrades to a
    miss (`ServingCounters.cache_errors`)."""


def _signature(state: dict) -> tuple:
    """(leaf, shape, dtype) of every leaf of a lane state, sorted."""
    return tuple(sorted((k, tuple(v.shape), str(v.dtype))
                        for k, v in state.items()))


def default_chunk_hash(prev: bytes, tokens: tuple) -> bytes:
    """Rolling chunk hash: blake2b-128 of (parent digest, this chunk's
    tokens as int64 bytes); stable across processes and equal to the JAX
    package's.  Injectable (`hash_fn=`) so that collisions are testable."""
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.digest()


@dataclasses.dataclass(frozen=True)
class CacheVariant:
    """Everything that changes the bits of a prefix state for the same
    tokens: the non-hash half of every key (`ExecutionPlan.cache_variant`
    derives it from the plan)."""
    arch: str               # model config name ("rwkv4-169m", ...)
    quant: str              # "fp" | "dpot_w8" | "dpot_mix_<hash>"
    numerics: str           # "exact" | "hw_lut"
    prefill: str            # "per_op" | "chunked"
    state_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class PrefixCacheConfig:
    """Tier sizes in entries (each one lane state); `host_slots=0`
    disables the spill tier."""
    device_slots: int = 64
    host_slots: int = 256


@dataclasses.dataclass
class _Entry:
    key: tuple                      # (variant, n_tokens, digest)
    tokens: tuple                   # the full prefix: the collision guard
    n_tokens: int
    state: Any                      # {leaf: tensor} on the device / the CPU
    tier: str = DEVICE
    refcount: int = 0
    signature: tuple = ()           # _signature(state) when stored


def _to_host(state: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in state.items()}


def _to_device(state: dict, device) -> dict:
    return {k: v.to(device) for k, v in state.items()}


class StateLease:
    """A refcount pin on one cache entry: between `probe` and `release`
    the entry is not evicted, spilled or overwritten.  Release is
    idempotent."""

    def __init__(self, entry: _Entry, device):
        self._entry = entry
        self._device = device
        entry.refcount += 1

    @property
    def n_tokens(self) -> int:
        return self._entry.n_tokens

    @property
    def tokens(self) -> tuple:
        return self._entry.tokens

    @property
    def state(self):
        """The cached lane state on the cache's device (a host entry that
        promotion found no room for is copied over for this use)."""
        if self._entry.tier == HOST:
            return _to_device(self._entry.state, self._device)
        return self._entry.state

    def release(self):
        if self._entry is not None:
            self._entry.refcount -= 1
            self._entry = None


class PrefixCache:
    """Two-tier LRU of chunk-boundary lane states (see the module
    docstring).

    chunk     — prefill-chunk granularity; must equal the serving plan's
                `prefill_chunk` (the engine checks)
    config    — PrefixCacheConfig tier sizes
    counters  — an optional `ServingCounters` taking the insert, evict and
                spill hooks (the scheduler reports hits and misses)
    hash_fn   — the rolling chunk hash (tests force collisions)

    Device-tier states live, and host hits return to, the device of the
    first state inserted or adopted into the device tier (`self.device`).
    """

    def __init__(self, chunk: int, *,
                 config: PrefixCacheConfig = PrefixCacheConfig(),
                 counters=None,
                 hash_fn: Callable[[bytes, tuple], bytes] =
                 default_chunk_hash):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.chunk = int(chunk)
        self.config = config
        self.counters = counters
        self.device = None
        self._hash = hash_fn
        self._device: collections.OrderedDict = collections.OrderedDict()
        self._host: collections.OrderedDict = collections.OrderedDict()
        self.stats = collections.Counter(
            hits=0, host_hits=0, misses=0, inserts=0, rejects=0,
            collisions=0, evictions=0, spills=0, drops=0, insert_dropped=0)

    # -- keying ------------------------------------------------------------

    def digests(self, prompt) -> dict:
        """{n: digest} for every chunk boundary n = chunk, 2·chunk, ... <=
        len(prompt); computed once per request and reused by probe,
        contains and insert."""
        out, h = {}, b""
        for n in range(self.chunk, len(prompt) + 1, self.chunk):
            h = self._hash(h, tuple(prompt[n - self.chunk:n]))
            out[n] = h
        return out

    def _key(self, variant: CacheVariant, n: int, digest: bytes) -> tuple:
        return (variant, int(n), digest)

    def _tokens_match(self, entry: _Entry, prompt, n: int) -> bool:
        if entry.tokens == tuple(prompt[:n]):
            return True
        self.stats["collisions"] += 1       # the token compare rejected it
        return False

    def _lookup(self, variant, prompt, digests):
        """(n, key, entry) of each cached candidate boundary, longest
        first; only proper prefixes (n < len(prompt))."""
        if digests is None:
            digests = self.digests(prompt)
        for n in sorted(digests, reverse=True):
            if n < len(prompt):
                yield n, self._key(variant, n, digests[n])

    # -- probe -------------------------------------------------------------

    @staticmethod
    def _damaged(entry: _Entry) -> Optional[CacheStorageError]:
        """The error for an entry whose stored state no longer matches
        what was inserted, or None when it does."""
        if _signature(entry.state) == entry.signature:
            return None
        return CacheStorageError(
            f"prefix-cache entry of {entry.n_tokens} tokens ({entry.tier} "
            f"tier) holds {_signature(entry.state)}, not the "
            f"{entry.signature} it was inserted with")

    def _check_stored(self, key: tuple, entry: _Entry):
        """Raise `CacheStorageError` for a damaged entry, dropping it when
        no lease pins it."""
        err = self._damaged(entry)
        if err is None:
            return
        if entry.refcount == 0:
            (self._device if entry.tier == DEVICE else self._host).pop(key)
        raise err

    def probe(self, variant: CacheVariant, prompt,
              digests: Optional[dict] = None) -> Optional[StateLease]:
        """The longest cached proper prefix of `prompt` under `variant`,
        as a lease, or None.  A whole-prompt hit is never served: the
        first generated token needs the last prompt token's logits.  A hit
        whose stored state is damaged raises `CacheStorageError`."""
        for _, key in self._lookup(variant, prompt, digests):
            entry = self._device.get(key)
            if entry is not None and self._tokens_match(entry, prompt,
                                                        key[1]):
                self._check_stored(key, entry)
                self._device.move_to_end(key)
                self.stats["hits"] += 1
                return StateLease(entry, self.device)
            entry = self._host.get(key)
            if entry is not None and self._tokens_match(entry, prompt,
                                                        key[1]):
                self._check_stored(key, entry)
                self.stats["hits"] += 1
                self.stats["host_hits"] += 1
                # pinned before promoting: the promotion's room-making only
                # evicts unleased entries, so the hit is never its victim
                lease = StateLease(entry, self.device)
                try:
                    self._promote(key, entry)
                except CacheStorageError:
                    lease.release()         # no lease outlives a failure
                    raise
                return lease
        self.stats["misses"] += 1
        return None

    def hit_length(self, variant: CacheVariant, prompt,
                   digests: Optional[dict] = None) -> int:
        """The longest cached proper-prefix boundary of `prompt` (0 = no
        hit) without a lease, an LRU bump or a stats change."""
        for n, key in self._lookup(variant, prompt, digests):
            entry = self._device.get(key) or self._host.get(key)
            if entry is not None and entry.tokens == tuple(prompt[:n]):
                return int(n)
        return 0

    def contains(self, variant: CacheVariant, prompt, n: int,
                 digests: Optional[dict] = None) -> bool:
        """True when boundary `n` of `prompt` is cached under `variant`
        in either tier (the scheduler's capture-skip check)."""
        if n % self.chunk or not 0 < n <= len(prompt):
            return False
        digest = (digests if digests is not None
                  else self.digests(prompt)).get(n)
        if digest is None:
            return False
        key = self._key(variant, n, digest)
        entry = self._device.get(key) or self._host.get(key)
        return entry is not None and entry.tokens == tuple(prompt[:n])

    # -- insert / evict ----------------------------------------------------

    def insert(self, variant: CacheVariant, prompt, n: int, state,
               digests: Optional[dict] = None) -> bool:
        """Insert the lane state holding tokens [0, n) of `prompt` into the
        device tier.  Write-once: a key present in either tier is never
        overwritten.  False when rejected (present, misaligned, or every
        device entry leased); `CacheStorageError` when making room finds
        a damaged entry."""
        if n % self.chunk or not 0 < n <= len(prompt):
            return False
        digest = (digests if digests is not None
                  else self.digests(prompt)).get(n)
        if digest is None:
            return False
        key = self._key(variant, n, digest)
        if key in self._device or key in self._host:
            self.stats["rejects"] += 1
            return False
        if not self._make_device_room():
            self.stats["insert_dropped"] += 1
            return False
        if self.device is None:
            self.device = next(iter(state.values())).device
        self._device[key] = _Entry(key=key, tokens=tuple(prompt[:n]),
                                   n_tokens=int(n), state=state,
                                   signature=_signature(state))
        self.stats["inserts"] += 1
        if self.counters is not None:
            self.counters.on_cache_insert()
        return True

    def _make_device_room(self) -> bool:
        """One free device slot, spilling the LRU unleased entries to the
        host (or dropping them when the host tier has no room).  False
        when every device entry is leased."""
        while len(self._device) >= self.config.device_slots:
            victim_key = next((k for k, e in self._device.items()
                               if e.refcount == 0), None)
            if victim_key is None:
                return False
            entry = self._device.pop(victim_key)
            self.stats["evictions"] += 1
            if self.counters is not None:
                self.counters.on_cache_evict()
            err = self._damaged(entry)
            if err is not None:             # never spill a damaged state
                self.stats["drops"] += 1
                raise err
            if self._make_host_room():
                entry.state = _to_host(entry.state)
                entry.tier = HOST
                self._host[victim_key] = entry
                self.stats["spills"] += 1
                if self.counters is not None:
                    self.counters.on_cache_spill()
            else:
                self.stats["drops"] += 1
        return True

    def _make_host_room(self) -> bool:
        if self.config.host_slots < 1:
            return False
        while len(self._host) >= self.config.host_slots:
            victim_key = next((k for k, e in self._host.items()
                               if e.refcount == 0), None)
            if victim_key is None:
                return False
            del self._host[victim_key]
            self.stats["drops"] += 1
        return True

    def _promote(self, key: tuple, entry: _Entry):
        """A host hit moves to the device tier (most recent) when an
        unleased device slot can be made; otherwise it stays on the host
        and its lease copies it over per use."""
        if not self._make_device_room():
            return
        del self._host[key]
        entry.state = _to_device(entry.state, self.device)
        entry.tier = DEVICE
        self._device[key] = entry

    # -- export / adopt ----------------------------------------------------

    def export_entries(self) -> list[tuple[dict, Any]]:
        """Every entry as (record, state), oldest first per tier, device
        tier first: adopting the records in this order rebuilds the LRU
        order.  Refcounts are not exported."""
        out = []
        for store in (self._device, self._host):
            for e in store.values():
                out.append(({"tier": e.tier, "n_tokens": e.n_tokens,
                             "tokens": list(e.tokens),
                             "variant": dataclasses.asdict(e.key[0])},
                            e.state))
        return out

    def adopt_entries(self, entries):
        """Install exported entries into an empty cache, keeping tier and
        LRU order; keys are recomputed from the tokens.  Device-tier
        states go to the cache's device, host-tier ones stay on the
        CPU."""
        if self._device or self._host:
            raise ValueError("adopt_entries needs an empty cache")
        for rec, state in entries:
            variant = CacheVariant(**rec["variant"])
            tokens = [int(t) for t in rec["tokens"]]
            n = int(rec["n_tokens"])
            digest = self.digests(tokens)[n]
            key = self._key(variant, n, digest)
            tier = rec["tier"]
            entry = _Entry(key=key, tokens=tuple(tokens), n_tokens=n,
                           state=state, tier=tier,
                           signature=_signature(state))
            if tier == DEVICE:
                if self.device is None:
                    self.device = next(iter(state.values())).device
                entry.state = _to_device(state, self.device)
                self._device[key] = entry
            else:
                entry.state = _to_host(state)
                self._host[key] = entry
        self.check_state()

    # -- introspection -----------------------------------------------------

    @property
    def n_device(self) -> int:
        return len(self._device)

    @property
    def n_host(self) -> int:
        return len(self._host)

    def snapshot(self) -> dict:
        """Stats and occupancy as a plain dict (the serve CLI prints it)."""
        probes = self.stats["hits"] + self.stats["misses"]
        return {**self.stats,
                "device_entries": self.n_device,
                "host_entries": self.n_host,
                "hit_rate": self.stats["hits"] / probes if probes else 0.0}

    def check_state(self):
        """Assert the invariants: tier capacities, no key in both tiers,
        refcounts non-negative, every entry's tier tag, tokens and
        boundary consistent with where it lives, host states on the
        CPU."""
        assert len(self._device) <= self.config.device_slots
        assert len(self._host) <= self.config.host_slots
        assert not set(self._device) & set(self._host), "key in both tiers"
        for store, tier in ((self._device, DEVICE), (self._host, HOST)):
            for key, e in store.items():
                assert e.key == key and e.tier == tier
                assert e.refcount >= 0, f"negative refcount on {key}"
                assert e.n_tokens == len(e.tokens) == key[1]
                assert e.n_tokens % self.chunk == 0 and e.n_tokens > 0
                if tier == HOST:
                    assert all(v.device.type == "cpu"
                               for v in e.state.values())
