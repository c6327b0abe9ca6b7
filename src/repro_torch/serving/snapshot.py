"""Crash-safe serving: tick-boundary engine snapshots and a bitwise resume
(port of `repro/serving/snapshot.py`).

The engine keeps what matters in the slot pool plus host bookkeeping, so
it can be captured at a scheduler tick boundary, where no speculation is
in flight, no prefix-cache lease is held and every lane's state is
committed.  A snapshot holds the pool's state tree, the prefix cache's
entries, each slot's staged boundary states, and a JSON `meta` with the
host bookkeeping: each slot's request and generator state
(`numpy.random.Generator.bit_generator.state` restores bit for bit), the
queue, the SLO configuration, the counters (clock anchors stored as
seconds before the capture), and the plan's `build_config`, from which
restore rebuilds the same programs.

The port's pool is written in place (`SlotStatePool.write_slot`: a cache
install, a poisoning, a reset), so `EngineSnapshot.capture` copies every
array to host memory before it returns; the writer thread never reads a
tensor that a later tick can change.  Arrays go through
`repro_torch.checkpoint.store` (`AsyncCheckpointer`): commits are atomic
by rename, the files are written on a background thread, dtypes round-trip
exactly, and `load_manifest` refuses a step without its COMMIT marker, so
a torn write is never restored.

`restore_engine` (`ServingEngine.restore`) rebuilds the plan from
`build_config` — from the seed when the snapshot's weights were drawn
(`from_seed`), else from `params=` — and checks CRC32 checksums over
every prepared weight form (`IntegrityError` names the planes that
differ).  It reinstalls the pool and the cache, registers a
`RequestHandle` per live request with its pre-crash tokens in `.resumed`,
and continues every stream so that `resumed + tokens` equals a run that
never crashed, bit for bit.  The port has no mesh yet (ROADMAP Queue 1
item 10a) and never demotes a path, so a snapshot's "demoted" is [].
"""
from __future__ import annotations

import dataclasses
import os
import time
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import (AsyncCheckpointer, _flatten,
                                          latest_step, load_manifest,
                                          restore_checkpoint)

SNAPSHOT_VERSION = 1


class IntegrityError(RuntimeError):
    """Checksum verification failed: a prepared weight plane does not
    match what was recorded (bit rot, a wrong `params=` given to restore,
    or corruption in memory)."""


# ---------------------------------------------------------------------------
# Integrity: CRC32 over every prepared weight plane
# ---------------------------------------------------------------------------


def _tensor_crc(t: torch.Tensor) -> int:
    host = t.detach().reshape(-1).contiguous().cpu()
    return zlib.crc32(host.view(torch.uint8).numpy())


def tree_checksums(tree: Any) -> dict:
    """{leaf key: crc32} over a tree of tensors (keys: the checkpoint
    store's, so a mismatch names its plane; a `FusedLayerStack` is walked
    field by field).  A tensor shared between forms (the prepared forms
    alias the raw tree's leaves) is hashed once; Python scalars and
    strings hash their repr, numpy arrays their bytes."""
    seen: dict = {}
    out = {}
    for key, leaf in _flatten(tree):
        if isinstance(leaf, torch.Tensor):
            cid = (leaf.device, leaf.data_ptr(), leaf.storage_offset(),
                   tuple(leaf.shape), leaf.stride(), leaf.dtype)
            if cid not in seen:
                seen[cid] = _tensor_crc(leaf)
            out[key] = seen[cid]
        elif isinstance(leaf, np.ndarray):
            out[key] = zlib.crc32(np.ascontiguousarray(leaf).tobytes())
        else:
            out[key] = zlib.crc32(repr(leaf).encode())
    return out


def param_checksums(prepared) -> dict:
    """Checksums over every form of a `PreparedParams` (raw, decode,
    prefill and the drafter's), so a fused path's slabs are covered even
    when the raw tree is intact."""
    return tree_checksums({"raw": prepared.raw, "decode": prepared.decode,
                           "prefill": prepared.prefill,
                           "draft": prepared.draft})


def verify_param_checksums(prepared, reference: dict, *, counters=None,
                           where: str = "startup"):
    """Recompute the checksums and compare them with `reference`; raises
    IntegrityError naming the planes that differ (counted in
    `ServingCounters.checksum_failures`)."""
    current = param_checksums(prepared)
    bad = sorted(k for k in reference if current.get(k) != reference[k])
    bad += sorted(k for k in current if k not in reference)
    if bad:
        if counters is not None:
            counters.on_checksum_failure(len(bad))
        raise IntegrityError(
            f"param checksum mismatch at {where}: "
            f"{len(bad)} plane(s) differ from the reference — "
            f"first offenders: {bad[:4]}")


# ---------------------------------------------------------------------------
# Generator streams, bit for bit
# ---------------------------------------------------------------------------


def rng_state(gen: Optional[np.random.Generator]):
    """A Generator's bit-generator state as a JSON-serializable dict."""
    return None if gen is None else gen.bit_generator.state


def make_rng(state) -> Optional[np.random.Generator]:
    """A Generator mid-stream: the next draw is the one the saved stream
    would have made."""
    if state is None:
        return None
    bg = getattr(np.random, state["bit_generator"])()
    bg.state = state
    return np.random.Generator(bg)


# ---------------------------------------------------------------------------
# Capture
# ---------------------------------------------------------------------------


def _host(state: dict) -> dict:
    """A lane or pool state copied to host memory (synchronous)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in state.items()}


@dataclasses.dataclass(frozen=True)
class SnapshotConfig:
    """How the engine snapshots itself.

    directory     — snapshot root (the checkpoint store's step layout)
    every         — snapshot every N scheduler ticks (0 disables the
                    cadence; `SnapshotManager.save` still works)
    keep          — committed snapshots kept (older ones pruned after a
                    commit)
    verify_params — re-checksum the prepared weights before a save, so a
                    snapshot of corrupted weights is refused
                    (IntegrityError) rather than written
    verify_interval_s — a save re-verifies only when this many seconds
                    have passed since the last check (0.0 = every save);
                    startup and restore always verify."""
    directory: str
    every: int = 8
    keep: int = 3
    verify_params: bool = True
    verify_interval_s: float = 30.0


@dataclasses.dataclass
class EngineSnapshot:
    """One consistent engine image: `meta` (JSON host bookkeeping) and
    `arrays` (host copies of the pool, cache and staged states)."""
    meta: dict
    arrays: dict

    @classmethod
    def capture(cls, engine, tick: int, *, extra: Optional[dict] = None
                ) -> "EngineSnapshot":
        """Capture `engine` at the boundary of scheduler tick `tick`
        (between ticks: the `after_tick` hook).  Every array is copied to
        host memory before this returns, so later in-place writes to the
        pool cannot reach the snapshot.  Raises if speculation is in
        flight."""
        sch, pool = engine.scheduler, engine.pool
        if sch._spec_snapshot is not None or sch._spec_inflight:
            raise RuntimeError(
                "EngineSnapshot.capture outside a tick boundary: "
                "speculation in flight")
        if engine.plan.build_config is None:
            raise RuntimeError(
                "plan has no build_config (hand-constructed ExecutionPlan) "
                "— snapshots need build_plan(...) provenance to restore")
        now = sch._now()
        arrays: dict = {"pool": _host(pool.state), "cache": {},
                        "pending": {}}
        cache_meta = None
        if engine.prefix_cache is not None:
            ents = engine.prefix_cache.export_entries()
            cache_meta = {
                "config": dataclasses.asdict(engine.prefix_cache.config),
                "entries": [rec for rec, _ in ents]}
            arrays["cache"] = {f"e{i:04d}": _host(st)
                               for i, (_, st) in enumerate(ents)}
        slot_recs = []
        for slot, m in sorted(sch.slots.items()):
            if m.drafted:
                raise RuntimeError(
                    f"slot {slot} holds unverified drafts — not a tick "
                    "boundary")
            slot_recs.append({
                "slot": slot, "req": dataclasses.asdict(m.req),
                "phase": m.phase, "fresh": bool(m.fresh),
                "n_prefilled": int(m.n_prefilled),
                "next_token": int(m.next_token),
                "generated": [int(t) for t in m.generated],
                "rng_state": rng_state(m.rng),
                "cached_tokens": int(m.cached_tokens),
                "seq": int(m.seq),
                "deadline_remaining": (None if m.deadline_t is None
                                       else m.deadline_t - now),
                "pending": [int(n) for n, _ in m.pending_inserts]})
            for j, (_, st) in enumerate(m.pending_inserts):
                arrays["pending"][f"s{slot}_p{j}"] = _host(st)
        queue_recs = []
        for r in sch.queue:
            qm = sch._queued[r.rid]
            queue_recs.append({
                "req": dataclasses.asdict(r), "seq": int(qm.seq),
                "enqueue_tick": int(qm.enqueue_tick),
                "deadline_remaining": (None if qm.deadline_t is None
                                       else qm.deadline_t - now)})
        meta = {
            "version": SNAPSHOT_VERSION,
            "tick": int(tick),
            "next_rid": int(engine._next_rid),
            "next_seq": int(sch._seq),
            "progress": int(sch._progress),
            "plan": engine.plan.build_config,
            "device": str(engine.plan.device),
            "max_batch": int(pool.max_slots),
            "slo": dataclasses.asdict(engine.slo),
            "sentinel_every": int(sch.sentinel_every),
            "demoted": [],                  # the port never demotes
            "param_checksums": None,        # SnapshotManager fills this
            "snapshot": None,               # ... and this
            "slots": slot_recs,
            "queue": queue_recs,
            "cache": cache_meta,
            "counters": engine.counters.state_dict(),
        }
        if extra:
            meta.update(extra)
        return cls(meta=meta, arrays=arrays)


class SnapshotManager:
    """Owns the engine's snapshot cadence and integrity reference.

    Construction checksums every prepared weight plane once (the startup
    reference), unless `reference` gives it (a restore has just verified
    them).  `maybe_save(tick)`, the scheduler's `after_tick` hook,
    captures and writes every `config.every` ticks: the capture and its
    host copies are synchronous (`ServingCounters.snapshot_wall_s`), the
    file writes run on the `AsyncCheckpointer`'s thread (a save joins the
    previous write first)."""

    def __init__(self, engine, config: SnapshotConfig, *,
                 reference: Optional[dict] = None):
        self.engine = engine
        self.config = config
        self.writer = AsyncCheckpointer(config.directory, keep=config.keep)
        self.reference_checksums = dict(reference) if reference is not None \
            else param_checksums(engine.plan.prepared)
        self._last_verify = time.monotonic()

    def verify(self, *, where: str = "snapshot"):
        """Re-checksum the prepared weights against the reference."""
        verify_param_checksums(self.engine.plan.prepared,
                               self.reference_checksums,
                               counters=self.engine.counters, where=where)
        self._last_verify = time.monotonic()

    def maybe_save(self, tick: int):
        if self.config.every and tick % self.config.every == 0:
            self.save(tick)

    def save(self, tick: int):
        t0 = time.perf_counter()
        if self.config.verify_params and (
                self.config.verify_interval_s == 0.0
                or time.monotonic() - self._last_verify
                >= self.config.verify_interval_s):
            self.verify()
        snap = EngineSnapshot.capture(self.engine, tick, extra={
            "param_checksums": self.reference_checksums,
            "snapshot": dataclasses.asdict(self.config)})
        self.writer.save(tick, snap.arrays, meta=snap.meta)
        self.engine.counters.on_snapshot(time.perf_counter() - t0)

    def write_torn(self, tick: int):
        """The `torn_snapshot_write` drill: leave what a crash mid-save
        leaves, a partial `.tmp-step_X` with a leaf and no COMMIT marker.
        `latest_step` skips it; restore falls back to the newest
        committed snapshot."""
        tmp = os.path.join(self.config.directory, f".tmp-step_{tick:08d}")
        os.makedirs(tmp, exist_ok=True)
        np.save(os.path.join(tmp, "['pool']_partial.npy"), np.zeros(3))

    def wait(self):
        """Join the background write in flight (raises its error)."""
        self.writer.wait()


# ---------------------------------------------------------------------------
# Restore
# ---------------------------------------------------------------------------


def load_snapshot(directory: str, step: Optional[int] = None
                  ) -> tuple[int, dict]:
    """(step, meta) of the newest committed snapshot (or exactly `step`).
    Torn or uncommitted directories are never candidates; a directory
    without a committed step raises FileNotFoundError, a committed
    checkpoint that is not a serving snapshot ValueError."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no committed snapshot under {directory!r}")
    manifest = load_manifest(directory, step)
    meta = manifest["meta"]
    if not isinstance(meta, dict) or meta.get("version") != SNAPSHOT_VERSION:
        version = meta.get("version") if isinstance(meta, dict) else None
        raise ValueError(
            f"step {step} at {directory!r} is not a serving snapshot "
            f"(version {version!r}; expected {SNAPSHOT_VERSION})")
    return step, meta


def _slo_from_dict(d: dict):
    from repro_torch.serving.slo import AdmissionPolicy, ServingSLO
    return ServingSLO(prefill_budget=d["prefill_budget"],
                      default_deadline_s=d["default_deadline_s"],
                      admission=AdmissionPolicy(**d["admission"]),
                      max_idle_ticks=d["max_idle_ticks"])


def restore_engine(directory: str, *, params: Any = None,
                   step: Optional[int] = None, snapshot="same",
                   fault_injector=None, verify_params: bool = True,
                   device=None):
    """Rebuild a ServingEngine from its newest committed snapshot so that
    every restored stream continues bit for bit (see the module
    docstring; `ServingEngine.restore` is the public alias).

    params   — required when the snapshot's weights were given
               (`build_config["from_seed"]` False); checksum-verified
               either way
    snapshot — "same": keep snapshotting into `directory` at the recorded
               cadence; None disables; or a SnapshotConfig
    device   — where to rebuild the engine (default: the recorded device)
    """
    from repro_torch.core.quant.policy import PlanePolicy
    from repro_torch.runtime.monitor import ServingCounters
    from repro_torch.serving.engine import RequestHandle, ServingEngine
    from repro_torch.serving.plan import build_plan
    from repro_torch.serving.prefix_cache import (PrefixCache,
                                                  PrefixCacheConfig)
    from repro_torch.serving.scheduler import Request, _Queued, _Slot

    step, meta = load_snapshot(directory, step)
    pc = meta["plan"]
    if params is None and not pc["from_seed"]:
        raise ValueError(
            "snapshot was built from externally-supplied weights "
            "(build_config.from_seed=False) — pass the same params= tree "
            "to restore; checksums will verify it")
    plan = build_plan(pc["arch"], params, smoke=pc["smoke"],
                      quantized=pc["quantized"],
                      plane_policy=PlanePolicy.from_config(
                          pc.get("plane_policy")),
                      fused_decode=(False if pc["fused_decode"] == "per_op"
                                    else pc["fused_decode"]),
                      fused_prefill=pc["fused_prefill"],
                      prefill_chunk=pc["prefill_chunk"],
                      max_len=pc["max_len"],
                      state_dtype=getattr(torch, pc["state_dtype"]),
                      seed=pc["seed"], speculative=pc["speculative"],
                      draft_depth=pc["draft_depth"],
                      device=meta["device"] if device is None else device)

    counters = ServingCounters()
    counters.load_state(meta["counters"])
    reference = meta.get("param_checksums")
    if verify_params and reference:
        verify_param_checksums(plan.prepared, reference,
                               counters=counters, where="restore")

    # -- arrays: host tensors in the snapshot's exact dtypes ----------------
    model, max_batch, dev = plan.model, meta["max_batch"], plan.device
    pool_like = model.init_slot_state(max_batch, plan.max_len,
                                      plan.state_dtype, "meta")
    lane_like = model.init_slot_state(1, plan.max_len, plan.state_dtype,
                                      "meta")
    n_entries = 0 if meta["cache"] is None else len(
        meta["cache"]["entries"])
    like = {"pool": pool_like,
            "cache": {f"e{i:04d}": lane_like for i in range(n_entries)},
            "pending": {f"s{rec['slot']}_p{j}": lane_like
                        for rec in meta["slots"]
                        for j in range(len(rec["pending"]))}}
    restored = restore_checkpoint(directory, step, like)

    def on_dev(state):
        return {k: v.to(dev) for k, v in state.items()}

    # -- prefix cache ---------------------------------------------------------
    cache = None
    if meta["cache"] is not None:
        cache = PrefixCache(plan.prefill_chunk, config=PrefixCacheConfig(
            **meta["cache"]["config"]))
        cache.device = dev              # device-tier entries go back there
        cache.adopt_entries(list(zip(
            meta["cache"]["entries"],
            (restored["cache"][f"e{i:04d}"] for i in range(n_entries)))))

    # -- the engine shell (fresh pool, programs, snapshot manager) ----------
    if snapshot == "same":
        snap_cfg = (None if meta["snapshot"] is None
                    else SnapshotConfig(**dict(meta["snapshot"],
                                               directory=directory)))
    else:
        snap_cfg = snapshot
    engine = ServingEngine(
        model, plan=plan, max_batch=max_batch, counters=counters,
        prefix_cache=cache, slo=_slo_from_dict(meta["slo"]),
        fault_injector=fault_injector,
        sentinel_every=meta["sentinel_every"])
    if snap_cfg is not None:
        engine._attach_snapshots(snap_cfg, reference=reference)

    # -- pool state and free list ---------------------------------------------
    engine.pool.state = on_dev(restored["pool"])
    occupied = {rec["slot"] for rec in meta["slots"]}
    engine.pool._free = sorted(set(range(max_batch)) - occupied,
                               reverse=True)

    # -- scheduler bookkeeping -----------------------------------------------
    sch = engine.scheduler
    now = sch._now()
    sch._tick_no = meta["tick"]
    sch._seq = meta["next_seq"]
    sch._progress = meta["progress"]

    def deadline(rec):
        left = rec["deadline_remaining"]
        if left is None:
            return None
        sch._has_deadlines = True
        return now + left

    for rec in meta["slots"]:
        req = Request(**rec["req"])
        m = _Slot(
            req=req, phase=rec["phase"], fresh=rec["fresh"],
            n_prefilled=rec["n_prefilled"], next_token=rec["next_token"],
            generated=list(rec["generated"]), rng=make_rng(rec["rng_state"]),
            cached_tokens=rec["cached_tokens"],
            digests=None if cache is None else cache.digests(req.prompt),
            seq=rec["seq"], deadline_t=deadline(rec))
        m.pending_inserts = [
            (n, on_dev(restored["pending"][f"s{rec['slot']}_p{j}"]))
            for j, n in enumerate(rec["pending"])]
        sch.slots[rec["slot"]] = m
    for rec in meta["queue"]:
        req = Request(**rec["req"])
        sch.queue.append(req)
        sch._queued[req.rid] = _Queued(
            seq=rec["seq"], enqueue_tick=rec["enqueue_tick"],
            deadline_t=deadline(rec),
            digests=None if cache is None else cache.digests(req.prompt))

    # -- engine bookkeeping: the rid counter, handles with resumed output ----
    engine._next_rid = meta["next_rid"]
    for rec in meta["slots"]:
        h = RequestHandle(sch.slots[rec["slot"]].req)
        h.resumed = list(rec["generated"])
        engine._handles[h.rid] = h
    for req in sch.queue:
        engine._handles[req.rid] = RequestHandle(req)
    counters.on_restore(resumed_lanes=len(meta["slots"]))
    return engine
