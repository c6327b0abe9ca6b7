"""The port's crash-safe serving on the CPU: tick-boundary snapshots and a
bitwise resume (`repro_torch.serving.snapshot`).

The contract: kill the engine at any tick, restore it from its newest
committed snapshot, and every request's stream (a handle's `resumed +
tokens`, or the pre-crash handle of a request that finished before the
snapshot) equals a run that never crashed, bit for bit — greedy and
seeded-sampled lanes, rwkv4 and rwkv6 smoke, on the per-op path, the
quantized "model" + chunked path (the kernels' plain versions here),
speculative decode and the prefix cache.  Around it: the checksums
against JAX's `tree_checksums` on the same bytes, the refusals (empty,
torn-only and foreign directories, wrong weights, a hand-built plan,
corrupted weights at save time), a torn write falling back to the last
committed step, and the in-place hazard of the port's pool (a snapshot
taken at tick t keeps tick t's bytes whatever later writes do).
"""
import os

import numpy as np
import pytest
import torch

from port_helpers import mixed_policies
from repro_torch.checkpoint.store import restore_checkpoint, save_checkpoint
from repro_torch.runtime.monitor import (EngineCrash, ServingCounters,
                                         ServingFaultInjector)
from repro_torch.serving import (IntegrityError, ServingEngine,
                                 SnapshotConfig, build_plan, load_snapshot)
from repro_torch.serving.snapshot import (EngineSnapshot, make_rng,
                                          param_checksums, rng_state,
                                          tree_checksums,
                                          verify_param_checksums)

ARCHS = ("rwkv4-169m", "rwkv6-7b")
N_TOKENS = 8
WARM = [1, 2, 3, 4, 5, 6, 7, 8]
CONFIGS = {
    "per_op": {},
    "fused": {"quantized": True, "fused_decode": "model",
              "fused_prefill": True},
    "speculative": {"speculative": 2},
    "prefix_cache": {"prefix_cache": True},
}


def _kw(config):
    kw = dict(CONFIGS[config])
    if config == "fused":
        kw["plane_policy"] = mixed_policies()[1]
    return kw


def _prompts(config, n=3):
    if config == "prefix_cache":
        return [WARM + [20 + i] for i in range(n)]
    return [[3 + i, 7, 11 + i, 2, 9, 5] for i in range(n)]


def _engine(arch, config, **kw):
    return ServingEngine(arch, smoke=True, prefill_chunk=4, max_batch=3,
                         seed=1, device="cpu", **_kw(config), **kw)


def _drive(engine, config):
    """Submit the traffic (even lanes greedy, odd lanes seeded-sampled);
    with the cache, a warm-up request is served first.  Returns (the
    traffic's handles, the ticks the warm-up took)."""
    warm_ticks = 0
    if config == "prefix_cache":
        w = engine.submit(WARM, max_new_tokens=2)
        engine.run()
        assert w.outcome == "finished"
        warm_ticks = engine.scheduler._tick_no
    hs = [engine.submit(p, max_new_tokens=N_TOKENS,
                        temperature=0.9 if i % 2 else 0.0, seed=11 + i)
          for i, p in enumerate(_prompts(config))]
    return hs, warm_ticks


_ORACLES: dict = {}


def _oracle(arch, config):
    """(streams by rid, warm-up ticks, last tick) of a run that never
    crashes."""
    if (arch, config) not in _ORACLES:
        eng = _engine(arch, config)
        hs, warm = _drive(eng, config)
        eng.run()
        assert all(h.outcome == "finished" for h in hs)
        _ORACLES[arch, config] = ({h.rid: list(h.tokens) for h in hs}, warm,
                                  eng.scheduler._tick_no)
    return _ORACLES[arch, config]


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("arch", ARCHS)
def test_crash_at_every_tick_resumes_bit_for_bit(arch, config, k, tmp_path):
    """Crash at the top of traffic tick k (the warm-up's ticks first),
    restore, drain: every stream equals the oracle's.  Before the first
    committed snapshot the restore is refused (FileNotFoundError); a
    crash scheduled past the last tick never fires."""
    oracle, warm, last = _oracle(arch, config)
    assert last - warm <= 8         # k covers every tick of the traffic
    crash = warm + k
    inj = ServingFaultInjector(schedule={crash: [("crash_at_tick", None)]})
    eng = _engine(arch, config, fault_injector=inj,
                  snapshot=SnapshotConfig(directory=str(tmp_path), every=2))
    hs, _ = _drive(eng, config)
    if crash > last:
        eng.run()
        eng.snapshot_manager.wait()
        assert inj.fired == [] and {h.rid: h.tokens for h in hs} == oracle
        return
    with pytest.raises(EngineCrash) as ei:
        eng.run()
    assert ei.value.tick == crash
    eng.snapshot_manager.wait()
    if crash <= 2:
        with pytest.raises(FileNotFoundError):
            ServingEngine.restore(str(tmp_path))
        return
    restored = ServingEngine.restore(str(tmp_path))
    handles = restored.handles
    assert restored.counters.restores == 1
    assert restored.counters.resumed_lanes == len(restored.scheduler.slots)
    if crash <= warm + 2:
        # the newest snapshot predates the traffic's submission: it holds
        # the warm-up's cache and none of the traffic
        assert not set(handles) & set(oracle)
        assert restored.prefix_cache.n_device > 0
        return
    restored.run()
    restored.snapshot_manager.wait()
    streams = {h.rid: list(h.tokens) for h in hs if h.done}
    streams.update({rid: h.resumed + h.tokens for rid, h in handles.items()
                    if rid in oracle})
    assert streams == oracle
    assert restored.pool.n_free == restored.pool.max_slots
    assert restored.scheduler._spec_snapshot is None
    if restored.prefix_cache is not None:
        restored.prefix_cache.check_state()


def test_restored_engine_serves_new_work(tmp_path):
    inj = ServingFaultInjector(schedule={5: [("crash_at_tick", None)]})
    eng = _engine("rwkv4-169m", "per_op", fault_injector=inj,
                  snapshot=SnapshotConfig(directory=str(tmp_path), every=2))
    _drive(eng, "per_op")
    with pytest.raises(EngineCrash):
        eng.run()
    eng.snapshot_manager.wait()
    restored = ServingEngine.restore(str(tmp_path), snapshot=None)
    assert restored.snapshot_manager is None
    restored.run()
    h = restored.submit([3, 7, 11, 2, 9, 5], max_new_tokens=3)
    restored.run()
    assert h.outcome == "finished" and len(h.tokens) == 3
    assert h.rid == 3                   # the rid counter was restored


# --- given weights: params= --------------------------------------------------------

def test_restore_with_given_params_and_refusals(tmp_path):
    model = build_plan("rwkv4-169m", smoke=True, device="cpu").model
    params = model.init_params(5, "cpu")
    kw = dict(params=params, smoke=True, prefill_chunk=4, max_batch=3,
              device="cpu")
    ref = ServingEngine("rwkv4-169m", **kw)
    ref_hs, _ = _drive(ref, "per_op")
    ref.run()
    inj = ServingFaultInjector(schedule={5: [("crash_at_tick", None)]})
    eng = ServingEngine("rwkv4-169m", fault_injector=inj,
                        snapshot=SnapshotConfig(str(tmp_path), every=2), **kw)
    _drive(eng, "per_op")
    with pytest.raises(EngineCrash):
        eng.run()
    eng.snapshot_manager.wait()
    assert load_snapshot(str(tmp_path))[1]["plan"]["from_seed"] is False
    with pytest.raises(ValueError, match="params="):
        ServingEngine.restore(str(tmp_path))
    with pytest.raises(IntegrityError):
        ServingEngine.restore(str(tmp_path),
                              params=model.init_params(6, "cpu"))
    restored = ServingEngine.restore(str(tmp_path), params=params,
                                     snapshot=None)
    handles = restored.handles
    restored.run()
    assert {rid: h.resumed + h.tokens for rid, h in handles.items()} == \
        {h.rid: h.tokens for h in ref_hs}


# --- checksums, generator streams, counters --------------------------------------

def test_tree_checksums_equal_jax_on_the_same_bytes():
    import jax.numpy as jnp
    from repro.serving.snapshot import tree_checksums as j_checksums
    rng = np.random.default_rng(0)
    a = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal((3,)).astype(np.float32)
    codes = rng.integers(0, 255, (5, 7)).astype(np.uint8)
    jt = {"w": jnp.asarray(a), "blk": {"b": jnp.asarray(b).astype(
        jnp.bfloat16), "codes": jnp.asarray(codes)}, "n": 3, "flag": True}
    tt = {"w": torch.from_numpy(a), "blk": {
        "b": torch.from_numpy(b).to(torch.bfloat16),
        "codes": torch.from_numpy(codes)}, "n": 3, "flag": True}
    assert tree_checksums(tt) == j_checksums(jt)


def test_tree_checksums_dedupe_and_sensitivity():
    a = torch.arange(6, dtype=torch.float32)
    tree = {"w": a, "alias": a, "n": 3, "flag": True}
    cks = tree_checksums(tree)
    assert cks == tree_checksums(tree)
    assert cks["['alias']"] == cks["['w']"]
    b = a.clone()
    b[2] += 1
    cks2 = tree_checksums({"w": b, "alias": a, "n": 3, "flag": True})
    assert cks2["['w']"] != cks["['w']"]
    assert cks2["['alias']"] == cks["['alias']"]
    # a view with other strides over the same storage is its own plane
    assert tree_checksums({"v": a[::2]})["['v']"] != cks["['w']"]


def test_param_checksums_cover_every_form_and_name_the_plane():
    plan = build_plan("rwkv4-169m", smoke=True, quantized=True,
                      plane_policy=mixed_policies()[1], fused_decode="model",
                      fused_prefill=True, speculative=2, device="cpu")
    ref = param_checksums(plan.prepared)
    assert {k.split("]")[0] + "]" for k in ref} == {
        "['raw']", "['decode']", "['prefill']", "['draft']"}
    assert any(".slabs" in k for k in ref)      # K4's slabs are covered
    verify_param_checksums(plan.prepared, ref)
    key = sorted(k for k in ref if "slabs" in k)[0]
    bad = dict(ref)
    bad[key] ^= 0xFFFF
    counters = ServingCounters()
    with pytest.raises(IntegrityError, match="1 plane") as ei:
        verify_param_checksums(plan.prepared, bad, counters=counters)
    assert key in str(ei.value) and counters.checksum_failures == 1


def test_rng_stream_serialization_is_bit_exact_and_jax_compatible():
    from repro.serving.snapshot import make_rng as j_make_rng
    gen = np.random.default_rng(123)
    gen.random(17)
    state = rng_state(gen)
    clone, jclone = make_rng(state), j_make_rng(state)
    want = gen.random(64)
    assert np.array_equal(want, clone.random(64))
    assert np.array_equal(want, jclone.random(64))
    assert rng_state(None) is None and make_rng(None) is None


def test_counters_state_roundtrip():
    c = ServingCounters()
    c.on_tick(active=2, queued=1)
    c.on_snapshot(0.25)
    c.on_quarantine(7)
    c.on_checksum_failure(2)
    fresh = ServingCounters()
    fresh.load_state(c.state_dict())

    def static(d):
        return {k: v for k, v in d.items() if k != "elapsed_s"}
    assert static(fresh.state_dict()) == static(c.state_dict())
    assert fresh.snapshot()["quarantined_lanes"] == 1
    assert fresh.snapshot()["checksum_failures"] == 2


# --- refusals ---------------------------------------------------------------------------

def test_load_snapshot_refuses_empty_and_torn_dirs(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_snapshot(str(tmp_path))
    tmp = tmp_path / ".tmp-step_00000004"
    tmp.mkdir()
    np.save(tmp / "leaf.npy", np.zeros(3))
    with pytest.raises(FileNotFoundError):
        load_snapshot(str(tmp_path))


@pytest.mark.parametrize("meta", [{"unrelated": True}, None, {"version": 2}])
def test_load_snapshot_refuses_foreign_checkpoints(tmp_path, meta):
    save_checkpoint(str(tmp_path), 4, {"w": np.zeros(3)}, meta=meta)
    with pytest.raises(ValueError, match="not a serving snapshot"):
        load_snapshot(str(tmp_path))
    with pytest.raises(ValueError, match="not a serving snapshot"):
        ServingEngine.restore(str(tmp_path))


def test_capture_requires_build_plan_provenance():
    plan = build_plan("rwkv4-169m", smoke=True, prefill_chunk=4,
                      device="cpu")
    plan.build_config = None
    eng = ServingEngine(plan.model, plan=plan, max_batch=1, device="cpu")
    with pytest.raises(RuntimeError, match="build_config"):
        EngineSnapshot.capture(eng, 0)


def test_save_refuses_corrupted_params(tmp_path):
    eng = _engine("rwkv4-169m", "per_op", snapshot=SnapshotConfig(
        directory=str(tmp_path), every=2, verify_interval_s=0.0))
    mgr = eng.snapshot_manager
    key = sorted(mgr.reference_checksums)[0]
    mgr.reference_checksums[key] ^= 0xFFFF
    _drive(eng, "per_op")
    with pytest.raises(IntegrityError, match="at snapshot"):
        eng.run()
    assert eng.counters.checksum_failures >= 1
    with pytest.raises(FileNotFoundError):
        load_snapshot(str(tmp_path))


def test_torn_write_falls_back_to_the_committed_step(tmp_path):
    oracle, _, _ = _oracle("rwkv4-169m", "per_op")
    inj = ServingFaultInjector(schedule={
        5: [("torn_snapshot_write", None)], 6: [("crash_at_tick", None)]})
    eng = _engine("rwkv4-169m", "per_op", fault_injector=inj,
                  snapshot=SnapshotConfig(directory=str(tmp_path), every=2))
    _drive(eng, "per_op")
    with pytest.raises(EngineCrash):
        eng.run()
    eng.snapshot_manager.wait()
    assert any(n.startswith(".tmp-step_") for n in os.listdir(tmp_path))
    step, meta = load_snapshot(str(tmp_path))
    assert step == 4 and meta["tick"] == 4 and meta["demoted"] == []
    restored = ServingEngine.restore(str(tmp_path), snapshot=None)
    handles = restored.handles
    restored.run()
    assert {rid: h.resumed + h.tokens for rid, h in handles.items()} == oracle


def test_restore_refuses_a_torn_only_directory(tmp_path):
    inj = ServingFaultInjector(schedule={2: [("torn_snapshot_write", None)]})
    eng = _engine("rwkv4-169m", "per_op", fault_injector=inj,
                  snapshot=SnapshotConfig(directory=str(tmp_path), every=0))
    h = eng.submit([1, 2, 3, 4], max_new_tokens=4)
    eng.run()
    assert h.outcome == "finished"
    assert [n.startswith(".tmp-step_") for n in os.listdir(tmp_path)] == \
        [True]
    with pytest.raises(FileNotFoundError):
        ServingEngine.restore(str(tmp_path))


# --- the in-place hazard of the port's pool --------------------------------------

def _pool_clone(eng):
    return {k: v.clone() for k, v in eng.pool.state.items()}


def test_capture_copies_the_pool_before_returning():
    eng = _engine("rwkv4-169m", "per_op")
    _drive(eng, "per_op")
    eng.step()
    want = _pool_clone(eng)
    snap = EngineSnapshot.capture(eng, eng.scheduler._tick_no)
    eng.pool.poison_slot(0)             # an in-place write after the tick
    eng.step()
    for k, v in want.items():
        got = snap.arrays["pool"][k]
        assert got.untyped_storage().data_ptr() != \
            eng.pool.state[k].untyped_storage().data_ptr()
        assert torch.equal(got, v), k


def test_saved_bytes_are_the_tick_boundary_pool(tmp_path):
    """Save at tick t, write the pool in place and run tick t+1, wait for
    the writer: the bytes on disk are tick t's pool."""
    eng = _engine("rwkv4-169m", "per_op", snapshot=SnapshotConfig(
        directory=str(tmp_path), every=0))
    _drive(eng, "per_op")
    eng.step()
    eng.step()
    want = _pool_clone(eng)
    eng.snapshot_manager.save(2)
    eng.pool.poison_slot(1)
    eng.step()
    eng.snapshot_manager.wait()
    like = {"pool": {k: torch.empty_like(v, device="meta")
                     for k, v in want.items()}, "cache": {}, "pending": {}}
    disk = restore_checkpoint(str(tmp_path), 2, like)["pool"]
    for k, v in want.items():
        assert torch.equal(disk[k], v), k
        assert not torch.equal(eng.pool.state[k], v)
