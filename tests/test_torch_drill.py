"""The port's training drill against the JAX package's, on the CPU.

`FailureInjector`, `HostFailure`, `TrainingSupervisor` and
`HeartbeatMonitor` of both packages run on the same schedules (those of
tests/test_substrate.py's `TestRuntime` and the example's 60% failure)
with the same step and restore functions: the log, the restart count,
the return step, the steps executed and the give-up after `max_restarts`
must be equal, exactly (host-side control flow; no tolerance).  Then
`examples/train_rwkv4_torch.py --drill` on the CPU at a tiny size: the
restored params equal the committed checkpoint bit for bit, and
`train_model` resumed from it ends on the supervised run's params bit
for bit.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

import repro.runtime as j_runtime
import repro.runtime.monitor as j_monitor
import repro_torch.runtime as t_runtime
import repro_torch.runtime.monitor as t_monitor

SIDES = {"jax": j_monitor, "port": t_monitor}
EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "train_rwkv4_torch.py"

# (n_steps, failure schedule, the step each restore reports, max_restarts)
SCHEDULES = {
    "substrate": (8, {4: [2]}, [2], 3),
    "example-60pct": (300, {180: [3]}, [150], 3),
    "two-failures": (20, {5: [0], 12: [1, 2]}, [4, 10], 3),
    "at-restart-limit": (10, {1: [1], 3: [2]}, [0, 2], 2),
}


def _drive(side, n_steps, schedule, restores, max_restarts):
    mon = SIDES[side]
    fi = mon.FailureInjector({k: list(v) for k, v in schedule.items()})
    executed, asked = [], []
    answers = iter(restores)

    def step(s):
        fi.check(s)
        executed.append(s)

    def restore(hosts):
        asked.append(list(hosts))
        return next(answers)

    sup = mon.TrainingSupervisor(step, restore, max_restarts=max_restarts)
    end = sup.run(n_steps)
    return {"end": end, "log": sup.log, "restarts": sup.restarts,
            "executed": executed, "asked": asked,
            "left": dict(fi.schedule)}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_supervisor_matches_jax(name):
    got = {side: _drive(side, *SCHEDULES[name]) for side in SIDES}
    assert got["port"] == got["jax"]
    assert got["port"]["restarts"] == len(SCHEDULES[name][2])


@pytest.mark.parametrize("max_restarts", [0, 1, 2])
def test_supervisor_gives_up_as_jax(max_restarts):
    outcome = {}
    for side, mon in SIDES.items():
        fi = mon.FailureInjector({0: [1], 1: [1], 2: [1], 3: [1]})

        def step(s, fi=fi):
            fi.check(s)

        sup = mon.TrainingSupervisor(step, restore_fn=lambda h: 0,
                                     max_restarts=max_restarts)
        with pytest.raises(mon.HostFailure) as e:
            sup.run(10)
        outcome[side] = (e.value.step, e.value.hosts, str(e.value),
                         sup.restarts, sup.log)
    assert outcome["port"] == outcome["jax"]
    assert outcome["port"][3] == max_restarts + 1


def test_injector_fires_once_and_can_be_disabled():
    for mon in SIDES.values():
        fi = mon.FailureInjector({3: [7]})
        fi.check(2)
        with pytest.raises(mon.HostFailure):
            fi.check(3)
        fi.check(3)                     # popped: fires once
        off = mon.FailureInjector({0: [1]}, enabled=False)
        off.check(0)
        assert off.schedule == {0: [1]}


def test_heartbeat_matches_jax():
    """Dead and alive hosts on a fake clock, beats with and without `at`."""
    seen = {}
    for side, mon in SIDES.items():
        t = [0.0]
        hm = mon.HeartbeatMonitor([0, 1, 2], timeout_s=10,
                                  clock=lambda: t[0])
        trace = []
        for now, beats in ((5.0, [(0, None)]), (9.0, [(2, 8.5)]),
                           (12.0, []), (18.6, [(1, None)]), (25.0, [])):
            t[0] = now
            for host, at in beats:
                hm.beat(host, at=at)
            trace.append((hm.dead_hosts(), hm.alive_hosts()))
        seen[side] = trace
    assert seen["port"] == seen["jax"]
    assert seen["port"][2] == ([1], [0, 2])


def test_runtime_exports_as_jax():
    for name in j_runtime.__all__:
        assert name in t_runtime.__all__
        assert getattr(t_runtime, name).__name__ == \
            getattr(j_runtime, name).__name__
    for name in ("ServingCounters", "ServingFaultInjector", "EngineCrash",
                 "percentile"):
        assert hasattr(t_runtime, name)


def _example():
    spec = importlib.util.spec_from_file_location("train_rwkv4_torch",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_drill_restores_bit_for_bit(tmp_path, capsys):
    """The example's drill on the CPU: a failure at step 6 of 10,
    checkpoints every 2 steps, the restore at step 6; the restored params
    equal the committed checkpoint bit for bit, and train_model resumed
    from it ends on the supervised run's params bit for bit."""
    ex = _example()
    rc = ex.main(["--drill", "--device", "cpu", "--steps", "10",
                  "--batch", "2", "--seq", "16", "--ckpt-every", "2",
                  "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "1 restart(s)" in out
    assert "['failure at step 6: hosts [3]', 'restored, resuming at step 6']" \
        in out
    assert "committed checkpoint bit for bit: True" in out
    assert "supervised run's bit for bit: True" in out


def test_example_drill_fields(tmp_path):
    ex = _example()
    model = ex.get_model(ex.CFG_100M)
    kw = dict(steps=5, batch=1, seq=8, ckpt_dir=tmp_path / "ck",
              ckpt_every=2, device="cpu")
    drill = ex.run_drill(model, **kw)
    assert drill["fail_at"] == 3 and drill["restored_step"] == 2
    assert drill["restored_equal"] is True
    assert drill["end_step"] == 5 and drill["restarts"] == 1
    # steps 0-2 ran, then 2-4 again from the checkpoint at 2
    assert len(drill["losses"]) == 6
    assert all(torch.isfinite(torch.tensor(drill["losses"])))
    with pytest.raises(ValueError):           # a used directory is refused
        ex.run_drill(model, **kw)
    resumed = ex.resume_run(model, **kw)
    assert ex.tree_bits_equal(resumed["params"], drill["params"])
