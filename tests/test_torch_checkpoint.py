"""Port vs JAX: the checkpoint store (`repro_torch/checkpoint/store.py`
against `repro/checkpoint/store.py`).  Every round trip is bit for bit:
the store copies bytes, so no tolerance applies.
"""
import os

import ml_dtypes
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro_torch.checkpoint import (
    AsyncCheckpointer, latest_step, load_manifest, restore_checkpoint,
    save_checkpoint)
from repro_torch.optim.optimizers import OptState


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "blocks": {"w": torch.randn((3, 4, 5), generator=g),
                   "b": torch.randn((5,), generator=g).to(torch.bfloat16)},
        "codes": torch.randint(0, 256, (7, 3), generator=g,
                               dtype=torch.uint8),
        "host": {"step": 12, "lr": 0.25, "done": True},
        "opt": OptState(mu={"w": torch.randn((2,), generator=g)},
                        nu={"w": torch.randn((2,), generator=g)},
                        count=torch.tensor(3, dtype=torch.int32)),
    }


def _like(tree):
    """Zeros of each tensor leaf's shape and dtype, scalars of their type."""
    if isinstance(tree, dict):
        return {k: _like(v) for k, v in tree.items()}
    if isinstance(tree, OptState):
        return OptState(*(_like(x) for x in tree))
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    return type(tree)()


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, tuple):
        assert type(a) is type(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert type(a) is type(b) and a == b


def test_round_trip_bit_for_bit(tmp_path):
    """f32, bf16 (stored by bit pattern under "bfloat16"), uint8, int32
    and Python-scalar leaves, in dicts and a NamedTuple, come back with
    their dtype, Python type and bits; the manifest carries `meta`."""
    tree = _tree()
    path = save_checkpoint(str(tmp_path), 5, tree, meta={"note": "x"})
    assert path.endswith("step_00000005")
    assert sorted(os.listdir(path))[:2] == ["COMMIT", "MANIFEST.json"]
    man = load_manifest(str(tmp_path), 5)
    assert man["meta"] == {"note": "x"} and man["step"] == 5
    dtypes = {r["key"]: r["dtype"] for r in man["leaves"]}
    assert dtypes["['blocks']['b']"] == "bfloat16"
    assert dtypes["['opt'].count"] == "int32"
    out = restore_checkpoint(str(tmp_path), 5, _like(tree))
    _assert_same(tree, out)


def test_uncommitted_and_latest_step(tmp_path):
    """A `.tmp-step_X` directory or a step directory without COMMIT is
    never read; latest_step names the newest committed step."""
    d = str(tmp_path)
    assert latest_step(d) is None
    assert latest_step(str(tmp_path / "missing")) is None
    save_checkpoint(d, 3, {"w": torch.ones(2)})
    save_checkpoint(d, 9, {"w": torch.ones(2)})
    os.makedirs(tmp_path / ".tmp-step_00000011")
    torn = tmp_path / "step_00000010"
    os.makedirs(torn)
    (torn / "MANIFEST.json").write_text("{}")
    assert latest_step(d) == 9
    with pytest.raises(FileNotFoundError, match="COMMIT"):
        load_manifest(d, 10)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(d, 11, {"w": torch.zeros(2)})
    with pytest.raises(KeyError):
        restore_checkpoint(d, 9, {"v": torch.zeros(2)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(d, 9, {"w": torch.zeros(3)})


def test_async_checkpointer(tmp_path):
    """save() snapshots the tree at once (an in-place update after it does
    not reach the file), wait() joins the write, and only the newest
    `keep` commits stay."""
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    w = torch.arange(6, dtype=torch.float32)
    for step in (1, 2, 3):
        ck.save(step, {"w": w, "step": step})
        w.add_(10.0)
    ck.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000003"]
    out = restore_checkpoint(str(tmp_path), 3, {"w": torch.zeros(6),
                                                "step": 0})
    assert torch.equal(out["w"], torch.arange(6.0) + 20.0)
    assert out["step"] == 3 and isinstance(out["step"], int)
    ck.wait()                           # nothing in flight: a no-op


def test_async_error_surfaces_on_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(str(blocker))
    ck.save(1, {"w": torch.ones(1)})
    with pytest.raises(OSError):
        ck.wait()


def test_jax_checkpoint_restores_in_port(tmp_path):
    """A checkpoint of f32, bf16 and uint8 leaves written by JAX's
    save_checkpoint restores in the port bit for bit."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(ml_dtypes.bfloat16)
    c = rng.integers(0, 256, (5,)).astype(np.uint8)
    j_save(str(tmp_path), 2, {"blocks": {"w": jnp.asarray(w)},
                              "b": jnp.asarray(b), "c": jnp.asarray(c)})
    like = {"blocks": {"w": torch.zeros(4, 6)},
            "b": torch.zeros(6, dtype=torch.bfloat16),
            "c": torch.zeros(5, dtype=torch.uint8)}
    out = restore_checkpoint(str(tmp_path), 2, like)
    assert torch.equal(out["blocks"]["w"], torch.from_numpy(w))
    assert np.array_equal(
        out["b"].view(torch.int16).numpy().view(np.uint16),
        b.view(np.uint16))
    assert torch.equal(out["c"], torch.from_numpy(c))


def test_port_checkpoint_restores_in_jax(tmp_path):
    """A checkpoint of f32, bf16 and uint8 leaves written by the port
    restores in JAX's restore_checkpoint bit for bit (bf16 through the
    manifest's dtype string)."""
    tree = _tree(3)
    save_checkpoint(str(tmp_path), 4, {"blocks": tree["blocks"],
                                       "codes": tree["codes"]})
    like = {"blocks": {"w": np.zeros((3, 4, 5), np.float32),
                       "b": np.zeros((5,), ml_dtypes.bfloat16)},
            "codes": np.zeros((7, 3), np.uint8)}
    out = j_restore(str(tmp_path), 4, like)
    assert np.array_equal(out["blocks"]["w"], tree["blocks"]["w"].numpy())
    assert out["blocks"]["b"].dtype == ml_dtypes.bfloat16
    assert np.array_equal(
        np.asarray(out["blocks"]["b"]).view(np.uint16),
        tree["blocks"]["b"].view(torch.int16).numpy().view(np.uint16))
    assert np.array_equal(out["codes"], tree["codes"].numpy())
