"""Numpy checkpoint store with async save (port of
`repro/checkpoint/store.py` on one device: no mesh, so no sharded writes
and no elastic re-sharding, which wait for ROADMAP Queue 1 item 10).

Layout (one directory per step), the JAX package's:

    <dir>/step_00000100/
        MANIFEST.json          step, per-leaf key, shape, dtype, scalar type,
                               and an optional JSON `meta` blob
        <leaf-key>.npy         one file per leaf
        COMMIT                 written last; restore ignores dirs without it

Leaf keys are JAX's `keystr` of the leaf's path ("['blocks']['att']['wk']",
".mu" for a NamedTuple field, "[0]" for a list item), so the two packages
read each other's checkpoints.  The data is staged in `.tmp-step_X` and
renamed after COMMIT is in place, so a crash mid-save never corrupts the
latest checkpoint.  Leaves round-trip with their exact dtype: a bf16
tensor is stored as its uint16 bit pattern (numpy has no bf16, and this
module needs no `ml_dtypes`) under the manifest dtype "bfloat16", which
is authoritative on restore (JAX's bf16 `.npy` files hold raw 2-byte
records, read the same way); Python scalar leaves come back as the same
Python type.  `AsyncCheckpointer` copies the tree to host memory at once
and writes the files on a background thread.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

_SCALARS = {"bool": bool, "int": int, "float": float}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _is_dataclass(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def _flatten(tree, path=""):
    """[(keystr, leaf)] in JAX's flatten order: dict keys sorted, NamedTuple
    and dataclass fields and sequence items in order, None an empty
    subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k],
                                                            f"{path}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields for kv in _flatten(
            getattr(tree, f), f"{path}.{f}")]
    if _is_dataclass(tree):
        return [kv for f in dataclasses.fields(tree) for kv in _flatten(
            getattr(tree, f.name), f"{path}.{f.name}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree) for kv in _flatten(
            x, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(like, leaves):
    """`like`'s structure with its leaves taken in order from `leaves`."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if _is_dataclass(like):
        return type(like)(**{f.name: _unflatten(getattr(like, f.name),
                                                leaves)
                             for f in dataclasses.fields(like)})
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def _safe(key: str) -> str:
    key = key.replace("/", "_")
    return "".join(c if c.isalnum() or c in "._-[]'" else "_" for c in key)


def _to_host(leaf):
    """A leaf as (numpy array, manifest dtype, Python scalar type or
    None); bf16 as its uint16 bits."""
    if isinstance(leaf, (bool, int, float)):
        return np.asarray(leaf), str(np.asarray(leaf).dtype), \
            type(leaf).__name__
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), \
                "bfloat16", None
        return t.numpy(), str(t.numpy().dtype), None
    arr = np.asarray(leaf)
    return arr, str(arr.dtype), None


def _host_copy(leaf):
    """A snapshot of `leaf` that later in-place updates cannot reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    return leaf


def save_checkpoint(directory: str, step: int, tree: Any, *,
                    meta: Any = None) -> str:
    """Blocking save; returns the committed checkpoint's path.  `meta`
    (JSON-serialisable) is stored inside MANIFEST.json."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = os.path.join(directory, f".tmp-step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": [], "meta": meta}
    for key, leaf in _flatten(tree):
        key = _safe(key)
        arr, dtype, scalar = _to_host(leaf)
        np.save(os.path.join(tmp, f"{key}.npy"), arr)
        manifest["leaves"].append({"key": key, "shape": list(arr.shape),
                                   "dtype": dtype, "scalar": scalar})
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def load_manifest(directory: str, step: int) -> dict:
    """The committed checkpoint's MANIFEST.json; refuses a step directory
    without its COMMIT marker (an uncommitted or torn write)."""
    path = os.path.join(directory, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, "COMMIT")):
        raise FileNotFoundError(
            f"no committed checkpoint at {path} (missing COMMIT marker — "
            "uncommitted or torn write)")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        return json.load(f)


def latest_step(directory: str) -> Optional[int]:
    """The newest committed step in `directory`, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(n.split("_")[1]) for n in os.listdir(directory)
             if n.startswith("step_")
             and os.path.exists(os.path.join(directory, n, "COMMIT"))]
    return max(steps) if steps else None


def _from_record(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A loaded array as a tensor of the manifest's dtype (bf16 from its
    2-byte records, whatever numpy read them as)."""
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    want = np.dtype(dtype)
    if arr.dtype != want:
        arr = arr.view(want) if arr.dtype.itemsize == want.itemsize \
            else arr.astype(want)
    return torch.from_numpy(np.array(arr, copy=True))


def restore_checkpoint(directory: str, step: int, like: Any) -> Any:
    """The checkpoint at `step` in the structure of `like`: each tensor
    leaf on like's device (the CPU for a meta tensor) in like's dtype,
    each Python scalar leaf as its Python type."""
    path = os.path.join(directory, f"step_{step:08d}")
    records = {r["key"]: r for r in load_manifest(directory,
                                                  step)["leaves"]}
    leaves = []
    for key, ref in _flatten(like):
        key = _safe(key)
        rec = records.get(key)
        if rec is None:
            raise KeyError(
                f"checkpoint leaf {key!r} missing from the manifest at "
                f"{path} — the saved tree had a different structure")
        try:
            arr = np.load(os.path.join(path, f"{key}.npy"))
        except FileNotFoundError as e:
            raise FileNotFoundError(
                f"checkpoint leaf {key!r}: file missing at {path} "
                "(manifest lists it — torn/corrupt checkpoint)") from e
        except Exception as e:
            raise ValueError(f"checkpoint leaf {key!r}: unreadable .npy at "
                             f"{path}: {e}") from e
        if rec.get("scalar") or not hasattr(ref, "shape"):
            py = _SCALARS.get(rec.get("scalar") or type(ref).__name__,
                              float)
            leaves.append(py(arr.item()))
            continue
        t = _from_record(arr, rec["dtype"])
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != "
                             f"model {tuple(ref.shape)}")
        if isinstance(ref, torch.Tensor):
            dev = "cpu" if ref.device.type == "meta" else ref.device
            t = t.to(device=dev, dtype=ref.dtype)
        leaves.append(t)
    return _unflatten(like, iter(leaves))


class AsyncCheckpointer:
    """Snapshot to host memory at once, write to disk on a thread.

    `save(step, tree)` returns once the tree is copied to host memory;
    `wait()` joins the write in flight and raises its error, if any.
    Keeps at most `keep` committed checkpoints (older ones pruned after a
    commit, never before)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, *, meta: Any = None):
        self.wait()
        leaves = [_host_copy(x) for _, x in _flatten(tree)]
        host_tree = _unflatten(tree, iter(leaves))

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, meta=meta)
                self._prune()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _prune(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and os.path.exists(
                os.path.join(self.directory, n, "COMMIT")))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"))
