"""JAX trees (as numpy) -> the port's torch trees, paths kept.

The caller turns a JAX parameter or state tree into numpy first
(`jax.tree_util.tree_map(np.asarray, tree)`); this module takes it from
there, so it imports no JAX.  Nested dicts keep their keys, so packed
`{"packed", "scale"}` leaves stay intact.

JAX bf16 arrays come out of `np.asarray` as `ml_dtypes.bfloat16`, which
`torch.from_numpy` refuses: they travel as their raw bits, a uint16 view
reinterpreted as int16 and then viewed as torch.bfloat16.  The arrays are
copied first, because `np.asarray` of a JAX array is read-only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def to_torch(a, device="cuda") -> torch.Tensor:
    device = resolve_device(device)
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        bits = a.view(np.uint16).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_jax_tree(tree, device="cuda"):
    """Nested dicts of numpy arrays -> the same dicts of torch tensors on
    `device`."""
    if isinstance(tree, dict):
        return {k: from_jax_tree(v, device) for k, v in tree.items()}
    return to_torch(tree, device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A torch tensor -> numpy in f32 for bf16 (exact), else as is."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
