"""JAX trees (as numpy) -> the port's torch trees, paths kept.

The caller turns a JAX parameter or state tree into numpy first
(`jax.tree_util.tree_map(np.asarray, tree)`); this module takes it from
there, so it imports no JAX.  Nested dicts keep their keys, so the plane
leaves — `{"packed", "scale"}`, `{"packed4", "scale"}` and
`{"vq_idx", "codebook"}` — stay intact, and so do the stacked layer axes:
the dense transformer's `blocks.dense` leaves keep their leading
(n_layers, 1, ...) pair, the layout `models/transformer.py` reads.  A
JAX `DPotQuantized` (a pytree node, as `quantize_tree` leaves it) comes
across as the port's `DPotQuantized`, its arrays converted and its `ks`
kept.

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
    `device`; a `DPotQuantized` node -> the port's."""
    if isinstance(tree, dict):
        return {k: from_jax_tree(v, device) for k, v in tree.items()}
    if type(tree).__name__ == "DPotQuantized":
        from repro_torch.core.quant.delta_pot import DPotQuantized
        return DPotQuantized(codes=to_torch(tree.codes, device),
                             signs=to_torch(tree.signs, device),
                             scale=to_torch(tree.scale, device),
                             ks=tuple(tree.ks))
    return to_torch(tree, device)


def fused_stack_to_numpy(stack):
    """A JAX `FusedLayerStack` (or the port's) -> (slabs {dtype name:
    numpy}, [aux numpy], manifest tuple), read through its `.slabs`,
    `.aux` and `.manifest` alone, for byte-level comparison."""
    conv = lambda a: to_numpy_raw(a) if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    return ({k: conv(v) for k, v in stack.slabs.items()},
            [conv(a) for a in stack.aux],
            tuple(tuple(e) for e in stack.manifest))


def to_numpy_raw(t: torch.Tensor) -> np.ndarray:
    """A torch tensor -> numpy with its bits kept: bf16 as a uint16 view."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A torch tensor -> numpy in f32 for bf16 (exact), else as is."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
