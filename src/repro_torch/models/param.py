"""Tiny parameter-spec system (port of `repro/models/param.py`).

Every model defines `spec(cfg) -> nested dict of P`; `init_params`
materializes it with a seeded `torch.Generator`.  Leaves are drawn in the
JAX flatten order (sorted dict keys), but the draws are torch's own: they
do not equal JAX's random weights, and nothing needs them to.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class P:
    """Declarative parameter spec."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones | uniform
    scale: float | None = None    # stddev override (default fan-in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} / axes {self.axes} mismatch")


def stack(spec, n: int):
    """Prepend a `layers` axis of size n to every P of a spec tree."""
    if isinstance(spec, P):
        return P((n, *spec.shape), ("layers", *spec.axes), init=spec.init,
                 scale=spec.scale)
    return {k: stack(v, n) for k, v in spec.items()}


def _init_leaf(p: P, gen: torch.Generator, device, dtype):
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init == "uniform":
        s = p.scale if p.scale is not None else 1.0
        t = torch.empty(p.shape, dtype=torch.float32, device=device)
        return t.uniform_(-s, s, generator=gen).to(dtype)
    if p.init != "normal":
        raise ValueError(f"unknown init {p.init!r}")
    # truncated normal in [-2, 2] std, fan-in scaled over the non-output
    # dims; stacked-layer tensors exclude the leading layer axis
    if p.scale is not None:
        std = p.scale
    else:
        dims = p.shape[1:-1] if (p.axes and p.axes[0] == "layers"
                                 and len(p.shape) > 2) else p.shape[:-1]
        fan_in = p.shape[0] if len(p.shape) == 1 else 1
        for d in dims:
            fan_in *= d
        std = 1.0 / max(fan_in, 1) ** 0.5
    t = torch.empty(p.shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std).to(dtype)


def init_params(spec, seed: int, device="cuda", dtype=torch.float32, *,
                leaf_fn: Optional[Callable] = None):
    """Materialize a spec tree from one seeded generator on `device`.
    `leaf_fn(path, tensor)`, when given, replaces each leaf as soon as it
    is drawn (the serving plan packs it there), so a 7B tree never lies
    on the device whole in f32; the draws are the same either way."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def walk(node, path):
        if isinstance(node, P):
            t = _init_leaf(node, gen, device, dtype)
            return t if leaf_fn is None else leaf_fn(path, t)
        return {k: walk(node[k], path + (k,)) for k in sorted(node)}
    return walk(spec, ())


def _spec_leaves(spec):
    if isinstance(spec, P):
        return [spec]
    return [p for k in sorted(spec) for p in _spec_leaves(spec[k])]


def param_count(spec) -> int:
    """The number of weights a spec tree holds."""
    return int(sum(math.prod(p.shape) for p in _spec_leaves(spec)))


def abstract_params(spec, dtype=torch.float32):
    """The spec tree as meta tensors: the shapes and dtype, no storage
    (the analogue of JAX's ShapeDtypeStruct tree)."""
    if isinstance(spec, P):
        return torch.empty(spec.shape, dtype=dtype, device="meta")
    return {k: abstract_params(v, dtype) for k, v in spec.items()}
