"""Optimizers as (init, update) pairs over the port's parameter trees
(port of `repro/optim/optimizers.py`).

  adamw     — AdamW with decoupled weight decay; moments in f32
  adafactor — factored second moments (row/col) for the largest configs

Both return `(init_fn, update_fn)`:
  init_fn(params)                         -> OptState
  update_fn(grads, state, params, step)   -> (params, new OptState)

The values are JAX's, operation for operation in f32; the torch idiom
differs in one way: `update_fn` writes the new parameters and moments
into the existing tensors (under no_grad) and returns the same trees, so
a step holds no second copy of them.  `count` is a 0-d int32 tensor,
1-based after the first update; `lr(step)` is taken at step = count
unless a step is given.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import leaves_with_path, tree_map


class OptState(NamedTuple):
    mu: Any        # first moment  (adamw) | None
    nu: Any        # second moment (adamw) | factored dict (adafactor)
    count: torch.Tensor


def _leaves(tree):
    return [t for _, t in leaves_with_path(tree)]


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / ‖g‖), ‖g‖): the norm over every
    leaf in f32, summed leaf by leaf in tree order as JAX's `sum` does."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in _leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), gn


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def _zero_count(params):
    dev = _leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw(lr: Callable | float, *, b1=0.9, b2=0.95, eps=1e-8,
          weight_decay=0.1, clip_norm: float | None = 1.0):
    lr_fn = _lr_fn(lr)

    def init(params):
        zeros = lambda: tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        return OptState(mu=zeros(), nu=zeros(), count=_zero_count(params))

    @torch.no_grad()
    def update(grads, state, params, step=None):
        count = state.count + 1
        step = count if step is None else step
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        t = count.to(torch.float32)
        c1 = 1 - b1 ** t
        c2 = 1 - b2 ** t
        lr_t = lr_fn(step)

        def upd(p, g, m, v):
            g32 = g.to(torch.float32)
            m.copy_(b1 * m + (1 - b1) * g32)
            v.copy_(b2 * v + (1 - b2) * g32 * g32)
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            if p.ndim >= 2:  # decay matrices only (standard practice)
                u = u + weight_decay * p.to(torch.float32)
            p.copy_(p.to(torch.float32) - lr_t * u)

        tree_map(upd, params, grads, state.mu, state.nu)
        return params, OptState(mu=state.mu, nu=state.nu, count=count)

    return init, update


def adafactor(lr: Callable | float, *, decay=0.8, eps=1e-30,
              clip_threshold=1.0, weight_decay=0.0,
              min_dim_size_to_factor=128):
    """Factored Adafactor (Shazeer & Stern 2018), no first moment: tensors
    whose two trailing dims are both >= min_dim_size_to_factor keep only
    row and column second-moment vectors."""
    lr_fn = _lr_fn(lr)

    def factored(p) -> bool:
        return (p.ndim >= 2 and p.shape[-1] >= min_dim_size_to_factor
                and p.shape[-2] >= min_dim_size_to_factor)

    def init(params):
        def per_leaf(p):
            z = lambda s: torch.zeros(s, dtype=torch.float32,
                                      device=p.device)
            if factored(p):
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return OptState(mu=None, nu=tree_map(per_leaf, params),
                        count=_zero_count(params))

    @torch.no_grad()
    def update(grads, state, params, step=None):
        count = state.count + 1
        step = count if step is None else step
        beta = 1.0 - count.to(torch.float32) ** (-decay)
        lr_t = lr_fn(step)

        def upd(p, g, v):
            g32 = g.to(torch.float32)
            g2 = g32 * g32 + eps
            if "vr" in v:
                vr = beta * v["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * v["vc"] + (1 - beta) * g2.mean(dim=-2)
                denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                vhat = (vr[..., None] * vc[..., None, :]) / denom[..., None]
                v["vr"].copy_(vr)
                v["vc"].copy_(vc)
            else:
                vhat = beta * v["v"] + (1 - beta) * g2
                v["v"].copy_(vhat)
            u = g32 / torch.sqrt(vhat + eps)
            # update clipping (RMS-capped), the adafactor stabilizer
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay and p.ndim >= 2:
                u = u + weight_decay * p.to(torch.float32)
            p.copy_(p.to(torch.float32) - lr_t * u)

        flat_p = leaves_with_path(params)
        flat_g = dict(leaves_with_path(grads))
        for path, p in flat_p:
            v = state.nu
            for k in path:
                v = v[k]
            upd(p, flat_g[path], v)
        return params, OptState(mu=None, nu=state.nu, count=count)

    return init, update
