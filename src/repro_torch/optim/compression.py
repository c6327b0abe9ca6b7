"""Int8 gradient compression with error feedback (port of
`repro/optim/compression.py`).

Int8 symmetric per-tensor quantization of gradients before a
cross-replica all-reduce (f32 -> int8, 8x less traffic), with an
error-feedback accumulator that re-injects each step's quantization
error into the next (Seide et al. 2014 / EF-SGD):

    ef, cg = compress_grads_int8(grads, ef)
    # the collective over the replicas goes here (it waits for the port's
    # meshes, ROADMAP Queue 1 item 10a)
    grads = decompress_grads_int8(cg)

The values are JAX's bit for bit on f32 trees, as JAX's callers run the
functions: eagerly, so the scale is the true division amax / 127 (under
jit XLA rewrites it as amax · fl(1/127), an ulp apart in about one scale
in twenty; the codes then agree).  Every division here takes a divisor on
the dividend's device, never a Python or CPU scalar: CUDA divides by such
a scalar through its reciprocal.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_map


class ErrorFeedback(NamedTuple):
    residual: Any  # same tree as grads, f32


def init_error_feedback(params) -> ErrorFeedback:
    return ErrorFeedback(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _q_leaf(g, r):
    """-> (int8 codes, f32 scale (0-d), f32 residual) of one leaf."""
    g32 = g.to(torch.float32) + r
    amax = torch.max(torch.abs(g32))
    scale = torch.where(amax <= 0, torch.ones_like(amax),
                        amax / amax.new_tensor(127.0))
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale, g32 - q.to(torch.float32) * scale


def compress_grads_int8(grads, ef: ErrorFeedback):
    """-> (new ErrorFeedback, {"q": int8 tree, "scale": f32 tree})."""
    out = tree_map(_q_leaf, grads, ef.residual)
    pick = lambda i: tree_map(lambda t: t[i], out)
    return ErrorFeedback(residual=pick(2)), {"q": pick(0), "scale": pick(1)}


def decompress_grads_int8(cg) -> Any:
    return tree_map(lambda q, s: q.to(torch.float32) * s, cg["q"],
                    cg["scale"])
