"""Shared layers for the port: LayerNorm in the paper's single-pass form.

Port of `repro/models/layers.py:spec_norm` / `apply_norm` (layernorm).
"""
from __future__ import annotations

import torch

from repro_torch.models.param import P


def spec_norm(d: int) -> dict:
    return {"scale": P((d,), (None,), init="ones"),
            "bias": P((d,), (None,), init="zeros")}


def apply_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in f32, single pass: var = E[x²] − μ²
    (the paper's Eq. 12), cast back to x's dtype.  Not `F.layer_norm`,
    which is two-pass and rounds differently."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    ex2 = (x32 * x32).mean(dim=-1, keepdim=True)
    var = ex2 - mu * mu
    y = (x32 - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)
