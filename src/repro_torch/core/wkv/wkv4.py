"""RWKV-4 WKV operator (paper Eq. 2), numerically stable running-max form.

Port of `repro/core/wkv/wkv4.py`: carry (a, b, o) where a/b are the
exponent-shifted numerator/denominator sums and o the running max
exponent, so no exp ever overflows.

Shapes: k, v (..., T, C); w, u (C,) with w > 0 the decay; state (..., C).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.device import resolve_device


class WKV4State(NamedTuple):
    a: torch.Tensor  # shifted numerator
    b: torch.Tensor  # shifted denominator
    o: torch.Tensor  # running max exponent


def wkv4_init_state(batch_shape, channels: int, device="cuda"
                    ) -> WKV4State:
    device = resolve_device(device)
    shape = tuple(batch_shape) + (channels,)
    z = lambda: torch.zeros(shape, dtype=torch.float32, device=device)
    return WKV4State(a=z(), b=z(),
                     o=torch.full(shape, -1e38, dtype=torch.float32,
                                  device=device))


def wkv4_step(state: WKV4State, k, v, w, u, *, exp=torch.exp, div=None
              ) -> tuple[WKV4State, torch.Tensor]:
    """One decode step; `exp`/`div` are injectable (the paper's LUT units
    substitute here in the hardware numerics)."""
    a, b, o = state
    if div is None:
        div = lambda x, y: x / y
    no = torch.maximum(o, u + k)
    A = exp(o - no)
    B = exp(u + k - no)
    wkv = div(A * a + B * v, A * b + B)
    no2 = torch.maximum(o - w, k)
    A2 = exp(o - w - no2)
    B2 = exp(k - no2)
    return WKV4State(a=A2 * a + B2 * v, b=A2 * b + B2, o=no2), wkv


def wkv4_scan(k, v, w, u, state: Optional[WKV4State] = None, *,
              exp=torch.exp, div=None) -> tuple[torch.Tensor, WKV4State]:
    """Sequence form over axis -2 of k, v (..., T, C)."""
    T, C = k.shape[-2], k.shape[-1]
    if state is None:
        state = wkv4_init_state(k.shape[:-2], C, k.device)
    k32, v32 = k.to(torch.float32), v.to(torch.float32)
    w32, u32 = w.to(torch.float32), u.to(torch.float32)
    outs = []
    for t in range(T):
        state, out = wkv4_step(state, k32[..., t, :], v32[..., t, :], w32,
                               u32, exp=exp, div=div)
        outs.append(out)
    return torch.stack(outs, dim=-2).to(k.dtype), state
