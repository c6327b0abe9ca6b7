"""RWKV-6 "Finch" WKV: linear attention with data-dependent per-channel
decay (port of `repro/core/wkv/wkv6.py`, the step and scan forms).

Per head with head dim N:

    y_t = r_t @ (S_{t-1} + diag(u) (k_t ⊗ v_t))
    S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t            w_t ∈ (0,1)^N per token

Shapes: r, k, v, w (B, T, H, N); u (H, N); state S (B, H, N, N).
`wkv6_step` is the decode step and the oracle of kernel K6; the chunked
form waits for the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device


def wkv6_init_state(batch: int, heads: int, head_dim: int,
                    dtype=torch.float32, device="cuda") -> torch.Tensor:
    device = resolve_device(device)
    return torch.zeros((batch, heads, head_dim, head_dim), dtype=dtype,
                       device=device)


def wkv6_step(state, r, k, v, w, u):
    """One decode step. r, k, v, w (B, H, N); u (H, N); state
    (B, H, N, N) -> (new state, y (B, H, N)), the ops of JAX's in order:
    kv = k⊗v, y = r @ (S + u·kv), S' = w·S + kv."""
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhn,bhnm->bhm", r, state + u[..., :, None] * kv)
    return w[..., :, None] * state + kv, y


def wkv6_scan(r, k, v, w, u, state=None):
    """The step over axis 1: r, k, v, w (B, T, H, N); u (H, N) ->
    (y (B, T, H, N) in r's dtype, final state f32)."""
    B, T, H, N = r.shape
    if state is None:
        state = wkv6_init_state(B, H, N, device=r.device)
    f32 = lambda x: x.to(torch.float32)
    u32 = f32(u)
    ys = []
    for t in range(T):
        state, y = wkv6_step(state, f32(r[:, t]), f32(k[:, t]),
                             f32(v[:, t]), f32(w[:, t]), u32)
        ys.append(y)
    return torch.stack(ys, dim=1).to(r.dtype), state
