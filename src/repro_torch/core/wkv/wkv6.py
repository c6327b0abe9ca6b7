"""RWKV-6 "Finch" WKV: linear attention with data-dependent per-channel
decay (port of `repro/core/wkv/wkv6.py`, the step and scan forms).

Per head with head dim N:

    y_t = r_t @ (S_{t-1} + diag(u) (k_t ⊗ v_t))
    S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t            w_t ∈ (0,1)^N per token

Shapes: r, k, v, w (B, T, H, N); u (H, N); state S (B, H, N, N).
`wkv6_step` is the decode step and the oracle of kernel K6.
`wkv6_chunked` is JAX's two-level whole-sequence form, the function
JAX's `rwkv6.forward` calls, held to JAX in the CPU tests.  Kernel K10
computes the same function by a one-level scheme; its oracle is that
scheme's own transcription, `kernels/wkv6.py:wkv6_chunked_plain`, which
the port's forward takes on the CPU.
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


def wkv6_chunked(r, k, v, w, u, state=None, *, chunk: int = 64,
                 subchunk: int = 16):
    """Chunked form (JAX's `wkv6_chunked`, the two-level scheme): per chunk
    of C tokens the inter-chunk product against the carried state, the
    intra-chunk part per target sub-chunk a — keys of earlier sub-chunks
    re-referenced to a's start, the diagonal (S_sub, S_sub) block with
    exact pairwise exponents masked strictly lower before the exp — the
    u-bonus, then the state update.  Every exponent that reaches `exp` is
    <= 0, so nothing overflows.  r, k, v, w (B, T, H, N); u (H, N) ->
    (y (B, T, H, N) in r's dtype, final state f32)."""
    B, T, H, N = r.shape
    if T % chunk != 0:
        raise ValueError(f"T={T} not divisible by chunk={chunk}")
    C = chunk
    S_sub = min(subchunk, C)
    if C % S_sub != 0:
        raise ValueError(f"chunk={C} not divisible by subchunk={S_sub}")
    n_sub, G = C // S_sub, T // C
    if state is None:
        state = wkv6_init_state(B, H, N, device=r.device)
    f32 = torch.float32
    resh = lambda x: x.to(f32).reshape(B, G, C, H, N)
    rs, ks, vs, ws = resh(r), resh(k), resh(v), resh(w)
    u32 = u.to(f32)
    NEG = -1e30
    diag_mask = torch.tril(torch.ones((S_sub, S_sub), dtype=torch.bool,
                                      device=r.device), diagonal=-1)
    positions = torch.arange(C, device=r.device)
    S = state
    ys = []
    for gi in range(G):
        rc, kc, vc, wc = rs[:, gi], ks[:, gi], vs[:, gi], ws[:, gi]
        logw = torch.log(torch.clamp(wc, min=1e-38))
        L = torch.cumsum(logw, dim=1)            # inclusive (B, C, H, N)
        Lprev = L - logw                         # exclusive: L_{t-1}
        y = torch.einsum("bchn,bhnm->bchm", rc * torch.exp(Lprev), S)
        y_intra = []
        for a in range(n_sub):
            lo, hi = a * S_sub, (a + 1) * S_sub
            L_start = Lprev[:, lo:lo + 1]
            r_loc = rc[:, lo:hi] * torch.exp(Lprev[:, lo:hi] - L_start)
            expo = torch.where((positions < lo)[None, :, None, None],
                               L_start - L, NEG)
            k_rel = kc * torch.exp(expo)
            att = torch.einsum("bshn,bchn->bhsc", r_loc, k_rel)
            ya = torch.einsum("bhsc,bchn->bshn", att, vc)
            D = Lprev[:, lo:hi, None] - L[:, None, lo:hi]
            D = torch.where(diag_mask[None, :, :, None, None], D, NEG)
            att_d = torch.einsum("bshn,bihn,bsihn->bhsi", rc[:, lo:hi],
                                 kc[:, lo:hi], torch.exp(D))
            ya = ya + torch.einsum("bhsi,bihn->bshn", att_d, vc[:, lo:hi])
            y_intra.append(ya)
        y = y + torch.cat(y_intra, dim=1)
        y = y + torch.einsum("bchn,bchn->bch", rc * u32[None, None],
                             kc)[..., None] * vc
        Ltot = L[:, -1:]                         # (B, 1, H, N)
        k_fut = kc * torch.exp(Ltot - L)
        S = torch.exp(Ltot[:, 0])[..., None] * S + torch.einsum(
            "bchn,bchm->bhnm", k_fut, vc)
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(B, T, H, N).to(r.dtype), S
