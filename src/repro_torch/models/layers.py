"""Shared layers for the port: norms, RoPE, GQA attention with a KV cache,
and the dense MLPs (port of `repro/models/layers.py`; MLA, cross-attention
and MoE wait for their slices).

Activation convention: (batch, seq, d_model).  Norms, RoPE and attention
compute in f32 and cast back to the input dtype; the projections and the
MLP run in the input dtype, as the JAX trace does.  Eager torch rounds
every bf16 op, the rounding rule `exact_jit` pins for JAX, so where JAX's
activation functions round in bf16 op by op (σ, the tanh GELU), these
follow them op for op.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import NEG_INF, flash_attention
from repro_torch.kernels.fused_layernorm import fused_layernorm
from repro_torch.models.param import P

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def spec_norm(d: int, kind: str = "layernorm") -> dict:
    if kind == "rmsnorm":
        return {"scale": P((d,), (None,), init="ones")}
    return {"scale": P((d,), (None,), init="ones"),
            "bias": P((d,), (None,), init="zeros")}


def apply_norm(p: dict, x: torch.Tensor, kind: str = "layernorm",
               eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm, or LayerNorm in the paper's single-pass form (var = E[x²] −
    μ², Eq. 12; not `F.layer_norm`, which is two-pass and rounds
    differently), over the last axis in f32, cast back to x's dtype."""
    x32 = x.to(torch.float32)
    if kind == "rmsnorm":
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps) * p["scale"]
    else:
        mu = x32.mean(dim=-1, keepdim=True)
        ex2 = (x32 * x32).mean(dim=-1, keepdim=True)
        var = ex2 - mu * mu
        y = (x32 - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def layernorm_kernel(p: dict, x: torch.Tensor) -> torch.Tensor:
    """`apply_norm`'s LayerNorm through kernel K11 (its plain version, the
    same formula, on the CPU): ln0, ln1, ln2 and ln_f of the RWKV
    whole-sequence forwards.  `apply_norm` itself stays eager, so the
    paths that call it keep their plain witnesses."""
    return fused_layernorm(x, p["scale"], p["bias"])


def token_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> the previous-token tensor, a zero before the first:
    the RWKV forwards' token shift from a zero carry."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


# ---------------------------------------------------------------------------
# Activations in XLA's bf16 expansions
# ---------------------------------------------------------------------------


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """σ(x) = 1 / (1 + exp(-x)), each op rounded in x's dtype: how XLA
    expands `jax.nn.sigmoid` (lax.logistic) for bf16, so the port rounds
    where the JAX reference does (`torch.sigmoid` rounds once, and
    differs from it in about a third of bf16 outputs)."""
    return torch.reciprocal(1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """x·σ(x) with σ in XLA's bf16 expansion: `jax.nn.silu` on bf16, each
    op rounded (F.silu rounds once and differs in ~40% of outputs)."""
    return x * sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu` (approximate=True) op for op: x·½(1 + tanh(√(2/π)(x +
    0.044715·x³))), each op in x's dtype.  JAX's Python constants are
    weakly typed, so they round to x's dtype first; torch would keep them
    in f32, so they are made tensors of x's dtype here."""
    c = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)
    cube = x * (x * x)                     # lax.integer_pow(x, 3)
    inner = c(math.sqrt(2.0 / math.pi)) * (x + c(0.044715) * cube)
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """The (head_dim / 2,) f32 inverse frequencies on `device`, which the
    caller names (the tensor's it rotates)."""
    half = head_dim // 2
    i = torch.arange(half, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (S,) or (..., S).  Rotates the two
    halves of each head in f32, cast back to x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (hd/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention core
# ---------------------------------------------------------------------------


def _causal_mask(Sq: int, Skv: int, q_offset: int, device) -> torch.Tensor:
    qpos = torch.arange(Sq, device=device) + q_offset
    kpos = torch.arange(Skv, device=device)
    return kpos[None, :] <= qpos[:, None]                     # (Sq, Skv)


def _plain_attention(q, k, v, causal: bool, q_offset) -> torch.Tensor:
    """q: (B,Sq,H,hd) k,v: (B,Skv,H,hd) — the full score matrix in f32
    (short sequences and the decode step)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q_offset, q.device)
        s = torch.where(mask[None, None], s, NEG_INF)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", a, v.to(torch.float32))
    return o.to(q.dtype)


def _flash_attention(q, k, v, causal: bool, q_offset,
                     kv_block: int = 1024) -> torch.Tensor:
    """Online softmax over key blocks of `kv_block` (halved until it
    divides Skv), a Python loop where JAX scans: the plain oracle of the
    fused-attention idea above `flash_threshold` keys."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    blk = min(kv_block, Skv)
    while Skv % blk != 0:
        blk //= 2
    f32 = torch.float32
    q32 = q.to(f32) * (1.0 / math.sqrt(hd))
    m = torch.full((B, H, Sq), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=f32, device=q.device)
    acc = torch.zeros((B, H, Sq, v.shape[-1]), dtype=f32, device=q.device)
    for start in range(0, Skv, blk):
        kb, vb = k[:, start:start + blk], v[:, start:start + blk]
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kb.to(f32))
        if causal:
            mask = _causal_mask(Sq, blk, q_offset - start, q.device)
            s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, vb.to(f32))
        m = m_new
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    return o.movedim(1, 2).to(q.dtype)                        # (B,Sq,H,hd)


def attention(q, k, v, *, causal: bool = True, q_offset=0,
              flash_threshold: int = 2048,
              use_flash_kernel: bool = False) -> torch.Tensor:
    """GQA-aware attention: k/v may have fewer heads (H % KVH == 0).

    The routing rule of the JAX package: full-sequence attention (q_offset
    0, Sq == Skv >= 512) goes to the flash-attention kernel K13 when
    `use_flash_kernel` is set, with k/v at their own head count (the
    kernel maps query head h to kv head h // (H // KVH)), which carries
    gradients through K13-dq and K13-dkv when grad is enabled; otherwise
    the plain score matrix up to `flash_threshold` keys, the
    online-softmax oracle above."""
    Sq, H, KVH = q.shape[1], q.shape[2], k.shape[2]
    if (use_flash_kernel and q_offset == 0 and Sq == k.shape[1]
            and Sq >= 512):
        return flash_attention(q, k, v, causal=causal)
    if H != KVH:
        k = k.repeat_interleave(H // KVH, dim=2)
        v = v.repeat_interleave(H // KVH, dim=2)
    if k.shape[1] <= flash_threshold:
        return _plain_attention(q, k, v, causal, q_offset)
    return _flash_attention(q, k, v, causal, q_offset)


# ---------------------------------------------------------------------------
# GQA attention layer (with KV-cache decode)
# ---------------------------------------------------------------------------


def spec_attention(cfg) -> dict:
    d, H, KVH = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    return {
        "wq": P((d, H, hd), ("fsdp", "tp", None)),
        "wk": P((d, KVH, hd), ("fsdp", "tp", None)),
        "wv": P((d, KVH, hd), ("fsdp", "tp", None)),
        "wo": P((H, hd, d), ("tp", None, "fsdp")),
    }


def _project(x, w):
    """x (B, S, D) @ w (D, heads, hd) -> (B, S, heads, hd)."""
    D, n, hd = w.shape
    return (x @ w.reshape(D, n * hd)).reshape(*x.shape[:-1], n, hd)


def apply_attention(p, x, cfg, *, positions=None, causal=True,
                    kv_cache=None, cache_pos=None):
    """x: (B,S,D).  Modes:
      * prefill: kv_cache None — full-sequence attention, through K13 under
        the routing rule of `attention` when cfg.use_flash_kernel is set
      * decode: kv_cache {"k","v"} (B,Smax,KVH,hd), cache_pos an int —
        writes this step's K/V at cache_pos (clamped to [0, Smax - S], as
        JAX's dynamic_update_slice clamps it), then attends to the prefix
        with q_offset=cache_pos.  The cache is updated IN PLACE (JAX
        returns a new one); the returned cache is the same dict.
    Returns (out (B,S,D), the cache or None)."""
    B, S, D = x.shape
    q, k, v = (_project(x, p[w]) for w in ("wq", "wk", "wv"))
    if positions is None:
        positions = torch.arange(S, device=x.device)
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if kv_cache is not None:
        kc, vc = kv_cache["k"], kv_cache["v"]
        pos = int(cache_pos)
        if S > kc.shape[1]:
            raise ValueError(f"{S} tokens exceed the cache's {kc.shape[1]} "
                             "positions")
        # dynamic_update_slice's rule: the write starts at pos clamped to
        # [0, Smax - S]; the attention still takes q_offset = pos
        start = min(max(pos, 0), kc.shape[1] - S)
        kc[:, start:start + S] = k.to(kc.dtype)
        vc[:, start:start + S] = v.to(vc.dtype)
        o = attention(q, kc, vc, causal=True, q_offset=pos)
    else:
        o = attention(q, k, v, causal=causal, q_offset=0,
                      use_flash_kernel=cfg.use_flash_kernel)
    H, hd = o.shape[2], o.shape[3]
    out = o.reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, D)
    return out, kv_cache


def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                  device="cuda"):
    device = resolve_device(device)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def spec_mlp(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {"wi": P((d, f), ("fsdp", "tp")),
                "wg": P((d, f), ("fsdp", "tp")),
                "wo": P((f, d), ("tp", "fsdp"))}
    return {"wi": P((d, f), ("fsdp", "tp")),
            "wo": P((f, d), ("tp", "fsdp"))}


def apply_mlp(p, x, cfg):
    h = x @ p["wi"]
    if cfg.act == "swiglu":
        h = silu(h) * (x @ p["wg"])
    elif cfg.act == "gelu":
        h = gelu(h)
    elif cfg.act == "relu_sq":
        h = torch.square(torch.relu(h))
    else:
        raise ValueError(cfg.act)
    return h @ p["wo"]
