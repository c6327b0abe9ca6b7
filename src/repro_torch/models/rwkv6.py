"""RWKV-6 "Finch" (arXiv:2404.05892), serving and training paths (port
of `repro/models/rwkv6.py`).

Block = TimeMix (ddlerp token shift -> r/k/v/w/g projections ->
multi-head WKV-6 recurrence -> GroupNorm -> SiLU(g) gate) + ChannelMix
(the squared-ReLU gated FFN of RWKV-4), each after a LayerNorm, plus the
pre-block ln0:

  ddlerp: xxx = x + dx·μ_x;  d = tanh(xxx @ maa_w1) @ maa_w2 -> 5 deltas
          x_s = x + dx·(μ_s + d_s)            for s in (w, k, v, r, g)
  decay:  w_t = exp(-exp(time_decay + tanh(x_w @ td_w1) @ td_w2))

Entry points, all on (B, ...) tensors with the JAX tree paths:
  decode_step              — per-op plain torch, the port's reference path
  decode_step_fused        — kernel K7 per layer, the head through K5
  decode_step_fused_model  — kernel K7 for all layers, the head through K5
  prefill_chunk            — chunk matmuls through K5, the WKV scan via K6
  forward                  — logits over a whole sequence (the prefill
                             and train steps): the WKV through K10 (S %
                             chunk == 0 and S > chunk) or K6, and under
                             grad through K10-bwd or K6-bwd, the
                             LayerNorms through K11 (K11-bwd), the matmuls
                             plain torch

Eager torch rounds every bf16 op, the rounding rule `exact_jit` pins for
JAX, so the plain path follows the JAX trace op for op.  Two places need
care: `jnp.var` is the biased variance, and `jax.nn.silu` is x·σ(x) with
σ in XLA's bf16 expansion (`layers.sigmoid`), which `F.silu` is not.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant.serving import (
    FusedLayerStack, broadcast_packed_scales, cast_compute,
    fuse_layer_stack, predecode_packed_leaves, prepare_layer_stack_params)
from repro_torch.core.wkv.wkv6 import wkv6_step
from repro_torch.device import exact_matmuls, resolve_device
from repro_torch.kernels.fused_decode import (
    RWKV6_STATE_KEYS as STATE_KEYS, rwkv6_block_decode, rwkv6_model_decode)
from repro_torch.kernels.fused_prefill import (
    chunk_matmul, gather_last_valid, last_valid_select, shifted_prev)
from repro_torch.kernels.wkv6 import wkv6_chunked_kernel, wkv6_seq
from repro_torch.models import layers as L
from repro_torch.models.param import P, stack
from repro_torch.models.layers import sigmoid, silu
from repro_torch.models.rwkv4 import _layer

MAA_RANK = 32   # low-rank dims of the data-dependent mixes (HF config: 32)
TD_RANK = 64    # low-rank dim of the data-dependent decay

# decode_step ignores `pos`, so slots in a serving pool may sit at
# unrelated sequence offsets within one step
DECODE_POS_FREE = True


def _block_spec(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    H, N = cfg.n_heads, cfg.rwkv_head_dim
    if H * N != d:
        raise ValueError(f"heads {H} x head_dim {N} != d_model {d}")
    return {
        "ln1": L.spec_norm(d),
        "ln2": L.spec_norm(d),
        "att": {
            "time_maa_x": P((d,), (None,), init="uniform", scale=0.5),
            # per-stream mus: w, k, v, r, g
            "time_maa": P((5, d), (None, None), init="uniform", scale=0.5),
            "maa_w1": P((d, 5 * MAA_RANK), (None, None), scale=0.01),
            "maa_w2": P((5, MAA_RANK, d), (None, None, None), scale=0.01),
            "time_decay": P((d,), (None,), init="zeros"),
            "td_w1": P((d, TD_RANK), (None, None), scale=0.01),
            "td_w2": P((TD_RANK, d), (None, None), scale=0.01),
            "time_faaaa": P((H, N), (None, None), init="zeros"),  # bonus u
            "wr": P((d, d), ("fsdp", "tp")),
            "wk": P((d, d), ("fsdp", "tp")),
            "wv": P((d, d), ("fsdp", "tp")),
            "wg": P((d, d), ("fsdp", "tp")),
            "wo": P((d, d), ("tp", "fsdp")),
            "ln_x": {"scale": P((d,), (None,), init="ones"),
                     "bias": P((d,), (None,), init="zeros")},
        },
        "ffn": {
            "time_mix_r": P((d,), (None,), init="uniform", scale=0.5),
            "time_mix_k": P((d,), (None,), init="uniform", scale=0.5),
            "wr": P((d, d), ("fsdp", "tp")),
            "wk": P((d, f), ("fsdp", "tp")),
            "wv": P((f, d), ("tp", "fsdp")),
        },
    }


def spec(cfg: ModelConfig) -> dict:
    return {
        "embed": P((cfg.vocab, cfg.d_model), ("tp", "fsdp"), scale=0.02),
        "ln0": L.spec_norm(cfg.d_model),
        "blocks": stack(_block_spec(cfg), cfg.n_layers),
        "ln_f": L.spec_norm(cfg.d_model),
        "head": P((cfg.d_model, cfg.vocab), ("fsdp", "tp")),
    }


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int = 0,
                      dtype=torch.float32, device="cuda"):
    """State per layer: att and ffn token-shift x (B, D), the WKV state
    (B, H, N, N).  max_len is ignored (O(1) state)."""
    del max_len
    device = resolve_device(device)
    Lc, D = cfg.n_layers, cfg.d_model
    H, N = cfg.n_heads, cfg.rwkv_head_dim
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return {"att_x": z(Lc, batch, D), "ffn_x": z(Lc, batch, D),
            "wkv_s": z(Lc, batch, H, N, N)}


def decode_state_axes(cfg: ModelConfig):
    return {"att_x": ("layers", "batch", None),
            "ffn_x": ("layers", "batch", None),
            "wkv_s": ("layers", "batch", "tp", None, None)}


# ---------------------------------------------------------------------------
# TimeMix internals (shared between the step and chunk forms)
# ---------------------------------------------------------------------------


def _ddlerp(p, x, dx, mm=torch.matmul):
    """Data-dependent token-shift mixes.  x, dx (..., D) -> (xw, xk, xv,
    xr, xg); `mm` is the maa_w1 product (chunk_matmul in the prefill)."""
    xxx = x + dx * p["time_maa_x"]
    lead = xxx.shape[:-1]
    dmix = torch.tanh(mm(xxx, p["maa_w1"])).reshape(*lead, 5, MAA_RANK)
    deltas = torch.einsum("...sr,srd->...sd", dmix, p["maa_w2"])
    mus = p["time_maa"] + deltas                      # (..., 5, D)
    return tuple(x + dx * mus[..., i, :] for i in range(5))


def _decay(p, xw, mm=torch.matmul):
    """w_t in (0, 1): exp(-exp(time_decay + lora(x_w))), in f32."""
    dd = p["time_decay"] + mm(torch.tanh(mm(xw, p["td_w1"])), p["td_w2"])
    return torch.exp(-torch.exp(dd.to(torch.float32)))


def _group_norm(p, y, H: int, eps: float = 64e-5):
    """Per-head LayerNorm (the official ln_x GroupNorm(H)) in f32, with
    the biased variance mean((y - μ)²) as `jnp.var` takes it."""
    lead = y.shape[:-1]
    yh = y.reshape(*lead, H, -1).to(torch.float32)
    mu = yh.mean(dim=-1, keepdim=True)
    c = yh - mu
    var = (c * c).mean(dim=-1, keepdim=True)
    yh = c * torch.rsqrt(var + eps)
    out = yh.reshape(*lead, -1) * p["scale"] + p["bias"]
    return out.to(y.dtype)


# ---------------------------------------------------------------------------
# Decode — O(1) state per token
# ---------------------------------------------------------------------------


def block_decode(lp, st, x, cfg: ModelConfig):
    """One layer's full decode step (exact numerics): ln1 -> ddlerp mixes
    -> r/k/v/w/g projections -> multi-head WKV-6 update -> GroupNorm ->
    SiLU-gated output, then ln2 -> channel mix.  x (B, D) residual; st
    this layer's state slice."""
    B = x.shape[0]
    H, N, D = cfg.n_heads, cfg.rwkv_head_dim, cfg.d_model
    f32 = torch.float32
    h = L.apply_norm(lp["ln1"], x)
    p = lp["att"]
    dx = st["att_x"].to(h.dtype) - h
    xw, xk, xv, xr, xg = _ddlerp(p, h, dx)
    r = (xr @ p["wr"]).reshape(B, H, N)
    k = (xk @ p["wk"]).reshape(B, H, N)
    v = (xv @ p["wv"]).reshape(B, H, N)
    g = silu(xg @ p["wg"])
    w = _decay(p, xw).reshape(B, H, N)
    S_new, y = wkv6_step(st["wkv_s"].to(f32), r.to(f32), k.to(f32),
                         v.to(f32), w, p["time_faaaa"].to(f32))
    y = _group_norm(p["ln_x"], y.reshape(B, D).to(h.dtype), H)
    x2 = x + (y * g) @ p["wo"]
    h2 = L.apply_norm(lp["ln2"], x2)
    p2 = lp["ffn"]
    ffn_x = st["ffn_x"].to(h2.dtype)
    mix = lambda m: h2 * p2[m] + ffn_x * (1.0 - p2[m])
    rr = sigmoid(mix("time_mix_r") @ p2["wr"])
    kk = torch.square(torch.relu(mix("time_mix_k") @ p2["wk"]))
    ffn = rr * (kk @ p2["wv"])
    new_st = {"att_x": h.to(st["att_x"].dtype),
              "ffn_x": h2.to(st["ffn_x"].dtype),
              "wkv_s": S_new.to(st["wkv_s"].dtype)}
    return x2 + ffn, new_st


def _stack_states(states: list) -> dict:
    return {k: torch.stack([s[k] for s in states]) for k in STATE_KEYS}


@exact_matmuls()
def decode_step(params, state, tokens, pos, cfg: ModelConfig):
    """Per-op plain decode; params already in the compute dtype (plain
    leaves).  tokens (B, 1) -> (logits (B, 1, V), new_state)."""
    del pos  # RWKV state is position-free
    dt = getattr(torch, cfg.dtype)
    x = params["embed"][tokens[:, 0].long()].to(dt)
    x = L.apply_norm(params["ln0"], x)
    new = []
    for i in range(cfg.n_layers):
        x, st = block_decode(_layer(params["blocks"], i),
                             {k: state[k][i] for k in STATE_KEYS}, x, cfg)
        new.append(st)
    x = L.apply_norm(params["ln_f"], x[:, None])
    return x @ params["head"].to(x.dtype), _stack_states(new)


def decode_step_fused(params, state, tokens, pos, cfg: ModelConfig, *,
                      bb: int | None = None):
    """Kernel decode: one K7 launch per layer and batch tile of `bb` lanes
    (default: the largest divisor of B up to 8), the head through K5 (or
    a torch matmul when plain), the W8, W4 or VQ planes decoded inside the
    kernels, plain bf16 matrices read as they are.  Embed, ln0 and ln_f
    stay plain
    torch, as the JAX package leaves them outside any kernel."""
    del pos
    dt = getattr(torch, cfg.dtype)
    params = cast_compute(params, dt)
    x = params["embed"][tokens[:, 0].long()].to(dt)
    x = L.apply_norm(params["ln0"], x)
    blocks = broadcast_packed_scales(params["blocks"], cfg.n_layers)
    new = []
    for i in range(cfg.n_layers):
        x, st = rwkv6_block_decode(_layer(blocks, i),
                                   {k: state[k][i] for k in STATE_KEYS}, x,
                                   cfg, bb=bb)
        new.append(st)
    x = L.apply_norm(params["ln_f"], x[:, None])
    return chunk_matmul(x, params["head"], dt), _stack_states(new)


def prepare_fused_model_params(params, cfg: ModelConfig):
    """One-time prep for the whole-model decode: the packed-aware compute
    cast, then the stacked blocks into per-dtype slabs
    (`fuse_layer_stack`).  `decode_step_fused_model` takes the result."""
    return prepare_layer_stack_params(params, cfg)


def decode_step_fused_model(params, state, tokens, pos, cfg: ModelConfig,
                            *, bb: int | None = None):
    """Kernel decode: ONE K7 launch a batch tile of `bb` lanes (default:
    the largest divisor of B up to 8) runs every layer, and the head goes
    through K5.  `params` is the output of `prepare_fused_model_params`
    (the serving path) or a raw tree, which is cast and fused here on
    every call."""
    del pos
    dt = getattr(torch, cfg.dtype)
    blocks = params["blocks"]
    if not isinstance(blocks, FusedLayerStack):
        params = cast_compute(params, dt)
        blocks = fuse_layer_stack(params["blocks"], cfg.n_layers)
    x = params["embed"][tokens[:, 0].long()].to(dt)
    x = L.apply_norm(params["ln0"], x)
    x, new_state = rwkv6_model_decode(blocks, state, x, cfg, bb=bb)
    x = L.apply_norm(params["ln_f"], x[:, None])
    return chunk_matmul(x, params["head"], dt), new_state


# ---------------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------------

# packed leaves block_prefill consumes OUTSIDE a matmul: element-wise
# mixes, the einsum'd low-rank delta table, and the WKV bonus
PREFILL_PLAIN_LEAVES = tuple(
    ("blocks", "att", k)
    for k in ("time_maa_x", "time_maa", "maa_w2", "time_faaaa"))


def prepare_prefill_params(params, cfg: ModelConfig):
    """One-time prep for the chunked prefill: decode the few packed leaves
    it consumes element-wise (`PREFILL_PLAIN_LEAVES`, 28 KB a layer at
    rwkv6-7b) with `unpack_leaf`, the per-op path's decode, so every
    remaining plane streams its codes into a chunk-matmul kernel."""
    del cfg
    return predecode_packed_leaves(params, PREFILL_PLAIN_LEAVES)


def block_prefill(lp, st, x, valid, cfg: ModelConfig):
    """One layer's chunked prefill over a (B, C, D) window: shifted-
    sequence ddlerp mixes, chunk-shaped r/k/v/w/g and low-rank matmuls
    (K5 on packed leaves), the masked sequential WKV-6 kernel (K6, state
    snapped to the pool dtype every step), GroupNorm and the gate, then
    the chunk-shaped channel mix.  Matches scanning `block_decode` over
    the window with the engine's per-step masked commits, for any
    per-slot PREFIX mask.  `lp` carries PREFILL_PLAIN_LEAVES plain."""
    B, C, D = x.shape
    H, N = cfg.n_heads, cfg.rwkv_head_dim
    dt = x.dtype
    f32 = torch.float32
    h = L.apply_norm(lp["ln1"], x)
    p = lp["att"]
    mm = lambda a, w_: chunk_matmul(a, w_, dt)
    # position t mixes with h[t-1] rounded through the state dtype; past
    # the valid prefix the carry freezes, as in the oracle's commits
    prev = shifted_prev(h.to(st["att_x"].dtype), st["att_x"], valid)
    dx = prev.to(h.dtype) - h
    xw, xk, xv, xr, xg = _ddlerp(p, h, dx, mm)
    r = mm(xr, p["wr"]).reshape(B, C, H, N)
    k = mm(xk, p["wk"]).reshape(B, C, H, N)
    v = mm(xv, p["wv"]).reshape(B, C, H, N)
    g = silu(mm(xg, p["wg"]))
    w = _decay(p, xw, mm).reshape(B, C, H, N)
    carry = str(st["wkv_s"].dtype).replace("torch.", "")
    y, S_new = wkv6_seq(r.to(f32), k.to(f32), v.to(f32), w,
                        p["time_faaaa"].to(f32), st["wkv_s"], valid=valid,
                        carry_dtype=carry)
    y = _group_norm(p["ln_x"], y.reshape(B, C, D).to(h.dtype), H)
    x2 = x + mm(y * g, p["wo"])
    h2 = L.apply_norm(lp["ln2"], x2)
    p2 = lp["ffn"]
    ffn_x = shifted_prev(h2.to(st["ffn_x"].dtype), st["ffn_x"],
                         valid).to(h2.dtype)
    mix = lambda m: h2 * p2[m] + ffn_x * (1.0 - p2[m])
    rr = sigmoid(mm(mix("time_mix_r"), p2["wr"]))
    kk = torch.square(torch.relu(mm(mix("time_mix_k"), p2["wk"])))
    ffn = rr * mm(kk, p2["wv"])
    n_valid = valid.to(torch.int32).sum(dim=1)
    new_st = {"att_x": last_valid_select(h, st["att_x"], n_valid),
              "ffn_x": last_valid_select(h2, st["ffn_x"], n_valid),
              # masked and snapped inside the kernel
              "wkv_s": S_new.to(st["wkv_s"].dtype)}
    return x2 + ffn, new_st


@exact_matmuls()
def prefill_chunk(params, state, tokens, valid, pos, cfg: ModelConfig, *,
                  all_logits: bool = False):
    """Chunked prefill: tokens (B, C) with a per-slot PREFIX validity mask
    (B, C) -> (new_state, last-valid logits (B, 1, V)).  Lanes with no
    valid token keep their state and return zero logits.  Takes the
    output of `prepare_prefill_params` (the serving path) or a raw tree,
    whose element-wise leaves are decoded here on every call.
    `all_logits=True` scores every position -> (new_state, (B, C, V)), as
    rwkv4's `prefill_chunk` does."""
    del pos
    dt = getattr(torch, cfg.dtype)
    params = cast_compute(prepare_prefill_params(params, cfg), dt)
    x = params["embed"][tokens.long()].to(dt)                 # (B, C, D)
    x = L.apply_norm(params["ln0"], x)
    blocks = broadcast_packed_scales(params["blocks"], cfg.n_layers)
    new = []
    for i in range(cfg.n_layers):
        x, st = block_prefill(_layer(blocks, i),
                              {k: state[k][i] for k in STATE_KEYS}, x,
                              valid, cfg)
        new.append(st)
    if all_logits:
        # ln_f a position at a time, at the (B, 1, D) shape of the last-
        # valid row below: a CUDA reduction's order depends on how many
        # rows it reduces, so one norm over all B·C rows could move a
        # row's bits; the head is one K5 call at M = B·C
        xf = torch.cat([L.apply_norm(params["ln_f"], x[:, j:j + 1])
                        for j in range(x.shape[1])], dim=1)
        logits = chunk_matmul(xf, params["head"], dt)
        return _stack_states(new), torch.where(
            valid[:, :, None], logits, torch.zeros_like(logits))
    n_valid = valid.to(torch.int32).sum(dim=1)
    xl = gather_last_valid(x, (n_valid - 1).clamp(min=0))[:, None]
    xl = L.apply_norm(params["ln_f"], xl)
    logits = chunk_matmul(xl, params["head"], dt)
    keep = (n_valid > 0)[:, None, None]
    return _stack_states(new), torch.where(keep, logits,
                                           torch.zeros_like(logits))


# ---------------------------------------------------------------------------
# Forward over a whole sequence (the prefill step)
# ---------------------------------------------------------------------------


def _wkv_operands(p, x, cfg: ModelConfig):
    """TimeMix's operands over a whole sequence x (B, S, D) from a zero
    carry: the ddlerp mixes, then r, k, v (B, S, H, N) in x's dtype, w
    (B, S, H, N) and u (H, N) in f32, and the SiLU gate g (B, S, D)."""
    B, S, _ = x.shape
    H, N = cfg.n_heads, cfg.rwkv_head_dim
    xw, xk, xv, xr, xg = _ddlerp(p, x, L.token_shift(x) - x)
    r = (xr @ p["wr"]).reshape(B, S, H, N)
    k = (xk @ p["wk"]).reshape(B, S, H, N)
    v = (xv @ p["wv"]).reshape(B, S, H, N)
    g = silu(xg @ p["wg"])
    w = _decay(p, xw).reshape(B, S, H, N)
    return r, k, v, w, p["time_faaaa"].to(torch.float32), g


def _time_mix_seq(p, x, cfg: ModelConfig, chunk: int):
    """TimeMix over a whole sequence x (B, S, D) from a zero carry: the
    operands, the WKV — K10 where S % chunk == 0 and S > chunk, else the
    exact sequential K6, as JAX picks `wkv6_chunked` or `wkv6_scan` —
    cast to r's dtype, GroupNorm and the gate.  Both WKV calls are the
    kernels' own forward calls (a zero initial state that takes no
    gradient, no mask, no snap), so under grad on the card they run
    through their autograd Functions, whose backward is K10-bwd or
    K6-bwd."""
    B, S, D = x.shape
    H, N = cfg.n_heads, cfg.rwkv_head_dim
    f32 = torch.float32
    r, k, v, w, u, g = _wkv_operands(p, x, cfg)
    if S % chunk == 0 and S > chunk:
        y, _ = wkv6_chunked_kernel(r, k, v, w, u, chunk=chunk)
    else:
        s0 = torch.zeros((B, H, N, N), dtype=f32, device=x.device)
        y, _ = wkv6_seq(r.to(f32), k.to(f32), v.to(f32), w, u, s0)
    y = _group_norm(p["ln_x"], y.to(r.dtype).reshape(B, S, D), H)
    return (y * g) @ p["wo"]


def _channel_mix_seq(p, x):
    """ChannelMix over a whole sequence from a zero carry."""
    xx = L.token_shift(x)
    mix = lambda m: x * p[m] + xx * (1.0 - p[m])
    r = sigmoid(mix("time_mix_r") @ p["wr"])
    k = torch.square(torch.relu(mix("time_mix_k") @ p["wk"]))
    return r * (k @ p["wv"])


def _block_seq(lp, x, cfg: ModelConfig, chunk: int):
    """One layer over a whole sequence: ln1 -> TimeMix -> residual, ln2 ->
    ChannelMix -> residual (JAX's `forward.body`)."""
    norm = L.layernorm_kernel
    x = x + _time_mix_seq(lp["att"], norm(lp["ln1"], x), cfg, chunk)
    return x + _channel_mix_seq(lp["ffn"], norm(lp["ln2"], x))


@exact_matmuls()
def forward(params, batch: dict, cfg: ModelConfig, *, chunk: int = 64):
    """batch {"tokens": (B, S) int}; params plain, in the compute dtype ->
    (logits (B, S, V), aux 0).  JAX's `rwkv6.forward` op for op: ln0, then
    per layer ln1 -> TimeMix -> residual, ln2 -> ChannelMix -> residual,
    ln_f and the head, every token shift from a zero carry.  With grad
    enabled and cfg.remat, each layer runs under a non-reentrant
    `checkpoint`, as JAX's `jax.checkpoint(body)`.  CPU tensors train
    through the plain versions, which autograd differentiates; on the card
    the WKV's gradients come from K10-bwd or K6-bwd and the LayerNorms'
    from K11-bwd (each forward call under remat runs twice, its backward
    once)."""
    dt = getattr(torch, cfg.dtype)
    x = params["embed"][batch["tokens"].long()].to(dt)
    x = L.layernorm_kernel(params["ln0"], x)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = _layer(params["blocks"], i)
        if remat:
            x = checkpoint(_block_seq, lp, x, cfg, chunk,
                           use_reentrant=False)
        else:
            x = _block_seq(lp, x, cfg, chunk)
    x = L.layernorm_kernel(params["ln_f"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x @ params["head"].to(x.dtype), aux
