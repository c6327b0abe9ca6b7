"""RWKV-4 — the paper's model, serving paths (port of `repro/models/rwkv4.py`).

Block = TimeMix (token shift -> r/k/v projections -> WKV recurrence ->
σ(r)-gated output) + ChannelMix (token shift -> squared-ReLU FFN with a
σ(r) gate), each after a LayerNorm, plus the pre-block ln0.

Entry points, all on (B, ...) tensors with the JAX tree paths:
  decode_step              — per-op plain torch, the port's reference path
  decode_step_fused        — kernel K3 per layer, the head through K5
  decode_step_fused_model  — kernel K4 for all layers, the head through K5
  prefill_chunk            — chunk matmuls through K5, the WKV scan via K2
K5 stands for the chunk matmul of the head's or the matrix's plane: K5
(W8), K5-W4 or K5-VQ.

Eager torch rounds every bf16 op, the rounding rule `exact_jit` pins for
JAX, so the plain path follows the JAX trace op for op.  Standard (exact)
numerics only; the paper's LUT/PWL hardware numerics are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant.serving import (
    FusedLayerStack, broadcast_packed_scales, cast_compute,
    fuse_layer_stack, prepare_layer_stack_params)
from repro_torch.core.wkv.wkv4 import WKV4State, wkv4_step
from repro_torch.device import exact_matmuls, resolve_device
from repro_torch.kernels.fused_decode import (
    STATE_KEYS, rwkv4_block_decode, rwkv4_model_decode)
from repro_torch.kernels.fused_prefill import (
    chunk_matmul, gather_last_valid, last_valid_select, shifted_prev)
from repro_torch.kernels.wkv4 import wkv4_seq
from repro_torch.models import layers as L
from repro_torch.models.param import P, stack

# decode_step ignores `pos`, so slots in a serving pool may sit at
# unrelated sequence offsets within one step
DECODE_POS_FREE = True


def _block_spec(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "ln1": L.spec_norm(d),
        "ln2": L.spec_norm(d),
        "att": {
            "time_mix_r": P((d,), (None,), init="uniform", scale=0.5),
            "time_mix_k": P((d,), (None,), init="uniform", scale=0.5),
            "time_mix_v": P((d,), (None,), init="uniform", scale=0.5),
            "time_decay": P((d,), (None,), init="zeros"),   # w = exp(·)
            "time_first": P((d,), (None,), init="zeros"),   # bonus u
            "wr": P((d, d), ("fsdp", "tp")),
            "wk": P((d, d), ("fsdp", "tp")),
            "wv": P((d, d), ("fsdp", "tp")),
            "wo": P((d, d), ("tp", "fsdp")),
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
    """State per layer: att token-shift x, ffn token-shift x, wkv (a,b,o).
    max_len is ignored (O(1) state)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.d_model)
    z = lambda: torch.zeros(shape, dtype=dtype, device=device)
    return {"att_x": z(), "ffn_x": z(), "wkv_a": z(), "wkv_b": z(),
            "wkv_o": torch.full(shape, -1e38, dtype=dtype, device=device)}


def decode_state_axes(cfg: ModelConfig):
    ax = ("layers", "batch", None)
    return {k: ax for k in STATE_KEYS}


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """σ(x) = 1 / (1 + exp(-x)), each op rounded in x's dtype: how XLA
    expands `jax.nn.sigmoid` (lax.logistic) for bf16, so the port rounds
    where the JAX reference does (`torch.sigmoid` rounds once, and
    differs from it in about a third of bf16 outputs)."""
    return torch.reciprocal(1.0 + torch.exp(-x))


def _layer(tree, i: int):
    """Layer i of a stacked tree (packed leaves slice both planes)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _stack_states(states: list) -> dict:
    return {k: torch.stack([s[k] for s in states]) for k in STATE_KEYS}


def block_decode(lp, st, x):
    """One layer's full decode step (exact numerics): ln1 -> token-shift
    mix -> r/k/v matvecs -> WKV update -> gated output, then ln2 ->
    channel mix.  x (B, D) residual; st this layer's state slice."""
    att_x, ffn_x = st["att_x"], st["ffn_x"]
    f32 = torch.float32
    wkv = WKV4State(st["wkv_a"].to(f32), st["wkv_b"].to(f32),
                    st["wkv_o"].to(f32))
    h = L.apply_norm(lp["ln1"], x)
    p = lp["att"]
    mix = lambda m: h * p[m] + att_x * (1.0 - p[m])
    r = mix("time_mix_r") @ p["wr"]
    k = mix("time_mix_k") @ p["wk"]
    v = mix("time_mix_v") @ p["wv"]
    w = torch.exp(p["time_decay"].to(f32))
    new_wkv, out = wkv4_step(wkv, k.to(f32), v.to(f32), w,
                             p["time_first"].to(f32))
    att = (sigmoid(r) * out.to(r.dtype)) @ p["wo"]
    x2 = x + att.to(x.dtype)
    h2 = L.apply_norm(lp["ln2"], x2)
    p = lp["ffn"]
    mix2 = lambda m: h2 * p[m] + ffn_x * (1.0 - p[m])
    rr = sigmoid(mix2("time_mix_r") @ p["wr"])
    kk = torch.square(torch.relu(mix2("time_mix_k") @ p["wk"]))
    ffn = rr * (kk @ p["wv"])
    new_st = {"att_x": h.to(att_x.dtype),
              "ffn_x": h2.to(ffn_x.dtype),
              "wkv_a": new_wkv.a.to(st["wkv_a"].dtype),
              "wkv_b": new_wkv.b.to(st["wkv_b"].dtype),
              "wkv_o": new_wkv.o.to(st["wkv_o"].dtype)}
    return x2 + ffn.to(x2.dtype), new_st


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
                             {k: state[k][i] for k in STATE_KEYS}, x)
        new.append(st)
    x = L.apply_norm(params["ln_f"], x[:, None])
    return x @ params["head"].to(x.dtype), _stack_states(new)


def decode_step_fused(params, state, tokens, pos, cfg: ModelConfig):
    """Kernel decode: one K3 launch per layer, the head through K5, the
    packed W8 leaves decoded inside the kernels.  Embed, ln0 and ln_f stay
    plain torch, as the JAX package leaves them outside any kernel."""
    del pos
    dt = getattr(torch, cfg.dtype)
    params = cast_compute(params, dt)
    x = params["embed"][tokens[:, 0].long()].to(dt)
    x = L.apply_norm(params["ln0"], x)
    blocks = broadcast_packed_scales(params["blocks"], cfg.n_layers)
    new = []
    for i in range(cfg.n_layers):
        x, st = rwkv4_block_decode(_layer(blocks, i),
                                   {k: state[k][i] for k in STATE_KEYS}, x)
        new.append(st)
    x = L.apply_norm(params["ln_f"], x[:, None])
    return chunk_matmul(x, params["head"], dt), _stack_states(new)


def prepare_fused_model_params(params, cfg: ModelConfig):
    """One-time prep for the whole-model decode: the packed-aware compute
    cast, then the stacked blocks into per-dtype slabs
    (`fuse_layer_stack`).  `decode_step_fused_model` takes the result."""
    return prepare_layer_stack_params(params, cfg)


def decode_step_fused_model(params, state, tokens, pos, cfg: ModelConfig):
    """Kernel decode: ONE K4 launch runs every layer, the residual kept on
    chip between them, and the head goes through K5.  `params` is the
    output of `prepare_fused_model_params` (the serving path) or a raw
    tree, which is cast and fused here on every call.  Embed, ln0 and ln_f
    stay plain torch, as the JAX package leaves them outside any
    kernel."""
    del pos
    dt = getattr(torch, cfg.dtype)
    blocks = params["blocks"]
    if not isinstance(blocks, FusedLayerStack):
        params = cast_compute(params, dt)
        blocks = fuse_layer_stack(params["blocks"], cfg.n_layers)
    x = params["embed"][tokens[:, 0].long()].to(dt)
    x = L.apply_norm(params["ln0"], x)
    x, new_state = rwkv4_model_decode(blocks, state, x)
    x = L.apply_norm(params["ln_f"], x[:, None])
    return chunk_matmul(x, params["head"], dt), new_state


def block_prefill(lp, st, x, valid):
    """One layer's chunked prefill over a (B, C, D) window: chunk-shaped
    r/k/v matmuls (K5 on packed leaves), the masked WKV sequence kernel
    (K2, state snapped to the pool dtype every step), then the chunk-shaped
    channel mix.  Matches scanning `block_decode` over the window with the
    engine's per-step masked commits, for any per-slot PREFIX mask."""
    dt = x.dtype
    f32 = torch.float32
    att_x, ffn_x = st["att_x"], st["ffn_x"]
    h = L.apply_norm(lp["ln1"], x)
    p = lp["att"]
    # position t mixes with h[t-1] rounded through the state dtype; past
    # the valid prefix the carry freezes, as in the oracle's commits
    hx = shifted_prev(h.to(att_x.dtype), att_x, valid)
    mm = lambda a, w_: chunk_matmul(a, w_, dt)
    mix = lambda m: h * p[m] + hx * (1.0 - p[m])
    r = mm(mix("time_mix_r"), p["wr"])
    k = mm(mix("time_mix_k"), p["wk"])
    v = mm(mix("time_mix_v"), p["wv"])
    w = torch.exp(p["time_decay"].to(f32))
    carry = str(st["wkv_a"].dtype).replace("torch.", "")
    out, (af, bf, of) = wkv4_seq(
        k.to(f32), v.to(f32), w, p["time_first"].to(f32),
        st["wkv_a"].to(f32), st["wkv_b"].to(f32), st["wkv_o"].to(f32),
        valid=valid, carry_dtype=carry)
    att = mm(sigmoid(r) * out.to(r.dtype), p["wo"])
    x2 = x + att.to(x.dtype)
    h2 = L.apply_norm(lp["ln2"], x2)
    p = lp["ffn"]
    h2x = shifted_prev(h2.to(ffn_x.dtype), ffn_x, valid)
    mix2 = lambda m: h2 * p[m] + h2x * (1.0 - p[m])
    rr = sigmoid(mm(mix2("time_mix_r"), p["wr"]))
    kk = torch.square(torch.relu(mm(mix2("time_mix_k"), p["wk"])))
    ffn = rr * mm(kk, p["wv"])
    n_valid = valid.to(torch.int32).sum(dim=1)
    new_st = {"att_x": last_valid_select(h, att_x, n_valid),
              "ffn_x": last_valid_select(h2, ffn_x, n_valid),
              # the WKV finals are masked and snapped inside the kernel
              "wkv_a": af.to(st["wkv_a"].dtype),
              "wkv_b": bf.to(st["wkv_b"].dtype),
              "wkv_o": of.to(st["wkv_o"].dtype)}
    return x2 + ffn.to(x2.dtype), new_st


@exact_matmuls()
def prefill_chunk(params, state, tokens, valid, pos, cfg: ModelConfig):
    """Chunked prefill: tokens (B, C) with a per-slot PREFIX validity mask
    (B, C) -> (new_state, last-valid logits (B, 1, V)).  Lanes with no
    valid token keep their state and return zero logits."""
    del pos
    dt = getattr(torch, cfg.dtype)
    params = cast_compute(params, dt)
    x = params["embed"][tokens.long()].to(dt)                 # (B, C, D)
    x = L.apply_norm(params["ln0"], x)
    blocks = broadcast_packed_scales(params["blocks"], cfg.n_layers)
    new = []
    for i in range(cfg.n_layers):
        x, st = block_prefill(_layer(blocks, i),
                              {k: state[k][i] for k in STATE_KEYS}, x, valid)
        new.append(st)
    n_valid = valid.to(torch.int32).sum(dim=1)
    xl = gather_last_valid(x, (n_valid - 1).clamp(min=0))[:, None]
    xl = L.apply_norm(params["ln_f"], xl)
    logits = chunk_matmul(xl, params["head"], dt)
    keep = (n_valid > 0)[:, None, None]
    return _stack_states(new), torch.where(keep, logits,
                                           torch.zeros_like(logits))
