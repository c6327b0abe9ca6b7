"""Decoder-only dense transformer (port of `repro/models/transformer.py`,
the dense family: smollm, phi3, minitron).

Block = pre-norm GQA attention with RoPE + pre-norm MLP (SwiGLU, GELU or
squared ReLU), RMSNorm or LayerNorm; tied or separate head.  The tree keeps
JAX's shape: `blocks.dense` leaves carry a leading (n_layers, 1, ...) pair
of axes (layer groups of one dense layer each), so a bridged JAX tree runs
as it is.  Layers run as a Python loop over that stack where JAX scans.

Entry points, on (B, ...) tensors:
  forward      — logits over the whole sequence (the prefill step, and the
                 train step's forward); its attention goes through K13
                 under `layers.attention`'s routing rule when
                 cfg.use_flash_kernel is set, and with grad enabled each
                 layer is recomputed in the backward when cfg.remat is
                 set (JAX's `jax.checkpoint(dense_body)`)
  decode_step  — one token against the KV cache (plain attention)
MoE, MLA and VLM patches raise NotImplementedError until their slice
(ROADMAP Queue 1 item 9).  `decode_step` reads `pos` (the cache write
index), so the serving engine, which needs a position-free state, refuses
this family, as the JAX engine does.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import exact_matmuls, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.param import P, stack


def _check(cfg: ModelConfig):
    for on, what in ((cfg.n_experts, "MoE experts"), (cfg.use_mla, "MLA"),
                     (cfg.n_patches, "VLM patches")):
        if on:
            raise NotImplementedError(
                f"{cfg.name}: {what} are ported with the other transformer "
                "architectures (ROADMAP Queue 1 item 9); this slice is the "
                "dense family")


def _block_spec(cfg: ModelConfig) -> dict:
    return {
        "ln1": L.spec_norm(cfg.d_model, cfg.norm),
        "attn": L.spec_attention(cfg),
        "ln2": L.spec_norm(cfg.d_model, cfg.norm),
        "mlp": L.spec_mlp(cfg),
    }


def spec(cfg: ModelConfig) -> dict:
    _check(cfg)
    sp = {
        "embed": P((cfg.vocab, cfg.d_model), ("tp", "fsdp"), scale=0.02),
        "blocks": stack({"dense": stack(_block_spec(cfg), 1)}, cfg.n_layers),
        "ln_f": L.spec_norm(cfg.d_model, cfg.norm),
    }
    if not cfg.tie_embeddings:
        sp["head"] = P((cfg.d_model, cfg.vocab), ("fsdp", "tp"))
    return sp


def _layers(params, n_layers: int) -> list[dict]:
    """Every layer's weights: each `blocks.dense` leaf's [:, 0] split once
    with `unbind`, so autograd stacks the layers' gradients into one
    tensor a leaf, where indexing [i, 0] per layer would scatter each
    layer's gradient into a zero of the whole stack."""
    def split(t):
        return {k: split(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.select(1, 0).unbind(0)

    def pick(t, i):
        return {k: pick(v, i) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    per_leaf = split(params["blocks"]["dense"])
    return [pick(per_leaf, i) for i in range(n_layers)]


def _apply_block(p, x, cfg: ModelConfig, *, positions=None, kv_cache=None,
                 cache_pos=None):
    h, new_cache = L.apply_attention(
        p["attn"], L.apply_norm(p["ln1"], x, cfg.norm), cfg,
        positions=positions, kv_cache=kv_cache, cache_pos=cache_pos)
    x = x + h
    y = L.apply_norm(p["ln2"], x, cfg.norm)
    return x + L.apply_mlp(p["mlp"], y, cfg), new_cache


def _embed(params, tokens, cfg: ModelConfig):
    return params["embed"][tokens.long()].to(getattr(torch, cfg.dtype))


def _head(params, x, cfg: ModelConfig):
    x = L.apply_norm(params["ln_f"], x, cfg.norm)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ head.to(x.dtype)


def _dense_body(p, x, cfg: ModelConfig, positions):
    return _apply_block(p, x, cfg, positions=positions)[0]


@exact_matmuls()
def forward(params, batch: dict, cfg: ModelConfig):
    """batch: {"tokens": (B, S) int}; params in the compute dtype.
    Returns (logits (B, S, V), aux), aux a zero (no MoE loss).  With grad
    enabled and cfg.remat, each layer runs under a non-reentrant
    `checkpoint`: its activations are recomputed in the backward (K13's
    forward launches again there, as in JAX's remat)."""
    _check(cfg)
    x = _embed(params, batch["tokens"], cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in _layers(params, cfg.n_layers):
        if remat:
            x = checkpoint(_dense_body, lp, x, cfg, positions,
                           use_reentrant=False)
        else:
            x = _dense_body(lp, x, cfg, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(params, x, cfg), aux


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device="cuda"):
    """The KV cache of every layer: {"k", "v"} (L, B, max_len, KVH, hd)."""
    _check(cfg)
    if max_len < 1:
        raise ValueError(f"{cfg.name}: a KV cache needs max_len >= 1")
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_state_axes(cfg: ModelConfig):
    """Logical axes of the decode state (JAX's, with its default
    shard_kv_seq: the port has no mesh and reads only "layers" and
    "batch")."""
    ax = ("layers", "batch", "seq", "tp", None)
    return {"k": ax, "v": ax}


@exact_matmuls()
def decode_step(params, state, tokens, pos, cfg: ModelConfig):
    """One decode step.  tokens (B, 1); pos the cache write index (an int).
    Returns (logits (B, 1, V), the state), the state's caches updated in
    place at `pos`."""
    x = _embed(params, tokens, cfg)
    pos = int(pos)
    positions = pos + torch.arange(tokens.shape[1], device=x.device)
    for i, lp in enumerate(_layers(params, cfg.n_layers)):
        cache = {"k": state["k"][i], "v": state["v"][i]}
        x, _ = _apply_block(lp, x, cfg, positions=positions,
                            kv_cache=cache, cache_pos=pos)
    return _head(params, x, cfg), state
