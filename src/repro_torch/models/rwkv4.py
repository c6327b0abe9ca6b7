"""RWKV-4 — the paper's model, serving paths (port of `repro/models/rwkv4.py`).

Block = TimeMix (token shift -> r/k/v projections -> WKV recurrence ->
σ(r)-gated output) + ChannelMix (token shift -> squared-ReLU FFN with a
σ(r) gate), each after a LayerNorm, plus the pre-block ln0.

Entry points, all on (B, ...) tensors with the JAX tree paths:
  decode_step              — per-op plain torch, the port's reference path
  decode_step_fused        — kernel K3 per layer, the head through K5
  decode_step_fused_model  — kernel K4 for all layers, the head through K5
  prefill_chunk            — chunk matmuls through K5, the WKV scan via K2
  forward                  — logits over a whole sequence (the prefill
                             step, and the train step under grad): the
                             WKV through K2, the LayerNorms through K11
                             (their gradients through K2-bwd and K11-bwd),
                             σ under hw through K9, the matmuls plain
                             torch
K5 stands for the chunk matmul of the head's or the matrix's plane: K5
(W8), K5-W4 or K5-VQ.

Eager torch rounds every bf16 op, the rounding rule `exact_jit` pins for
JAX, so the plain path follows the JAX trace op for op.

Two numerics, chosen by `hw=` as in the JAX package:
  standard  exact exp and division, XLA's bf16 σ expansion
  hw        the accelerator's (paper §3-4): LUT exp, PWL σ and LUT division
            (`core/approx`), activations fake-quantized to 9 bits (A9,
            `core/quant/uniform.py`) over the whole (B, features) tensor.
            The units return f32, so y, att, rr and ffn stay f32 where
            the standard numerics hold bf16.  The kernels take the EXP and
            DIV tables as operands (the paper's on-chip LUTs): K2 and K3 as
            arguments, K4 as the prepared stack's `_luts` leaves.  Because
            A9 spans the batch, a lane's bits depend on its batchmates, so
            the serving engine stays on the standard numerics (as the JAX
            engine does) and `launch/serve.py --legacy --hw-numerics`
            serves a fixed batch.  `forward` applies A9 over the whole
            (B, S, features) tensor, as JAX's forward does.
JAX's `cfg.wkv_stub` (dry-run instrumentation) waits for the analysis
tools (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.approx.units import (
    div_lut, exp_lut, lut_tensor, sigmoid_pwl)
from repro_torch.core.quant.serving import (
    FusedLayerStack, broadcast_packed_scales, cast_compute,
    prepare_layer_stack_params)
from repro_torch.core.quant.uniform import uniform_fake_quant
from repro_torch.core.wkv.wkv4 import WKV4State, wkv4_step
from repro_torch.device import exact_matmuls, resolve_device
from repro_torch.kernels.expsig import sigmoid_kernel
from repro_torch.kernels.fused_decode import (
    STATE_KEYS, rwkv4_block_decode, rwkv4_model_decode, stack_luts)
from repro_torch.kernels.fused_prefill import (
    chunk_matmul, gather_last_valid, last_valid_select, shifted_prev)
from repro_torch.kernels.wkv4 import wkv4_seq
from repro_torch.models import layers as L
from repro_torch.models.layers import sigmoid
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


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------


class _Std:
    hw = False
    exp = staticmethod(torch.exp)
    sigmoid = staticmethod(sigmoid)
    div = None                    # wkv4_step's exact x / y
    act_q = staticmethod(lambda x: x)


class _Hw:
    """Paper numerics: LUT exp, PWL sigmoid, LUT division, A9 activations
    (one scale over the whole tensor)."""
    hw = True
    exp = staticmethod(exp_lut)
    sigmoid = staticmethod(sigmoid_pwl)
    div = staticmethod(div_lut)
    act_q = staticmethod(lambda x: uniform_fake_quant(x, 9, None))


def _numerics(hw: bool):
    return _Hw if hw else _Std


def _hw_numerics_with_tables(exp_table, div_table):
    """_Hw with the LUTs bound as explicit tensors, as the kernels take
    them."""
    class _HwTabled(_Hw):
        exp = staticmethod(lambda x: exp_lut(x, table=exp_table))
        div = staticmethod(lambda a, b: div_lut(a, b, table=div_table))
    return _HwTabled


def _chunk_numerics(hw: bool):
    """The chunked prefill's numerics: the same units, with A9 scoped per
    token position (axis 1 of a (B, C, ...) chunk tensor), so that each
    position sees the (B, features) grain the per-step oracle applies, and
    σ through the EXP-σ kernel K9 (its plain version on the CPU)."""
    if not hw:
        return _Std

    class _HwChunk(_Hw):
        sigmoid = staticmethod(lambda x: sigmoid_kernel(x.to(torch.float32)))
        act_q = staticmethod(lambda x: uniform_fake_quant(x, 9, 1))
    return _HwChunk


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w with JAX's promotion: an f32 activation widens bf16 weights
    (exactly) and the product is f32."""
    return a @ w if a.dtype == w.dtype else a @ w.to(a.dtype)


def _layer(tree, i: int):
    """Layer i of a stacked tree (packed leaves slice both planes)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _stack_states(states: list) -> dict:
    return {k: torch.stack([s[k] for s in states]) for k in STATE_KEYS}


def block_decode(lp, st, x, nm=_Std):
    """One layer's full decode step: ln1 -> token-shift mix -> r/k/v
    matvecs -> WKV update -> gated output, then ln2 -> channel mix, under
    the numerics `nm`.  x (B, D) residual; st this layer's state slice."""
    att_x, ffn_x = st["att_x"], st["ffn_x"]
    f32 = torch.float32
    wkv = WKV4State(st["wkv_a"].to(f32), st["wkv_b"].to(f32),
                    st["wkv_o"].to(f32))
    h = L.apply_norm(lp["ln1"], x)
    p = lp["att"]
    mix = lambda m: nm.act_q(h * p[m] + att_x * (1.0 - p[m]))
    # an f32 state makes the mixes f32 (JAX's promotion); _mm widens
    r = _mm(mix("time_mix_r"), p["wr"])
    k = _mm(mix("time_mix_k"), p["wk"])
    v = _mm(mix("time_mix_v"), p["wv"])
    w = torch.exp(p["time_decay"].to(f32))
    new_wkv, out = wkv4_step(wkv, k.to(f32), v.to(f32), w,
                             p["time_first"].to(f32), exp=nm.exp,
                             div=nm.div)
    att = _mm(nm.act_q(nm.sigmoid(r) * out.to(r.dtype)), p["wo"])
    x2 = x + att.to(x.dtype)
    h2 = L.apply_norm(lp["ln2"], x2)
    p = lp["ffn"]
    mix2 = lambda m: nm.act_q(h2 * p[m] + ffn_x * (1.0 - p[m]))
    rr = nm.sigmoid(_mm(mix2("time_mix_r"), p["wr"]))
    kk = torch.square(torch.relu(_mm(mix2("time_mix_k"), p["wk"])))
    ffn = nm.act_q(rr * _mm(nm.act_q(kk), p["wv"]))
    new_st = {"att_x": h.to(att_x.dtype),
              "ffn_x": h2.to(ffn_x.dtype),
              "wkv_a": new_wkv.a.to(st["wkv_a"].dtype),
              "wkv_b": new_wkv.b.to(st["wkv_b"].dtype),
              "wkv_o": new_wkv.o.to(st["wkv_o"].dtype)}
    return x2 + ffn.to(x2.dtype), new_st


@exact_matmuls()
def decode_step(params, state, tokens, pos, cfg: ModelConfig, *,
                hw: bool = False):
    """Per-op plain decode; params already in the compute dtype (plain
    leaves).  tokens (B, 1) -> (logits (B, 1, V), new_state)."""
    del pos  # RWKV state is position-free
    nm = _numerics(hw)
    dt = getattr(torch, cfg.dtype)
    x = params["embed"][tokens[:, 0].long()].to(dt)
    x = L.apply_norm(params["ln0"], x)
    new = []
    for i in range(cfg.n_layers):
        x, st = block_decode(_layer(params["blocks"], i),
                             {k: state[k][i] for k in STATE_KEYS}, x, nm)
        new.append(st)
    x = L.apply_norm(params["ln_f"], x[:, None])
    return x @ params["head"].to(x.dtype), _stack_states(new)


def _lut_operands(device, n_layers: int | None = None):
    """The EXP and DIV tables as kernel operands {"exp", "div"}: (256,)
    for K3, or (n_layers, 256) broadcast views for a stack (a leading 1
    makes them shared aux leaves of K4's slab form)."""
    out = {k: lut_tensor(k, device) for k in ("exp", "div")}
    if n_layers is not None:
        out = {k: t.expand(n_layers, 256) for k, t in out.items()}
    return out


def decode_step_fused(params, state, tokens, pos, cfg: ModelConfig, *,
                      hw: bool = False):
    """Kernel decode: one K3 launch per layer, the head through K5 (or a
    torch matmul when plain), the plane leaves decoded inside the kernels
    and plain bf16 matrices read as they are; `hw` passes the EXP and
    DIV tables to K3.  Embed, ln0 and ln_f stay plain torch, as the JAX
    package leaves them outside any kernel."""
    del pos
    dt = getattr(torch, cfg.dtype)
    params = cast_compute(params, dt)
    x = params["embed"][tokens[:, 0].long()].to(dt)
    x = L.apply_norm(params["ln0"], x)
    blocks = broadcast_packed_scales(params["blocks"], cfg.n_layers)
    luts = _lut_operands(x.device) if hw else None
    new = []
    for i in range(cfg.n_layers):
        x, st = rwkv4_block_decode(_layer(blocks, i),
                                   {k: state[k][i] for k in STATE_KEYS}, x,
                                   luts=luts)
        new.append(st)
    x = L.apply_norm(params["ln_f"], x[:, None])
    return chunk_matmul(x, params["head"], dt), _stack_states(new)


def prepare_fused_model_params(params, cfg: ModelConfig, *,
                               hw: bool = False):
    """One-time prep for the whole-model decode: the packed-aware compute
    cast, then the stacked blocks into per-dtype slabs
    (`fuse_layer_stack`), with the EXP and DIV tables as the `_luts` aux
    leaves when `hw`.  `decode_step_fused_model` takes the result."""
    extra = {"_luts": _lut_operands(params["embed"].device, 1)} if hw \
        else None
    return prepare_layer_stack_params(params, cfg, extra)


def _stack_has_luts(stack: FusedLayerStack) -> bool:
    """Whether a prepared stack carries the hw LUT operands."""
    return stack_luts(stack) is not None


def decode_step_fused_model(params, state, tokens, pos, cfg: ModelConfig, *,
                            hw: bool = False, bb: int | None = None):
    """Kernel decode: ONE K4 launch runs every layer, the residual passed
    between them as a bf16 row, and the head goes through K5.  `params` is the
    output of `prepare_fused_model_params` (the serving path; its `hw`
    must be this call's) or a raw tree, which is cast and fused here on
    every call.  `bb` is K4's batch tile (under hw each tile takes its own
    A9 scale).  Embed, ln0 and ln_f stay plain torch, as the JAX package
    leaves them outside any kernel."""
    del pos
    dt = getattr(torch, cfg.dtype)
    blocks = params["blocks"]
    prepared = isinstance(blocks, FusedLayerStack)
    if prepared and _stack_has_luts(blocks) != hw:
        raise ValueError(
            f"prepared params were built with hw={not hw} but decode was "
            f"called with hw={hw}; rebuild them with "
            "prepare_fused_model_params(params, cfg, hw=...)")
    if not prepared:
        params = prepare_fused_model_params(params, cfg, hw=hw)
        blocks = params["blocks"]
    x = params["embed"][tokens[:, 0].long()].to(dt)
    x = L.apply_norm(params["ln0"], x)
    x, new_state = rwkv4_model_decode(blocks, state, x, bb=bb)
    x = L.apply_norm(params["ln_f"], x[:, None])
    return chunk_matmul(x, params["head"], dt), new_state


def block_prefill(lp, st, x, valid, nm=_Std, *, hw: bool = False):
    """One layer's chunked prefill over a (B, C, D) window: chunk-shaped
    r/k/v matmuls (K5 on packed leaves), the masked WKV sequence kernel
    (K2, state snapped to the pool dtype every step; its LUT form when
    `hw`), then the chunk-shaped channel mix, under the chunk numerics
    `nm`.  Matches scanning `block_decode` over the window with the
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
    mix = lambda m: nm.act_q(h * p[m] + hx * (1.0 - p[m]))
    r = mm(mix("time_mix_r"), p["wr"])
    k = mm(mix("time_mix_k"), p["wk"])
    v = mm(mix("time_mix_v"), p["wv"])
    w = torch.exp(p["time_decay"].to(f32))
    carry = str(st["wkv_a"].dtype).replace("torch.", "")
    tables = {}
    if hw:
        luts = _lut_operands(x.device)
        tables = {"exp_table": luts["exp"], "div_table": luts["div"]}
    out, (af, bf, of) = wkv4_seq(
        k.to(f32), v.to(f32), w, p["time_first"].to(f32),
        st["wkv_a"].to(f32), st["wkv_b"].to(f32), st["wkv_o"].to(f32),
        valid=valid, carry_dtype=carry, **tables)
    att = mm(nm.act_q(nm.sigmoid(r) * out.to(r.dtype)), p["wo"])
    x2 = x + att.to(x.dtype)
    h2 = L.apply_norm(lp["ln2"], x2)
    p = lp["ffn"]
    h2x = shifted_prev(h2.to(ffn_x.dtype), ffn_x, valid)
    mix2 = lambda m: nm.act_q(h2 * p[m] + h2x * (1.0 - p[m]))
    rr = nm.sigmoid(mm(mix2("time_mix_r"), p["wr"]))
    kk = torch.square(torch.relu(mm(mix2("time_mix_k"), p["wk"])))
    ffn = nm.act_q(rr * mm(nm.act_q(kk), p["wv"]))
    n_valid = valid.to(torch.int32).sum(dim=1)
    new_st = {"att_x": last_valid_select(h, att_x, n_valid),
              "ffn_x": last_valid_select(h2, ffn_x, n_valid),
              # the WKV finals are masked and snapped inside the kernel
              "wkv_a": af.to(st["wkv_a"].dtype),
              "wkv_b": bf.to(st["wkv_b"].dtype),
              "wkv_o": of.to(st["wkv_o"].dtype)}
    return x2 + ffn.to(x2.dtype), new_st


@exact_matmuls()
def prefill_chunk(params, state, tokens, valid, pos, cfg: ModelConfig, *,
                  hw: bool = False, all_logits: bool = False):
    """Chunked prefill: tokens (B, C) with a per-slot PREFIX validity mask
    (B, C) -> (new_state, last-valid logits (B, 1, V)).  Lanes with no
    valid token keep their state and return zero logits.

    `all_logits=True` scores every position instead -> (new_state,
    (B, C, V)): after ln_f the head runs over the whole chunk, K5 at
    M = B·C, and invalid positions give zero logits.  Row n_valid - 1
    equals the last-valid logits bit for bit: ln_f runs at the last-valid
    row's shape, and K5's row bits do not depend on M."""
    del pos
    nm = _chunk_numerics(hw)
    dt = getattr(torch, cfg.dtype)
    params = cast_compute(params, dt)
    x = params["embed"][tokens.long()].to(dt)                 # (B, C, D)
    x = L.apply_norm(params["ln0"], x)
    blocks = broadcast_packed_scales(params["blocks"], cfg.n_layers)
    new = []
    for i in range(cfg.n_layers):
        x, st = block_prefill(_layer(blocks, i),
                              {k: state[k][i] for k in STATE_KEYS}, x, valid,
                              nm, hw=hw)
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


def _seq_numerics(hw: bool):
    """The forward's numerics: the same units, A9 over the whole tensor,
    and under hw σ through the EXP-σ kernel K9 (its plain version on the
    CPU)."""
    if not hw:
        return _Std

    class _HwSeq(_Hw):
        sigmoid = staticmethod(lambda x: sigmoid_kernel(x.to(torch.float32)))
    return _HwSeq


def _wkv_operands(p, x, nm):
    """TimeMix's operands over a whole sequence x (B, S, D) from a zero
    carry: r, and K2's arguments as the forward hands them — k, v, w, u
    in f32 and the zero state (a, b 0, o -1e38) — with the EXP and DIV
    tables under hw."""
    f32 = torch.float32
    xx = L.token_shift(x)
    mix = lambda m: nm.act_q(x * p[m] + xx * (1.0 - p[m]))
    r = _mm(mix("time_mix_r"), p["wr"])
    k = _mm(mix("time_mix_k"), p["wk"])
    v = _mm(mix("time_mix_v"), p["wv"])
    B, D = k.shape[0], k.shape[-1]
    z = lambda: torch.zeros((B, D), dtype=f32, device=x.device)
    args = (k.to(f32), v.to(f32), torch.exp(p["time_decay"].to(f32)),
            p["time_first"].to(f32), z(), z(),
            torch.full((B, D), -1e38, dtype=f32, device=x.device))
    tables = {}
    if nm.hw:
        luts = _lut_operands(x.device)
        tables = {"exp_table": luts["exp"], "div_table": luts["div"]}
    return r, args, tables


def _time_mix_seq(p, x, nm):
    """TimeMix over a whole sequence: the mixes, the r/k/v products, the
    WKV over every position through K2 (its LUT form under hw) from the
    zero state, the σ(r) gate and the output product."""
    r, args, tables = _wkv_operands(p, x, nm)
    out, _ = wkv4_seq(*args, **tables)
    out = nm.act_q(nm.sigmoid(r) * out.to(r.dtype))
    return _mm(out, p["wo"])


def _channel_mix_seq(p, x, nm):
    """ChannelMix over a whole sequence from a zero carry."""
    xx = L.token_shift(x)
    mix = lambda m: nm.act_q(x * p[m] + xx * (1.0 - p[m]))
    r = nm.sigmoid(_mm(mix("time_mix_r"), p["wr"]))
    k = torch.square(torch.relu(_mm(mix("time_mix_k"), p["wk"])))
    return nm.act_q(r * _mm(nm.act_q(k), p["wv"]))


def _block_seq(lp, x, nm):
    """One layer over a whole sequence: ln1 -> TimeMix -> residual, ln2 ->
    ChannelMix -> residual (JAX's `forward.body`)."""
    att = _time_mix_seq(lp["att"], L.layernorm_kernel(lp["ln1"], x), nm)
    x = x + att.to(x.dtype)
    ffn = _channel_mix_seq(lp["ffn"], L.layernorm_kernel(lp["ln2"], x), nm)
    return x + ffn.to(x.dtype)


@exact_matmuls()
def forward(params, batch: dict, cfg: ModelConfig, *, hw: bool = False):
    """batch {"tokens": (B, S) int}; params plain, in the compute dtype ->
    (logits (B, S, V), aux 0).  JAX's `rwkv4.forward` op for op under the
    numerics `hw` picks: ln0, then per layer ln1 -> TimeMix -> residual,
    ln2 -> ChannelMix -> residual, ln_f and the head, every token shift
    from a zero carry.  With grad enabled and cfg.remat, each layer runs
    under a non-reentrant `checkpoint`, as JAX's `jax.checkpoint(body)`:
    its activations are recomputed in the backward (K11 and K2 launch
    again there).  Gradients flow through K2-bwd and K11-bwd under the
    standard numerics; under hw a CUDA call raises at K9 or K2-hw (the
    hardware numerics are not trained), while CPU tensors stay
    differentiable."""
    nm = _seq_numerics(hw)
    dt = getattr(torch, cfg.dtype)
    x = params["embed"][batch["tokens"].long()].to(dt)
    x = L.layernorm_kernel(params["ln0"], x)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = _layer(params["blocks"], i)
        if remat:
            x = checkpoint(_block_seq, lp, x, nm, use_reentrant=False)
        else:
            x = _block_seq(lp, x, nm)
    x = L.layernorm_kernel(params["ln_f"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x @ params["head"].to(x.dtype), aux
