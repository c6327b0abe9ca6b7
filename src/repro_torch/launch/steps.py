"""Step builders: the train, prefill and serve steps of a model, and the
(arch, shape) entry that picks one (port of `repro/launch/steps.py`
without a mesh: one card, no shardings, no jit).

    step, args, (init_opt, update_opt) = build_train_step(model)
    step = build_prefill_step(model)        # step(params, batch) -> logits
    step, args, kind = build_step_for_cell(
        "smollm-135m", "train_4k", cfg_overrides={"use_flash_kernel": True})
    step, args, kind = build_step_for_cell("rwkv6-7b", "prefill_32k")
    step, args, kind = build_step_for_cell("rwkv4-169m", "train_4k")
    step = build_serve_step(model, variant="quantized")
    step, args, kind = build_step_for_cell("rwkv6-7b", "decode_32k",
                                           serve_variant="quantized")

`args` are meta tensors, the analogue of JAX's abstract arguments: the
shapes and dtypes a call of `step` takes at that cell.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.core.quant.serving import packed_abstract, unpack_params
from repro_torch.data.pipeline import batch_specs
from repro_torch.device import exact_matmuls
from repro_torch.models.registry import Model, get_model, loss_fn
from repro_torch.optim import adafactor, adamw, cosine_schedule
from repro_torch.tree import leaves_with_path


def make_optimizer(cfg: ModelConfig, *, lr=None):
    lr = lr if lr is not None else cosine_schedule(3e-4, 200, 10_000)
    if cfg.optimizer == "adafactor":
        return adafactor(lr)
    return adamw(lr)


def _set_path(tree: dict, path: tuple, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def loss_and_grads(model: Model, params, batch):
    """((loss, metrics), grads): `loss_fn` on the compute-dtype cast of the
    f32 master `params` and its gradient with respect to them, a tree of
    the params' paths (JAX's `jax.value_and_grad(..., has_aux=True)`).
    Forward and backward run under `exact_matmuls`, the precision JAX's
    step compiles with: the autograd engine's backward would otherwise
    take torch's reduced-precision bf16 reductions."""
    with exact_matmuls():
        flat = leaves_with_path(params)
        # aliases that share the params' storage and collect the grads
        leaves = [t.detach().requires_grad_() for _, t in flat]
        alias: dict = {}
        for (path, _), t in zip(flat, leaves):
            _set_path(alias, path, t)
        with torch.enable_grad():
            loss, metrics = loss_fn(model, alias, batch)
            grads_flat = torch.autograd.grad(loss, leaves)
    grads: dict = {}
    for (path, _), g in zip(flat, grads_flat):
        _set_path(grads, path, g)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), \
        grads


def build_train_step(model: Model, shape: ShapeConfig | None = None):
    """-> (train_step, meta args, (init_opt, update_opt)), where
    train_step(params, opt_state, batch) -> (params, opt_state, metrics):
    `loss_and_grads`, then the optimizer's update, also under
    `exact_matmuls`.  The update writes the params and moments in place
    (optim/optimizers.py) and returns the same trees.  The meta args are
    at `shape` (default: the train_4k cell)."""
    init_opt, update_opt = make_optimizer(model.cfg)

    def train_step(params, opt_state, batch):
        (_, metrics), grads = loss_and_grads(model, params, batch)
        with exact_matmuls():
            params, opt_state = update_opt(grads, opt_state, params)
        return params, opt_state, metrics

    shape = shape or SHAPES["train_4k"]
    abstract = model.abstract_params()
    args = (abstract, init_opt(abstract),
            batch_specs(model.cfg.vocab, shape.seq_len, shape.global_batch))
    return train_step, args, (init_opt, update_opt)


def build_prefill_step(model: Model, *, hw: bool = False):
    """Inference prefill: the forward pass producing logits (no state
    capture), under no_grad.  The dense family's attention runs through
    K13 with cfg.use_flash_kernel; the RWKV families' WKV runs through K2
    (rwkv4) or K10 / K6 (rwkv6) and their LayerNorms through K11.  `hw`
    picks rwkv4's hardware numerics (JAX's `forward(..., hw=True)`)."""
    kw = {"hw": True} if hw else {}

    def prefill_step(params, batch):
        with torch.no_grad():
            logits, _ = model.forward(params, batch, **kw)
        return logits
    return prefill_step


SERVE_VARIANTS = ("base", "quantized")


def build_serve_step(model: Model, *, variant: str = "base"):
    """One decode step of the per-op path: (params, state, tokens (B, 1),
    pos) -> (logits, state).

    variant:
      "base"       plain (bf16) weights
      "quantized"  the W8 tree `pack_params` makes ({"packed", "scale"} on
                   every matmul), decoded by `unpack_params` inside the
                   step, every step, as JAX's step decodes inside its jit:
                   the same operations as "base" on `unpack_params(tree)`,
                   so the same bits
    JAX's "replicated" variant (bf16 weights replicated over the data
    axis of a mesh) waits for the port's meshes (ROADMAP Queue 1 item
    10)."""
    if variant == "replicated":
        raise NotImplementedError(
            'build_serve_step(variant="replicated") replicates the weights '
            "over a device mesh, which waits for the port's meshes (ROADMAP "
            "Queue 1 item 10)")
    if variant not in SERVE_VARIANTS:
        raise ValueError(f"variant={variant!r}: expected one of "
                         f"{SERVE_VARIANTS + ('replicated',)}")
    decode = unpack_params if variant == "quantized" else (lambda p: p)

    def serve_step(params, state, tokens, pos):
        return model.decode_step(decode(params), state, tokens, pos)
    return serve_step


def build_step_for_cell(arch: str, shape_name: str, *, smoke: bool = False,
                        serve_variant: str = "base",
                        cfg_overrides: dict | None = None,
                        hw: bool = False):
    """(arch, shape) -> (step, meta arguments, kind); `hw` goes to a
    prefill step (rwkv4's hardware numerics), `serve_variant` to a decode
    cell's serve step, whose meta parameters are then the packed tree's
    (`packed_abstract`)."""
    model = get_model(arch, smoke=smoke)
    if cfg_overrides:
        model = Model(cfg=dataclasses.replace(model.cfg, **cfg_overrides),
                      module=model.module)
    shape = SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    meta = lambda *s: torch.empty(s, dtype=torch.int32, device="meta")
    if shape.kind == "train":
        step, args, _ = build_train_step(model, shape)
        return step, args, "train_step"
    if shape.kind == "prefill":
        args = (model.abstract_params(), {"tokens": meta(B, S)})
        return build_prefill_step(model, hw=hw), args, "prefill_step"
    step = build_serve_step(model, variant=serve_variant)
    params = model.abstract_params(torch.bfloat16)
    if serve_variant == "quantized":
        params = packed_abstract(params)
    args = (params, model.init_decode_state(B, S, device="meta"),
            meta(B, 1), 0)
    return step, args, f"serve_step[{serve_variant}]"
