"""Step builders: the prefill and serve steps of a model, and the
(arch, shape) entry that picks one (port of `repro/launch/steps.py`
without a mesh: one card, no shardings, no jit).

    step = build_prefill_step(model)        # step(params, batch) -> logits
    step, args, kind = build_step_for_cell(
        "smollm-135m", "prefill_32k", cfg_overrides={"use_flash_kernel": True})

`args` are meta tensors, the analogue of JAX's abstract arguments: the
shapes and dtypes a call of `step` takes at that cell.  The train step
waits for the training slice.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import SHAPES
from repro_torch.models.registry import Model, get_model


def build_prefill_step(model: Model):
    """Inference prefill: the forward pass producing logits (no state
    capture); with cfg.use_flash_kernel its attention runs through K13."""
    def prefill_step(params, batch):
        logits, _ = model.forward(params, batch)
        return logits
    return prefill_step


def build_serve_step(model: Model):
    """One decode step of the per-op path on plain weights (JAX's "base"
    variant): (params, state, tokens (B, 1), pos) -> (logits, state)."""
    def serve_step(params, state, tokens, pos):
        return model.decode_step(params, state, tokens, pos)
    return serve_step


def build_step_for_cell(arch: str, shape_name: str, *, smoke: bool = False,
                        cfg_overrides: dict | None = None):
    """(arch, shape) -> (step, meta arguments, kind)."""
    model = get_model(arch, smoke=smoke)
    if cfg_overrides:
        model = Model(cfg=dataclasses.replace(model.cfg, **cfg_overrides),
                      module=model.module)
    shape = SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    meta = lambda *s: torch.empty(s, dtype=torch.int32, device="meta")
    if shape.kind == "train":
        raise NotImplementedError(
            "the train step (loss, optimizer, K13's backward) comes with "
            "the training slice (ROADMAP Queue 1 item 8)")
    if shape.kind == "prefill":
        args = (model.abstract_params(), {"tokens": meta(B, S)})
        return build_prefill_step(model), args, "prefill_step"
    args = (model.abstract_params(torch.bfloat16),
            model.init_decode_state(B, S, device="meta"), meta(B, 1), 0)
    return build_serve_step(model), args, "serve_step[base]"
