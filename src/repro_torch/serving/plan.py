"""Execution plans: path selection, param preparation and the two serving
programs (port of `repro/serving/plan.py`; no mesh, speculation or prefix
cache yet).

    plan = build_plan("rwkv4-169m", smoke=False, quantized=True,
                      plane_policy=policy, fused_decode="model",
                      fused_prefill=True)

picks the decode and prefill paths from the registry's descriptor tables,
prepares each path's form of the weights once (`PreparedParams`), and
hands the scheduler `decode_fn()` and `prefill_fn()`.  Every program commits state
through `masked_state_commit`, the engine's one masking rule.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant.policy import PlanePolicy
from repro_torch.core.quant.serving import (
    PreparedParams, pack_leaf, unpack_params)
from repro_torch.device import resolve_device
from repro_torch.models.registry import Model, PathDescriptor, get_model
from repro_torch.tree import keystr

# the pool dtype: K3, K4 and K7 take a bf16 state, as the JAX engine's
# default pool
STATE_DTYPE = torch.bfloat16


def masked_state_commit(new_state, old_state, mask, axes):
    """`where(mask, new, old)` leafwise, the mask broadcast into position
    `axes[i]` of leaf i (sorted-key order, `Model.decode_state_batch_axes`).
    A lane whose mask is False is computed but its state never moves."""
    out = {}
    for key, ax in zip(sorted(old_state), axes):
        n = new_state[key]
        m = mask.reshape(tuple(-1 if i == ax else 1 for i in range(n.ndim)))
        out[key] = torch.where(m, n, old_state[key])
    return out


def maybe_unpack(params, quantized: bool):
    """Whole-tree plane decode for the per-op paths; the kernel paths
    decode per leaf inside the kernels instead."""
    return unpack_params(params) if quantized else params


def _normalize_decode(fused_decode) -> str:
    if fused_decode in (False, None):
        return "per_op"
    if fused_decode in ("block", "model"):
        return fused_decode
    raise ValueError(f"fused_decode={fused_decode!r}: expected False, "
                     "'block' or 'model'")


class ExecutionPlan:
    """One model's executable serving configuration.

    model         — the registry Model handle
    prepared      — PreparedParams (raw / decode / prefill forms)
    decode_desc / prefill_desc — the selected PathDescriptors
    prefill_chunk — prompt tokens absorbed per prefill call per slot
    device        — where the pool, weights and programs live
    """

    def __init__(self, model: Model, prepared: PreparedParams,
                 decode_desc: PathDescriptor, prefill_desc: PathDescriptor,
                 *, prefill_chunk: int = 16, device="cuda"):
        self.model = model
        self.prepared = prepared
        self.decode_desc = decode_desc
        self.prefill_desc = prefill_desc
        self.prefill_chunk = int(prefill_chunk)
        self.device = resolve_device(device)
        self.state_axes = model.decode_state_batch_axes()

    def _decode_step(self):
        model, quantized = self.model, self.prepared.quantized
        if self.decode_desc.name == "model":
            # one K4 / K7 launch for every layer, over the prepared slabs
            return lambda p, s, t: model.decode_step_fused_model(p, s, t, 0)
        if self.decode_desc.name == "block":
            # one K3 / K7 launch per layer; plane leaves decode in-kernel
            return lambda p, s, t: model.decode_step_fused(p, s, t, 0)
        return lambda p, s, t: model.decode_step(
            maybe_unpack(p, quantized), s, t, 0)

    def _on_device(self, a):
        return torch.as_tensor(a).to(self.device)

    def decode_fn(self):
        """fn(state, tokens (S,1), mask (S,)) -> (logits (S,1,V), state)."""
        axes, step = self.state_axes, self._decode_step()
        params = self.prepared.decode

        @torch.inference_mode()
        def decode(state, toks, mask):
            toks, mask = self._on_device(toks), self._on_device(mask)
            logits, new_state = step(params, state, toks)
            return logits, masked_state_commit(new_state, state, mask, axes)
        return decode

    def prefill_fn(self):
        """fn(state, tokens (S,C), valid (S,C), fresh (S,))
        -> (state, last-valid logits (S,1,V))."""
        model, axes = self.model, self.state_axes
        quantized = self.prepared.quantized
        chunked = self.prefill_desc.name == "chunked"
        fresh_lane = model.init_slot_state(1, STATE_DTYPE, self.device)
        params = self.prepared.prefill
        dt = getattr(torch, model.cfg.dtype)

        @torch.inference_mode()
        def prefill(state, toks, valid, fresh):
            toks, valid = self._on_device(toks), self._on_device(valid)
            fresh = self._on_device(fresh)
            # newly admitted lanes restart from the fresh state in-call
            state = masked_state_commit(state, fresh_lane, ~fresh, axes)
            if chunked:
                # chunk matmuls (K5) + the masked WKV scan (K2 / K6);
                # packed leaves decode inside the kernels
                return model.prefill_chunk(params, state, toks, valid)
            p = maybe_unpack(params, quantized)
            last = torch.zeros((toks.shape[0], 1, model.cfg.vocab),
                               dtype=dt, device=self.device)
            for j in range(toks.shape[1]):
                ok = valid[:, j]
                logits, stepped = model.decode_step(p, state,
                                                    toks[:, j:j + 1], 0)
                state = masked_state_commit(stepped, state, ok, axes)
                last = torch.where(ok[:, None, None], logits, last)
            return state, last
        return prefill


def build_plan(model: Model | str, *, smoke: bool = True,
               quantized: bool = False,
               plane_policy: PlanePolicy | None = None,
               fused_decode: str | None = None,
               fused_prefill: bool = False, prefill_chunk: int = 16,
               seed: int = 0, device="cuda") -> ExecutionPlan:
    """Select paths, prepare params (one pass) and build an ExecutionPlan.

    model         — a Model handle or arch id (resolved with `smoke=`)
    quantized     — pack the weights (drawn from `seed` on `device`) once,
                    each leaf as it is drawn
    plane_policy  — a `PlanePolicy` choosing W8 / W4 / VQ per tensor
                    (needs quantized=True); None packs everything W8
    fused_decode  — None/False (per-op) | "block" (K3 or K7 per layer) |
                    "model" (one K4 or K7 launch for all layers); the
                    kernels take the packed tree of any plane policy and
                    the plain bf16 tree of quantized=False alike
    fused_prefill — False (per-op loop) | True (chunked: K5 + K2 or K6)
    device        — "cuda" (default) or "cpu"; a missing GPU raises
    """
    dev = resolve_device(device)
    if isinstance(model, str):
        model = get_model(model, smoke=smoke)
    decode_paths, prefill_paths = model.decode_paths(), model.prefill_paths()
    if not model.position_free_decode:
        raise ValueError(f"{model.cfg.name}: the slotted engine needs a "
                         "position-free recurrent state")
    decode_desc = decode_paths[_normalize_decode(fused_decode)]
    prefill_desc = prefill_paths["chunked" if fused_prefill else "per_op"]
    if plane_policy is not None and not quantized:
        raise ValueError("plane_policy selects quantized weight planes; "
                         "it does nothing without quantized=True")
    # packing each leaf as it is drawn keeps rwkv6-7b's f32 tree (28 GB)
    # off the device; the bytes equal pack_params(init_params(...))
    pack = (lambda path, t: pack_leaf(keystr(path), t, plane_policy)) \
        if quantized else None
    params = model.init_params(seed, dev, leaf_fn=pack)
    prepared = PreparedParams(
        raw=params,
        decode=model.prepare_path_params(decode_desc, params),
        prefill=model.prepare_path_params(prefill_desc, params),
        quantized=quantized, decode_path=decode_desc.name,
        prefill_path=prefill_desc.name)
    return ExecutionPlan(model, prepared, decode_desc, prefill_desc,
                         prefill_chunk=prefill_chunk, device=dev)
