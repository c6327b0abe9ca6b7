"""Execution plans: path selection, param preparation and the two serving
programs (port of `repro/serving/plan.py`; no mesh, speculation or prefix
cache yet: ROADMAP Queue 1 items 6 and 10a).

    plan = build_plan("rwkv4-169m", params, smoke=False, quantized=True,
                      plane_policy=policy, fused_decode="model",
                      fused_prefill=True)

picks the decode and prefill paths from the registry's descriptor tables,
prepares each path's form of the weights once (`PreparedParams`: a given
tree, or one drawn from the seed), and hands the scheduler
`decode_fn(batch)` and `prefill_fn(batch)`, each built once per (kind,
path, batch, state dtype) key (`trace_counts`).  Every program commits
state through `masked_state_commit`, the engine's one masking rule.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant.policy import PlanePolicy
from repro_torch.core.quant.serving import (
    PreparedParams, pack_leaf, pack_params, unpack_params)
from repro_torch.device import resolve_device
from repro_torch.models.registry import Model, PathDescriptor, get_model
from repro_torch.tree import keystr, leaves_with_path

# the default pool dtype, the JAX engine's; K3, K4, K7 and the chunk's K2
# and K6 take only a bf16 state on the card (ROADMAP Queue 2 A)
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
    if fused_decode is True:          # JAX takes True for "block"
        fused_decode = "block"
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
    max_len, state_dtype — the pool's, passed to `init_slot_state`
    device        — where the pool, weights and programs live
    trace_counts  — {"decode": n, "prefill": n}: how many times the plan
                    built each program; 1 per used (path, batch, state
                    dtype) key for the life of the plan
    build_config  — `build_plan`'s inputs (JAX's keys), None on a plan
                    constructed by hand
    """

    def __init__(self, model: Model, prepared: PreparedParams,
                 decode_desc: PathDescriptor, prefill_desc: PathDescriptor,
                 *, prefill_chunk: int = 16, max_len: int = 0,
                 state_dtype=STATE_DTYPE, device="cuda"):
        self.model = model
        self.prepared = prepared
        self.decode_desc = decode_desc
        self.prefill_desc = prefill_desc
        self.prefill_chunk = int(prefill_chunk)
        self.max_len = int(max_len)
        self.state_dtype = state_dtype
        self.device = resolve_device(device)
        self.state_axes = model.decode_state_batch_axes()
        self.trace_counts = {"decode": 0, "prefill": 0}
        self._programs: dict = {}
        self.build_config: dict | None = None

    def _key(self, kind: str, batch: int):
        desc = self.decode_desc if kind == "decode" else self.prefill_desc
        return (kind, desc.name, int(batch), _dtype_name(self.state_dtype))

    def decode_fn(self, batch: int):
        """The decode program for a `batch`-slot pool:
        fn(state, tokens (S,1), mask (S,)) -> (logits (S,1,V), state).
        Built once per key; the same key returns the same program."""
        key = self._key("decode", batch)
        if key not in self._programs:
            self.trace_counts["decode"] += 1
            self._programs[key] = self._build_decode()
        return self._programs[key]

    def prefill_fn(self, batch: int):
        """The prefill program for a `batch`-slot pool:
        fn(state, tokens (S,C), valid (S,C), fresh (S,))
        -> (state, last-valid logits (S,1,V)).  Cached like `decode_fn`."""
        key = self._key("prefill", batch)
        if key not in self._programs:
            self.trace_counts["prefill"] += 1
            self._programs[key] = self._build_prefill()
        return self._programs[key]

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

    def _build_decode(self):
        axes, step = self.state_axes, self._decode_step()
        params = self.prepared.decode

        @torch.inference_mode()
        def decode(state, toks, mask):
            toks, mask = self._on_device(toks), self._on_device(mask)
            logits, new_state = step(params, state, toks)
            return logits, masked_state_commit(new_state, state, mask, axes)
        return decode

    def _build_prefill(self):
        model, axes = self.model, self.state_axes
        quantized = self.prepared.quantized
        chunked = self.prefill_desc.name == "chunked"
        fresh_lane = model.init_slot_state(1, self.max_len, self.state_dtype,
                                           self.device)
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


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _on(t: torch.Tensor, dev: torch.device) -> bool:
    return t.device.type == dev.type and (
        dev.index is None or t.device.index == dev.index)


def _check_given(params, dev: torch.device):
    """A given tree must lie on the plan's device: a leaf elsewhere raises,
    it is never copied quietly."""
    for path, leaf in leaves_with_path(params):
        if isinstance(leaf, torch.Tensor) and not _on(leaf, dev):
            raise ValueError(
                f"params{keystr(path)} is on {leaf.device}, the plan on "
                f"{dev}; move the tree to the plan's device first")


def _registry_arch_id(cfg_name: str, smoke: bool) -> str:
    """The registry arch id whose (smoke) config is named `cfg_name`
    (rwkv6-7b's smoke config is "rwkv6-smoke"), so that
    `build_config["arch"]` round-trips through `get_model`."""
    from repro_torch.configs.base import (get_config, list_configs,
                                          smoke_config)
    base = cfg_name[:-len("-smoke")] if smoke else cfg_name
    known = list_configs()
    for arch in ([base] if base in known else []) + known:
        cfg = smoke_config(arch) if smoke else get_config(arch)
        if cfg.name == cfg_name:
            return arch
    return base


def build_plan(model: Model | str, params=None, *, smoke: bool = True,
               quantized: bool = False,
               plane_policy: PlanePolicy | None = None,
               fused_decode: bool | str | None = False,
               fused_prefill: bool = False, prefill_chunk: int = 16,
               max_len: int = 0, state_dtype=STATE_DTYPE, seed: int = 0,
               decode_prepare_kw: dict | None = None,
               device="cuda") -> ExecutionPlan:
    """Select paths, prepare params (one pass) and build an ExecutionPlan.

    model         — a Model handle or arch id (resolved with `smoke=`)
    params        — a given weight tree (f32 or bf16) on `device`, served
                    in place of the seed's; a leaf elsewhere raises
    quantized     — pack the weights once: a given tree through
                    `pack_params`, a drawn one leaf by leaf as it is drawn
    plane_policy  — a `PlanePolicy` choosing W8 / W4 / VQ per tensor
                    (needs quantized=True); None packs everything W8
    fused_decode  — False (per-op) | "block" (K3 or K7 per layer) |
                    "model" (one K4 or K7 launch for all layers); the
                    kernels take the packed tree of any plane policy and
                    the plain tree of quantized=False alike
    fused_prefill — False (per-op loop) | True (chunked: K5 + K2 or K6)
    max_len, state_dtype — the pool's; on the card a fused path takes
                    only a bf16 state, so another dtype raises there
    decode_prepare_kw — extra keywords for the decode path's one-time
                    prep (rwkv4's "model" path: `hw=True`)
    device        — "cuda" (default) or "cpu"; a missing GPU raises
    """
    dev = resolve_device(device)
    if isinstance(model, str):
        model = get_model(model, smoke=smoke)
    decode_paths, prefill_paths = model.decode_paths(), model.prefill_paths()
    if not model.position_free_decode:
        raise ValueError(f"{model.cfg.name}: the slotted engine needs a "
                         "position-free recurrent state")
    decode_name = _normalize_decode(fused_decode)
    decode_desc = decode_paths[decode_name]
    prefill_desc = prefill_paths["chunked" if fused_prefill else "per_op"]
    if plane_policy is not None and not quantized:
        raise ValueError("plane_policy selects quantized weight planes; "
                         "it does nothing without quantized=True")
    if not state_dtype.is_floating_point:
        raise ValueError(f"state_dtype={state_dtype}: the recurrent state "
                         "is a float tensor")
    if (dev.type == "cuda" and state_dtype != torch.bfloat16
            and (decode_name != "per_op" or fused_prefill)):
        raise ValueError(
            f"state_dtype={state_dtype} with fused_decode={decode_name!r}, "
            f"fused_prefill={fused_prefill}: K3, K4, K7 and the chunk's K2 "
            "and K6 take only a bf16 state on the card (an f32 state is "
            "ROADMAP Queue 2 A); serve it on the per-op paths")
    from_seed = params is None
    if from_seed:
        # packing each leaf as it is drawn keeps rwkv6-7b's f32 tree (28
        # GB) off the device; the bytes equal pack_params(init_params(...))
        pack = (lambda path, t: pack_leaf(keystr(path), t, plane_policy)) \
            if quantized else None
        params = model.init_params(seed, dev, leaf_fn=pack)
    else:
        _check_given(params, dev)
        if quantized:
            params = pack_params(params, plane_policy)
    prepared = PreparedParams(
        raw=params,
        decode=model.prepare_path_params(decode_desc, params,
                                         **(decode_prepare_kw or {})),
        prefill=model.prepare_path_params(prefill_desc, params),
        quantized=quantized, decode_path=decode_desc.name,
        prefill_path=prefill_desc.name)
    plan = ExecutionPlan(model, prepared, decode_desc, prefill_desc,
                         prefill_chunk=prefill_chunk, max_len=max_len,
                         state_dtype=state_dtype, device=dev)
    name = model.cfg.name
    smoke_flag = name.endswith("-smoke")
    plan.build_config = {
        "arch": _registry_arch_id(name, smoke_flag),
        "smoke": smoke_flag,
        "quantized": bool(quantized),
        "plane_policy": None if plane_policy is None
        else plane_policy.to_config(),
        "fused_decode": decode_name,
        "fused_prefill": bool(fused_prefill),
        "prefill_chunk": int(prefill_chunk),
        "max_len": int(max_len),
        "state_dtype": _dtype_name(state_dtype),
        "seed": int(seed),
        "from_seed": from_seed,
        # the features item 6 and item 10a bring: none on this plan
        "speculative": None,
        "draft_depth": None,
        "mesh_devices": None,
    }
    return plan
