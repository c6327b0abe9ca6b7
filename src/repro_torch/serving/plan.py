"""Execution plans: path selection, param preparation and the serving
programs (port of `repro/serving/plan.py`; no mesh yet: ROADMAP Queue 1
item 10a).

    plan = build_plan("rwkv4-169m", params, smoke=False, quantized=True,
                      plane_policy=policy, fused_decode="model",
                      fused_prefill=True, speculative=4)

picks the decode and prefill paths from the registry's descriptor tables,
prepares each path's form of the weights once (`PreparedParams`: a given
tree, or one drawn from the seed), and hands the scheduler
`decode_fn(batch)` and `prefill_fn(batch)` and, under self-speculative
decode (`SpeculativePath`), `draft_fn`, `verify_fn` and `rollback_fn`.
Each program is built once per (kind, path, batch, state dtype) key and
counted in `trace_counts` at its first call, as JAX counts a trace.
Every program commits state through `masked_state_commit`, the engine's
one masking rule.  `cache_variant()` is the prefix cache's isolation key.

Speculation: the drafter is the first `draft_depth` layers of the same
model on the decode path's own kernel (K4 / K7-model over the truncated
stack on "model", K3 / K7-block on "block", the per-op step on per-op),
its state a narrowed view of the pool's; the verifier is the chunked
prefill with the head at every position (K5 over the layers and the head
at M = S·k, K2 or K6 over the window), or the per-op step's masked loop.
Neither writes into its input state, so the pool state before the verify
is the rollback snapshot without a copy.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.quant.policy import PlanePolicy
from repro_torch.core.quant.serving import (
    PreparedParams, pack_leaf, pack_params, plane_fingerprint,
    unpack_params)
from repro_torch.device import resolve_device
from repro_torch.models.registry import (DraftDescriptor, Model,
                                         PathDescriptor, get_model)
from repro_torch.serving.prefix_cache import CacheVariant
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


@dataclasses.dataclass(frozen=True)
class SpeculativePath:
    """The plan's self-speculative decode.

    Each decode tick becomes draft -> verify -> accept: the drafter (the
    first `draft_depth` layers of the same model on a slice of the pool
    state) proposes k-1 tokens a lane, one verify call scores the lane's
    pending token and every draft, and the scheduler accepts the longest
    prefix the verifier agrees with, rolling rejected lanes back through
    `masked_state_commit`.  Every emitted token is sampled from verifier
    logits, so the drafter moves only the acceptance rate.

    k           — verify window: the pending token plus k-1 drafts (k=1 is
                  the verify-only tick: no drafter)
    draft_depth — layers the truncated-stack drafter keeps
    desc        — the registry DraftDescriptor it was built from
    """
    k: int
    draft_depth: int
    desc: DraftDescriptor


def draft_path(decode_path: str, depth: int) -> str:
    """The decode path the drafter runs: the plan's own, except that a
    one-layer stack on "model" runs "block" (K3 / K7-block, the same
    kernel launched on one layer; the slab tables take no one-layer
    stack)."""
    return "block" if decode_path == "model" and depth == 1 else decode_path


def prepare_draft(model: Model, decode_path: str, raw, depth: int,
                  **decode_prepare_kw):
    """The drafter's weights: `truncate_params(raw, depth)` in the form
    its decode path takes (`draft_path`): the "model" path's slabs of the
    truncated stack, the truncated tree as it is for the others."""
    tm = model.truncated(depth)
    name = draft_path(decode_path, depth)
    kw = decode_prepare_kw if name == "model" else {}
    return tm.prepare_path_params(tm.decode_paths()[name],
                                  model.truncate_params(raw, depth), **kw)


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
    speculative   — the SpeculativePath, or None
    trace_counts  — {"decode": n, "prefill": n}, plus "verify",
                    "rollback" and (k > 1) "draft" under speculation: the
                    programs of each kind run at least once, counted at
                    their first call as JAX counts a trace; 1 per used
                    (path, batch, state dtype) key for the life of the plan
    build_config  — `build_plan`'s inputs (JAX's keys), None on a plan
                    constructed by hand
    """

    def __init__(self, model: Model, prepared: PreparedParams,
                 decode_desc: PathDescriptor, prefill_desc: PathDescriptor,
                 *, prefill_chunk: int = 16, max_len: int = 0,
                 state_dtype=STATE_DTYPE, device="cuda",
                 speculative: Optional[SpeculativePath] = None):
        self.model = model
        self.prepared = prepared
        self.decode_desc = decode_desc
        self.prefill_desc = prefill_desc
        self.prefill_chunk = int(prefill_chunk)
        self.max_len = int(max_len)
        self.state_dtype = state_dtype
        self.device = resolve_device(device)
        self.speculative = speculative
        self.state_axes = model.decode_state_batch_axes()
        self.trace_counts = {"decode": 0, "prefill": 0}
        if speculative is not None:
            self.trace_counts.update({"verify": 0, "rollback": 0})
            if speculative.k > 1:
                self.trace_counts["draft"] = 0
        self._programs: dict = {}
        self.build_config: dict | None = None

    def cache_variant(self, *, numerics: str = "exact") -> CacheVariant:
        """The prefix-cache variant this plan's prefill states file under,
        derived from what runs: the model config's name, the prepared
        tree's planes (`plane_fingerprint`), the prefill path and the pool
        dtype.  The engine's paths run exact numerics; "hw_lut" is for
        callers driving the paper's numerics directly."""
        return CacheVariant(arch=self.model.cfg.name,
                            quant=plane_fingerprint(self.prepared.raw),
                            numerics=numerics,
                            prefill=self.prefill_desc.name,
                            state_dtype=_dtype_name(self.state_dtype))

    def prefill_quota(self, budget_tokens: int, batch: int) -> int:
        """The per-tick prefill LANE quota for a token budget (the SLO
        layer's `prefill_budget`).  The prefill program's shape is (batch,
        prefill_chunk) whatever the load, so a budget cannot shrink a call:
        it only chooses how many lanes' validity rows are filled.  The
        budget rounds down to whole chunks with a floor of one lane, so
        prefill always progresses; the program keys never see it, so
        budgeted serving runs the same programs (`trace_counts` stays 1).
        0 = unlimited: the whole batch."""
        if budget_tokens <= 0:
            return int(batch)
        return max(1, min(int(batch),
                          int(budget_tokens) // self.prefill_chunk))

    def _program(self, key: tuple, count: str, build):
        """The program of `key`, built once; `trace_counts[count]` goes up
        at its first call."""
        if key not in self._programs:
            fn, first = build(), [True]

            def run(*args):
                if first:
                    first.clear()
                    self.trace_counts[count] += 1
                return fn(*args)
            self._programs[key] = run
        return self._programs[key]

    def _key(self, kind: str, name: str, batch: int):
        return (kind, name, int(batch), _dtype_name(self.state_dtype))

    def decode_fn(self, batch: int):
        """The decode program for a `batch`-slot pool:
        fn(state, tokens (S,1), mask (S,)) -> (logits (S,1,V), state).
        Built once per key; the same key returns the same program."""
        return self._program(self._key("decode", self.decode_desc.name,
                                       batch), "decode", self._build_decode)

    def prefill_fn(self, batch: int):
        """The prefill program for a `batch`-slot pool:
        fn(state, tokens (S,C), valid (S,C), fresh (S,))
        -> (state, last-valid logits (S,1,V)).  Cached like `decode_fn`."""
        return self._program(self._key("prefill", self.prefill_desc.name,
                                       batch), "prefill",
                             self._build_prefill)

    def draft_fn(self, batch: int):
        """The drafter for a `batch`-slot pool (k > 1 only):
        fn(state, tokens (S,1)) -> drafted (S, k-1) int32, a greedy argmax
        chain of the truncated stack on `truncate_state(state, depth)`,
        the argmax on the device and fed back without a host round trip.
        It never writes into `state`."""
        sp = self.speculative
        return self._program(self._key("draft", sp.desc.name, batch),
                             "draft", self._build_draft)

    def verify_fn(self, batch: int):
        """The verifier for a `batch`-slot pool:
        fn(state, tokens (S,k), valid (S,k)) -> (logits (S,k,V), state).
        Row j holds the logits after tokens[:, :j+1]; the state commits
        through every valid position.  It never writes into `state`: the
        caller's pre-verify reference is the rollback snapshot."""
        return self._program(self._key("verify", self.prefill_desc.name,
                                       batch), "verify", self._build_verify)

    def rollback_fn(self, batch: int):
        """The rollback for a `batch`-slot pool:
        fn(committed, snapshot, reject (S,)) -> state, rejected lanes
        taking the snapshot (`masked_state_commit`)."""
        return self._program(self._key("rollback", "masked", batch),
                             "rollback", self._build_rollback)

    def _decode_step(self, name: Optional[str] = None,
                     model: Optional[Model] = None):
        """The decode path `name` (default: the plan's) of `model`
        (default: the plan's) as (params, state, tokens) -> (logits,
        state)."""
        model = self.model if model is None else model
        quantized = self.prepared.quantized
        name = self.decode_desc.name if name is None else name
        if name == "model":
            # one K4 / K7 launch for every layer, over the prepared slabs
            return lambda p, s, t: model.decode_step_fused_model(p, s, t, 0)
        if name == "block":
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

    def _build_draft(self):
        sp, model = self.speculative, self.model
        depth, steps = sp.draft_depth, sp.k - 1
        step = self._decode_step(draft_path(self.decode_desc.name, depth),
                                 model.truncated(depth))
        params = self.prepared.draft

        @torch.inference_mode()
        def draft(state, toks):
            tok = self._on_device(toks)
            st = model.truncate_state(state, depth)
            out = []
            for _ in range(steps):
                logits, st = step(params, st, tok)
                tok = torch.argmax(logits[:, 0].float(), dim=-1).to(
                    torch.int32)[:, None]
                out.append(tok)
            return torch.cat(out, dim=1)
        return draft

    def _build_verify(self):
        model, axes = self.model, self.state_axes
        quantized = self.prepared.quantized
        chunked = self.prefill_desc.name == "chunked"
        params = self.prepared.prefill

        @torch.inference_mode()
        def verify(state, toks, valid):
            toks, valid = self._on_device(toks), self._on_device(valid)
            if chunked:
                # the chunked prefill with the head at every position: K5
                # over the layers and the head at M = S·k, K2 / K6 over
                # the window
                new_state, logits = model.prefill_chunk_logits(
                    params, state, toks, valid)
                return logits, new_state
            p = maybe_unpack(params, quantized)
            rows = []
            for j in range(toks.shape[1]):
                ok = valid[:, j]
                logits, stepped = model.decode_step(p, state,
                                                    toks[:, j:j + 1], 0)
                state = masked_state_commit(stepped, state, ok, axes)
                rows.append(torch.where(ok[:, None], logits[:, 0],
                                        torch.zeros_like(logits[:, 0])))
            return torch.stack(rows, dim=1), state
        return verify

    def _build_rollback(self):
        axes = self.state_axes

        @torch.inference_mode()
        def rollback(committed, snapshot, reject):
            return masked_state_commit(snapshot, committed,
                                       self._on_device(reject), axes)
        return rollback


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
               speculative: Optional[int] = None,
               draft_depth: Optional[int] = None,
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
    speculative   — k >= 1: self-speculative decode with a k-token verify
                    window a tick (SpeculativePath; k=1 is verify-only)
    draft_depth   — layers the truncated-stack drafter keeps (default:
                    the DraftDescriptor's, else half the stack)
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
    spec_path = None
    if speculative is not None:
        k = int(speculative)
        if k < 1:
            raise ValueError(
                f"speculative={k}: the verify window needs at least the "
                "lane's pending token (K >= 1)")
        drafts = model.draft_paths()
        if "truncated" not in drafts:
            raise ValueError(
                f"{model.cfg.name} has no truncated-stack drafter; "
                "speculative decode needs a position-free decode_step, "
                "stacked `blocks` params and a named `layers` state axis")
        desc = drafts["truncated"]
        depth = draft_depth if draft_depth is not None else (
            desc.depth if desc.depth is not None
            else max(1, model.cfg.n_layers // 2))
        model.truncated(int(depth))     # validates 1 <= depth <= n_layers
        spec_path = SpeculativePath(k=k, draft_depth=int(depth), desc=desc)
    elif draft_depth is not None:
        raise ValueError("draft_depth without speculative=K does nothing")
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
        prefill_path=prefill_desc.name,
        draft=None if spec_path is None or spec_path.k == 1 else
        prepare_draft(model, decode_name, params, spec_path.draft_depth,
                      **(decode_prepare_kw or {})))
    plan = ExecutionPlan(model, prepared, decode_desc, prefill_desc,
                         prefill_chunk=prefill_chunk, max_len=max_len,
                         state_dtype=state_dtype, device=dev,
                         speculative=spec_path)
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
        "speculative": None if spec_path is None else spec_path.k,
        "draft_depth": None if spec_path is None
        else spec_path.draft_depth,
        # item 10a brings the mesh
        "mesh_devices": None,
    }
    return plan
