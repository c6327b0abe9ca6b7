"""Model registry (port of `repro/models/registry.py`: the rwkv4 family,
rwkv6-7b and the dense transformers).

`get_model(arch)` returns a `Model` handle bundling the model module
(rwkv4, rwkv6 or transformer) with its config; `loss_fn` is the
causal-LM loss the train step differentiates.  The serving paths are
rows of the `DECODE_PATHS` / `PREFILL_PATHS` tables: a path exists iff
the module ships its entry.  `DRAFT_PATHS` names the truncated-stack
drafter (`Model.truncated`, `truncate_params`, `truncate_state`), which
item 6's speculative decode and item 8c's depth-truncated training stand
on.
"""
from __future__ import annotations

import dataclasses
from types import ModuleType

import torch

from repro_torch.configs.base import ModelConfig, get_config, smoke_config
from repro_torch.core.quant.serving import cast_compute
from repro_torch.kernels.fused_ce import fused_cross_entropy
from repro_torch.models import param as PM
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class PathDescriptor:
    """One executable serving path.

    name    — plan key ("per_op" | "block" | "model" | "chunked")
    entry   — module attribute implementing the step
    prepare — module attribute for the one-time param prep (None: params
              pass through)
    """
    name: str
    entry: str
    prepare: str | None = None


DECODE_PATHS = (
    PathDescriptor("per_op", "decode_step"),
    # one K3 (rwkv4) or K7 (rwkv6) launch per layer; planes decode
    # in-kernel
    PathDescriptor("block", "decode_step_fused"),
    # one K4 (rwkv4) or K7 (rwkv6) launch for every layer, over the slab
    # form of the weights
    PathDescriptor("model", "decode_step_fused_model",
                   prepare="prepare_fused_model_params"),
)

PREFILL_PATHS = (
    # the per-op prefill is a loop of decode_step; the plan builds it
    PathDescriptor("per_op", "decode_step"),
    # chunk matmuls through K5, the masked WKV scan through K2 (rwkv4) or
    # K6 (rwkv6); rwkv6 pre-decodes its element-wise planes once
    PathDescriptor("chunked", "prefill_chunk",
                   prepare="prepare_prefill_params"),
)


@dataclasses.dataclass(frozen=True)
class DraftDescriptor:
    """One self-speculative drafter.

    The "truncated" drafter is the first `depth` layers of the same model:
    layer l's state transition depends only on the layers below it, so the
    truncated stack's state is exactly the full model's first `depth`
    layer slices (`Model.truncate_state`), never a second pool.

    name  — plan key ("truncated")
    entry — module attribute the draft loop chains per proposed token
    depth — default layers kept (None: half the stack, at least one)
    """
    name: str
    entry: str = "decode_step"
    depth: int | None = None


DRAFT_PATHS = (
    DraftDescriptor("truncated"),
)


def _module_for(cfg: ModelConfig) -> ModuleType:
    if cfg.rwkv_version == 4:
        from repro_torch.models import rwkv4
        return rwkv4
    if cfg.rwkv_version == 6:
        from repro_torch.models import rwkv6
        return rwkv6
    if cfg.family == "dense":
        from repro_torch.models import transformer
        return transformer
    raise NotImplementedError(
        f"{cfg.name}: family {cfg.family!r} is not ported yet (the rwkv4 "
        "family, rwkv6 and the dense transformers are)")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    module: ModuleType

    # -- parameters --------------------------------------------------------
    def spec(self):
        return self.module.spec(self.cfg)

    def init_params(self, seed: int = 0, device="cuda",
                    dtype=torch.float32, *, leaf_fn=None):
        """The seeded weights; `leaf_fn(path, leaf)` replaces each leaf
        as it is drawn (`models.param.init_params`)."""
        return PM.init_params(self.spec(), seed, device, dtype,
                              leaf_fn=leaf_fn)

    def abstract_params(self, dtype=torch.float32):
        """The parameter tree as meta tensors (shapes and dtype only)."""
        return PM.abstract_params(self.spec(), dtype)

    def param_count(self) -> int:
        return PM.param_count(self.spec())

    def cast_params(self, params):
        """Master params -> compute dtype (packed leaves pass through)."""
        return cast_compute(params, getattr(torch, self.cfg.dtype))

    # -- compute -----------------------------------------------------------
    def forward(self, params, batch, **kw):
        """(logits over the whole sequence, aux) on the compute-dtype cast
        of `params`: the prefill step of every family and, with grad
        enabled, the dense transformer's train step (gradients flow back
        to `params` through the cast).  `kw` goes to the module's forward
        (rwkv4's `hw`, rwkv6's `chunk`).  rwkv4's gradients on the card
        flow through K2-bwd and K11-bwd; rwkv6's raise at K10 or K6 (no
        backward kernel yet)."""
        return self.module.forward(self.cast_params(params), batch,
                                   self.cfg, **kw)

    # -- serving paths -----------------------------------------------------
    def decode_paths(self) -> dict[str, PathDescriptor]:
        return {d.name: d for d in DECODE_PATHS
                if hasattr(self.module, d.entry)}

    def prefill_paths(self) -> dict[str, PathDescriptor]:
        return {d.name: d for d in PREFILL_PATHS
                if hasattr(self.module, d.entry)}

    def draft_paths(self) -> dict[str, DraftDescriptor]:
        """The drafters this model can run: the "truncated" one needs the
        per-op decode step on a position-free state, a stacked `blocks`
        tree (layer axis first) and a `layers` axis in every state leaf."""
        if not (hasattr(self.module, "decode_step")
                and self.position_free_decode):
            return {}
        try:
            self.decode_state_layer_axes()
        except (ValueError, AttributeError):
            return {}
        if "blocks" not in self.spec():
            return {}
        return {d.name: d for d in DRAFT_PATHS}

    def truncated(self, depth: int) -> "Model":
        """The first-`depth`-layers model: the same module, its config with
        `n_layers=depth`."""
        if not 1 <= depth <= self.cfg.n_layers:
            raise ValueError(
                f"draft depth {depth} outside [1, {self.cfg.n_layers}] "
                f"for {self.cfg.name}")
        return Model(cfg=dataclasses.replace(self.cfg, n_layers=depth),
                     module=self.module)

    def truncate_params(self, params, depth: int):
        """The first `depth` layers of the stacked `blocks` tree (views of
        its leaves); the embedding, outer norms and head are the full
        tree's tensors, aliased, not copied.  Packed trees too: code and
        scale planes carry the layer axis first."""
        return {**params,
                "blocks": tree_map(lambda t: t[:depth], params["blocks"])}

    def decode_state_layer_axes(self) -> list[int]:
        """Position of the layer axis in every state leaf, in sorted-key
        order (as `decode_state_batch_axes`)."""
        axes = self.decode_state_axes()
        return [axes[k].index("layers") for k in sorted(axes)]

    def truncate_state(self, state, depth: int):
        """The first `depth` layer slices of a decode-state tree (views):
        the truncated model's state."""
        axes = dict(zip(sorted(state), self.decode_state_layer_axes()))
        return {k: v.narrow(axes[k], 0, depth) for k, v in state.items()}

    @property
    def has_decode(self) -> bool:
        return "per_op" in self.decode_paths()

    @property
    def has_fused_decode(self) -> bool:
        """The model ships `decode_step_fused` (K3 or K7 per layer)."""
        return "block" in self.decode_paths()

    @property
    def has_fused_model_decode(self) -> bool:
        """The model ships `decode_step_fused_model` (one K4 or K7 launch
        for every layer)."""
        return "model" in self.decode_paths()

    @property
    def has_fused_prefill(self) -> bool:
        """The model ships the chunked `prefill_chunk` (K5 + K2 or K6)."""
        return "chunked" in self.prefill_paths()

    def init_decode_state(self, batch: int, max_len: int = 0,
                          dtype=torch.bfloat16, device="cuda"):
        return self.module.init_decode_state(self.cfg, batch, max_len, dtype,
                                             device)

    def decode_state_axes(self):
        return self.module.decode_state_axes(self.cfg)

    def decode_step(self, params, state, tokens, pos):
        """Per-op plain decode on plain (unpacked) params."""
        return self.module.decode_step(self.cast_params(params), state,
                                       tokens, pos, self.cfg)

    def decode_step_fused(self, params, state, tokens, pos):
        """Kernel decode (K3 or K7 per layer); params pass through uncast —
        the model applies the packed-aware cast itself."""
        return self.module.decode_step_fused(params, state, tokens, pos,
                                             self.cfg)

    def decode_step_fused_model(self, params, state, tokens, pos):
        """Kernel decode (one K4 or K7 launch for all layers); params prepared by
        `prepare_path_params` (the serving path) or raw and uncast."""
        return self.module.decode_step_fused_model(params, state, tokens,
                                                   pos, self.cfg)

    def prepare_path_params(self, desc: PathDescriptor, params, **kw):
        """One-time param prep for one path, through its descriptor: the
        module's `desc.prepare`, or the params as they are when the
        descriptor or the module has none.  `kw` goes to the module's
        prep (rwkv4's "model" path: `hw=True` attaches the LUT
        operands)."""
        prep = getattr(self.module, desc.prepare, None) if desc.prepare \
            else None
        return params if prep is None else prep(params, self.cfg, **kw)

    def prepare_fused_model_params(self, params, **kw):
        """The "model" path's one-time prep (`kw` as above: the decode's
        `hw` must match the prepared form)."""
        return self.prepare_path_params(self.decode_paths()["model"],
                                        params, **kw)

    def prefill_chunk(self, params, state, tokens, valid):
        """Chunked prefill (K5 + K2, or K5 + K6): tokens (B, C) with a
        per-slot PREFIX validity mask -> (new_state, last-valid logits)."""
        return self.module.prefill_chunk(params, state, tokens, valid, 0,
                                         self.cfg)

    def prefill_chunk_logits(self, params, state, tokens, valid):
        """`prefill_chunk` with the head over every position: tokens (B, K)
        with a prefix validity mask -> (new_state, logits (B, K, V)), row k
        the logits after token k (the head through K5 at M = B·K); invalid
        positions give zero logits and leave the state untouched."""
        return self.module.prefill_chunk(params, state, tokens, valid, 0,
                                         self.cfg, all_logits=True)

    # -- per-slot decode-state contract (serving engine) -------------------
    @property
    def position_free_decode(self) -> bool:
        return bool(getattr(self.module, "DECODE_POS_FREE", False))

    def init_slot_state(self, n_slots: int = 1, max_len: int = 0,
                        dtype=torch.bfloat16, device="cuda"):
        """Decode state for a slot pool: the batch axis is the slot axis."""
        return self.init_decode_state(n_slots, max_len, dtype, device)

    def decode_state_batch_axes(self) -> list[int]:
        """Position of the slot axis in every state leaf, in sorted-key
        order (the order of `repro_torch.tree.leaves_with_path`)."""
        axes = self.decode_state_axes()
        return [axes[k].index("batch") for k in sorted(axes)]


def get_model(cfg_or_id: ModelConfig | str, *, smoke: bool = False) -> Model:
    if isinstance(cfg_or_id, str):
        cfg = smoke_config(cfg_or_id) if smoke else get_config(cfg_or_id)
    else:
        cfg = cfg_or_id
    return Model(cfg=cfg, module=_module_for(cfg))


def loss_fn(model: Model, params, batch):
    """Causal-LM cross-entropy (mean over the unmasked tokens) + 0.01·aux:
    each token's NLL through `fused_cross_entropy` (K12 and K12-bwd on the
    card; on the CPU the f32 log-softmax and the label's entry, as JAX's
    `loss_fn` computes it), then the masked mean.  Returns (loss +
    0.01·aux, {"loss", "aux"})."""
    logits, aux = model.forward(params, batch)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:
        logits = logits[:, -labels.shape[1]:]
    nll = fused_cross_entropy(logits, labels)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(nll)
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}
