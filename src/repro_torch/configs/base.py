"""Model configuration: the `ModelConfig` fields the port's models read.

A copy of the fields of `repro/configs/base.py` that `models/rwkv4.py`,
`models/rwkv6.py`, `models/transformer.py` and the train step consume, with
`get_config` / `smoke_config` resolving the rwkv4 family, rwkv6-7b and
the dense transformers (smollm-135m, phi3-mini-3.8b, minitron-4b),
`SHAPES`, the input shapes `launch/steps.py:build_step_for_cell` takes,
`supported_shapes`, and JAX's two arch lists: `ASSIGNED_ARCHS` names all
ten, of which six are not ported yet (ROADMAP item 9; `list_configs`
names the ported ones), and `RWKV4_ARCHS`.
"""
from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# families that run long_500k (sub-quadratic decode state)
_SUBQUADRATIC = {"ssm", "hybrid", "rwkv"}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    family: str = "rwkv"   # dense | moe | ssm | hybrid | audio | vlm | rwkv
    n_heads: int = 0       # attention heads; rwkv6 WKV heads (H·N = d_model)
    n_kv_heads: int = 0           # GQA: H % n_kv_heads == 0
    head_dim: int | None = None   # default d_model // n_heads
    act: str = "swiglu"           # swiglu | gelu | relu_sq
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # features of the transformer family that later slices port
    n_experts: int = 0
    use_mla: bool = False
    n_patches: int = 0
    rwkv_version: int = 0  # 4 or 6
    rwkv_head_dim: int = 64       # rwkv6 head size N
    dtype: str = "bfloat16"
    # route full-sequence attention (q_offset 0, Sq == Skv >= 512) through
    # the flash-attention kernel K13; off by default, as in JAX
    use_flash_kernel: bool = False
    # training: recompute each layer in the backward (jax.checkpoint in
    # JAX, torch.utils.checkpoint here), and the optimizer
    remat: bool = True
    optimizer: str = "adamw"      # adamw | adafactor
    # dry-run instrumentation: attention replaced by a zero-flop stub (the
    # mean of v), so a count's difference (base - stub) isolates
    # attention's traffic and FLOPs, as in JAX
    attn_stub: bool = False
    # the same for rwkv4's WKV recurrence: its output is v and K2 does not
    # launch
    wkv_stub: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


_ARCH_MODULES = {
    "rwkv4-169m": "rwkv4_family",
    "rwkv4-430m": "rwkv4_family",
    "rwkv4-1b5": "rwkv4_family",
    "rwkv4-3b": "rwkv4_family",
    "rwkv4-7b": "rwkv4_family",
    "rwkv6-7b": "rwkv6_7b",
    "smollm-135m": "smollm_135m",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "minitron-4b": "minitron_4b",
}

ASSIGNED_ARCHS = [
    "whisper-medium", "moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b",
    "smollm-135m", "minicpm3-4b", "minitron-4b", "phi3-mini-3.8b",
    "rwkv6-7b", "zamba2-7b", "internvl2-2b",
]

RWKV4_ARCHS = ["rwkv4-169m", "rwkv4-430m", "rwkv4-1b5", "rwkv4-3b",
               "rwkv4-7b"]


def list_configs() -> list[str]:
    return list(_ARCH_MODULES)


def _module(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list_configs()}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    """The published configuration of `arch_id`."""
    mod = _module(arch_id)
    return mod.get(arch_id) if hasattr(mod, "get") else mod.CONFIG


def smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family config for CPU tests."""
    mod = _module(arch_id)
    return mod.smoke(arch_id) if hasattr(mod, "smoke") else mod.SMOKE


def supported_shapes(cfg: ModelConfig) -> dict[str, str]:
    """shape name -> "ok" or a skip reason."""
    out = {}
    for name in SHAPES:
        if name == "long_500k" and cfg.family not in _SUBQUADRATIC:
            out[name] = ("skip: full-attention arch — 500k-token decode "
                         "needs sub-quadratic attention")
        else:
            out[name] = "ok"
    return out
