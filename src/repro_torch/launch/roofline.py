"""Roofline terms of a counted call on the H100 (port of
`repro/launch/roofline.py`).

Three terms per call, in seconds (per card):

    compute    = FLOPs / peak FLOP/s
    memory     = device-memory bytes / HBM bandwidth
    collective = collective bytes / NVLink bandwidth

The FLOPs and bytes come from `launch/op_analysis.py` (eager op
boundaries and each kernel's own boundary); the bottleneck is the
largest term.

Hardware constants: one H100 SXM5 80 GB, from NVIDIA's H100 Tensor Core
GPU datasheet (dense rates, no sparsity): 989 TFLOP/s bf16 on the tensor
cores, 3.35 TB/s HBM3, 900 GB/s NVLink a card (bidirectional).  Those
rates assume the card's full 700 W power limit.

`xla_flops` / `xla_bytes` keep JAX's cross-check fields: `xla_flops` is
torch's `FlopCounterMode` over the same call (the aten products alone,
blind to the hand-written kernels, as XLA's cost_analysis is blind to
loop trips past the first); `FlopCounterMode` counts no bytes, so
`xla_bytes` stays 0.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

PEAK_FLOPS = 989e12       # bf16 FLOP/s, dense, tensor cores
HBM_BW = 3.35e12          # bytes/s, HBM3
NVLINK_BW = 900e9         # bytes/s a card, bidirectional


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-card FLOPs (products)
    hbm_bytes: float             # per-card device-memory bytes
    coll_bytes: float            # per-card collective bytes
    coll_breakdown: dict
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: Optional[float] = None   # 6*N*D (global)
    useful_ratio: Optional[float] = None  # model_flops / (flops * chips)
    xla_flops: float = 0.0                # FlopCounterMode cross-check
    xla_bytes: float = 0.0                # (counts no bytes)

    def as_dict(self):
        return dataclasses.asdict(self)


def analyze(metrics, *, chips: int = 1,
            model_flops: Optional[float] = None) -> Roofline:
    """The roofline of an `op_analysis.OpMetrics` on `chips` cards."""
    terms = {
        "compute": metrics.flops / PEAK_FLOPS,
        "memory": metrics.hbm_bytes / HBM_BW,
        "collective": metrics.coll_bytes / NVLINK_BW,
    }
    useful = None
    if model_flops:
        useful = model_flops / max(metrics.flops * chips, 1.0)
    return Roofline(
        flops=metrics.flops, hbm_bytes=metrics.hbm_bytes,
        coll_bytes=metrics.coll_bytes,
        coll_breakdown=dict(metrics.coll_breakdown),
        compute_s=terms["compute"], memory_s=terms["memory"],
        collective_s=terms["collective"],
        bottleneck=max(terms, key=terms.get),
        model_flops=model_flops, useful_ratio=useful,
        xla_flops=metrics.flop_counter_flops)


def model_flops_estimate(cfg, shape_kind: str, tokens: int) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N the parameter
    count.  Mixture-of-experts configs count their active parameters,
    which waits for the MoE layers (ROADMAP Queue 1 item 9a)."""
    from repro_torch.models.registry import get_model
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: the active-parameter count of a mixture of "
            "experts waits for the port's MoE layers (ROADMAP Queue 1 "
            "item 9a)")
    n = get_model(cfg).param_count()
    mult = 6.0 if shape_kind == "train" else 2.0
    return mult * n * tokens
