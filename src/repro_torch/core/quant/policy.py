"""Mixed-precision quantization policy over a parameter tree (port of
`repro/core/quant/policy.py`, the paper's §3.2).

Weights that multiply activations (≥2-D projections) take Δ-PoT;
weights used additively or element-wise (token-shift μ, decay, bonus,
LayerNorm γ/β, embeddings — matched by path, or 1-D) take 9-bit uniform
symmetric.  `QuantPolicy` is the operating point (W9 matmuls, A9
activations); `fake_quantize_tree` and `fake_quantize_tree_with` apply it
(or a Table-1 scheme) as quantize -> dequantize, `quantize_tree` and
`dequantize_tree` as real codes and back.  `PlanePolicy` picks the
serving plane of each matmul tensor: scalar Δ-PoT W8, nibble-packed W4,
or a VQ codebook, by path override, by a fixed default, or by the excess
kurtosis of the weights.

Paths are JAX key strings ("['blocks']['att']['wr']"); trees are nested
dicts, walked in sorted-key order (JAX's flatten order).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.quant.delta_pot import (
    FORMAT_W4, FORMAT_W8, FORMAT_W9, DPotFormat, DPotQuantized,
    dpot_dequantize, dpot_fake_quant, dpot_quantize)
from repro_torch.core.quant.uniform import (
    uniform_dequantize, uniform_fake_quant, uniform_quantize)
from repro_torch.core.quant.vq import vq_dequantize, vq_quantize
from repro_torch.tree import keystr

# path substrings that force the uniform branch even for 2-D tensors
_ADDITIVE_HINTS = re.compile(
    r"(embed|emb_|ln|norm|scale|bias|mu_|time_mix|time_decay|time_first|"
    r"decay|bonus|gamma|beta|_shift|pos_emb|a_log|dt_bias|conv)",
    re.IGNORECASE,
)


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """The mixed-precision operating point."""

    matmul_fmt: DPotFormat = FORMAT_W9   # Δ-PoT format of projections
    additive_bits: int = 9               # uniform bits, additive weights
    activation_bits: int = 9             # uniform bits, activations
    channel_axis: int = -1               # per-output-channel scales
    mse_search: bool = False

    def act_fq(self, x: torch.Tensor) -> torch.Tensor:
        """Activation fake-quant, per tensor (the paper's A9)."""
        return uniform_fake_quant(x, self.activation_bits, None)


def classify_param(path: str, leaf: Any) -> str:
    """'matmul' | 'additive' | 'skip' for a parameter leaf.  `path` is the
    JAX key string form, e.g. "['blocks']['att']['wr']"."""
    if not hasattr(leaf, "ndim"):
        return "skip"
    if leaf.ndim < 2:
        return "additive"
    if _ADDITIVE_HINTS.search(path):
        return "additive"
    return "matmul"


PLANES = ("w8", "w4", "vq")


def _np_f32(w) -> np.ndarray:
    if hasattr(w, "detach"):           # a torch tensor, on any device
        w = w.detach().float().cpu().numpy()
    return np.asarray(w, np.float32)


def weight_outlier_proxy(w, sample: int = 1 << 16) -> float:
    """Excess kurtosis of the weights (~0 for Gaussian weights, large for
    heavy tails), over a deterministic strided subsample."""
    v = _np_f32(w).reshape(-1)
    if v.size > sample:
        v = v[:: (v.size + sample - 1) // sample]
    v = v - v.mean()
    var = float((v * v).mean())
    if var <= 0:
        return 0.0
    return float((v ** 4).mean() / (var * var) - 3.0)


@dataclasses.dataclass(frozen=True)
class PlanePolicy:
    """Which quantized plane each matmul tensor gets.

    default       — "proxy" (threshold `weight_outlier_proxy`) or a fixed
                    plane name ("w8" | "w4" | "vq")
    w4_max_proxy  — proxy <= this -> W4
    vq_min_proxy  — proxy >= this -> VQ; between the two, W8
    vq_codes      — codebook entries (<= 256, uint8 indices)
    overrides     — ((path regex, plane), ...) checked first, in order
    """

    default: str = "proxy"
    w4_max_proxy: float = 1.5
    vq_min_proxy: float = 8.0
    vq_codes: int = 256
    overrides: tuple = ()

    def __post_init__(self):
        if self.default not in PLANES + ("proxy",):
            raise ValueError(f"default={self.default!r}: expected one of "
                             f"{PLANES + ('proxy',)}")
        for pat, plane in self.overrides:
            if plane not in PLANES:
                raise ValueError(f"override {pat!r} -> {plane!r}: expected "
                                 f"one of {PLANES}")

    def plane_for(self, path: str, leaf) -> str:
        """The plane for one matmul leaf (callers classify first); `path`
        is the JAX key string form."""
        for pat, plane in self.overrides:
            if re.search(pat, path):
                return plane
        if self.default != "proxy":
            return self.default
        p = weight_outlier_proxy(leaf)
        if p >= self.vq_min_proxy:
            return "vq"
        if p <= self.w4_max_proxy:
            return "w4"
        return "w8"

    def to_config(self) -> dict:
        return {"default": self.default,
                "w4_max_proxy": float(self.w4_max_proxy),
                "vq_min_proxy": float(self.vq_min_proxy),
                "vq_codes": int(self.vq_codes),
                "overrides": [list(o) for o in self.overrides]}

    @classmethod
    def from_config(cls, cfg) -> "PlanePolicy | None":
        if cfg is None:
            return None
        return cls(default=cfg["default"],
                   w4_max_proxy=cfg["w4_max_proxy"],
                   vq_min_proxy=cfg["vq_min_proxy"],
                   vq_codes=cfg["vq_codes"],
                   overrides=tuple(tuple(o) for o in cfg["overrides"]))


# Presets: the named operating points of the JAX package's ablation.
PLANE_W8 = PlanePolicy(default="w8")
PLANE_W4 = PlanePolicy(default="w4")
PLANE_VQ = PlanePolicy(default="vq")
PLANE_PROXY = PlanePolicy()


def _map_with_path(fn: Callable, tree, path=()):
    """fn(key string, leaf) over every leaf of a nested dict tree."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (k,)) for k in tree}
    return fn(keystr(path), tree)


def _fake_quantize(params, matmul_fn: Callable, additive_bits: int):
    def leaf_fn(p, leaf):
        kind = classify_param(p, leaf)
        if kind == "matmul":
            return matmul_fn(leaf)
        if kind == "additive":
            return uniform_fake_quant(leaf, additive_bits, None)
        return leaf
    return _map_with_path(leaf_fn, params)


def fake_quantize_tree(params, policy: QuantPolicy = QuantPolicy()):
    """Quantize -> dequantize every weight per the policy (accuracy
    evaluation): the same tree, the same dtypes."""
    return _fake_quantize(params, lambda w: dpot_fake_quant(
        w, policy.matmul_fmt.ks, policy.channel_axis, policy.mse_search),
        policy.additive_bits)


def fake_quantize_tree_with(params, scheme_fn: Callable, bits: int = 9,
                            axis=None):
    """A Table-1 scheme on every matmul weight; additive weights always
    take 9-bit uniform (the ablation varies only the matrix scheme)."""
    return _fake_quantize(params, lambda w: scheme_fn(w, bits, axis), 9)


def quantize_tree(params, policy: QuantPolicy = QuantPolicy(), *,
                  planes: PlanePolicy | None = None):
    """Real quantization: matmul weights become `DPotQuantized`, additive
    weights {"codes": int16, "scale": f32}.  With `planes`, each matmul
    tensor takes its plane's format: "w8" FORMAT_W8, "w4" FORMAT_W4 (W8
    where axis -2 is odd), "vq" {"vq_idx", "codebook"}; the stats then
    gain bytes by plane and the selection map.  Returns (tree, stats),
    stats with the byte accounting of the Table-2 resource benchmark."""
    stats = {"bytes_fp16": 0, "bytes_quant": 0}
    by_plane: dict = {}
    plane_map: dict = {}

    def leaf_fn(p, leaf):
        kind = classify_param(p, leaf)
        if kind == "skip":
            return leaf
        stats["bytes_fp16"] += leaf.numel() * 2
        if kind == "additive":
            codes, scale = uniform_quantize(leaf, policy.additive_bits)
            stats["bytes_quant"] += (leaf.numel() * policy.additive_bits
                                     + 7) // 8 + 4
            return {"codes": codes.to(torch.int16), "scale": scale}
        if planes is None:
            q = dpot_quantize(leaf, policy.matmul_fmt,
                              axis=policy.channel_axis,
                              mse_search=policy.mse_search)
            stats["bytes_quant"] += q.nbytes_hardware()
            return q
        plane = planes.plane_for(p, leaf)
        if plane == "w4" and (leaf.ndim < 2 or leaf.shape[-2] % 2):
            plane = "w8"        # nibble pairing needs an even axis -2
        if plane == "vq":
            idx, codebook = vq_quantize(leaf, planes.vq_codes)
            nb = idx.numel() + codebook.numel() * 2
            out = {"vq_idx": idx, "codebook": codebook}
        else:
            out = dpot_quantize(leaf, FORMAT_W4 if plane == "w4"
                                else FORMAT_W8, axis=policy.channel_axis,
                                mse_search=policy.mse_search)
            nb = out.nbytes_hardware()
        plane_map[p] = plane
        by_plane[plane] = by_plane.get(plane, 0) + nb
        stats["bytes_quant"] += nb
        return out

    tree = _map_with_path(leaf_fn, params)
    stats["compression"] = stats["bytes_fp16"] / max(stats["bytes_quant"], 1)
    if planes is not None:
        stats["bytes_by_plane"] = by_plane
        stats["planes"] = plane_map
    return tree, stats


def dequantize_tree(qparams):
    """Inverse of `quantize_tree` (the tests' reference path): f32
    weights."""
    if isinstance(qparams, DPotQuantized):
        return dpot_dequantize(qparams)
    if isinstance(qparams, dict):
        if set(qparams) == {"codes", "scale"}:
            return uniform_dequantize(qparams["codes"], qparams["scale"])
        if set(qparams) == {"vq_idx", "codebook"}:
            return vq_dequantize(qparams["vq_idx"],
                                 qparams["codebook"]).to(torch.float32)
        return {k: dequantize_tree(v) for k, v in qparams.items()}
    return qparams
