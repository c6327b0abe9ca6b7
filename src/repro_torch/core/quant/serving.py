"""Packed-weight serving, Δ-PoT W8 plane (port of
`repro/core/quant/serving.py`).

Matmul weights live on the device as ONE uint8 per weight (sign + ks=(3,4)
code) plus an f32 scale per output channel: `{"packed": uint8 (..., K, N),
"scale": f32 (1, ..., N)}`.  `unpack_leaf` is the single definition of the
decode numerics: sign · level in f32, times the scale in f32, rounded once
to bf16.  The CUDA kernels decode in-kernel with the same arithmetic
(`csrc/common.cuh:dpot_w8_decode`).

API:
  pack_params(params)          -> packed tree (+ other floating leaves bf16)
  unpack_leaf(leaf)            -> decode ONE packed leaf to bf16
  unpack_params(packed)        -> bf16 compute tree
  broadcast_packed_scales(t,L) -> stacked scales (1,1,N) -> (L,1,N) views
  cast_compute(tree, dtype)    -> packed-aware compute-dtype cast
  PreparedParams               -> the per-path forms of one weight set
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.quant.delta_pot import (
    FORMAT_W8, dpot_decode_codes, dpot_pack_int8, dpot_quantize)
from repro_torch.core.quant.policy import classify_param
from repro_torch.tree import keystr, leaves_with_path, tree_map


def leaf_plane(leaf) -> str | None:
    """"w8" for a packed W8 leaf, None otherwise (the W4 and VQ planes are
    not ported yet)."""
    if isinstance(leaf, dict) and set(leaf) == {"packed", "scale"}:
        return "w8"
    return None


def is_packed_leaf(leaf) -> bool:
    return leaf_plane(leaf) is not None


def pack_params(params):
    """Quantize every matmul weight to Δ-PoT W8; cast the other floating
    leaves to bf16."""
    out: dict = {}
    for path, leaf in leaves_with_path(params):
        if classify_param(keystr(path), leaf) == "matmul":
            q = dpot_quantize(leaf, FORMAT_W8, axis=-1)
            new = {"packed": dpot_pack_int8(q),
                   "scale": q.scale.to(torch.float32)}
        elif torch.is_floating_point(leaf):
            new = leaf.to(torch.bfloat16)
        else:
            new = leaf
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = new
    return out


def unpack_leaf(leaf):
    """Decode one packed leaf -> bf16 weights (identity on anything else)."""
    if leaf_plane(leaf) is None:
        return leaf
    p = leaf["packed"]
    codes = p & 0x7F
    ones = torch.ones(p.shape, dtype=torch.float32, device=p.device)
    sign = torch.where(((p >> 7) & 1).bool(), -ones, ones)
    lvl = dpot_decode_codes(codes, FORMAT_W8.ks)
    return (sign * lvl * leaf["scale"]).to(torch.bfloat16)


def unpack_params(packed):
    return tree_map(unpack_leaf, packed, is_leaf=is_packed_leaf)


def broadcast_packed_scales(blocks, n_layers: int):
    """Give every stacked packed leaf's shared (1, 1, N) scale the layer
    axis (an expand view), so a per-layer slice decodes like the whole."""
    def fix(leaf):
        if not is_packed_leaf(leaf):
            return leaf
        s = leaf["scale"]
        if s.shape[0] == 1:
            s = s.expand((n_layers,) + tuple(s.shape[1:]))
        return {"packed": leaf["packed"], "scale": s}
    return tree_map(fix, blocks, is_leaf=is_packed_leaf)


def cast_compute(tree, dtype):
    """Floating leaves to `dtype`; packed leaves pass through intact so the
    uint8 codes and f32 scales reach the kernels unchanged."""
    def cast(a):
        if is_packed_leaf(a):
            return a
        if torch.is_tensor(a) and torch.is_floating_point(a):
            return a.to(dtype)
        return a
    return tree_map(cast, tree, is_leaf=is_packed_leaf)


@dataclasses.dataclass(frozen=True)
class PreparedParams:
    """Every per-path form of one weight set, prepared once at startup.

      raw     — the tree as stored (packed Δ-PoT when `quantized`)
      decode  — the form the decode path consumes
      prefill — the form the prefill path consumes
    """
    raw: Any
    decode: Any
    prefill: Any
    quantized: bool = False
