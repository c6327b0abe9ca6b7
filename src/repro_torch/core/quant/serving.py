"""Packed-weight serving: the quantized weight planes (port of
`repro/core/quant/serving.py`).

Matmul weights live on the device in one of three plane forms, one dict
shape per plane:

  w8 — {"packed":  uint8 (..., K, N),   "scale": f32 (1, ..., N)}  sign + 7b
  w4 — {"packed4": uint8 (..., K/2, N), "scale": f32 (1, ..., N)}  2 a byte
  vq — {"vq_idx":  uint8 (..., K, N),   "codebook": bf16 (1, C)}   gather

`unpack_leaf` is the single definition of the decode numerics: for W8 and
W4, sign · level in f32, times the channel's f32 scale, rounded once to
bf16; for VQ, the bf16 codebook entry.  The CUDA kernels decode in-kernel
with the same arithmetic (`csrc/common.cuh`).

API:
  pack_params(params, policy)  -> packed tree (+ other floating leaves bf16)
  pack_leaf(key, leaf, policy) -> one leaf of it (models.param.init_params
                                  packs each leaf as it is drawn)
  predecode_packed_leaves(t, paths) -> decode the planes at those paths
  unpack_leaf(leaf)            -> decode ONE plane leaf to bf16
  unpack_params(packed)        -> bf16 compute tree
  plane_fingerprint(params)    -> "fp" | "dpot_w8" | "dpot_mix_<hash>"
  packed_abstract(abstract)    -> the packed tree as meta tensors
  broadcast_packed_scales(t,L) -> shared (1, ...) scales and codebooks ->
                                  (L, ...) views
  cast_compute(tree, dtype)    -> packed-aware compute-dtype cast
  fuse_layer_stack / unfuse_layer / prepare_layer_stack_params
                               -> the whole-model decode's slab form
  PreparedParams               -> the per-path forms of one weight set
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any

import torch

from repro_torch.core.quant.delta_pot import (
    FORMAT_W4, FORMAT_W8, dpot_decode_codes, dpot_pack_int8,
    dpot_pack_nibbles, dpot_quantize, dpot_scale)
from repro_torch.core.quant.policy import PlanePolicy, classify_param
from repro_torch.core.quant.vq import vq_dequantize, vq_quantize
from repro_torch.tree import keystr, leaves_with_path, tree_map

_PLANE_KEYS = {
    frozenset({"packed", "scale"}): "w8",
    frozenset({"packed4", "scale"}): "w4",
    frozenset({"vq_idx", "codebook"}): "vq",
}
# the key of each plane's code tensor (uint8, layer axis first)
CODES_KEY = {"w8": "packed", "w4": "packed4", "vq": "vq_idx"}


def leaf_plane(leaf) -> str | None:
    """"w8" | "w4" | "vq" for a quantized plane leaf, None otherwise."""
    if not isinstance(leaf, dict):
        return None
    return _PLANE_KEYS.get(frozenset(leaf))


def is_packed_leaf(leaf) -> bool:
    """True for any quantized plane leaf (W8, W4 or VQ)."""
    return leaf_plane(leaf) is not None


def _quantize_planes(leaf: torch.Tensor, fmt, pack) -> tuple:
    """Δ-PoT-quantize a matmul leaf and pack it with `pack`, one slice of
    axis 0 at a time when the leaf is stacked (3-D and up): the shared
    (1, ..., N) scale is reduced over every slice first, so the bytes
    equal a whole-leaf `dpot_quantize`, but the f32 and int64
    temporaries are one layer's, not the stack's (rwkv6-7b's stacked
    ffn.wk holds 1.9e9 weights)."""
    if leaf.ndim < 3:
        q = dpot_quantize(leaf, fmt, axis=-1)
        return pack(q), q.scale.to(torch.float32)
    red = tuple(range(leaf.ndim - 2))
    amax = torch.stack([leaf[i].to(torch.float32).abs().amax(
        dim=red, keepdim=True) for i in range(leaf.shape[0])]).amax(dim=0)
    scale = dpot_scale(amax, fmt)
    codes = torch.stack([pack(dpot_quantize(leaf[i], fmt, scale=scale))
                         for i in range(leaf.shape[0])])
    return codes, scale[None].to(torch.float32)


def pack_leaf(key: str, leaf, policy: PlanePolicy | None = None):
    """One leaf of `pack_params`: a matmul weight to its plane, another
    floating leaf to bf16, anything else as it is.  `key` is the leaf's
    JAX key string ("['blocks']['att']['wr']")."""
    if classify_param(key, leaf) != "matmul":
        if torch.is_floating_point(leaf):
            return leaf.to(torch.bfloat16)
        return leaf
    plane = "w8" if policy is None else policy.plane_for(key, leaf)
    if plane == "w4" and (leaf.ndim < 2 or leaf.shape[-2] % 2):
        plane = "w8"
    if plane == "vq":
        idx, codebook = vq_quantize(leaf, policy.vq_codes)
        return {"vq_idx": idx, "codebook": codebook}
    if plane == "w4":
        codes, scale = _quantize_planes(leaf, FORMAT_W4, dpot_pack_nibbles)
        return {"packed4": codes, "scale": scale}
    codes, scale = _quantize_planes(leaf, FORMAT_W8, dpot_pack_int8)
    return {"packed": codes, "scale": scale}


def pack_params(params, policy: PlanePolicy | None = None):
    """Quantize every matmul weight to a plane; cast the other floating
    leaves to bf16.  Without a policy every matmul weight is W8; with one,
    each tensor gets the policy's plane, W4 falling back to W8 where the
    contraction axis is odd (nibbles pair along it)."""
    out: dict = {}
    for path, leaf in leaves_with_path(params):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = pack_leaf(keystr(path), leaf, policy)
    return out


def predecode_packed_leaves(params, paths):
    """Decode the plane leaves at the given key paths (tuples of dict
    keys) with `unpack_leaf`, leaving everything else, plain leaves at
    those paths included, as it is: rwkv6's chunked prefill consumes a
    few packed leaves element-wise, so it decodes them once at startup
    and every other plane streams its codes into a kernel."""
    def update(node, path):
        if not path:
            return unpack_leaf(node) if is_packed_leaf(node) else node
        head, rest = path[0], path[1:]
        return {**node, head: update(node[head], rest)}

    for path in paths:
        params = update(params, tuple(path))
    return params


def _sign(bits: torch.Tensor) -> torch.Tensor:
    ones = torch.ones(bits.shape, dtype=torch.float32, device=bits.device)
    return torch.where(bits.bool(), -ones, ones)


def _decode_plane(plane: str, codes: torch.Tensor, aux: torch.Tensor):
    if plane == "vq":
        return vq_dequantize(codes, aux).to(torch.bfloat16)
    if plane == "w4":
        words = torch.stack([codes & 0xF, (codes >> 4) & 0xF], dim=-2)
        words = words.reshape(codes.shape[:-2] + (2 * codes.shape[-2],
                                                  codes.shape[-1]))
        lvl = dpot_decode_codes(words & 0x7, FORMAT_W4.ks)
        return (_sign((words >> 3) & 1) * lvl * aux).to(torch.bfloat16)
    lvl = dpot_decode_codes(codes & 0x7F, FORMAT_W8.ks)
    return (_sign((codes >> 7) & 1) * lvl * aux).to(torch.bfloat16)


def unpack_leaf(leaf):
    """Decode one plane leaf -> bf16 weights (identity on anything else).
    W4 re-interleaves the nibble pairs along the contraction axis (low
    nibble = even row) before the same decode as W8; VQ gathers from the
    flattened codebook.  A stacked leaf (3-D and up) decodes one slice of
    axis 0 at a time into its output: the decode is elementwise, so the
    bits equal a whole-leaf decode, while the f32 and int64 temporaries
    are one layer's (rwkv6-7b's stacked ffn.wk would take ~15 GB of int64
    indices and several 7.5 GB f32 temporaries at once)."""
    plane = leaf_plane(leaf)
    if plane is None:
        return leaf
    codes = leaf[CODES_KEY[plane]]
    aux = leaf["codebook" if plane == "vq" else "scale"]
    if codes.ndim < 3:
        return _decode_plane(plane, codes, aux)
    out = None
    for i in range(codes.shape[0]):
        a = aux
        if plane != "vq" and aux.ndim == codes.ndim:
            a = aux[i if aux.shape[0] > 1 else 0]
        w = _decode_plane(plane, codes[i], a)
        if out is None:
            out = torch.empty((codes.shape[0],) + tuple(w.shape),
                              dtype=torch.bfloat16, device=codes.device)
        out[i] = w
    return out


def unpack_params(packed):
    return tree_map(unpack_leaf, packed, is_leaf=is_packed_leaf)


def plane_fingerprint(params) -> str:
    """The quant-form fingerprint of a (possibly packed) tree, as JAX's
    `plane_fingerprint` gives it: "fp" when nothing is packed, "dpot_w8"
    when every plane is W8, else "dpot_mix_" + a 4-byte blake2b of the
    repr of the [(key string, plane), ...] list in flatten order, so two
    per-tensor selections never share a fingerprint."""
    kinds = [(keystr(path), leaf_plane(leaf)) for path, leaf in
             leaves_with_path(params, is_leaf=is_packed_leaf)
             if is_packed_leaf(leaf)]
    if not kinds:
        return "fp"
    if all(k == "w8" for _, k in kinds):
        return "dpot_w8"
    h = hashlib.blake2b(repr(kinds).encode(), digest_size=4).hexdigest()
    return f"dpot_mix_{h}"


def broadcast_packed_scales(blocks, n_layers: int):
    """Give every stacked plane leaf's shared (1, ...) scale or codebook
    the layer axis (an expand view), so a per-layer slice decodes like
    the whole."""
    def fix(leaf):
        if not is_packed_leaf(leaf):
            return leaf
        out = {}
        for k, v in leaf.items():
            if k in ("scale", "codebook") and v.shape[0] == 1:
                v = v.expand((n_layers,) + tuple(v.shape[1:]))
            out[k] = v
        return out
    return tree_map(fix, blocks, is_leaf=is_packed_leaf)


def cast_compute(tree, dtype):
    """Floating leaves to `dtype`; plane leaves pass through intact so the
    uint8 codes, f32 scales and bf16 codebooks reach the kernels
    unchanged."""
    def cast(a):
        if is_packed_leaf(a):
            return a
        if torch.is_tensor(a) and torch.is_floating_point(a):
            return a.to(dtype)
        return a
    return tree_map(cast, tree, is_leaf=is_packed_leaf)


def packed_abstract(abstract_params):
    """The W8 packed form of an abstract (meta-tensor) parameter tree, as
    `pack_params` shapes it: each matmul leaf {"packed": uint8 of its
    shape, "scale": f32 (1, ..., N)}, every other leaf bf16.  Meta tensors
    carry the shapes and dtypes only (JAX's ShapeDtypeStructs; JAX's
    function also takes the spec tree, which it does not read)."""

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    out: dict = {}
    for path, leaf in leaves_with_path(abstract_params):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        shape = tuple(leaf.shape)
        if classify_param(keystr(path), leaf) == "matmul":
            node[path[-1]] = {
                "packed": meta(shape, torch.uint8),
                "scale": meta((1,) * (len(shape) - 1) + shape[-1:],
                              torch.float32)}
        else:
            node[path[-1]] = meta(shape, torch.bfloat16)
    return out


# ---------------------------------------------------------------------------
# Fused layer stack: each layer's weights as one contiguous row per dtype
# ---------------------------------------------------------------------------


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class FusedLayerStack:
    """A stacked per-layer parameter tree in slab form.

    slabs    — {dtype name: (L, N) tensor}: layer l's leaves of that
               dtype, flattened and concatenated in flatten order.
    aux      — leading-1 leaves kept out of the slabs (the shared scales
               and codebooks), whole.
    manifest — one entry per leaf, in flatten order: ("slab", dtype name,
               offset in elements, per-layer shape) or ("aux", index).
    tdef     — the leaves' paths, in flatten order (sorted keys, inside
               plane dicts too), from which `unfuse_layer` rebuilds the
               tree.
    """
    slabs: dict
    aux: tuple
    manifest: tuple
    tdef: tuple

    @property
    def n_layers(self) -> int:
        return next(iter(self.slabs.values())).shape[0]


def fuse_layer_stack(blocks, n_layers: int) -> FusedLayerStack:
    """Pack a stacked block tree into per-dtype (L, N) slabs, the layout
    of the JAX package's `fuse_layer_stack` byte for byte.  Values are
    only reshaped and concatenated, so unfusing is exact."""
    flat = leaves_with_path(blocks)
    manifest, aux, parts, offs = [], [], {}, {}
    for path, leaf in flat:
        if leaf.ndim and leaf.shape[0] == n_layers:
            key = _dtype_name(leaf)
            shape = tuple(leaf.shape[1:])
            n = math.prod(shape)
            manifest.append(("slab", key, offs.get(key, 0), shape))
            parts.setdefault(key, []).append(leaf.reshape(n_layers, n))
            offs[key] = offs.get(key, 0) + n
        elif leaf.ndim and leaf.shape[0] == 1:
            manifest.append(("aux", len(aux)))
            aux.append(leaf)
        else:
            raise ValueError(
                f"per-layer leaf {keystr(path)} has shape "
                f"{tuple(leaf.shape)}; expected a leading axis of "
                f"{n_layers} (stacked) or 1 (shared)")
    slabs = {k: torch.cat(v, dim=1).contiguous() for k, v in parts.items()}
    return FusedLayerStack(slabs, tuple(aux), tuple(manifest),
                           tuple(p for p, _ in flat))


def unfuse_layer(rows: dict, aux_vals, manifest, tdef):
    """Rebuild one layer's tree: rows {dtype name: (N,) slab row}, aux_vals
    the shared leaves with the leading 1 squeezed."""
    out: dict = {}
    for path, entry in zip(tdef, manifest):
        if entry[0] == "slab":
            _, key, off, shape = entry
            leaf = rows[key][off:off + math.prod(shape)].reshape(shape)
        else:
            leaf = aux_vals[entry[1]]
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def prepare_layer_stack_params(params, cfg, extra_block_operands=None):
    """The whole-model decode's one-time prep: the packed-aware compute
    cast, any extra per-block kernel operands attached (rwkv4's hw LUT
    tables), then the stacked blocks into slabs (`fuse_layer_stack`)."""
    params = cast_compute(params, getattr(torch, cfg.dtype))
    blocks = params["blocks"]
    if extra_block_operands:
        blocks = {**blocks, **extra_block_operands}
    return {**params, "blocks": fuse_layer_stack(blocks, cfg.n_layers)}


@dataclasses.dataclass(frozen=True)
class PreparedParams:
    """Every per-path form of one weight set, prepared once at startup.

      raw     — the tree as stored (packed planes when `quantized`)
      decode  — the form the decode path consumes (the "model" path's
                `FusedLayerStack` slabs; == raw for the others)
      prefill — the form the prefill path consumes
      decode_path / prefill_path — the paths that produced the forms
    """
    raw: Any
    decode: Any
    prefill: Any
    quantized: bool = False
    decode_path: str = "per_op"
    prefill_path: str = "per_op"
