"""RWKV-4 decode in one launch per layer (kernel K3) or one launch for the
whole layer stack (kernel K4).

Port of `repro/kernels/fused_decode.py`: `rwkv4_block_decode` replaces
`fused_block_decode` and `rwkv4_model_decode` replaces `fused_model_decode`,
both for the RWKV-4 body with exact numerics.  Pallas traced the model's
`block_decode` inside the kernel; CUDA cannot trace, so the body is
written into `csrc/rwkv4_body.cuh`, which rounds to bf16 at the places the
JAX trace does, and which both kernels run: L launches of K3 and one of
K4 give the same bits.  The TPU's "stream" and "resident" forms of K4
compute the same bits too, and on Hopper collapse into one layer loop
inside the launch, so K4 has one form.  The sources' headers say what
bounds each kernel on an H100 and how the design answers that.

Every matrix may arrive as a W8, W4 or VQ plane (`core/quant/serving.py`);
K3 takes the layer's tree, K4 the `FusedLayerStack` slab form, whose
manifest the wrapper turns into a table of offsets and planes.

A CPU tensor takes the plain version — `models/rwkv4.py:block_decode` on
the layer's weights decoded by `unpack_leaf`, exactly what the JAX kernel
body ran, in a Python loop over layers for K4; a CUDA tensor launches the
kernel or raises (the kernels take quantized planes and a bf16 state
only; plain bf16 weights are not ported).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.quant.serving import (
    CODES_KEY, FusedLayerStack, is_packed_leaf, leaf_plane, unfuse_layer,
    unpack_leaf)
from repro_torch.device import exact_matmuls
from repro_torch.kernels.build import check, load_library, stream_ptr
from repro_torch.tree import tree_map

# the RWKV-4 decode state leaves, in the order the kernels take them
STATE_KEYS = ("att_x", "ffn_x", "wkv_a", "wkv_b", "wkv_o")
# a layer's vector leaves and matrices, in the kernels' order
# (csrc/rwkv4_body.cuh: enum Vec, enum Mat)
VEC_KEYS = (("ln1", "scale"), ("ln1", "bias"), ("ln2", "scale"),
            ("ln2", "bias"), ("att", "time_mix_r"), ("att", "time_mix_k"),
            ("att", "time_mix_v"), ("att", "time_decay"),
            ("att", "time_first"), ("ffn", "time_mix_r"),
            ("ffn", "time_mix_k"))
MAT_KEYS = (("att", "wr"), ("att", "wk"), ("att", "wv"), ("att", "wo"),
            ("ffn", "wr"), ("ffn", "wk"), ("ffn", "wv"))
PLANE_IDS = {"w8": 0, "w4": 1, "vq": 2}   # csrc/common.cuh: enum Plane
MAX_BB = 8                  # batch lanes per block the kernels instantiate
SMEM_BYTES = 232_448        # shared memory one H100 block may use (227 KB)


def _mat_shapes(D: int, F: int):
    return ((D, D),) * 5 + ((D, F), (F, D))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@exact_matmuls()
def rwkv4_block_decode_plain(lp, st, x):
    """The plain version: decode the plane leaves, run `block_decode`."""
    from repro_torch.models.rwkv4 import block_decode
    lp = tree_map(lambda l: unpack_leaf(l).to(x.dtype)
                  if is_packed_leaf(l) else l, lp, is_leaf=is_packed_leaf)
    return block_decode(lp, st, x)


def rwkv4_model_decode_plain(blocks: FusedLayerStack, state, x):
    """The plain version of K4: for each layer, unfuse its slab rows and
    run K3's plain version, the body the Pallas kernel ran per layer."""
    aux = [a[0] for a in blocks.aux]          # the leading 1 squeezed
    new = []
    for l in range(blocks.n_layers):
        rows = {k: s[l] for k, s in blocks.slabs.items()}
        lp = unfuse_layer(rows, aux, blocks.manifest, blocks.tdef)
        x, st = rwkv4_block_decode_plain(
            lp, {k: state[k][l] for k in STATE_KEYS}, x)
        new.append(st)
    return x, {k: torch.stack([s[k] for s in new]) for k in STATE_KEYS}


def default_bb(B: int) -> int:
    """The batch tile: the whole batch in one block (as fused_decode.py:91)
    when it fits the kernel, else the largest divisor of B that does."""
    return max(d for d in range(1, min(B, MAX_BB) + 1) if B % d == 0)


def check_tile(B: int, bb: int, D: int, F: int):
    """Raise unless bb lanes divide B, lie in [1, MAX_BB] and their
    intermediates, (6·D + F)·2 bytes a lane, fit one block's shared
    memory.  There is no silent smaller tile."""
    if not 1 <= bb <= MAX_BB or B % bb:
        raise ValueError(f"batch tile bb={bb} must divide B={B} and lie in "
                         f"[1, {MAX_BB}]")
    need = bb * (6 * D + F) * 2
    if need > SMEM_BYTES:
        raise ValueError(
            f"batch tile bb={bb} at D={D}, F={F} needs {need} B of shared "
            f"memory, over the {SMEM_BYTES} B (227 KB) a block may use; "
            "pass a smaller bb")


def _vec(t, n: int, name: str):
    if t.shape != (n,) or t.dtype != torch.bfloat16:
        raise ValueError(f"{name}: expected bf16 {(n,)}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def _aux(plane: str, aux: torch.Tensor, N: int, name: str):
    """A matrix's scale (W8, W4: N f32) or codebook (VQ: <= 256 bf16)."""
    aux = aux.reshape(-1)
    if plane == "vq":
        if aux.dtype != torch.bfloat16 or not 1 <= aux.numel() <= 256:
            raise ValueError(f"{name}: codebook must be bf16 with 1..256 "
                             f"entries, got {aux.dtype} {aux.numel()}")
    elif aux.dtype != torch.float32 or aux.numel() != N:
        raise ValueError(f"{name}: scale must be f32 with {N} entries, got "
                         f"{aux.dtype} {aux.numel()}")
    return aux.contiguous()


def _codes_shape(plane: str, K: int, N: int):
    return (K // 2, N) if plane == "w4" else (K, N)


def _layer_matrix(leaf, K: int, N: int, name: str):
    """(codes, scale or codebook, plane id) of one plane leaf."""
    plane = leaf_plane(leaf)
    if plane is None:
        raise TypeError(f"the decode kernels take W8, W4 or VQ planes; "
                        f"{name} is not one")
    codes = leaf[CODES_KEY[plane]]
    want = _codes_shape(plane, K, N)
    if (codes.shape != want or codes.dtype != torch.uint8
            or not codes.is_contiguous()):
        raise ValueError(f"{name}: codes must be contiguous uint8 {want}, "
                         f"got {codes.dtype} {tuple(codes.shape)}")
    aux = leaf["codebook"] if plane == "vq" else leaf["scale"]
    return codes, _aux(plane, aux, N, name), PLANE_IDS[plane]


def _state_in(st, shape, name: str):
    out = []
    for k in STATE_KEYS:
        s = st[k]
        if tuple(s.shape) != shape or s.dtype != torch.bfloat16:
            raise TypeError(f"{name} state {k}: expected bf16 {shape}, got "
                            f"{s.dtype} {tuple(s.shape)}")
        out.append(s.contiguous())
    return out


def _launch_ptrs(tensors):
    """The tensors' device pointers as a C array."""
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError("decode kernel: operands on several devices")
    ptrs = [t.data_ptr() for t in tensors]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def rwkv4_block_decode(lp, st, x, *, bb: int | None = None):
    """One layer's decode step: lp the layer's params (compute-cast, plane
    leaves with a (1, N) scale or a codebook), st the five (B, D) state
    leaves, x (B, D) bf16 -> (x2 (B, D), new state)."""
    if x.device.type == "cpu":
        return rwkv4_block_decode_plain(lp, st, x)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bf16, got {x.dtype}")
    B, D = x.shape
    wk = lp["ffn"]["wk"]
    if not is_packed_leaf(wk):
        raise TypeError("the decode kernels take W8, W4 or VQ planes; "
                        "ffn.wk is not one")
    F = wk[CODES_KEY[leaf_plane(wk)]].shape[-1]
    bb = default_bb(B) if bb is None else int(bb)
    check_tile(B, bb, D, F)
    vecs = [_vec(_get(lp, p), D, ".".join(p)) for p in VEC_KEYS]
    mats = [_layer_matrix(_get(lp, p), K, N, ".".join(p))
            for p, (K, N) in zip(MAT_KEYS, _mat_shapes(D, F))]
    states = _state_in(st, (B, D), "rwkv4_block_decode")
    outs = [torch.empty((B, D), dtype=torch.bfloat16, device=x.device)
            for _ in range(1 + len(STATE_KEYS))]
    arr = _launch_ptrs([x.contiguous(), outs[0], *vecs,
                        *(m[0] for m in mats), *(m[1] for m in mats),
                        *states, *outs[1:]])
    planes = (ctypes.c_int * len(mats))(*(m[2] for m in mats))
    check(load_library().rwkv4_block_decode(
        arr, len(arr), planes, B, D, F, bb, stream_ptr(x)),
        "rwkv4_block_decode")
    rwkv4_block_decode.launches += 1
    return outs[0], dict(zip(STATE_KEYS, outs[1:]))


rwkv4_block_decode.launches = 0


class MatEntry(NamedTuple):
    """One matrix in K4's table: its codes' offset in a uint8 slab row,
    its scale or codebook (an aux leaf, shared by every layer) and its
    plane."""
    offset: int
    aux: torch.Tensor
    plane: int


def stack_table(blocks: FusedLayerStack, D: int):
    """The K4 table of a slab stack, checked against the expected shapes:
    (F, the vectors' offsets in a bf16 slab row, [MatEntry] per matrix).
    Raises on a leaf the kernel does not take or a shape it does not
    expect, and unless every scale and codebook is an aux leaf shared by
    every layer (a one-layer stack keeps them in its slabs)."""
    entries = dict(zip(blocks.tdef, blocks.manifest))
    used = set()

    def entry(path, kind):
        e = entries.get(path)
        if e is None or e[0] != kind:
            raise ValueError(f"FusedLayerStack: {'.'.join(path)} must be a "
                             f"leaf of kind {kind!r}, got {e}")
        used.add(path)
        return e

    def slab_offset(path, dtype, shape):
        _, key, off, got = entry(path, "slab")
        if key != dtype or tuple(got) != shape:
            raise ValueError(f"FusedLayerStack: {'.'.join(path)} is {key} "
                             f"{tuple(got)}, expected {dtype} {shape}")
        return off

    def plane_of(path):
        keys = {p[-1]: None for p in blocks.tdef if p[:-1] == path}
        plane = leaf_plane(keys)
        if plane is None:
            raise TypeError(f"the decode kernels take W8, W4 or VQ planes; "
                            f"{'.'.join(path)} is not one")
        return plane

    wk_plane = plane_of(("ffn", "wk"))
    wk_codes = entries.get(("ffn", "wk", CODES_KEY[wk_plane]))
    if wk_codes is None or wk_codes[0] != "slab":
        raise ValueError("FusedLayerStack: ffn.wk codes must be a slab leaf")
    F = wk_codes[3][-1]
    vec_offs = [slab_offset(p, "bfloat16", (D,)) for p in VEC_KEYS]
    mats = []
    for path, (K, N) in zip(MAT_KEYS, _mat_shapes(D, F)):
        plane = plane_of(path)
        off = slab_offset(path + (CODES_KEY[plane],), "uint8",
                          _codes_shape(plane, K, N))
        aux_path = path + ("codebook" if plane == "vq" else "scale",)
        aux = _aux(plane, blocks.aux[entry(aux_path, "aux")[1]], N,
                   ".".join(aux_path))
        mats.append(MatEntry(off, aux, PLANE_IDS[plane]))
    extra = set(blocks.tdef) - used
    if extra:
        raise ValueError(f"FusedLayerStack holds leaves K4 does not take: "
                         f"{sorted('.'.join(p) for p in extra)}")
    return F, vec_offs, mats


def rwkv4_model_decode(blocks: FusedLayerStack, state, x, *,
                       bb: int | None = None):
    """The whole L-layer decode step: blocks the slab form of the stacked
    layers (`fuse_layer_stack` of the compute-cast tree), state the five
    (L, B, D) leaves, x (B, D) bf16 -> (x out (B, D), new state)."""
    if not isinstance(blocks, FusedLayerStack):
        raise TypeError("rwkv4_model_decode takes a FusedLayerStack "
                        "(core/quant/serving.py:fuse_layer_stack)")
    if x.device.type == "cpu":
        return rwkv4_model_decode_plain(blocks, state, x)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bf16, got {x.dtype}")
    B, D = x.shape
    L = blocks.n_layers
    F, vec_offs, mats = stack_table(blocks, D)
    bb = default_bb(B) if bb is None else int(bb)
    check_tile(B, bb, D, F)
    u8, b16 = blocks.slabs["uint8"], blocks.slabs["bfloat16"]
    if not (u8.is_contiguous() and b16.is_contiguous()):
        raise ValueError("FusedLayerStack slabs must be contiguous")
    states = _state_in(state, (L, B, D), "rwkv4_model_decode")
    x_out = torch.empty((B, D), dtype=torch.bfloat16, device=x.device)
    outs = [torch.empty((L, B, D), dtype=torch.bfloat16, device=x.device)
            for _ in STATE_KEYS]
    arr = _launch_ptrs([x.contiguous(), x_out, u8, b16,
                        *(m.aux for m in mats), *states, *outs])
    offs = (ctypes.c_longlong * (2 + len(vec_offs) + len(mats)))(
        u8.shape[1], b16.shape[1], *vec_offs, *(m.offset for m in mats))
    planes = (ctypes.c_int * len(mats))(*(m.plane for m in mats))
    check(load_library().rwkv4_model_decode(
        arr, len(arr), offs, len(offs), planes, L, B, D, F, bb,
        stream_ptr(x)), "rwkv4_model_decode")
    rwkv4_model_decode.launches += 1
    return x_out, dict(zip(STATE_KEYS, outs))


rwkv4_model_decode.launches = 0
