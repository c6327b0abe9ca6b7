"""RWKV decode in one launch per layer or one launch for the whole layer
stack: kernels K3 and K4 (RWKV-4) and the two forms of K7 (RWKV-6).

Port of `repro/kernels/fused_decode.py`: `rwkv4_block_decode` and
`rwkv6_block_decode` replace `fused_block_decode`, `rwkv4_model_decode`
and `rwkv6_model_decode` replace `fused_model_decode`, each for its
model's body.  Pallas traced the model's `block_decode` inside the
kernel; CUDA cannot trace, so each body is written into
`csrc/rwkv4_grid.cuh` or `csrc/rwkv6_body.cuh`, which round to bf16 at
the places the JAX trace does, and which both forms of a model run: L
block launches and one model launch give the same bits.  The TPU's
"stream" and "resident" forms of the whole-model kernel compute the same
bits too, and on Hopper become one layer loop inside the launch (for
RWKV-4 the stream form: each layer's weights copied in behind the layer
before).  The sources' headers say what bounds each kernel on an H100 and
how the design answers that.

Every form takes W8, W4 or VQ planes (`core/quant/serving.py`, a mixed
policy's layer holding several) and plain bf16 weights (a tree that was
never packed), as the JAX kernels take packed and plain trees; a plain
matrix in another dtype raises.  K3 spreads a layer over the whole card
(a cooperative launch; `k3_plan` gives its split and shared memory) and
K4 is the same kernel looping over every layer in one launch (its ring of
weight stages crossing layers, `K3Plan.ring`), both under the exact
numerics or the paper's hardware numerics (LUT exp and division, PWL σ,
A9 activations), with the same arithmetic for every output:
K3 takes the EXP and DIV tables as `luts=`, K4 finds them as the stack's
`_luts` aux leaves (`prepare_fused_model_params(hw=True)`).  Under the
hardware numerics the A9 scale spans the tile's lanes, so a tile of
bb < B lanes gives other bits than the whole batch, exactly as the TPU
kernel body, which sees one tile, does (`fused_decode.py:249-252`); the
plain versions split the batch into the same tiles.  K7 spreads each
rwkv6-7b layer (220 MB of W8 codes) over the whole card as a cooperative
launch of one block an SM, each block streaming its strips of weights
through a ring of asynchronous copies into tensor-core products, with
seven grid barriers a layer (`k7_plan` gives its plan), under the exact
numerics (the JAX package has no RWKV-6 hardware numerics).  A W4 leaf
must pair rows within a layer: `pack_leaf` pairs a (L, D) leaf such as
time_maa_x along the layer axis, which K7 refuses, as the JAX fused paths
cannot take it either.  The block forms take the layer's tree, the model
forms the `FusedLayerStack` slab form, whose manifest the wrapper turns
into a table of offsets and planes.

A CPU tensor takes the plain version — the model's `block_decode` on the
layer's weights decoded by `unpack_leaf`, exactly what the JAX kernel
body ran, in a Python loop over layers for the model forms; a CUDA tensor
launches the kernel or raises (the kernels take a bf16 state only).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.quant.serving import (
    CODES_KEY, FusedLayerStack, is_packed_leaf, leaf_plane, unfuse_layer,
    unpack_leaf)
from repro_torch.device import exact_matmuls
from repro_torch.kernels.build import (
    check, counted, load_library, meta_empty, meta_like, stream_ptr)
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
# csrc/common.cuh: enum Plane ("bf16": plain weights, never packed)
PLANE_IDS = {"w8": 0, "w4": 1, "vq": 2, "bf16": 3}
PLANE_NAMES = {v: k for k, v in PLANE_IDS.items()}
MAX_BB = 8                  # batch lanes a tile of the kernels holds
SMEM_BYTES = 232_448        # shared memory one H100 block may use (227 KB)
LUT_KEYS = ("exp", "div")   # the `_luts` operands, EXP and DIV tables
# K3's grid-wide body (csrc/rwkv4_grid.cuh): columns a slice, rows a stage
# of phase A (3x in the other phases), the most ring slots
K3_WIDTH = 16               # columns a slice
K3_STAGE_ROWS = 128
K3_MAX_STAGES = 24
K3_SCALE_BYTES = 64         # a slice's 16 f32 column scales, in its stage
HW_SCRATCH_FLOATS = 512 + 3 * 33   # csrc/rwkv4_body.cuh: kHwScratch
K3_STATIC_BYTES = 1024      # K3's static shared memory (its layer table)


def _mat_shapes(D: int, F: int):
    return ((D, D),) * 5 + ((D, F), (F, D))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _numerics(luts):
    from repro_torch.models.rwkv4 import _Std, _hw_numerics_with_tables
    if luts is None:
        return _Std
    return _hw_numerics_with_tables(luts["exp"], luts["div"])


@exact_matmuls()
def rwkv4_block_decode_plain(lp, st, x, nm=None, *, bb: int | None = None):
    """The plain version: decode the plane leaves, run `block_decode` with
    the numerics `nm` (None: exact).  Under the hardware numerics a tile
    of bb < B lanes runs alone, as it does in the kernel; the exact
    numerics' lanes do not depend on each other."""
    from repro_torch.models.rwkv4 import _Std, block_decode
    nm = _Std if nm is None else nm
    lp = tree_map(lambda l: unpack_leaf(l).to(x.dtype)
                  if is_packed_leaf(l) else l, lp, is_leaf=is_packed_leaf)
    B = x.shape[0]
    if not nm.hw or bb is None or bb >= B:
        return block_decode(lp, st, x, nm)
    outs = [block_decode(lp, {k: v[i:i + bb] for k, v in st.items()},
                         x[i:i + bb], nm) for i in range(0, B, bb)]
    return (torch.cat([o[0] for o in outs]),
            {k: torch.cat([o[1][k] for o in outs]) for k in STATE_KEYS})


def rwkv4_model_decode_plain(blocks: FusedLayerStack, state, x, *,
                             bb: int | None = None):
    """The plain version of K4: for each layer, unfuse its slab rows and
    run K3's plain version, the body the Pallas kernel ran per layer, with
    the hardware numerics when the stack carries `_luts`."""
    aux = [a[0] for a in blocks.aux]          # the leading 1 squeezed
    new = []
    for l in range(blocks.n_layers):
        rows = {k: s[l] for k, s in blocks.slabs.items()}
        lp = unfuse_layer(rows, aux, blocks.manifest, blocks.tdef)
        nm = _numerics(lp.pop("_luts", None))
        x, st = rwkv4_block_decode_plain(
            lp, {k: state[k][l] for k in STATE_KEYS}, x, nm, bb=bb)
        new.append(st)
    return x, {k: torch.stack([s[k] for s in new]) for k in STATE_KEYS}


def default_bb(B: int, most: int = MAX_BB) -> int:
    """The batch tile: the whole batch in one block (as fused_decode.py:91)
    when it fits the kernel, else the largest divisor of B that does."""
    return max(d for d in range(1, min(B, most) + 1) if B % d == 0)


# K3's phases (csrc/rwkv4_grid.cuh: enum Phase), each with its items'
# matrices: (names, output width "D" or "F", contraction rows "D" or "F")
K3_PHASES = (
    ("A", (("att", "wr"), ("att", "wk"), ("att", "wv")), "D", "D"),
    ("B", (("att", "wo"),), "D", "D"),
    ("C", (("ffn", "wk"),), "F", "D"),
    ("C", (("ffn", "wr"),), "D", "D"),
    ("D", (("ffn", "wv"),), "D", "F"),
)


class K3Plan(NamedTuple):
    """K3's split of a layer and a block's shared memory
    (csrc/rwkv4_grid.cuh): slices of `width` = 16 columns, `row_bytes` of
    codes a row (16 for a W8, W4 or VQ plane, 32 for bf16 weights);
    stages of `kc` rows in phase A (three matrices) and 3·kc in the
    others; a ring of `stages` slots; `smem` bytes a block.  It depends on
    the widths, the weight form, the numerics and the tile, not on B or
    the grid."""
    width: int
    row_bytes: int
    kc: int
    stages: int
    smem: int
    bb: int
    D: int
    F: int

    def slices(self):
        """Each phase's item columns, in item order within a tile:
        [(phase, matrices, c0, c1)], phase C's ffn.wk slices before its
        ffn.wr ones."""
        out = []
        for ph, mats, n, _ in K3_PHASES:
            N = self.D if n == "D" else self.F
            out += [(ph, mats, c0, min(c0 + self.width, N))
                    for c0 in range(0, N, self.width)]
        return out

    def items(self, B: int, grid: int):
        """The items of a B-lane launch on `grid` blocks, as the kernel
        deals them: [(block, tile, phase, matrices, c0, c1)].  Item i of a
        phase (tile-major over its slices) goes to block (i + off) mod
        grid, off the items of the phases before.  Raises for a grid of no
        blocks, which holds no phase."""
        return [it[:2] + it[3:] for it in self._dealt(B, grid)]

    def _dealt(self, B: int, grid: int):
        """items() with each item's index in its phase:
        [(block, tile, i, phase, matrices, c0, c1)]."""
        if not isinstance(grid, int) or grid < 1:
            raise ValueError(f"K3: a grid of {grid} blocks cannot hold a "
                             "phase; it takes at least one block")
        tiles = B // self.bb
        by_phase = {}
        for sl in self.slices():
            by_phase.setdefault(sl[0], []).append(sl)
        out, before = [], 0
        for ph in "ABCD":
            sl = by_phase[ph]
            for i in range(tiles * len(sl)):
                _, mats, c0, c1 = sl[i % len(sl)]
                out.append(((i + before) % grid, i // len(sl), i, ph, mats,
                            c0, c1))
            before += tiles * len(sl)
        return out

    def stage_order(self, B: int, grid: int, L: int = 1):
        """Each block's weight stages over a launch of L layers, in the
        order it consumes them (csrc/rwkv4_grid.cuh: Cursor, advance):
        {block: [(layer, phase, item, chunk)]}, an item's rows kc at a
        time in phase A, 3·kc in the others; every layer deals its items
        alike.  A block with no item has no entry."""
        per = {}
        for block, _, i, ph, _, _, _ in self._dealt(B, grid):
            K = self.F if ph == "D" else self.D
            rows = self.kc if ph == "A" else 3 * self.kc
            per.setdefault(block, []).append((ph, i, -(-K // rows)))
        return {b: [(l, ph, i, ch) for l in range(L) for ph, i, n in its
                    for ch in range(n)] for b, its in per.items()}

    def ring(self, B: int, grid: int, L: int = 1, refill: int = 3):
        """The twin of each block's ring of `stages` slots over a
        launch (csrc/rwkv4_grid.cuh: Ring, ring_fill, run):
        {block: [("issue" | "consume", stage, slot)]}.  At launch the
        block issues as many of its stages as the ring holds; each stage
        consumed (decoded, its slot freed) lets up to `refill` more be
        issued into free slots, the next stage in (layer, phase, item,
        chunk) order first, whatever its layer.  Stage k takes slot
        k mod ns."""
        out = {}
        for block, seq in self.stage_order(B, grid, L).items():
            ev, issued, consumed = [], 0, 0

            def fill(most):
                nonlocal issued
                for _ in range(most):
                    if (issued == len(seq)
                            or issued >= consumed + self.stages):
                        return
                    ev.append(("issue", seq[issued], issued % self.stages))
                    issued += 1
            fill(self.stages)
            for st in seq:
                ev.append(("consume", st, consumed % self.stages))
                consumed += 1
                fill(refill)
            out[block] = ev
        return out


def _pad8(k: int) -> int:
    """csrc/rwkv4_grid.cuh: pad8, a padded row in elements."""
    return (k + 7) // 8 * 8 + 8


def _k3_smem(bb, D, F, hw, kc, ns, rb) -> int:
    """Bytes of shared memory a K3 block takes (csrc/rwkv4_grid.cuh:
    layout): the ring (a stage's codes and its column scales a slot) and
    its barriers, the tile's inputs and LN output, the layer's vectors,
    two decoded f32 stages, phase A's sums, under hw the tables and
    reduction room, and 128 bytes to align the base."""
    LD, LF = _pad8(D), _pad8(F)
    act = max(4 * LD * 2, LD * 4 if hw else 0, LF * 2)
    W = K3_WIDTH
    tile = max(3 * W * (kc + 4), W * (3 * kc + 4))
    return (ns * _k3_slot(kc, rb) + K3_MAX_STAGES * 8 + bb * act
            + len(VEC_KEYS) * LD * 2 + 2 * tile * 4 + 3 * W * bb * 4
            + (HW_SCRATCH_FLOATS * 4 if hw else 0) + 128)


def tile_plan(B: int, bb: int, D: int, F: int, bf16_weights: bool,
              hw: bool) -> K3Plan:
    """K3's and K4's plan for a batch of B lanes in tiles of bb: raises
    unless bb divides B and lies in [1, MAX_BB], and unless `k3_plan` fits
    the tile's inputs and two weight stages in one block's shared memory.
    There is no silent smaller tile."""
    if not 1 <= bb <= MAX_BB or B % bb:
        raise ValueError(f"batch tile bb={bb} must divide B={B} and lie in "
                         f"[1, {MAX_BB}]")
    return k3_plan(D, F, bf16_weights, hw, bb)


def _k3_slot(kc: int, rb: int) -> int:
    """A ring slot: 3·kc rows of rb bytes of codes, then 3 slices' scales,
    rounded up to 128 bytes (csrc/rwkv4_grid.cuh: slot_bytes)."""
    return -(-(3 * rb * kc + 3 * K3_SCALE_BYTES) // 128) * 128


def k3_plan(D: int, F: int, bf16_weights: bool, hw: bool, bb: int
            ) -> K3Plan:
    """K3's plan for a layer of widths D, F (plain bf16 weights or
    quantized planes), the numerics and a tile of bb lanes: stages of
    K3_STAGE_ROWS rows (fewer, down to 16, where the tile's inputs leave
    too little room) and as many ring slots as fit, up to K3_MAX_STAGES.
    Raises when not even two slots of 16-row stages fit beside the tile's
    inputs in one block's 227 KB (less the kernel's static table)."""
    if not 1 <= bb <= MAX_BB:
        raise ValueError(f"batch tile bb={bb} must lie in [1, {MAX_BB}]")
    rb = K3_WIDTH * (2 if bf16_weights else 1)
    kc = K3_STAGE_ROWS
    while kc >= 16:
        fixed = _k3_smem(bb, D, F, hw, kc, 0, rb)
        ns = min(K3_MAX_STAGES, (SMEM_BYTES - K3_STATIC_BYTES - fixed)
                 // _k3_slot(kc, rb))
        if ns >= 2:
            return K3Plan(K3_WIDTH, rb, kc, ns,
                          _k3_smem(bb, D, F, hw, kc, ns, rb), bb, D, F)
        kc //= 2
    raise ValueError(
        f"K3: a tile of bb={bb} lanes at D={D}, F={F} leaves no room for "
        f"its weight stages in a block's {SMEM_BYTES} B (227 KB) of shared "
        "memory; pass a smaller bb")


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


def _codes_shape(plane: str, shape: tuple, name: str):
    """The per-layer codes shape of a matrix of per-layer `shape`: W4
    bytes pair rows along axis -2, which must be even.  A leaf with no
    such axis in a layer, time_maa_x (D,) for one, is one whose nibbles
    `pack_leaf` paired along the stack's layer axis: no decode kernel
    takes it (nor do the JAX fused paths)."""
    if plane != "w4":
        return tuple(shape)
    if len(shape) < 2 or shape[-2] % 2:
        raise ValueError(
            f"{name}: a W4 plane pairs contraction rows within a layer, and "
            f"this leaf's per-layer shape {tuple(shape)} has no even row "
            "axis (its nibbles pair two layers); pack it W8, e.g. with a "
            "PlanePolicy override")
    return tuple(shape[:-2]) + (shape[-2] // 2, shape[-1])


def _plain_matrix(leaf, shape: tuple, name: str):
    """Raise unless `leaf` is contiguous bf16 weights of `shape`: a plain
    matrix in another dtype (an f32 tree) is no form the kernels take."""
    if not torch.is_tensor(leaf) or leaf.dtype != torch.bfloat16:
        got = leaf.dtype if torch.is_tensor(leaf) else type(leaf).__name__
        raise TypeError(f"the decode kernels take W8, W4 or VQ planes or "
                        f"bf16 weights; {name} is {got}")
    if tuple(leaf.shape) != tuple(shape) or not leaf.is_contiguous():
        raise ValueError(f"{name}: weights must be contiguous bf16 "
                         f"{tuple(shape)}, got {tuple(leaf.shape)}")


def _layer_matrix(leaf, shape: tuple, name: str):
    """(codes, scale or codebook, plane id) of one matrix of per-layer
    `shape`: a plane leaf, or plain bf16 weights, which the kernels read
    as they are (codes the weights, aux None)."""
    plane = leaf_plane(leaf)
    if plane is None:
        _plain_matrix(leaf, shape, name)
        return leaf, None, PLANE_IDS["bf16"]
    codes = leaf[CODES_KEY[plane]]
    want = _codes_shape(plane, shape, name)
    if (tuple(codes.shape) != want or codes.dtype != torch.uint8
            or not codes.is_contiguous()):
        raise ValueError(f"{name}: codes must be contiguous uint8 {want}, "
                         f"got {codes.dtype} {tuple(codes.shape)}")
    aux = leaf["codebook"] if plane == "vq" else leaf["scale"]
    return codes, _aux(plane, aux, shape[-1], name), PLANE_IDS[plane]


def _k3_planes(planes):
    """K3's and K4's plane ids of a layer's seven matrices: all plain bf16
    or all quantized (the kernels compile no layer that mixes the two, and
    no packed or plain tree holds one)."""
    plain = [p == PLANE_IDS["bf16"] for p in planes]
    if any(plain) and not all(plain):
        raise ValueError("K3 and K4 take a layer of plain bf16 matrices or "
                         "of quantized planes, not both: "
                         f"{[PLANE_NAMES[p] for p in planes]}")
    return planes


def _out_cols(leaf, name: str) -> int:
    """The output width of a plane leaf or plain matrix."""
    plane = leaf_plane(leaf)
    if plane is not None:
        return leaf[CODES_KEY[plane]].shape[-1]
    if not torch.is_tensor(leaf):
        raise TypeError(f"the decode kernels take W8, W4 or VQ planes or "
                        f"bf16 weights; {name} is {type(leaf).__name__}")
    return leaf.shape[-1]


def _state_in(st, shape, name: str):
    out = []
    for k in STATE_KEYS:
        s = st[k]
        if tuple(s.shape) != shape or s.dtype != torch.bfloat16:
            raise TypeError(f"{name} state {k}: expected bf16 {shape}, got "
                            f"{s.dtype} {tuple(s.shape)}")
        out.append(s.contiguous())
    return out


def _launch_ptrs(tensors, tail=()):
    """The device pointers of `tensors`, then of `tail`, as a C array
    (None a null pointer)."""
    given = [t for t in tensors if t is not None]
    if any(t.device != given[0].device for t in given):
        raise ValueError("decode kernel: operands on several devices")
    ptrs = [None if t is None else t.data_ptr()
            for t in list(tensors) + list(tail)]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _luts_in(luts, device):
    """The EXP and DIV tables as contiguous (256,) f32 on `device`."""
    out = []
    for k in LUT_KEYS:
        t = luts[k].reshape(-1)
        if t.shape != (256,) or t.dtype != torch.float32 or \
                t.device != device:
            raise ValueError(f"_luts.{k}: expected 256 f32 values on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
        out.append(t.contiguous())
    return out


def _k3_vec(mats, rows, D: int, F: int) -> int:
    """K3's and K4's load widths: bit 0 when every matrix's slice rows,
    layer stride and scales are 16-byte aligned (tensor and bulk copies;
    else byte by byte), bit 1 when D and F are multiples of 8 and every
    row operand (x, the state, the vectors, and their layer strides) is
    16-byte aligned (16-byte loads; else one value at a time).  mats:
    (codes address, layer stride in bytes, scale or codebook, plane id)
    per matrix; rows: addresses and strides in bytes."""
    codes = all(
        not (N * (2 if plane == PLANE_IDS["bf16"] else 1) % 16
             or addr % 16 or stride % 16
             or (plane in (PLANE_IDS["w8"], PLANE_IDS["w4"])
                 and aux.data_ptr() % 16))
        for (addr, stride, aux, plane), (_, N) in zip(mats,
                                                      _mat_shapes(D, F)))
    rows16 = D % 8 == 0 and F % 8 == 0 and all(r % 16 == 0 for r in rows)
    return int(codes) | 2 * int(rows16)


def _k3_scratch(B: int, D: int, F: int, tiles: int, device, L: int = 1):
    """K3's and K4's scratch in device memory, one buffer: y, x2, kk, rr,
    g, a max per layer and tile, and for more than one layer the two
    residual rows (csrc/rwkv4_grid.cuh: Scratch), each 256-byte aligned;
    returns the buffer and the pointers."""
    sizes = (4 * B * D, 2 * B * D, 2 * B * F, 4 * B * D, 4 * B * D,
             4 * tiles * L) + ((2 * B * D,) * 2 if L > 1 else ())
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += (n + 255) // 256 * 256
    buf = torch.empty((total,), dtype=torch.uint8, device=device)
    return buf, [buf.data_ptr() + o for o in offs]


def _rwkv4_flops(B: int, D: int, F: int, L: int = 1) -> int:
    """The matvecs JAX's HLO analysis counts in RWKV-4's decode step, per
    layer: r, k, v, o (D x D each), the channel mix's r (D x D), k (D x
    F) and v (F x D), 2 operations a weight and lane."""
    return 2 * L * B * (5 * D * D + 2 * D * F)


def _rwkv4_meta(x, lead):
    bf16 = torch.bfloat16
    return (meta_empty(x.shape, bf16),
            {k: meta_empty((*lead, *x.shape), bf16) for k in STATE_KEYS})


@counted("rwkv4_block_decode",
         meta=lambda lp, st, x, **_: _rwkv4_meta(x, ()),
         flops=lambda lp, st, x, **_: _rwkv4_flops(
             *x.shape, _out_cols(lp["ffn"]["wk"], "ffn.wk")))
def rwkv4_block_decode(lp, st, x, *, bb: int | None = None, luts=None,
                       grid: int | None = None):
    """One layer's decode step: lp the layer's params (compute-cast, plane
    leaves with a (1, N) scale or a codebook, or plain bf16 matrices), st
    the five (B, D) state leaves, x (B, D) bf16 -> (x2 (B, D), new
    state).  `luts`, the EXP and DIV tables {"exp", "div"} (256 f32 each),
    selects the hardware numerics.  `grid` caps the cooperative grid
    (default: every block that fits); the outputs do not depend on it."""
    if x.device.type == "cpu":
        return rwkv4_block_decode_plain(lp, st, x, _numerics(luts), bb=bb)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bf16, got {x.dtype}")
    B, D = x.shape
    F = _out_cols(lp["ffn"]["wk"], "ffn.wk")
    bb = default_bb(B) if bb is None else int(bb)
    if D % 2 or F % 2:
        raise ValueError(f"K3 takes even D and F, got {D}, {F}")
    hw = luts is not None
    tabs = [None, None] if luts is None else _luts_in(luts, x.device)
    vecs = [_vec(_get(lp, p), D, ".".join(p)) for p in VEC_KEYS]
    mats = [_layer_matrix(_get(lp, p), shape, ".".join(p))
            for p, shape in zip(MAT_KEYS, _mat_shapes(D, F))]
    ids = _k3_planes([m[2] for m in mats])
    plan = tile_plan(B, bb, D, F, ids[0] == PLANE_IDS["bf16"], hw)
    planes = (ctypes.c_int * len(mats))(*ids)
    lib = load_library()
    grid = _cooperative(
        ("k3", tuple(ids), hw, plan.smem, x.device.index),
        lambda c, m: lib.rwkv4_block_decode_grid(planes, int(hw), plan.smem,
                                                 c, m), "K3", grid)
    states = _state_in(st, (B, D), "rwkv4_block_decode")
    x = x.contiguous()
    outs = [torch.empty((B, D), dtype=torch.bfloat16, device=x.device)
            for _ in range(1 + len(STATE_KEYS))]
    scratch, sptrs = _k3_scratch(B, D, F, B // bb, x.device)
    arr = _launch_ptrs([x, outs[0], *vecs,
                        *(m[0] for m in mats), *(m[1] for m in mats),
                        *states, *outs[1:]], tabs)
    arr = (ctypes.c_void_p * (len(arr) + len(sptrs)))(*arr, *sptrs)
    check(lib.rwkv4_block_decode(
        arr, len(arr), planes, B, D, F, bb, plan.width, plan.kc,
        plan.stages, plan.smem, grid,
        _k3_vec([(c.data_ptr(), 0, aux, p) for c, aux, p in mats],
                [t.data_ptr() for t in (x, *vecs, *states, *outs)], D, F),
        stream_ptr(x)),
        "rwkv4_block_decode")
    rwkv4_block_decode.launches += 1
    rwkv4_block_decode.grid = grid
    del scratch      # enqueued: the caching allocator orders its reuse
    return outs[0], dict(zip(STATE_KEYS, outs[1:]))


rwkv4_block_decode.launches = 0
rwkv4_block_decode.grid = None      # the blocks of the last launch


class MatEntry(NamedTuple):
    """One matrix in a model form's table: its offset in a row of `slab`
    (the codes' in "uint8", or plain bf16 weights' in "bfloat16"), its
    scale or codebook (an aux leaf, shared by every layer; None for plain
    weights) and its plane id."""
    offset: int
    aux: torch.Tensor | None
    plane: int
    slab: str


def _entry(entries: dict, path, kind: str, used: set):
    """A leaf's manifest entry, which must be of `kind` ("slab" or
    "aux"); the path joins `used`."""
    e = entries.get(path)
    if e is None or e[0] != kind:
        raise ValueError(f"FusedLayerStack: {'.'.join(path)} must be a "
                         f"leaf of kind {kind!r}, got {e}")
    used.add(path)
    return e


def _slab_offset(entries: dict, path, dtype: str, shape, used: set) -> int:
    """A slab leaf's offset in its dtype's slab row, checked against the
    expected dtype and per-layer shape."""
    _, key, off, got = _entry(entries, path, "slab", used)
    if key != dtype or tuple(got) != shape:
        raise ValueError(f"FusedLayerStack: {'.'.join(path)} is {key} "
                         f"{tuple(got)}, expected {dtype} {shape}")
    return off


def _stack_plane(blocks: FusedLayerStack, entries: dict, path) -> str:
    """The form of the matrix at `path` in a slab stack: its plane, or
    "bf16" for plain weights (one slab leaf); raises on anything else."""
    if path in entries:
        e = entries[path]
        if e[0] == "slab" and e[1] == "bfloat16":
            return "bf16"
        raise TypeError(f"the decode kernels take W8, W4 or VQ planes or "
                        f"bf16 weights; {'.'.join(path)} is "
                        f"{e[1] if e[0] == 'slab' else 'a shared aux leaf'}")
    plane = leaf_plane({p[-1]: None for p in blocks.tdef if p[:-1] == path})
    if plane is None:
        raise TypeError(f"the decode kernels take W8, W4 or VQ planes or "
                        f"bf16 weights; {'.'.join(path)} is neither")
    return plane


def _stack_matrix(blocks: FusedLayerStack, entries: dict, path,
                  shape: tuple, used: set) -> MatEntry:
    """The table entry of the matrix at `path`, checked against its
    per-layer `shape`; its scale or codebook must be an aux leaf."""
    name = ".".join(path)
    plane = _stack_plane(blocks, entries, path)
    if plane == "bf16":
        off = _slab_offset(entries, path, "bfloat16", tuple(shape), used)
        return MatEntry(off, None, PLANE_IDS["bf16"], "bfloat16")
    off = _slab_offset(entries, path + (CODES_KEY[plane],), "uint8",
                       _codes_shape(plane, shape, name), used)
    aux_path = path + ("codebook" if plane == "vq" else "scale",)
    aux = _aux(plane, blocks.aux[_entry(entries, aux_path, "aux", used)[1]],
               shape[-1], ".".join(aux_path))
    return MatEntry(off, aux, PLANE_IDS[plane], "uint8")


def _stack_slabs(blocks: FusedLayerStack):
    """The uint8 slab (None when no leaf is packed) and the bf16 slab, each
    contiguous."""
    u8, b16 = blocks.slabs.get("uint8"), blocks.slabs["bfloat16"]
    if not all(t.is_contiguous() for t in (u8, b16) if t is not None):
        raise ValueError("FusedLayerStack slabs must be contiguous")
    return u8, b16


def stack_luts(blocks: FusedLayerStack):
    """The stack's `_luts` operands as {"exp", "div"} (each a (1, 256) f32
    aux leaf), or None when it has none; raises on a partial or malformed
    set."""
    entries = dict(zip(blocks.tdef, blocks.manifest))
    got = {p[1]: e for p, e in entries.items() if p[0] == "_luts"}
    if not got:
        return None
    if set(got) != set(LUT_KEYS) or any(
            e[0] != "aux" for e in got.values()):
        raise ValueError(f"FusedLayerStack: _luts must hold the aux leaves "
                         f"{LUT_KEYS}, got {got}")
    luts = {k: blocks.aux[got[k][1]] for k in LUT_KEYS}
    for k, t in luts.items():
        if tuple(t.shape) != (1, 256) or t.dtype != torch.float32:
            raise ValueError(f"FusedLayerStack: _luts.{k} must be (1, 256) "
                             f"f32, got {t.dtype} {tuple(t.shape)}")
    return luts


def stack_table(blocks: FusedLayerStack, D: int):
    """The K4 table of a slab stack, checked against the expected shapes:
    (F, the vectors' offsets in a bf16 slab row, [MatEntry] per matrix:
    a plane's codes in the uint8 slab, plain weights in the bf16 slab).
    Raises on a leaf the kernel does not take or a shape it does not
    expect, and unless every scale and codebook is an aux leaf shared by
    every layer (a one-layer stack keeps them in its slabs).  A complete
    `_luts` set (`stack_luts`) is the hardware numerics' operand."""
    entries = dict(zip(blocks.tdef, blocks.manifest))
    used = set()
    if stack_luts(blocks) is not None:
        used.update(("_luts", k) for k in LUT_KEYS)
    wk_plane = _stack_plane(blocks, entries, ("ffn", "wk"))
    wk = entries.get(("ffn", "wk") if wk_plane == "bf16"
                     else ("ffn", "wk", CODES_KEY[wk_plane]))
    if wk is None or wk[0] != "slab":
        raise ValueError("FusedLayerStack: ffn.wk codes must be a slab leaf")
    F = wk[3][-1]
    vec_offs = [_slab_offset(entries, p, "bfloat16", (D,), used)
                for p in VEC_KEYS]
    mats = [_stack_matrix(blocks, entries, path, shape, used)
            for path, shape in zip(MAT_KEYS, _mat_shapes(D, F))]
    _k3_planes([m.plane for m in mats])
    extra = set(blocks.tdef) - used
    if extra:
        raise ValueError(f"FusedLayerStack holds leaves K4 does not take: "
                         f"{sorted('.'.join(p) for p in extra)}")
    return F, vec_offs, mats


def k4_tensor_maps(blocks: FusedLayerStack, D: int, kc: int):
    """Each matrix's 3-D tensor map over a slab stack, as
    csrc/rwkv4_model_decode.cu:encode_matrix builds it: [{"slab": its
    slab's dtype name, "base": the bytes into a slab row where layer 0's
    codes (or bf16 weights) start, "dims": (row bytes, rows, layers),
    "strides": (bytes a row, bytes a layer: the slab row), "box": (one
    slice's row bytes, kc rows, one layer)}], W4 rows being nibble pairs
    (K / 2 of them, boxes of kc / 2).  Stage r0.. of the slice from column
    c0 of layer l is the box at (c0 · esize, r0 / half, l)."""
    F, _, mats = stack_table(blocks, D)
    out = []
    for m, (K, N) in zip(mats, _mat_shapes(D, F)):
        esz = 2 if m.plane == PLANE_IDS["bf16"] else 1
        half = 2 if m.plane == PLANE_IDS["w4"] else 1
        out.append({"slab": m.slab, "base": m.offset * esz,
                    "dims": (N * esz, K // half, blocks.n_layers),
                    "strides": (N * esz,
                                blocks.slabs[m.slab].shape[1] * esz),
                    "box": (K3_WIDTH * esz, kc // half, 1)})
    return out


@counted("rwkv4_model_decode",
         meta=lambda blocks, state, x, **_: _rwkv4_meta(
             x, (blocks.n_layers,)),
         flops=lambda blocks, state, x, **_: _rwkv4_flops(
             *x.shape, stack_table(blocks, x.shape[1])[0], blocks.n_layers))
def rwkv4_model_decode(blocks: FusedLayerStack, state, x, *,
                       bb: int | None = None, grid: int | None = None):
    """The whole L-layer decode step: blocks the slab form of the stacked
    layers (`fuse_layer_stack` of the compute-cast tree, packed or plain,
    with `_luts` for the hardware numerics), state the five (L, B, D)
    leaves, x (B, D) bf16 -> (x out (B, D), new state).  One cooperative
    launch of K3's kernel over the L layers, on K3's plan (`tile_plan`);
    `grid` caps the grid (default: every block that fits), and the
    outputs do not depend on it."""
    if not isinstance(blocks, FusedLayerStack):
        raise TypeError("rwkv4_model_decode takes a FusedLayerStack "
                        "(core/quant/serving.py:fuse_layer_stack)")
    if x.device.type == "cpu":
        return rwkv4_model_decode_plain(blocks, state, x, bb=bb)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bf16, got {x.dtype}")
    B, D = x.shape
    L = blocks.n_layers
    F, vec_offs, mats = stack_table(blocks, D)
    if D % 2 or F % 2:
        raise ValueError(f"K4 takes even D and F, got {D}, {F}")
    luts = stack_luts(blocks)
    hw = luts is not None
    bb = default_bb(B) if bb is None else int(bb)
    ids = [m.plane for m in mats]
    plan = tile_plan(B, bb, D, F, ids[0] == PLANE_IDS["bf16"], hw)
    planes = (ctypes.c_int * len(mats))(*ids)
    lib = load_library()
    grid = _cooperative(
        ("k4", tuple(ids), hw, plan.smem, x.device.index),
        lambda c, m: lib.rwkv4_block_decode_grid(planes, int(hw), plan.smem,
                                                 c, m), "K4", grid)
    tabs = [None, None] if luts is None else _luts_in(luts, x.device)
    u8, b16 = _stack_slabs(blocks)
    states = _state_in(state, (L, B, D), "rwkv4_model_decode")
    x = x.contiguous()
    x_out = torch.empty((B, D), dtype=torch.bfloat16, device=x.device)
    outs = [torch.empty((L, B, D), dtype=torch.bfloat16, device=x.device)
            for _ in STATE_KEYS]
    scratch, sptrs = _k3_scratch(B, D, F, B // bb, x.device, L)
    arr = _launch_ptrs([x, x_out, u8, b16, *(m.aux for m in mats), *states,
                        *outs], tabs)
    arr = (ctypes.c_void_p * (len(arr) + len(sptrs)))(*arr, *sptrs)
    rows = {"uint8": 0 if u8 is None else u8.shape[1],
            "bfloat16": b16.shape[1]}
    offs = (ctypes.c_longlong * (2 + len(vec_offs) + len(mats)))(
        rows["uint8"], rows["bfloat16"], *vec_offs, *(m.offset for m in mats))
    esz = {"uint8": 1, "bfloat16": 2}
    slab_ptr = {"uint8": 0 if u8 is None else u8.data_ptr(),
                "bfloat16": b16.data_ptr()}
    vec = _k3_vec(
        [(slab_ptr[m.slab] + m.offset * esz[m.slab],
          rows[m.slab] * esz[m.slab], m.aux, m.plane) for m in mats],
        [t.data_ptr() for t in (x, x_out, *states, *outs)]
        + [b16.data_ptr() + 2 * o for o in vec_offs]
        + [2 * rows["bfloat16"], 2 * B * D] + sptrs[-2:], D, F)
    check(lib.rwkv4_model_decode(
        arr, len(arr), offs, len(offs), planes, L, B, D, F, bb, plan.width,
        plan.kc, plan.stages, plan.smem, grid, vec, stream_ptr(x)),
        "rwkv4_model_decode")
    rwkv4_model_decode.launches += 1
    rwkv4_model_decode.grid = grid
    del scratch      # enqueued: the caching allocator orders its reuse
    return x_out, dict(zip(STATE_KEYS, outs))


rwkv4_model_decode.launches = 0
rwkv4_model_decode.grid = None      # the blocks of the last launch


# ---------------------------------------------------------------------------
# RWKV-6: kernel K7 in its block form (one layer a launch) and its model
# form (every layer in one launch)
# ---------------------------------------------------------------------------

# the RWKV-6 decode state leaves, in the order the kernels take them
RWKV6_STATE_KEYS = ("att_x", "ffn_x", "wkv_s")
# a layer's bf16 vectors and matrices, in the kernels' order
# (csrc/rwkv6_body.cuh: enum Vec, enum Mat)
RWKV6_VEC_KEYS = (("ln1", "scale"), ("ln1", "bias"), ("ln2", "scale"),
                  ("ln2", "bias"), ("att", "time_decay"),
                  ("att", "ln_x", "scale"), ("att", "ln_x", "bias"),
                  ("ffn", "time_mix_r"), ("ffn", "time_mix_k"))
RWKV6_MAT_KEYS = (("att", "time_maa_x"), ("att", "time_maa"),
                  ("att", "time_faaaa"), ("att", "maa_w1"),
                  ("att", "maa_w2"), ("att", "td_w1"), ("att", "td_w2"),
                  ("att", "wr"), ("att", "wk"), ("att", "wv"), ("att", "wg"),
                  ("att", "wo"), ("ffn", "wr"), ("ffn", "wk"), ("ffn", "wv"))
RWKV6_MAX_B = 8             # batch lanes one K7 launch carries


def _rwkv6_mat_shapes(D: int, F: int, H: int, N: int):
    """Each matrix's per-layer shape, in RWKV6_MAT_KEYS order."""
    from repro_torch.models.rwkv6 import MAA_RANK, TD_RANK
    return ((D,), (5, D), (H, N), (D, 5 * MAA_RANK), (5, MAA_RANK, D),
            (D, TD_RANK), (TD_RANK, D)) + ((D, D),) * 6 + ((D, F), (F, D))


def _rwkv6_dims(cfg, x):
    B, D = x.shape
    if D != cfg.d_model or cfg.n_heads * cfg.rwkv_head_dim != D:
        raise ValueError(f"x (B, {D}) does not match {cfg.name}'s "
                         f"D = {cfg.d_model} = H·N")
    N = cfg.rwkv_head_dim
    # a head's N threads tile K7's consumer threads; codes are copied 4
    # bytes at a time at least
    if (32 * K7_WARPS) % N or D % 4 or cfg.d_ff % 4:
        raise ValueError(f"K7 needs N | {32 * K7_WARPS} and D, F multiples "
                         f"of 4; got N {N}, D {D}, F {cfg.d_ff}")
    return B, D, cfg.d_ff, cfg.n_heads, N


def _rwkv6_tile(B: int, bb):
    """K7's batch tile: `bb` lanes a launch, one launch a tile (the largest
    divisor of B up to RWKV6_MAX_B by default).  Raises unless bb divides B
    and lies in [1, RWKV6_MAX_B]; there is no silent smaller tile.  The
    exact numerics keep lanes independent, so a lane's bits do not depend
    on its tile."""
    bb = default_bb(B, RWKV6_MAX_B) if bb is None else int(bb)
    if not 1 <= bb <= RWKV6_MAX_B or B % bb:
        raise ValueError(f"K7 batch tile bb={bb} must divide B={B} and lie "
                         f"in [1, {RWKV6_MAX_B}]")
    return bb


# K7's launch plan (csrc/rwkv6_body.cuh): its block (8 consumer warps and
# 4 producer warps), the ring of weight stages, the x buffer, the K slices
# of maa_w1, the decode table (256 entries x 16 bank copies), the barriers
# a layer; K7_STATIC_BYTES bounds the kernel's static shared tables (its
# Net and Layer: ptxas reports 1408 bytes)
K7_THREADS = 384
K7_WARPS = 8
K7_SLOTS = 4
K7_SLOT_ROWS = 512
K7_ROW_BYTES = 32
K7_SLOT_BYTES = K7_SLOT_ROWS * K7_ROW_BYTES
K7_X_ROWS = 4096
K7_SLICE_ROWS = 256
K7_TAB_WORDS = 256 * 16
K7_BARRIERS_PER_LAYER = 7
K7_STATIC_BYTES = 1536
# the phases with matvec items, in order (the WKV phase D between C and
# E has none), and each one's jobs: (matrix, first row, rows K, columns N,
# K sliced), K and N as functions of (D, F)
K7_PHASES = ("A", "B", "C", "E", "F", "G")
_MAA_RANK, _TD_RANK = 32, 64


def _k7_jobs(p: str, D: int, F: int):
    idx = {".".join(k): i for i, k in enumerate(RWKV6_MAT_KEYS)}
    if p == "A":
        return ((idx["att.maa_w1"], 0, D, 5 * _MAA_RANK, True),)
    if p == "B":
        return tuple((idx["att.maa_w2"], j * _MAA_RANK, _MAA_RANK, D, False)
                     for j in range(5))
    if p == "C":
        return tuple((idx[f"att.{w}"], 0, D, D, False)
                     for w in ("wr", "wk", "wv", "wg")) + (
            (idx["att.td_w1"], 0, D, _TD_RANK, False),)
    if p == "E":
        return ((idx["att.wo"], 0, D, D, False),)
    if p == "F":
        return ((idx["ffn.wr"], 0, D, D, False),
                (idx["ffn.wk"], 0, D, F, False))
    return ((idx["ffn.wv"], 0, F, D, False),)


class K7Item(NamedTuple):
    """One work item: strip `strip` (columns [col0, col0 + ncols), clipped
    to N) of job `job` of its phase, rows [k0, k1) of that job's matrix
    rows (its K slice), `stages` ring stages."""
    job: int
    mat: int
    plane: int
    strip: int
    slice: int
    k0: int
    k1: int
    col0: int
    ncols: int
    K: int
    N: int
    stages: int


class K7Plan(NamedTuple):
    """K7's launch plan at (D, F, H, N), B lanes and `grid` blocks: the
    twin of csrc/rwkv6_body.cuh:plan_of, which the C query
    `rwkv6_decode_plan` reports in `ints()`'s order."""
    D: int
    F: int
    H: int
    N: int
    B: int
    grid: int
    planes: tuple
    threads: int
    warps: int
    slots: int
    slot_bytes: int
    x_rows: int
    slice_rows: int
    smem: int
    barriers_per_layer: int
    items: tuple            # per phase of K7_PHASES
    stages: int             # a layer's stages over the grid
    stages_max_block: int   # the most one block takes a layer
    wkv_items: int          # (lane, head) items of phase D
    wkv_items_max_block: int
    offsets: tuple          # ring, x, table, partial sums, slot scales,
                            # barriers, stats

    def phase_items(self, phase: str):
        """Every item of `phase`, in the kernel's order."""
        out = []
        for j, (m, row0, K, N, sliced) in enumerate(
                _k7_jobs(phase, self.D, self.F)):
            plane = self.planes[m]
            cols = 32
            # a slot holds K7_SLOT_ROWS strip rows of codes, half as many
            # of bf16 weights (64-byte rows)
            slot_rows = K7_SLOT_ROWS // (2 if plane == PLANE_IDS["bf16"]
                                         else 1)
            S = -(-K // K7_SLICE_ROWS) if sliced else 1
            kpr = 2 if plane == PLANE_IDS["w4"] else 1
            for t in range(-(-N // cols)):
                for sl in range(S):
                    k0 = sl * K7_SLICE_ROWS if sliced else 0
                    k1 = min(K, k0 + K7_SLICE_ROWS) if sliced else K
                    rows = (k1 - k0) // kpr
                    out.append(K7Item(j, m, plane, t, sl, k0, k1, t * cols,
                                      cols, K, N,
                                      max(1, -(-rows // slot_rows))))
        return out

    def block_range(self, total: int, b: int):
        return total * b // self.grid, total * (b + 1) // self.grid

    def block_items(self, phase: str, b: int):
        """Block b's items of `phase` (a contiguous range)."""
        items = self.phase_items(phase)
        lo, hi = self.block_range(len(items), b)
        return items[lo:hi]

    def ints(self):
        return (self.threads, self.warps, self.slots, self.slot_bytes,
                self.x_rows, self.slice_rows, self.smem,
                self.barriers_per_layer, *self.items, self.stages,
                self.stages_max_block, self.wkv_items,
                self.wkv_items_max_block, *self.offsets)


def k7_planes(form, n: int = 15) -> tuple:
    """The 15 matrix plane ids of a K7 layer form: "w8", "bf16", "mixed"
    (W4 att.wk, VQ ffn.wv, the rest W8, as the serving engines' MIXED
    policy) or a sequence of plane names or ids."""
    if form in ("w8", "bf16"):
        return (PLANE_IDS[form],) * n
    if form == "mixed":
        pl = [PLANE_IDS["w8"]] * n
        pl[RWKV6_MAT_KEYS.index(("att", "wk"))] = PLANE_IDS["w4"]
        pl[RWKV6_MAT_KEYS.index(("ffn", "wv"))] = PLANE_IDS["vq"]
        return tuple(pl)
    return tuple(PLANE_IDS[p] if isinstance(p, str) else int(p)
                 for p in form)


def k7_plan(D: int, F: int, H: int, N: int, form="w8", grid: int = 132,
            B: int = 8) -> K7Plan:
    """K7's plan (`K7Plan`): items of each phase dealt in contiguous
    ranges over `grid` blocks, each item a strip of 32 columns whose rows
    stream through the ring in stages of K7_SLOT_BYTES (K7_SLOT_ROWS rows
    of codes, half as many of plain bf16 weights); maa_w1 cut along K into
    K7_SLICE_ROWS slices; the shared memory a block needs."""
    planes = k7_planes(form)
    per_block = [0] * grid
    items = []
    plan = K7Plan(D, F, H, N, B, grid, planes, K7_THREADS, K7_WARPS,
                  K7_SLOTS, K7_SLOT_BYTES, K7_X_ROWS, K7_SLICE_ROWS, 0,
                  K7_BARRIERS_PER_LAYER, (), 0, 0, B * H, -(-B * H // grid),
                  ())
    for p in K7_PHASES:
        its = plan.phase_items(p)
        items.append(len(its))
        for b in range(grid):
            lo, hi = plan.block_range(len(its), b)
            per_block[b] += sum(it.stages for it in its[lo:hi])
    ring = 0
    x = K7_SLOTS * K7_SLOT_BYTES
    tab = x + K7_X_ROWS * MAX_BB * 2
    red = tab + K7_TAB_WORDS * 4
    scl = red + 2 * K7_WARPS * 32 * MAX_BB * 4
    bars = scl + K7_SLOTS * 32 * 4
    stats = bars + 2 * K7_SLOTS * 8
    smem = stats + 2 * MAX_BB * 4
    return plan._replace(smem=smem, items=tuple(items),
                         stages=sum(per_block),
                         stages_max_block=max(per_block),
                         offsets=(ring, x, tab, red, scl, bars, stats))


def k7_plan_of_source(D: int, F: int, H: int, N: int, form="w8",
                      grid: int = 132, B: int = 8) -> tuple:
    """The plan the kernel's source reports (the C query
    `rwkv6_decode_plan`), in `K7Plan.ints()`'s order: held to `k7_plan`
    by the on-card tests."""
    planes = k7_planes(form)
    mats = (ctypes.c_int * len(planes))(*planes)
    out = (ctypes.c_int * 25)()
    check(load_library().rwkv6_decode_plan(mats, D, F, H, N, B, grid, out),
          "rwkv6_decode_plan")
    return tuple(out)


# bytes K7's producers copy at a time at least (rows 16-byte aligned take
# 16-byte copies), to which every matrix's codes or weights must be aligned
K7_ALIGN = 4


def _k7_info(planes, auxes):
    """K7's matrix info, 2·15 ints: the planes, then the codebooks'
    entries (0 unless VQ)."""
    lens = [a.numel() if p == PLANE_IDS["vq"] else 0
            for p, a in zip(planes, auxes)]
    return (ctypes.c_int * (2 * len(planes)))(*planes, *lens)


def rwkv6_layer_table(lp, D: int, F: int, H: int, N: int):
    """K7-block's matrices of one layer's tree, checked against the
    expected shapes: (codes or bf16 weights, scale or codebook or None,
    plane id) per matrix in RWKV6_MAT_KEYS order.  Raises on a leaf the
    kernel does not take (a W4 leaf paired across layers among them,
    `_codes_shape`) or one not aligned for its loads."""
    mats = []
    for path, shape in zip(RWKV6_MAT_KEYS, _rwkv6_mat_shapes(D, F, H, N)):
        name = ".".join(path)
        m = _layer_matrix(_get(lp, path), shape, name)
        need = K7_ALIGN
        if m[0].data_ptr() % need:
            raise ValueError(f"{name}: K7 reads {need} bytes of it at a "
                             f"time; it must be {need}-byte aligned")
        mats.append(m)
    return mats


def _rwkv6_state(st, shapes, name: str):
    out = []
    for k, shape in zip(RWKV6_STATE_KEYS, shapes):
        s = st[k]
        if tuple(s.shape) != shape or s.dtype != torch.bfloat16:
            raise TypeError(f"{name} state {k}: expected bf16 {shape}, got "
                            f"{s.dtype} {tuple(s.shape)}")
        out.append(s.contiguous())
    return out


# a cooperative kernel instance's key -> the most of its blocks resident
# at once on that device
_COOP_GRIDS: dict = {}


def _cooperative(key, query, who: str, grid):
    """A cooperative launch's grid: the most blocks that fit on the card at
    once (`query(coop, most)`, the kernel instance's C query, asked once
    per `key`), or `grid` when asked; raises if the device has no
    cooperative launch or the grid would not fit."""
    if key not in _COOP_GRIDS:
        coop, most = ctypes.c_int(0), ctypes.c_int(0)
        check(query(ctypes.byref(coop), ctypes.byref(most)), f"{who} grid")
        if not coop.value:
            raise RuntimeError(f"{who} needs cooperative launch, which this "
                               "device does not offer")
        _COOP_GRIDS[key] = most.value
    most = _COOP_GRIDS[key]
    grid = most if grid is None else int(grid)
    if not 1 <= grid <= most:
        raise ValueError(f"{who}: a cooperative grid of {grid} blocks does "
                         f"not fit; at most {most} are resident at once")
    return grid


def _coop_grid(which: str, grid, info, device):
    """The cooperative grid of K7's `which` form for the instance that the
    matrix planes in `info` (`_k7_info`) select (`_cooperative`)."""
    fn = getattr(load_library(), f"rwkv6_{which}_decode_grid")
    return _cooperative((which, tuple(info[:len(RWKV6_MAT_KEYS)]),
                         device.index), lambda c, m: fn(info, c, m),
                        f"K7 {which}", grid)


def _rwkv6_scratch(D: int, F: int, device):
    n = load_library().rwkv6_decode_scratch_bytes(D, F)
    return torch.zeros((n,), dtype=torch.uint8, device=device)


@exact_matmuls()
def rwkv6_block_decode_plain(lp, st, x, cfg):
    """The plain version: decode the plane leaves, run `block_decode`."""
    from repro_torch.models.rwkv6 import block_decode
    lp = tree_map(lambda l: unpack_leaf(l).to(x.dtype)
                  if is_packed_leaf(l) else l, lp, is_leaf=is_packed_leaf)
    return block_decode(lp, st, x, cfg)


def rwkv6_model_decode_plain(blocks: FusedLayerStack, state, x, cfg):
    """The plain version of K7-model: for each layer, unfuse its slab rows
    and run K7-block's plain version, the body the Pallas kernel ran per
    layer."""
    aux = [a[0] for a in blocks.aux]          # the leading 1 squeezed
    new = []
    for l in range(blocks.n_layers):
        rows = {k: s[l] for k, s in blocks.slabs.items()}
        lp = unfuse_layer(rows, aux, blocks.manifest, blocks.tdef)
        x, st = rwkv6_block_decode_plain(
            lp, {k: state[k][l] for k in RWKV6_STATE_KEYS}, x, cfg)
        new.append(st)
    return x, {k: torch.stack([s[k] for s in new])
               for k in RWKV6_STATE_KEYS}


def _rwkv6_flops(x, cfg, L: int = 1) -> int:
    """The products JAX's HLO analysis counts in RWKV-6's decode step, per
    layer and lane, 2 operations each: maa_w1 and maa_w2 (D x 5R, 5R x
    D), td_w1 and td_w2 (D x TR, TR x D), r, k, v, g, o and the channel
    mix's r (D x D), its k and v (D x F, F x D), and the WKV's r·S (H N x
    N)."""
    B, D = x.shape
    F, H, N = cfg.d_ff, cfg.n_heads, cfg.rwkv_head_dim
    return 2 * L * B * (10 * _MAA_RANK * D + 2 * _TD_RANK * D + 6 * D * D
                        + 2 * D * F + H * N * N)


def _rwkv6_meta(st, x):
    return meta_like(x), {k: meta_like(st[k]) for k in RWKV6_STATE_KEYS}


def _rwkv6_launches(x, bb):
    """One K7 launch a batch tile."""
    return x.shape[0] // _rwkv6_tile(x.shape[0], bb)


@counted("rwkv6_block_decode",
         meta=lambda lp, st, x, cfg, **_: _rwkv6_meta(st, x),
         flops=lambda lp, st, x, cfg, **_: _rwkv6_flops(x, cfg),
         launches=lambda lp, st, x, cfg, *, bb=None, **_:
             _rwkv6_launches(x, bb))
def rwkv6_block_decode(lp, st, x, cfg, *, grid: int | None = None,
                       bb: int | None = None):
    """One RWKV-6 layer's decode step: lp the layer's params (compute-cast,
    W8, W4 or VQ plane leaves with their shared scales and codebooks
    broadcast, or plain bf16 matrices), st the layer's
    att_x, ffn_x (B, D) and wkv_s (B, H, N, N) bf16 state, x (B, D) bf16
    -> (x2 (B, D), new state).  `grid` caps the cooperative grid (default:
    every block that fits); `bb` is the batch tile (`_rwkv6_tile`), one
    launch a tile."""
    if x.device.type == "cpu":
        return rwkv6_block_decode_plain(lp, st, x, cfg)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bf16, got {x.dtype}")
    B, D, F, H, N = _rwkv6_dims(cfg, x)
    bb = _rwkv6_tile(B, bb)
    vecs = [_vec(_get(lp, p), D, ".".join(p)) for p in RWKV6_VEC_KEYS]
    mats = rwkv6_layer_table(lp, D, F, H, N)
    info = _k7_info([m[2] for m in mats], [m[1] for m in mats])
    states = _rwkv6_state(st, ((B, D), (B, D), (B, H, N, N)),
                          "rwkv6_block_decode")
    grid = _coop_grid("block", grid, info, x.device)
    ins = [x.contiguous(), *states]
    outs = [torch.empty_like(t) for t in ins]
    # lanes >= bb of the scratch are never written, so the tiles share it
    scratch = _rwkv6_scratch(D, F, x.device)
    for i in range(0, B, bb):
        tile = [t[i:i + bb] for t in ins + outs]      # batch-major: contiguous
        arr = _launch_ptrs([tile[0], tile[len(ins)], *vecs,
                            *(m[0] for m in mats), *(m[1] for m in mats),
                            *tile[1:len(ins)], *tile[len(ins) + 1:],
                            scratch])
        check(load_library().rwkv6_block_decode(
            arr, len(arr), info, bb, D, F, H, N, grid, stream_ptr(x)),
            "rwkv6_block_decode")
        rwkv6_block_decode.launches += 1
    return outs[0], dict(zip(RWKV6_STATE_KEYS, outs[1:]))


rwkv6_block_decode.launches = 0


def rwkv6_stack_table(blocks: FusedLayerStack, D: int, F: int, H: int,
                      N: int):
    """K7-model's table of a slab stack, checked against the expected
    shapes: (the vectors' offsets in a bf16 slab row, [MatEntry] per
    matrix: a W8, W4 or VQ plane's codes in the uint8 slab with its shared
    scale or codebook, plain weights in the bf16 slab).  Raises on a leaf
    the kernel does not take (a W4 leaf paired across layers among them,
    `_codes_shape`), and unless every scale and codebook is an aux leaf
    shared by every layer (a one-layer stack keeps them in its slabs)."""
    entries = dict(zip(blocks.tdef, blocks.manifest))
    extra = {p for p in blocks.tdef if p[:-1] not in RWKV6_MAT_KEYS
             and p not in RWKV6_MAT_KEYS and p not in RWKV6_VEC_KEYS}
    if extra:
        raise ValueError(f"FusedLayerStack holds leaves K7 does not take: "
                         f"{sorted('.'.join(p) for p in extra)}")
    used = set()
    vec_offs = [_slab_offset(entries, p, "bfloat16", (D,), used)
                for p in RWKV6_VEC_KEYS]
    mats = [_stack_matrix(blocks, entries, path, shape, used)
            for path, shape in zip(RWKV6_MAT_KEYS,
                                   _rwkv6_mat_shapes(D, F, H, N))]
    return vec_offs, mats


@counted("rwkv6_model_decode",
         meta=lambda blocks, state, x, cfg, **_: _rwkv6_meta(state, x),
         flops=lambda blocks, state, x, cfg, **_: _rwkv6_flops(
             x, cfg, blocks.n_layers),
         launches=lambda blocks, state, x, cfg, *, bb=None, **_:
             _rwkv6_launches(x, bb))
def rwkv6_model_decode(blocks: FusedLayerStack, state, x, cfg, *,
                       grid: int | None = None, bb: int | None = None):
    """The whole L-layer RWKV-6 decode step: blocks the slab form of the
    stacked layers (`fuse_layer_stack` of the compute-cast tree, packed or
    plain), state
    att_x, ffn_x (L, B, D) and wkv_s (L, B, H, N, N) bf16, x (B, D) bf16
    -> (x out (B, D), new state).  `bb` is the batch tile (`_rwkv6_tile`),
    one launch a tile; a tile's state is a strided view of the whole
    state, which the kernel walks with the whole batch's layer stride."""
    if not isinstance(blocks, FusedLayerStack):
        raise TypeError("rwkv6_model_decode takes a FusedLayerStack "
                        "(core/quant/serving.py:fuse_layer_stack)")
    if x.device.type == "cpu":
        return rwkv6_model_decode_plain(blocks, state, x, cfg)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bf16, got {x.dtype}")
    B, D, F, H, N = _rwkv6_dims(cfg, x)
    bb = _rwkv6_tile(B, bb)
    L = blocks.n_layers
    vec_offs, mats = rwkv6_stack_table(blocks, D, F, H, N)
    u8, b16 = _stack_slabs(blocks)
    rows = (0 if u8 is None else u8.shape[1], b16.shape[1])
    if any(r % 4 for r in rows) or any(m.offset % 4 for m in mats):
        raise ValueError("K7 reads four columns at a time (four code bytes "
                         "or bf16 weights): the slab rows and every matrix "
                         "offset must be multiples of 4")
    info = _k7_info([m.plane for m in mats], [m.aux for m in mats])
    states = _rwkv6_state(state, ((L, B, D), (L, B, D), (L, B, H, N, N)),
                          "rwkv6_model_decode")
    grid = _coop_grid("model", grid, info, x.device)
    x_in = x.contiguous()
    x_out = torch.empty_like(x)
    outs = [torch.empty_like(s) for s in states]
    # lanes >= bb of the scratch are never written, so the tiles share it
    scratch = _rwkv6_scratch(D, F, x.device)
    offs = (ctypes.c_longlong * (2 + len(vec_offs) + len(mats)))(
        *rows, *vec_offs, *(m.offset for m in mats))
    for i in range(0, B, bb):
        lanes = [s[:, i:i + bb] for s in states + outs]
        arr = _launch_ptrs([x_in[i:i + bb], x_out[i:i + bb], u8, b16,
                            *(m.aux for m in mats), *lanes, scratch])
        check(load_library().rwkv6_model_decode(
            arr, len(arr), offs, len(offs), info, L, bb, B, D, F, H, N,
            grid, stream_ptr(x)), "rwkv6_model_decode")
        rwkv6_model_decode.launches += 1
    return x_out, dict(zip(RWKV6_STATE_KEYS, outs))


rwkv6_model_decode.launches = 0
