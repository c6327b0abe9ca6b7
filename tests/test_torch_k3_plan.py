"""K3's split of a layer over the grid and K11-bwd's instances, on the CPU.

K3 (`kernels/fused_decode.py:rwkv4_block_decode`) runs a layer as a
cooperative launch whose work items are column slices of the seven
matrices (`k3_plan`, `K3Plan.items`, mirrored by `csrc/rwkv4_grid.cuh`);
K11-bwd (`kernels/fused_layernorm.py:fused_layernorm_bwd`) picks its
warps a row and values a lane by `bwd_plan`.  Neither needs a card: these
are the plans' own properties (every column owned once, 16-byte slices,
shared memory within a block's 227 KB, nothing depending on B), checked
at rwkv4-169m's widths and at the smoke config.  K3's A9 step, which
multiplies by the reciprocal where the one-block body divides, is held to
the division's bits by a numpy twin of both.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.fused_decode import (
    K3_PHASES, K3_STATIC_BYTES, SMEM_BYTES, k3_plan)
from repro_torch.kernels.fused_layernorm import BWD_WARPS, bwd_plan
from repro_torch.models.registry import get_model

WIDTHS = {"rwkv4-169m": (768, 3072), "rwkv4-169m-smoke": (64, 256)}
# the weight forms: MIXED (W8, W4 and VQ planes) is quantized, as W8
FORMS = {"w8": False, "mixed": False, "bf16": True}
GRIDS = (1, 7, 66, 132)


def _widths(name):
    cfg = get_model(name.replace("-smoke", ""),
                    smoke=name.endswith("-smoke")).cfg
    assert (cfg.d_model, cfg.d_ff) == WIDTHS[name]
    return cfg.d_model, cfg.d_ff


@pytest.mark.parametrize("name", list(WIDTHS))
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("hw", [False, True], ids=["exact", "hw"])
@pytest.mark.parametrize("bb", [8, 4])
def test_k3_plan_fits_a_block(name, form, hw, bb):
    """The plan's shared memory stays within one H100 block's 227 KB and
    leaves room for at least two stages in flight; slices are 16 columns,
    at least 16 bytes of codes a row (16 of a W8, W4 or VQ plane, 32 of
    bf16 weights)."""
    D, F = _widths(name)
    plan = k3_plan(D, F, FORMS[form], hw, bb)
    assert plan.smem + K3_STATIC_BYTES <= SMEM_BYTES
    assert plan.stages >= 2 and plan.kc % 8 == 0
    assert plan.width == 16
    assert plan.row_bytes == 16 * (2 if FORMS[form] else 1)
    if name == "rwkv4-169m" and not FORMS[form]:
        # every block's share of a quantized layer (one tile) fits the ring,
        # so all its copies are issued at launch
        assert plan.kc == 128
        assert max(_block_stages(plan, bb, 132).values()) <= plan.stages


def _block_stages(plan, B, grid):
    """The stages each block copies: an item's rows kc at a time in phase
    A, 3·kc in the others (csrc/rwkv4_grid.cuh: item_of)."""
    out = {}
    for block, _, phase, _, _, _ in plan.items(B, grid):
        K = plan.F if phase == "D" else plan.D
        rows = plan.kc if phase == "A" else 3 * plan.kc
        out[block] = out.get(block, 0) + -(-K // rows)
    return out


@pytest.mark.parametrize("name", list(WIDTHS))
@pytest.mark.parametrize("form", ["w8", "bf16"])
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("B,bb", [(8, 8), (8, 4), (16, 8)])
def test_k3_items_own_every_column_once(name, form, grid, B, bb):
    """Over the grid's blocks, each tile's items cover every column of
    each of the seven matrices exactly once; every slice starts on a
    16-byte boundary of its codes' rows (a W4 byte pairs two rows of one
    column, so its slices are 16 columns too); every item lands on a block
    of the grid."""
    D, F = _widths(name)
    plan = k3_plan(D, F, FORMS[form], False, bb)
    esize = 2 if FORMS[form] else 1
    owned = {}
    for block, tile, phase, mats, c0, c1 in plan.items(B, grid):
        assert 0 <= block < grid and 0 <= tile < B // bb
        assert (c0 * esize) % 16 == 0 and 0 < c1 - c0 <= plan.width
        assert (c1 - c0) * esize >= 16 or c1 in (D, F)
        for m in mats:
            for c in range(c0, c1):
                key = (tile, m, c)
                assert key not in owned, key
                owned[key] = block
    widths = {("att", "wr"): D, ("att", "wk"): D, ("att", "wv"): D,
              ("att", "wo"): D, ("ffn", "wr"): D, ("ffn", "wk"): F,
              ("ffn", "wv"): D}
    want = {(t, m, c) for t in range(B // bb) for m, n in widths.items()
            for c in range(n)}
    assert set(owned) == want


def test_k3_plan_does_not_depend_on_b():
    """The plan takes no B; a tile's slices are the same whatever the
    batch, and phase A's r, k and v of a channel stay in one item."""
    D, F = WIDTHS["rwkv4-169m"]
    plan = k3_plan(D, F, False, True, 8)
    one = [it[2:] for it in plan.items(8, 132)]
    two = [it[2:] for it in plan.items(16, 132) if it[1] == 0]
    assert one == two
    a = [it for it in plan.items(8, 132) if it[2] == "A"]
    assert all(len(it[3]) == 3 for it in a) and len(a) == D // 16
    assert [p[0] for p in K3_PHASES] == ["A", "B", "C", "C", "D"]


def test_k3_spreads_a_layer_over_the_card():
    """At rwkv4-169m and 132 blocks the items of consecutive phases land on
    different blocks, so every block stages some of the layer and none
    more than 4 items' codes (about 56 KB a block at W8)."""
    D, F = WIDTHS["rwkv4-169m"]
    plan = k3_plan(D, F, False, False, 8)
    per = {}
    for block, *_ in plan.items(8, 132):
        per[block] = per.get(block, 0) + 1
    assert len(per) == 132 and max(per.values()) <= 4


@pytest.mark.parametrize("grid", [0, -1, 2.5])
def test_k3_plan_raises_for_a_grid_without_blocks(grid):
    D, F = WIDTHS["rwkv4-169m-smoke"]
    with pytest.raises(ValueError, match="cannot hold a phase"):
        k3_plan(D, F, False, False, 8).items(8, grid)


def test_k3_plan_raises_when_a_tile_leaves_no_room():
    """rwkv4-7b's widths (D 4096, F 16384) at bb 8: the tile's inputs alone
    pass 227 KB; a smaller tile fits."""
    with pytest.raises(ValueError, match="smaller bb"):
        k3_plan(4096, 16384, False, False, 8)
    with pytest.raises(ValueError, match="bb"):
        k3_plan(64, 256, False, False, 9)
    assert k3_plan(4096, 16384, False, True, 2).smem <= SMEM_BYTES


# (D, dtype) -> (values a lane, warps a row) of K11-bwd's instance for
# 16-byte-aligned rows (element loads where D is not a multiple of 16
# bytes' worth of values)
BWD_INSTANCES = {
    (1, torch.float32): (1, 1), (1, torch.bfloat16): (1, 1),
    (100, torch.float32): (4, 1), (100, torch.bfloat16): (4, 1),
    (576, torch.float32): (12, 2), (576, torch.bfloat16): (24, 1),
    (768, torch.float32): (12, 2), (768, torch.bfloat16): (24, 1),
    (4096, torch.float32): (16, 8), (4096, torch.bfloat16): (16, 8),
}


@pytest.mark.parametrize("D,dtype", list(BWD_INSTANCES))
@pytest.mark.parametrize("aligned", [True, False])
def test_bwd_plan_instance_and_ownership(D, dtype, aligned):
    """The instance K11-bwd takes, and that lane l of warp part p, chunk
    c, value q owns column ((c·warps + p)·32 + l)·per_chunk + q: every
    column of the row exactly once, none past the lanes' registers."""
    per16 = 16 // torch.tensor([], dtype=dtype).element_size()
    vec = aligned and D % per16 == 0
    plan = bwd_plan(D, dtype, vec)
    if vec or D % per16:
        assert (plan.values, plan.warps) == BWD_INSTANCES[(D, dtype)]
    assert plan.values == plan.chunks * plan.per_chunk
    assert plan.per_chunk == (per16 if vec else 1)
    assert plan.rows * plan.warps == max(8, plan.warps)
    cols = [((c * plan.warps + p) * 32 + lane) * plan.per_chunk + q
            for p in range(plan.warps) for lane in range(32)
            for c in range(plan.chunks) for q in range(plan.per_chunk)]
    live = [j for j in cols if j < D]
    assert sorted(live) == list(range(D))
    # the fewest warps: half as many could not hold the row
    if plan.warps > 1:
        from repro_torch.kernels.fused_layernorm import BWD_MAX_CHUNKS
        most = BWD_MAX_CHUNKS[(dtype, bool(vec))]
        assert -(-D // plan.per_chunk) > 16 * plan.warps * most


def test_bwd_plan_raises_past_its_widest_instance():
    with pytest.raises(ValueError, match="wider than"):
        bwd_plan(32 * BWD_WARPS[-1] * 8 + 1, torch.float32, False)
    assert bwd_plan(8192, torch.float32, True).warps == 16


def _a9(x, scale):
    """csrc/hw_units.cuh:a9 in f32: rint(x / scale) clipped to ±255, times
    the scale."""
    return np.clip(np.rint(x / scale), -255, 255).astype(np.float32) * scale


def _a9_rcp(x, scale):
    """csrc/hw_units.cuh:a9_rcp in f32: x · (1 / scale), rounded, unless
    that lies within 2^-10 of a rounding boundary (or is large or not
    finite), where it divides."""
    rcp = np.float32(1) / scale
    q = x * rcp
    n = np.rint(q)
    with np.errstate(invalid="ignore"):
        fast = (np.abs(q) < 4096) & (np.abs(q - n) < np.float32(0.5 - 2**-10))
    n = np.where(fast, n, np.rint(x / scale)).astype(np.float32)
    return np.clip(n, -255, 255).astype(np.float32) * scale


@pytest.mark.parametrize("seed", range(4))
def test_a9_reciprocal_path_gives_a9_bits(seed):
    """K3's A9 (a multiply by the reciprocal, the division only near a
    rounding boundary) equals the division form bit for bit: random
    tensors over 2^-30..2^30 magnitudes, and values placed on and a few
    ulps around every half-integer multiple of the scale, signed zeros."""
    rng = np.random.default_rng(seed)
    one255 = np.float32(1) / np.float32(255)
    for mag in (2.0 ** -30, 1e-3, 1.0, 37.0, 2.0 ** 30):
        x = (rng.standard_normal(1 << 16) * mag).astype(np.float32)
        amax = np.abs(x).max()
        scale = np.float32(amax * one255)
        half = ((np.arange(-256, 256, dtype=np.float32) + np.float32(0.5))
                * scale).astype(np.float32)
        near = np.concatenate([np.nextafter(half, np.float32(s * np.inf))
                               for s in (-1, 1)] + [half])
        near = near[np.abs(near) <= amax]
        x = np.concatenate([x, near, np.float32([0.0, -0.0])])
        got, want = _a9_rcp(x, scale), _a9(x, scale)
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
