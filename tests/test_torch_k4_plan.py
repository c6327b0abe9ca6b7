"""K4's schedule and tensor maps, on the CPU.

K4 (`kernels/fused_decode.py:rwkv4_model_decode`) is K3's cooperative
kernel looping over every layer in one launch: each block's ring of
weight stages runs over the launch, so layer l + 1's stages are copied in
behind layer l's compute (`K3Plan.ring`, the twin of
`csrc/rwkv4_grid.cuh`'s Ring, ring_fill and run), and each matrix is a
3-D tensor map over the slab stack (`k4_tensor_maps`, the twin of
`csrc/rwkv4_model_decode.cu:encode_matrix`).  Neither needs a card: the
ring twin is checked for every form, grid, batch and depth the card runs
(each stage issued once and consumed in order, never more than the ring
holds in flight, no slot reused before its stage is consumed, the next
layer's first stage in flight before the last one's is consumed), and a
numpy model of the tensor-copy unit reads every stage's box of every
matrix and layer of a smoke stack, which must be the bytes
`unfuse_layer` gives for that slice.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core.quant.policy import PlanePolicy
from repro_torch.core.quant.serving import (
    CODES_KEY, leaf_plane, pack_params, unfuse_layer)
from repro_torch.kernels.fused_decode import (
    K3_WIDTH, MAT_KEYS, k3_plan, k4_tensor_maps)
from repro_torch.models.registry import get_model
from repro_torch.models.rwkv4 import prepare_fused_model_params

D, F = 768, 3072          # rwkv4-169m
# form -> (plain bf16 weights, hardware numerics); W8 and MIXED share a plan
FORMS = {"w8": (False, False), "mixed": (False, False), "bf16": (True, False),
         "w8-hw": (False, True), "mixed-hw": (False, True),
         "bf16-hw": (True, True)}
GRIDS = (1, 7, 132)
BATCHES = (1, 8)
DEPTHS = (1, 2, 12)
CASES = [(f, g, b, l) for f in FORMS for g in GRIDS for b in BATCHES
         for l in DEPTHS]
IDS = [f"{f}-g{g}-B{b}-L{l}" for f, g, b, l in CASES]
MIXED = PlanePolicy(default="w8", overrides=(
    (r"\['att'\]\['wk'\]", "w4"), (r"\['ffn'\]\['wv'\]", "vq"),
    (r"\['head'\]", "w4")))


@functools.lru_cache(maxsize=None)
def _ring(form, grid, B, L):
    bf16, hw = FORMS[form]
    plan = k3_plan(D, F, bf16, hw, min(B, 8))
    return plan, plan.stage_order(B, grid, L), plan.ring(B, grid, L)


@pytest.mark.parametrize("form,grid,B,L", CASES, ids=IDS)
def test_k4_ring_issues_every_stage_once_in_order(form, grid, B, L):
    """Every block issues each of its stages exactly once, in (layer,
    phase, item, chunk) order, and consumes them in the order issued."""
    _, order, ring = _ring(form, grid, B, L)
    assert set(ring) == set(order)
    for block, ev in ring.items():
        issued = [s for kind, s, _ in ev if kind == "issue"]
        consumed = [s for kind, s, _ in ev if kind == "consume"]
        assert issued == consumed == order[block]
        assert len(set(issued)) == len(issued)
        assert [s[0] for s in issued] == sorted(s[0] for s in issued)


@pytest.mark.parametrize("form,grid,B,L", CASES, ids=IDS)
def test_k4_ring_holds_at_most_its_slots(form, grid, B, L):
    """At no point are more stages in flight (issued, not yet consumed)
    than the ring has slots, and a stage is consumed only once issued."""
    plan, _, ring = _ring(form, grid, B, L)
    for ev in ring.values():
        flight = 0
        for kind, _, _ in ev:
            flight += 1 if kind == "issue" else -1
            assert 0 <= flight <= plan.stages


@pytest.mark.parametrize("form,grid,B,L", CASES, ids=IDS)
def test_k4_ring_reuses_a_slot_after_its_stage(form, grid, B, L):
    """Stage k takes slot k mod ns, and is issued only after the stage
    that last held that slot (k - ns) was consumed: no copy lands on a
    slot still being decoded."""
    plan, order, ring = _ring(form, grid, B, L)
    for block, ev in ring.items():
        index = {s: k for k, s in enumerate(order[block])}
        done = set()
        for kind, s, slot in ev:
            k = index[s]
            assert slot == k % plan.stages
            if kind == "consume":
                done.add(k)
            elif k >= plan.stages:
                assert k - plan.stages in done


@pytest.mark.parametrize("form,grid,B,L", CASES, ids=IDS)
def test_k4_ring_streams_the_next_layer(form, grid, B, L):
    """The double buffering: in every block, layer l + 1's first stage is
    issued before layer l's last stage is consumed, so the next layer's
    weights are in flight while this one computes (the ring always holds
    two slots or more)."""
    plan, order, ring = _ring(form, grid, B, L)
    assert plan.stages >= 2
    for block, ev in ring.items():
        at = {(kind, s): n for n, (kind, s, _) in enumerate(ev)}
        seq = order[block]
        for l in range(L - 1):
            last = max(s for s in seq if s[0] == l)
            first = min(s for s in seq if s[0] == l + 1)
            assert at[("issue", first)] < at[("consume", last)]


def _read_box(flat, tmap, x, y, z):
    """The tensor-copy unit's box at (x, y, z) of a 3-D byte map over
    `flat` (a slab's bytes): elements past dims[0] or dims[1] read as
    zeros."""
    bx, by, _ = tmap["box"]
    cols, rows = x + np.arange(bx), y + np.arange(by)
    live = (cols[None, :] < tmap["dims"][0]) & (rows[:, None] <
                                                 tmap["dims"][1])
    addr = (tmap["base"] + z * tmap["strides"][1]
            + rows[:, None] * tmap["strides"][0] + cols[None, :])
    return np.where(live, flat[np.where(live, addr, 0)], 0).astype(np.uint8)


def _bytes(t):
    return t.contiguous().view(torch.uint8).numpy().reshape(-1)


@pytest.mark.parametrize("form", ["mixed", "bf16"])
def test_k4_tensor_map_boxes_are_unfuse_layer_slices(form):
    """For each matrix (its plane: W8, W4 row pairs, VQ, or bf16 weights)
    and layer of the smoke stack, every stage's box (one 16-column slice
    × kc rows, kc / 2 byte rows for W4, at (c0 · esize, r0 / half, l))
    holds the bytes of `unfuse_layer`'s slice of that matrix, zeros past
    its rows and columns."""
    model = get_model("rwkv4-169m", smoke=True)
    cfg = model.cfg
    params = model.init_params(0, "cpu")
    if form == "mixed":
        params = pack_params(params, MIXED)
    stack = prepare_fused_model_params(params, cfg)["blocks"]
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    plan = k3_plan(d, f, form == "bf16", False, 8)
    maps = k4_tensor_maps(stack, d, plan.kc)
    flat = {k: _bytes(s) for k, s in stack.slabs.items()}
    aux = [a[0] for a in stack.aux]
    planes = set()
    for l in range(L):
        lp = unfuse_layer({k: s[l] for k, s in stack.slabs.items()}, aux,
                          stack.manifest, stack.tdef)
        for path, tmap in zip(MAT_KEYS, maps):
            leaf = lp[path[0]][path[1]]
            plane = leaf_plane(leaf)
            planes.add(plane)
            codes = leaf if plane is None else leaf[CODES_KEY[plane]]
            want = _bytes(codes).reshape(codes.shape[0], -1)
            esz = 2 if plane is None else 1
            assert tmap["dims"] == (want.shape[1], want.shape[0], L)
            bx, by, _ = tmap["box"]
            assert bx == K3_WIDTH * esz
            for y in range(0, want.shape[0], by):
                for c0 in range(0, want.shape[1] // esz, K3_WIDTH):
                    got = _read_box(flat[tmap["slab"]], tmap, c0 * esz, y, l)
                    ref = np.zeros((by, bx), np.uint8)
                    part = want[y:y + by, c0 * esz:c0 * esz + bx]
                    ref[:part.shape[0], :part.shape[1]] = part
                    assert np.array_equal(got, ref), (path, l, y, c0)
    assert planes == ({"w8", "w4", "vq"} if form == "mixed" else {None})
