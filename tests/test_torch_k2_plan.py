"""K2's and K2-bwd's plan, and K2-bwd's chunked passes, on the CPU.

K2 (`csrc/wkv4_seq.cu`) and K2-bwd (`csrc/wkv4_bwd.cu`) give a warp 32
consecutive channels of one batch row and stage their operands through
shared memory; `kernels/wkv4.py:k2_plan` is the twin of the source's
`plan_of` (`csrc/wkv4_common.cuh`), held to the C query `wkv4_plan` on the
card by `tests/test_torch_cuda.py::test_k2_plan_is_the_source`, so the
coverage and limits checked here are the launches'.  K2-bwd's reverse
pass runs chunk by chunk, recomputing each chunk's forward from a
checkpoint; its plain version does the same, and must give the bits of
one pass over the whole sequence at every chunk.
"""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import wkv4 as K2
from repro_torch.kernels.wkv4 import k2_plan, wkv4_seq_bwd_plain

ROOT = Path(__file__).resolve().parents[1]
SMEM_PER_BLOCK = 232448        # the most one block may take on an H100


def _forward_channels(p, C):
    """Every (b, c) K2's grid runs: block (x, y), warp w, lane l."""
    seen = []
    for y in range(p.fwd_grid_y):
        for x in range(p.fwd_grid_x):
            for w in range(p.warps):
                c0 = (x * p.warps + w) * p.lanes
                seen += [(y, c0 + l) for l in range(p.lanes) if c0 + l < C]
    return seen


@pytest.mark.parametrize("C", [8, 37, 160, 768])
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("warps", [None, 3, 4])
def test_plan_covers_every_channel_once(B, C, warps):
    p = k2_plan(B, 100, C, warps=warps)
    want = sorted((b, c) for b in range(B) for c in range(C))
    assert sorted(_forward_channels(p, C)) == want
    assert p.fwd_threads == p.warps * p.lanes == (warps or 1) * 32
    bwd = [(y, x * p.lanes + l) for y in range(p.bwd_grid_y)
           for x in range(p.bwd_grid_x) for l in range(p.lanes)
           if x * p.lanes + l < C]
    assert sorted(bwd) == want
    assert p.bwd_threads == 2 * p.lanes
    # no block of K2 is all past C
    assert (p.fwd_grid_x - 1) * p.warps * p.lanes < C


@pytest.mark.parametrize("T", [1, 63, 64, 100, 1024])
@pytest.mark.parametrize("chunk", [None, 1, 7, 16, 64])
def test_plan_shared_memory_and_checkpoints(T, chunk):
    """Within 232,448 shared bytes at every tile, block and chunk the
    source takes; at B8 C768 the grid covers every SM (192 warps); the
    checkpoint buffer is (3, B, ⌈T/Lc⌉, C) f32."""
    B, C = 8, 768
    for tile in (None, 1, 33, 64):
        for warps in (None, 2):
            for hw in (False, True):
                p = k2_plan(B, T, C, hw=hw, tile=tile, warps=warps,
                            chunk=chunk)
                assert max(p.fwd_smem, p.bwd_smem) <= SMEM_PER_BLOCK
    p = k2_plan(B, T, C, chunk=chunk)
    Lc = chunk or K2.K2_CHUNK
    assert (p.chunk, p.n_chunks) == (Lc, -(-T // Lc))
    assert p.checkpoint_bytes == 4 * 3 * B * -(-T // Lc) * C
    assert p.fwd_grid_x * p.fwd_grid_y * p.warps == 192 >= 132


def test_plan_default_at_the_train_shape():
    """The documented numbers: B8 T1024 C768 takes 49,664 shared bytes a
    K2 warp (51,712 with the tables), 110,592 a K2-bwd block, and 2.36 MB
    of checkpoints in place of the first design's 75.5 MB scratch."""
    p = k2_plan(8, 1024, 768)
    assert (p.fwd_smem, p.bwd_smem, p.checkpoint_bytes) == (
        49664, 110592, 2359296)
    assert k2_plan(8, 1024, 768, hw=True).fwd_smem == 51712


@pytest.mark.parametrize("kw", [
    dict(B=0), dict(B=65536), dict(C=0), dict(T=-1), dict(tile=65),
    dict(warps=9), dict(chunk=65), dict(tile=64, warps=8),
    dict(tile=64, warps=4, hw=True)])
def test_plan_refuses(kw):
    args = {"B": 8, "T": 16, "C": 768, **kw}
    with pytest.raises(ValueError):
        k2_plan(args.pop("B"), args.pop("T"), args.pop("C"), **args)


def test_twin_constants_are_the_source():
    """The twin's constants are the header's."""
    src = (ROOT / "src/repro_torch/csrc/wkv4_common.cuh").read_text()
    found = dict(re.findall(r"constexpr (?:int|long long) k(\w+) = (\d+);",
                            src))
    names = {"Lanes": "LANES", "Tile": "TILE", "MaxTile": "MAX_TILE",
             "Stages": "STAGES", "Warps": "WARPS", "MaxWarps": "MAX_WARPS",
             "Chunk": "CHUNK", "MaxChunk": "MAX_CHUNK", "Bufs": "BUFS",
             "Rows": "ROWS", "BwdThreads": "BWD_THREADS",
             "TabFloats": "TAB_FLOATS", "Group": "GROUP",
             "MaxSmem": "MAX_SMEM"}
    assert set(found) == set(names)
    for cname, pyname in names.items():
        assert int(found[cname]) == getattr(K2, "K2_" + pyname), cname


def _case(B, T, C, zero_state, seed):
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g)
    k, v, gy = 2 * rn(B, T, C), rn(B, T, C), rn(B, T, C)
    w, u = torch.exp(0.5 * rn(C) - 1), rn(C)
    if zero_state:
        a0, b0 = torch.zeros(B, C), torch.zeros(B, C)
        o0 = torch.full((B, C), -1e38)
    else:
        a0, b0, o0 = rn(B, C), rn(B, C).abs() + 0.5, rn(B, C)
    return k, v, w, u, a0, b0, o0, gy


@pytest.mark.parametrize("zero_state", [True, False])
@pytest.mark.parametrize("T", [1, 63, 64, 100])
@pytest.mark.parametrize("chunk", [1, 7, 16, 64])
def test_bwd_plain_chunked_is_one_pass(chunk, T, zero_state):
    """The chunked reverse pass equals `chunk >= T` bit for bit: the
    recompute repeats the forward's operations on the checkpointed
    state."""
    ops_ = _case(3, T, 37, zero_state, 7 * T + chunk)
    one = wkv4_seq_bwd_plain(*ops_, chunk=T)
    got = wkv4_seq_bwd_plain(*ops_, chunk=chunk)
    for name, a, b in zip(("gk", "gv", "gw", "gu"), got, one):
        assert torch.equal(a, b), name
        assert bool(torch.isfinite(a).all()), name


def test_bwd_cpu_entry_is_the_plain_chunked():
    """`wkv4_seq_bwd` on CPU tensors is the plain version at the plan's
    Lc, or at the chunk it is given."""
    ops_ = _case(2, 70, 40, True, 3)
    ref = wkv4_seq_bwd_plain(*ops_, chunk=70)
    for chunk in (None, 5):
        got = K2.wkv4_seq_bwd(*ops_, chunk=chunk)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
