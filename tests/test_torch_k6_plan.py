"""K6's plan and its lane decomposition, on the CPU.

K6 (`csrc/wkv6_seq.cu`) gives a block one (b, h) pair and each state
column two threads (one at a ragged N), each holding rows of the column
in registers, and
stages the window's operands in a ring of shared-memory tiles;
`kernels/wkv6.py:k6_plan` is the twin of the source's `plan_of`, held to
the C query `wkv6_seq_plan` on the card by
`tests/test_torch_cuda.py::test_k6_plan_is_the_source`, so the coverage
and limits checked here are the launch's.  `_lanes_twin` transcribes the
kernel's arithmetic lane by lane in numpy float32 (each lane's rows, the
running sum handed from lane to lane, rows past a ragged N left out) and
must give the in-order reference's bits.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import wkv6 as K6
from repro_torch.kernels.wkv6 import (
    k6_plan, wkv6_seq_inorder, wkv6_seq_plain)

ROOT = Path(__file__).resolve().parents[1]
SMEM_PER_BLOCK = 232448        # the most one block may take on an H100


def _owned(p, B, H, N):
    """Every (b, h, n, m) of the state the launch's threads hold: block
    (b, h), thread j·np + m, rows j·rows .. (j+1)·rows - 1 of column m,
    those past N left out."""
    seen = []
    for blk in range(p.blocks):
        b, h = divmod(blk, H)
        for tid in range(p.threads):
            j, m = divmod(tid, p.np)
            seen += [(b, h, n, m) for n in range(j * p.rows,
                                                 (j + 1) * p.rows)
                     if n < N and m < N]
    return seen


@pytest.mark.parametrize("N", [16, 32, 64, 8, 37, 48])
@pytest.mark.parametrize("B,H", [(1, 2), (3, 4), (2, 5)])
def test_plan_covers_every_element_once(B, H, N):
    ragged = N not in (16, 32, 64)
    p = k6_plan(B, 5, H, N)
    want = sorted((b, h, n, m) for b in range(B) for h in range(H)
                  for n in range(N) for m in range(N))
    assert sorted(_owned(p, B, H, N)) == want
    assert p.blocks == B * H and p.threads == p.np * p.lanes
    assert p.threads % 32 == 0 and p.rows % 4 == 0
    assert p.rows * p.lanes == p.np >= N and p.ragged == int(ragged)


@pytest.mark.parametrize("N", [16, 32, 64, 37])
def test_shared_memory_fits_at_every_T(N):
    """The ring's stages (r, k, w, v rows and the valid flags of a tile),
    the lanes' two rows of running sums, u and the initial state stay
    within one block's shared memory for every length and shape, and
    every stage and the state start on 16 bytes (the copies and the
    float4 reads)."""
    for T in list(range(1, 70)) + [1000, 32768]:
        p = k6_plan(8, T, 64, N)
        stage = 4 * (4 * p.tile * p.np + p.tile)
        assert p.smem == p.stages * stage + 4 * (
            2 * (p.lanes - 1) * p.np + p.np + N * N)
        assert p.smem <= SMEM_PER_BLOCK and stage % 16 == 0
        # the state's area starts on 16 bytes (its cp.async chunks)
        assert (p.stages * stage + 4 * (2 * (p.lanes - 1) * p.np
                                        + p.np)) % 16 == 0


@pytest.mark.parametrize("B,H,N,want", [
    (8, 64, 64, 2),     # the prefill chunk
    (2, 64, 64, 2),     # the forward at S 40: 128 pairs
    (1, 64, 64, 2),
    (1, 1, 64, 2),
    (16, 64, 64, 2),    # two lanes beat one here too (PERF.md, K6)
    (64, 64, 32, 2),
    (8, 64, 16, 2),     # a whole warp: two lanes of 8 rows
    (8, 64, 37, 1),     # a ragged N: the 64-row instance, one lane
    (2, 3, 8, 1)])
def test_plan_lanes(B, H, N, want):
    p = k6_plan(B, 40, H, N)
    assert p.lanes == want and p.threads % 32 == 0
    assert p.lanes == (1 if p.ragged else K6.K6_LANES)


@pytest.mark.parametrize("kw", [
    dict(N=65), dict(N=128), dict(N=0), dict(N=-1), dict(B=0), dict(T=0),
    dict(H=0), dict(B=-2), dict(B=2 ** 25, H=64)])
def test_plan_refuses(kw):
    args = {"B": 8, "T": 16, "H": 64, "N": 64, **kw}
    with pytest.raises(ValueError):
        k6_plan(args["B"], args["T"], args["H"], args["N"])


def test_twin_constants_are_the_source():
    """The twin's constants are the source's."""
    src = (ROOT / "src/repro_torch/csrc/wkv6_seq.cu").read_text()
    found = dict(re.findall(r"constexpr (?:int|long long) k(\w+) = (\d+);",
                            src))
    names = {"MaxN": "MAX_N", "Tile": "TILE", "Stages": "STAGES",
             "Lanes": "LANES", "MinBlocks": "MIN_BLOCKS", "MaxSmem": "MAX_SMEM"}
    assert set(found) == set(names)
    for cname, pyname in names.items():
        assert int(found[cname]) == getattr(K6, "K6_" + pyname), cname
    fields = re.search(r"struct Plan \{\s*long long ([^;]+);", src).group(1)
    assert [f.strip() for f in fields.split(",")] == list(K6.K6Plan._fields)


def _snap(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _lanes_twin(r, k, v, w, u, s0, valid, snap):
    """K6's arithmetic as the launch of `k6_plan` runs it, in numpy
    float32: lane j of a column holds rows j·R .. j·R + R - 1
    (zeros past N), each row's term r·(s + u·(k·v)) and new state w·s +
    k·v, the state kept where the step is not valid, snapped through bf16;
    y from +0, lane j adding its rows' terms in order to the sum lane j - 1
    handed it (a step earlier in the kernel's iterations: each lane's rows
    are its own, so the skew changes no value)."""
    B, T, H, N = r.shape
    p = k6_plan(B, T, H, N)
    f = np.float32
    pad = lambda a, axes: np.pad(a, [(0, p.np - N) if i in axes else (0, 0)
                                     for i in range(a.ndim)])
    r, k, v, w = (pad(a.numpy(), (3,)) for a in (r, k, v, w))
    u, S = pad(u.numpy(), (1,)), pad(s0.float().numpy(), (2, 3))
    y = np.zeros((B, T, H, p.np), f)
    for t in range(T):
        acc = np.zeros((B, H, p.np), f)              # +0, over (b, h, m)
        new = np.empty_like(S)
        for j in range(p.lanes):
            for n in range(j * p.rows, (j + 1) * p.rows):
                kv = k[:, t, :, n, None] * v[:, t]
                term = r[:, t, :, n, None] * (S[:, :, n] + u[None, :, n, None]
                                               * kv)
                new[:, :, n] = w[:, t, :, n, None] * S[:, :, n] + kv
                if n < N:
                    acc = acc + term
        y[:, t] = acc
        ok = np.ones(B, bool) if valid is None else valid[:, t].numpy() != 0
        S = np.where(ok[:, None, None, None], new, S)
        if snap:
            S = _snap(S)
    return (torch.from_numpy(y[..., :N]),
            torch.from_numpy(np.ascontiguousarray(S[:, :, :N, :N])))


@pytest.mark.parametrize("N", [16, 32, 64, 8, 37, 48])
@pytest.mark.parametrize("carry", ["bfloat16", None])
def test_lanes_twin_is_the_inorder_reference(N, carry):
    """At both lane counts the plan takes (two; one at a ragged N), the
    kernel's decomposition gives y bit for bit as `wkv6_seq_inorder` and
    the state as the plain version, over full, partial and empty prefix
    masks and a bf16 pool state."""
    B, T, H = 3, 6, 2
    g = torch.Generator().manual_seed(N * 10)
    rn = lambda *s: torch.randn(s, generator=g)
    args = (rn(B, T, H, N), rn(B, T, H, N), rn(B, T, H, N),
            torch.exp(-torch.exp(0.5 * rn(B, T, H, N))), 0.5 * rn(H, N),
            rn(B, H, N, N).to(torch.bfloat16))
    valid = torch.zeros((B, T), dtype=torch.int32)
    for i, n in enumerate((T, 2, 0)):
        valid[i, :n] = 1
    y_t, s_t = _lanes_twin(*args, valid, carry is not None)
    y_o, s_o = wkv6_seq_inorder(*args, valid=valid, carry_dtype=carry)
    _, s_p = wkv6_seq_plain(*args, valid=valid, carry_dtype=carry)
    assert torch.equal(y_t.view(torch.int32), y_o.view(torch.int32))
    assert torch.equal(s_t, s_p) and torch.equal(s_o, s_p)
