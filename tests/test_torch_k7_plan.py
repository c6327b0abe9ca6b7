"""K7's launch plan and the data flow of its tensor-core matvec, on the CPU.

`kernels/fused_decode.py:k7_plan` is the twin of the source's plan
(`csrc/rwkv6_body.cuh:plan_of`, held to it on the card by
`test_torch_cuda.py:test_rwkv6_decode_plan_is_the_source`).  Here, at
rwkv6-7b's widths, the smoke widths and a ragged width (D 80, F 176: 2.5
strips of 32), for the all-W8, MIXED and plain bf16 layer forms:

- every output column of every phase's jobs is covered exactly once,
  each K slice once (maa_w1's, the only sliced matrix);
- the items and their K slices depend on (K, N) alone: the same for
  every grid and B, and the blocks' contiguous ranges cover them once;
- the shared memory of the instance fits a block (232,448 bytes);
- a layer has at most seven grid barriers (the twin's count and the
  source's `barrier();` calls);
- the twin's constants are the source's.

`_item_twin` transcribes, lane by lane, what one item's consumer warps
do with its stages, in numpy: the strip rows a slot holds, the x
buffer's fragment order, each thread's A and B registers under the
m16n8k16 layouts of common.cuh, the MMA, the warps' partial sums and
their pairwise reduction.  It is held to the plain product of the decoded matrix
(`unpack_leaf`) for every plane, ragged strips, K not a multiple of 16
and B < 8.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.quant.serving import unpack_leaf
from repro_torch.kernels import fused_decode as fd
from repro_torch.kernels.fused_decode import (
    K7_PHASES, PLANE_IDS, RWKV6_MAT_KEYS, k7_plan)

SRC = (Path(fd.__file__).resolve().parents[1] / "csrc" / "rwkv6_body.cuh")
WIDTHS = {"rwkv6-7b": (4096, 14336, 64, 64), "smoke": (64, 128, 4, 16),
          "ragged": (80, 176, 5, 16)}
FORMS = ("w8", "mixed", "bf16")
SMEM_BYTES = 232_448


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_every_column_once(width, form):
    D, F, H, N = WIDTHS[width]
    plan = k7_plan(D, F, H, N, form)
    for p in K7_PHASES:
        items = plan.phase_items(p)
        seen = {}
        for it in items:
            K, Ncol = it.K, it.N
            cover = seen.setdefault(it.job, np.zeros((K, Ncol), np.int32))
            cover[it.k0:it.k1, it.col0:min(it.col0 + it.ncols, Ncol)] += 1
        jobs = fd._k7_jobs(p, D, F)
        assert sorted(seen) == list(range(len(jobs)))
        for j, cover in seen.items():
            assert (cover == 1).all(), (p, j)
        assert len(items) == plan.items[K7_PHASES.index(p)]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_slices_depend_on_k_and_n_alone(width, form):
    D, F, H, N = WIDTHS[width]
    ref = k7_plan(D, F, H, N, form, grid=132, B=8)
    for grid in (1, 37, 132, 133):
        for B in (1, 5, 8):
            plan = k7_plan(D, F, H, N, form, grid=grid, B=B)
            for p in K7_PHASES:
                items = plan.phase_items(p)
                assert items == ref.phase_items(p)
                dealt = [it for b in range(grid)
                         for it in plan.block_items(p, b)]
                assert dealt == items
            assert plan.stages == ref.stages
    for p in K7_PHASES:
        for it in ref.phase_items(p):
            if it.mat == RWKV6_MAT_KEYS.index(("att", "maa_w1")):
                assert (it.k0, it.k1) == (
                    it.slice * fd.K7_SLICE_ROWS,
                    min(it.K, (it.slice + 1) * fd.K7_SLICE_ROWS))
            else:
                assert (it.k0, it.k1, it.slice) == (0, it.K, 0)


@pytest.mark.parametrize("form", FORMS)
def test_shared_memory_and_barriers(form):
    for D, F, H, N in WIDTHS.values():
        plan = k7_plan(D, F, H, N, form)
        assert plan.smem + fd.K7_STATIC_BYTES <= SMEM_BYTES
        assert plan.barriers_per_layer <= 7
        ring, x, tab, red, scl, bars, stats = plan.offsets
        assert ring == 0 and x == plan.slots * plan.slot_bytes
        assert bars % 8 == 0 and all(o % 16 == 0 for o in plan.offsets)
        assert plan.slots * plan.slot_bytes >= 64 * 1024
        assert plan.stages_max_block * plan.grid >= plan.stages


def test_twin_constants_are_the_source():
    src = SRC.read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kWarps"]) == fd.K7_WARPS
    assert int(const["kSlots"]) == fd.K7_SLOTS
    assert int(const["kSlotRows"]) == fd.K7_SLOT_ROWS
    assert int(const["kRowBytes"]) == fd.K7_ROW_BYTES
    assert int(const["kXRows"]) == fd.K7_X_ROWS
    assert int(const["kSliceRows"]) == fd.K7_SLICE_ROWS
    assert int(const["kBarriersPerLayer"]) == fd.K7_BARRIERS_PER_LAYER
    assert 32 * fd.K7_WARPS + 32 * int(const["kProducers"]) == \
        fd.K7_THREADS
    body = src[src.index("__device__ void consume("):
               src.index("// The kernel both forms launch")]
    assert body.count("barrier();") == fd.K7_BARRIERS_PER_LAYER


# --- the tensor-core data flow of one item ---------------------------------

def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _w8_table():
    t = np.zeros(256, np.float32)
    for e in range(256):
        dq0, dq1 = e & 7, (e >> 3) & 15
        lvl = 0.0
        if dq0:
            lvl = 2.0 ** -dq0 + (2.0 ** -(dq0 + dq1) if dq1 else 0.0)
        t[e] = -lvl if e & 0x80 else lvl
    return t


def _w4_table():
    t = np.zeros(256, np.float32)
    for e in range(16):
        q = e & 7
        lvl = 2.0 ** -q if q else 0.0
        t[e] = -lvl if e & 8 else lvl
    return t


def _frag_pos(o, perm):
    c = (o & 3) if perm else ((o & 7) >> 1)
    j = (o >> 2) if perm else ((o & 1) | ((o >> 3) << 1))
    return c, j


def _item_twin(plane, store, aux, x, B, strip, k0, k1):
    """The sums of one item as the kernel forms them: `store` the matrix as
    stored (uint8 codes (K or K/2, N), or bf16 weights as uint16), x (8,
    K) bf16 values (lanes >= B ignored), rows [k0, k1) -> (cols, 8)."""
    K = x.shape[1]
    kpr = 2 if plane == "w4" else 1
    cols = 32
    sb = 64 if plane == "bf16" else 32      # a strip row's bytes
    srows = 16384 // sb                      # strip rows a slot holds
    raw = store.view(np.uint8) if plane == "bf16" else store
    rb = raw.shape[1]
    perm = plane in ("w8", "vq")
    if plane == "w8":
        tab = _w8_table()
    elif plane == "w4":
        tab = _w4_table()
    elif plane == "vq":
        tab = np.zeros(256, np.float32)
        tab[:aux.size] = aux
    N = store.shape[1]
    sc = np.zeros(cols + 32, np.float32)
    if plane in ("w8", "w4"):
        n = np.arange(strip * cols, strip * cols + cols)
        sc[:cols] = np.where(n < N, aux[np.minimum(n, N - 1)], 0.0)
    # the x buffer: rows k0.. in fragment order, lanes >= B and rows >= K 0
    nrows = k1 - k0
    nkb = -(-nrows // 16)
    xs = np.zeros((nkb, 32, 4), np.float32)
    for off in range(nkb * 16):
        c, j = _frag_pos(off & 15, perm)
        for g in range(8):
            k = k0 + off
            if g < B and k < K:
                xs[off >> 4, 4 * g + c, j] = x[g, k]
    W = fd.K7_WARPS
    acc = np.zeros((W, 32, 8))        # warp, lane, register
    nbr = nrows // kpr
    for st in range(max(1, -(-nbr // srows))):
        br0 = st * srows
        rows = min(srows, nbr - br0)
        nks = -(-rows * kpr // 16)
        prow = nks * 16 // kpr
        slot = np.zeros((prow, sb), np.uint8)
        for r in range(rows):
            row = raw[k0 // kpr + br0 + r]
            seg = row[sb * strip:sb * strip + sb]
            slot[r, :seg.size] = seg
        for w in range(W):
            for kb in range(w, nks, W):
                xkb = (br0 * kpr) // 16 + kb
                A0 = np.zeros((16, 16))
                A1 = np.zeros((16, 16))
                Bm = np.zeros((16, 8))
                for lane in range(32):
                    g, c = lane >> 2, lane & 3
                    b = xs[xkb, lane]
                    Bm[2 * c, g], Bm[2 * c + 1, g] = b[0], b[1]
                    Bm[2 * c + 8, g], Bm[2 * c + 9, g] = b[2], b[3]
                    if plane == "bf16":
                        bf = lambda u: np.array(
                            [u], np.uint32).__lshift__(16).view(
                                np.float32)[0]
                        tiles = []
                        for t in range(2):     # columns 0-15, then 16-31
                            mats = []
                            for mi in range(4):
                                o = 32 * t + (mi & 1) * 16
                                mats.append([slot[kb * 16 + (mi >> 1) * 8 + r,
                                                  o:o + 16].view(np.uint16)
                                             for r in range(8)])
                            tiles.append([(bf(mats[mi][2 * c][g]),
                                           bf(mats[mi][2 * c + 1][g]))
                                          for mi in range(4)])
                        regs0, regs1 = tiles
                    else:
                        def word(r):
                            return slot[r, 4 * g:4 * g + 4]
                        if plane == "w4":
                            wa, wb = word(kb * 8 + c), word(kb * 8 + c + 4)

                            def p4(wd, j):
                                byte = int(wd[j])
                                return (_bf16(tab[byte & 15] * sc[4 * g + j]),
                                        _bf16(tab[byte >> 4] * sc[4 * g + j]))
                            regs0 = [p4(wa, 0), p4(wa, 1), p4(wb, 0),
                                     p4(wb, 1)]
                            regs1 = [p4(wa, 2), p4(wa, 3), p4(wb, 2),
                                     p4(wb, 3)]
                        else:
                            wd = [word(kb * 16 + c + 4 * j) for j in range(4)]

                            def dec(e, j):
                                t = tab[int(e)]
                                return t if plane == "vq" else _bf16(
                                    t * sc[4 * g + j])

                            def p8(w0, w1, j):
                                return (dec(w0[j], j), dec(w1[j], j))
                            regs0 = [p8(wd[0], wd[1], 0), p8(wd[0], wd[1], 1),
                                     p8(wd[2], wd[3], 0), p8(wd[2], wd[3], 1)]
                            regs1 = [p8(wd[0], wd[1], 2), p8(wd[0], wd[1], 3),
                                     p8(wd[2], wd[3], 2), p8(wd[2], wd[3], 3)]
                    for A, regs in ((A0, regs0), (A1, regs1)):
                        if regs is None:
                            continue
                        A[g, 2 * c], A[g, 2 * c + 1] = regs[0]
                        A[g + 8, 2 * c], A[g + 8, 2 * c + 1] = regs[1]
                        A[g, 2 * c + 8], A[g, 2 * c + 9] = regs[2]
                        A[g + 8, 2 * c + 8], A[g + 8, 2 * c + 9] = regs[3]
                D0, D1 = A0 @ Bm, A1 @ Bm
                for lane in range(32):
                    g, c = lane >> 2, lane & 3
                    acc[w, lane, 0:4] += (D0[g, 2 * c], D0[g, 2 * c + 1],
                                          D0[g + 8, 2 * c],
                                          D0[g + 8, 2 * c + 1])
                    acc[w, lane, 4:8] += (D1[g, 2 * c], D1[g, 2 * c + 1],
                                          D1[g + 8, 2 * c],
                                          D1[g + 8, 2 * c + 1])
    red = np.zeros((W, 32, 8))
    for w in range(W):
        for lane in range(32):
            g, c = lane >> 2, lane & 3
            if plane == "bf16":
                for j in range(4):
                    red[w, g + 8 * j, 2 * c:2 * c + 2] = \
                        acc[w, lane, 2 * j:2 * j + 2]
            else:
                for j in range(4):
                    red[w, 4 * g + j, 2 * c:2 * c + 2] = \
                        acc[w, lane, 2 * j:2 * j + 2]
    nw = min(W, -(-nrows // 16))
    p = [red[w] if w < nw else np.zeros_like(red[0]) for w in range(16)]
    while len(p) > 1:
        p = [p[2 * w] + p[2 * w + 1] for w in range(len(p) // 2)]
    return p[0][:cols]


def _leaf(plane, K, N, rng, codebook=256):
    if plane == "bf16":
        w = _bf16(rng.standard_normal((K, N)) * 0.1)
        store = torch.from_numpy(w).to(torch.bfloat16).view(
            torch.int16).numpy().view(np.uint16)
        return store, None, w
    if plane == "vq":
        codes = rng.integers(0, codebook, (K, N), dtype=np.uint8)
        cb = _bf16(rng.standard_normal(codebook) * 0.1)
        leaf = {"vq_idx": torch.from_numpy(codes),
                "codebook": torch.from_numpy(cb).to(torch.bfloat16)[None]}
        return codes, cb, unpack_leaf(leaf).float().numpy()
    rows = K // 2 if plane == "w4" else K
    codes = rng.integers(0, 256, (rows, N), dtype=np.uint8)
    scale = (rng.random(N).astype(np.float32) * 0.2 + 0.01)
    key = "packed4" if plane == "w4" else "packed"
    leaf = {key: torch.from_numpy(codes),
            "scale": torch.from_numpy(scale)[None]}
    return codes, scale, unpack_leaf(leaf).float().numpy()


@pytest.mark.parametrize("plane,K,N,strip,sliced,B", [
    ("w8", 1040, 80, 2, False, 8),     # 1040 rows: two stages, ragged strip
    ("w8", 512, 160, 1, True, 3),      # a maa_w1 K slice
    ("w4", 2080, 48, 1, False, 8),     # three W4 stages (1024 rows each)
    ("w4", 36, 64, 0, False, 5),       # K not a multiple of 16
    ("vq", 600, 40, 1, False, 8),      # ragged strip, 37-entry codebook
    ("bf16", 530, 40, 1, False, 7),    # bf16 strips of 32, ragged strip
])
def test_item_twin_matches_the_decoded_product(plane, K, N, strip, sliced,
                                               B):
    rng = np.random.default_rng(K + N)
    store, aux, w = _leaf(plane, K, N, rng,
                          codebook=37 if plane == "vq" else 256)
    x = _bf16(rng.standard_normal((8, K)))
    k0, k1 = (256, 512) if sliced else (0, K)
    cols = 32
    got = _item_twin(plane, store, aux, x, B, strip, k0, k1)
    c0, c1 = strip * cols, min(N, strip * cols + cols)
    ref = x[:B, k0:k1].astype(np.float64) @ w[k0:k1, c0:c1].astype(
        np.float64)
    np.testing.assert_allclose(got[:c1 - c0, :B], ref.T, rtol=1e-12,
                               atol=1e-12)
    assert not got[:c1 - c0, B:].any()
