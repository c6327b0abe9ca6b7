"""Chunked-prefill building blocks: the chunk matmuls over the three
weight planes (kernels K5, K5-W4, K5-VQ) and the plain prefix-mask helpers.

Port of `repro/kernels/fused_prefill.py`.  Each wrapper replaces one TPU
kernel, x (M, K) bf16 @ a quantized plane decoded inside the kernel:

  dpot_w8_matmul  `dpot_chunk_matmul` (`_mm_kernel`)     W8 (K, N) + (N,) f32
  dpot_w4_matmul  `w4_chunk_matmul` (`_mm_kernel_w4`)    W4 (K/2, N) + (N,) f32
  vq_matmul       `vq_chunk_matmul` (`_mm_kernel_vq`)    VQ (K, N) + (C,) bf16

All three are one tensor-core CUDA kernel over a decode table
(`csrc/chunk_matmul.cu`; its header says what bounds it on an H100 and
how its design answers that).  `chunk_matmul_plan` cuts the work: one row
tile for M <= 128, 128-column tiles, and K in slices chosen from K and N
only, so a row's bits never depend on M.  The wrappers pass the plan, the
decode table (`decode_table`, cached per device) and, when K is cut, an
f32 workspace for the slices' partials.  The serving path calls them for
every prefill matmul (M = B·C) and for the prefill and decode heads (M =
B).  `dpot_w8_matmul_f32x`, `dpot_w4_matmul_f32x` and `vq_matmul_f32x`
are the three for an f32 x, returning f32 (the TPU kernels'
`result_type(x, dt)`): under the hardware numerics att.wo's input is
f32.  They are instances of the same kernel under the same plan: x is
split into three bf16 pieces (`split_bf16x3` is the split's plain twin,
for the tests), each multiplied by the bf16 weights on the tensor cores,
so the f32 products are exact and only the order of the f32 sums
differs from the plain version.

A CPU tensor takes the plain version, `x @ unpack_leaf(leaf).to(bf16)`; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.quant.delta_pot import (
    FORMAT_W4, FORMAT_W8, dpot_decode_codes)
from repro_torch.core.quant.serving import _sign, leaf_plane, unpack_leaf
from repro_torch.device import exact_matmuls
from repro_torch.kernels.build import check, load_library, stream_ptr

# the kernel's tile (csrc/chunk_matmul.cu: BN, BK), the grid it aims for
# (two blocks on each of the H100's 132 SMs: the 128-row instance's
# occupancy), the least code bytes a block should read when the plane is
# too small for that many, and a block's fixed cost in ring stages (the
# prologue, the table and the epilogue), by which the plan weighs a
# partly filled last wave
CHUNK_BN, CHUNK_BK = 128, 32
TARGET_BLOCKS = 2 * 132
BLOCK_CODE_BYTES = 16 * 1024
BLOCK_OVERHEAD_STAGES = 4


class ChunkPlan(NamedTuple):
    """How `csrc/chunk_matmul.cu` cuts one call: rows in tiles of `bm`
    (16·ceil(M/16), at most 128), columns in tiles of `bn`, the
    contraction in `slices` slices of `slice_len` rows (the last shorter),
    each `bk` rows a ring stage."""
    bm: int
    bn: int
    bk: int
    slices: int
    slice_len: int
    row_tiles: int
    col_tiles: int

    @property
    def blocks(self) -> int:
        return self.row_tiles * self.col_tiles * self.slices


@functools.lru_cache(maxsize=None)
def chunk_matmul_plan(M: int, K: int, N: int, plane: str = "w8") -> ChunkPlan:
    """The slices come from K, N and the plane only, never from M.  They
    are at least enough to give the grid TARGET_BLOCKS blocks, or one per
    BLOCK_CODE_BYTES of codes when the plane is smaller; a slice is a
    whole number of ring stages (so W4's slices are even), rounded down
    so the slices are at least as many as asked.  A plane that needs a
    split to fill the card takes, from up to twice that many slices, the
    count with the least waves × (stages a block + its fixed cost)."""
    bm = min(128, 16 * -(-M // 16))
    col_tiles = -(-N // CHUNK_BN)
    code_bytes = K * N // 2 if plane == "w4" else K * N
    want = min(TARGET_BLOCKS, -(-code_bytes // BLOCK_CODE_BYTES))
    k_tiles = -(-K // CHUNK_BK)
    s_min = min(k_tiles, -(-want // col_tiles))

    def cut(s):
        length = (k_tiles // s) * CHUNK_BK
        return length, -(-K // length)

    def cost(c):
        waves = -(-col_tiles * c[1] // TARGET_BLOCKS)
        return waves * (c[0] // CHUNK_BK + BLOCK_OVERHEAD_STAGES)
    best = cut(s_min)
    if want == TARGET_BLOCKS and s_min > 1:
        best = min((cut(s) for s in range(s_min, min(k_tiles, 2 * s_min)
                                          + 1)), key=cost)
    return ChunkPlan(bm, CHUNK_BN, CHUNK_BK, best[1], best[0], -(-M // 128),
                     col_tiles)


@functools.lru_cache(maxsize=None)
def decode_table(plane: str, device: torch.device) -> torch.Tensor:
    """The kernel's decode table: sign·level in f32 for each of W8's 256
    codes or W4's 16 nibbles, formed by unpack_leaf's own operations, so
    bf16(table[code]·scale) is unpack_leaf's weight bit for bit."""
    fmt, bits = (FORMAT_W8, 8) if plane == "w8" else (FORMAT_W4, 4)
    codes = torch.arange(1 << bits, device=device)
    top = 1 << (bits - 1)
    return _sign((codes & top) // top) * dpot_decode_codes(codes & (top - 1),
                                                           fmt.ks)


@functools.lru_cache(maxsize=None)
def piece_table(plane: str, device: torch.device) -> torch.Tensor:
    """K1's and K8's decode table (`csrc/chunk_matmul.cu`, the EXACT
    instances): each code's sign·level, `decode_table`'s f32 value with no
    scale, as two bf16 pieces in one int32 word, hi in bits 15:0 and lo in
    31:16.  hi is the level with its significand cut to bf16's (the top
    16 bits of the f32), lo = level - hi, exact.  A W8 level 2^-q0 +
    2^-(q0+Δq1) is hi + lo exactly, lo nonzero only when Δq1 > 7; a W4
    level 2^-Δq is hi alone.  Raises if a level needs a third piece."""
    hi, lo, rest = split_bf16x3(decode_table(plane, device))
    if bool((rest != 0).any()):
        raise ValueError(f"a {plane} level is not two bf16 pieces")
    # each piece's f32 bits have 15:0 clear: its bf16 bits are 31:16
    return (hi.view(torch.int32) >> 16 & 0xFFFF) | lo.view(torch.int32)


def _vector_loads(x: torch.Tensor, codes: torch.Tensor) -> int:
    """Which producers copy 16-byte chunks by cp.async: bit 0 the code
    rows, bit 1 the x rows (bf16 or f32); each needs rows that are whole
    chunks, starting on 16-byte addresses.  A plane that has not
    (rwkv4-169m's head, N = 50277) takes the kernel instance whose
    producer loads bytes."""
    K, N = x.shape[1], codes.shape[1]
    return (int(N % 16 == 0 and codes.data_ptr() % 16 == 0)
            | int(K * x.element_size() % 16 == 0
                  and x.data_ptr() % 16 == 0) << 1)


def split_bf16x3(x: torch.Tensor):
    """The f32-x kernels' split of an f32 x into three bf16 pieces
    (`csrc/common.cuh:split_bf16x3`), in plain torch, for the tests: x0
    is x with its low 16 bits cleared, x1 the same of x - x0, x2 the high
    16 bits of x - x0 - x1, each returned as f32.  Each difference is
    exact, so x0 + x1 + x2 == x in f32 for every finite x whose lowest set
    bit is at least 2^-133 (bf16's least subnormal; every |x| >= 2^-110);
    smaller bits are cut toward zero.  No piece overflows."""
    def top16(t):
        return (t.view(torch.int32) & -65536).view(torch.float32)
    x = x.to(torch.float32)
    x0 = top16(x)
    r1 = x - x0
    x1 = top16(r1)
    x2 = top16(r1 - x1)
    return x0, x1, x2


@exact_matmuls()
def dpot_w8_matmul_plain(x: torch.Tensor, wq: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """The plain version: decode the whole plane, then one matmul."""
    w = unpack_leaf({"packed": wq, "scale": scale.reshape(1, -1)})
    return x @ w.to(x.dtype)


@exact_matmuls()
def dpot_w4_matmul_plain(x: torch.Tensor, wq4: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    w = unpack_leaf({"packed4": wq4, "scale": scale.reshape(1, -1)})
    return x @ w.to(x.dtype)


@exact_matmuls()
def vq_matmul_plain(x: torch.Tensor, idx: torch.Tensor,
                    codebook: torch.Tensor) -> torch.Tensor:
    w = unpack_leaf({"vq_idx": idx, "codebook": codebook})
    return x @ w.to(x.dtype)


# the x each C entry takes (its out is the same dtype)
_X_DTYPE = {"dpot_w8_matmul": torch.bfloat16,
            "dpot_w4_matmul": torch.bfloat16,
            "vq_matmul": torch.bfloat16,
            "dpot_w8_matmul_f32x": torch.float32,
            "dpot_w4_matmul_f32x": torch.float32,
            "vq_matmul_f32x": torch.float32}


def _check_operands(name, x, codes, aux, k_rows: int, aux_dtype,
                    aux_len: int | None):
    if codes.shape[0] != k_rows or (aux_len is not None
                                    and aux.numel() != aux_len):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)} codes "
                         f"{tuple(codes.shape)} aux {aux.numel()} do not "
                         "agree")
    if (x.dtype != _X_DTYPE[name] or codes.dtype != torch.uint8
            or aux.dtype != aux_dtype):
        raise TypeError(f"{name} takes {_X_DTYPE[name]} x, uint8 codes, "
                        f"{aux_dtype} aux; got {x.dtype}, {codes.dtype}, "
                        f"{aux.dtype}")
    if not (codes.device == x.device == aux.device):
        raise ValueError(f"{name}: x, codes and aux must be on one device")
    if not codes.is_contiguous():
        raise ValueError(f"{name}: codes must be contiguous")


def launch_chunk_mm(entry: str, plane: str, x, codes, lead: tuple, tail=()):
    """Launch one K5 form (or K1, K8): `lead` are the entry's arguments
    between the codes and the workspace (the scale and the decode table,
    or the codebook and its length), `tail` those before the stream.  The
    out is x's dtype: bf16, or f32 for the f32-x forms."""
    M, K, N = x.shape[0], x.shape[1], codes.shape[1]
    plan = chunk_matmul_plan(M, K, N, plane)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    ws = (torch.empty((plan.slices, M, N), dtype=torch.float32,
                      device=x.device) if plan.slices > 1 else None)
    check(getattr(load_library(), entry)(
        x.data_ptr(), codes.data_ptr(), *lead,
        None if ws is None else ws.data_ptr(), out.data_ptr(), M, K, N,
        plan.bm, plan.bn, plan.bk, plan.slice_len, plan.slices,
        _vector_loads(x, codes), *tail, stream_ptr(x)), entry)
    return out


def _w8(entry: str, x, wq, scale):
    scale = scale.reshape(-1)
    _check_operands(entry, x, wq, scale, x.shape[1], torch.float32,
                    wq.shape[1])
    x, scale = x.contiguous(), scale.contiguous()
    return launch_chunk_mm(entry, "w8", x, wq, (
        scale.data_ptr(), decode_table("w8", x.device).data_ptr()))


def _w4(entry: str, x, wq4, scale):
    scale = scale.reshape(-1)
    if x.shape[1] % 2:
        raise ValueError(f"{entry}: K={x.shape[1]} must be even")
    _check_operands(entry, x, wq4, scale, x.shape[1] // 2, torch.float32,
                    wq4.shape[1])
    x, scale = x.contiguous(), scale.contiguous()
    return launch_chunk_mm(entry, "w4", x, wq4, (
        scale.data_ptr(), decode_table("w4", x.device).data_ptr()))


def _vq(entry: str, x, idx, codebook):
    cb = codebook.reshape(-1)
    _check_operands(entry, x, idx, cb, x.shape[1], torch.bfloat16, None)
    C = cb.numel()
    if not 1 <= C <= 256:
        raise ValueError(f"{entry}: codebook of {C} entries; uint8 "
                         "indices need 1..256")
    x, cb = x.contiguous(), cb.contiguous()
    return launch_chunk_mm(entry, "vq", x, idx, (cb.data_ptr(), C))


def dpot_w8_matmul(x: torch.Tensor, wq: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) bf16 @ W8 plane wq (K, N) uint8 with scale (..., N) f32
    -> (M, N) bf16, the codes decoded in-kernel."""
    if x.device.type == "cpu":
        return dpot_w8_matmul_plain(x, wq, scale)
    out = _w8("dpot_w8_matmul", x, wq, scale)
    dpot_w8_matmul.launches += 1
    return out


def dpot_w8_matmul_f32x(x: torch.Tensor, wq: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """K5's f32-activation form: x (M, K) f32 @ the W8 plane -> (M, N)
    f32, the bf16 weights promoted and the f32 sum not rounded."""
    if x.device.type == "cpu":
        return dpot_w8_matmul_plain(x, wq, scale)
    out = _w8("dpot_w8_matmul_f32x", x, wq, scale)
    dpot_w8_matmul_f32x.launches += 1
    return out


def dpot_w4_matmul(x: torch.Tensor, wq4: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) bf16 @ W4 plane wq4 (K/2, N) uint8 (row 2k in the low
    nibble of packed row k) with scale (..., N) f32 -> (M, N) bf16."""
    if x.device.type == "cpu":
        return dpot_w4_matmul_plain(x, wq4, scale)
    out = _w4("dpot_w4_matmul", x, wq4, scale)
    dpot_w4_matmul.launches += 1
    return out


def dpot_w4_matmul_f32x(x: torch.Tensor, wq4: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """K5-W4's f32-activation form: x (M, K) f32 @ the W4 plane -> (M, N)
    f32, the bf16 weights promoted and the f32 sum not rounded."""
    if x.device.type == "cpu":
        return dpot_w4_matmul_plain(x, wq4, scale)
    out = _w4("dpot_w4_matmul_f32x", x, wq4, scale)
    dpot_w4_matmul_f32x.launches += 1
    return out


def vq_matmul(x: torch.Tensor, idx: torch.Tensor,
              codebook: torch.Tensor) -> torch.Tensor:
    """x (M, K) bf16 @ codebook[idx (K, N) uint8], codebook (..., C) bf16
    with C <= 256 -> (M, N) bf16."""
    if x.device.type == "cpu":
        return vq_matmul_plain(x, idx, codebook)
    out = _vq("vq_matmul", x, idx, codebook)
    vq_matmul.launches += 1
    return out


def vq_matmul_f32x(x: torch.Tensor, idx: torch.Tensor,
                   codebook: torch.Tensor) -> torch.Tensor:
    """K5-VQ's f32-activation form: x (M, K) f32 @ codebook[idx] -> (M, N)
    f32, the bf16 weights promoted and the f32 sum not rounded."""
    if x.device.type == "cpu":
        return vq_matmul_plain(x, idx, codebook)
    out = _vq("vq_matmul_f32x", x, idx, codebook)
    vq_matmul_f32x.launches += 1
    return out


dpot_w8_matmul.launches = 0
dpot_w8_matmul_f32x.launches = 0
dpot_w4_matmul.launches = 0
dpot_w4_matmul_f32x.launches = 0
vq_matmul.launches = 0
vq_matmul_f32x.launches = 0


def chunk_matmul(x: torch.Tensor, leaf, dt) -> torch.Tensor:
    """`x @ leaf` over a (..., K) chunk tensor, plane aware: plain leaves
    take the torch matmul (as the JAX package leaves them to XLA); a plane
    leaf flattens the chunk to (S·C, K) and runs its kernel (K5, K5-W4 or
    K5-VQ, or their f32-x forms).  x is in the compute dtype `dt`, or f32
    (the result then f32, the weights promoted, as JAX's matmul promotes
    them)."""
    plane = leaf_plane(leaf)
    if plane is None:
        return x @ leaf.to(x.dtype)
    if x.dtype not in (dt, torch.float32):
        raise TypeError(f"chunk_matmul: x is {x.dtype}, compute dtype {dt}")
    lead, K = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, K)
    f32x = x.dtype == torch.float32
    if plane == "w4":
        fn = dpot_w4_matmul_f32x if f32x else dpot_w4_matmul
        out = fn(xf, leaf["packed4"], leaf["scale"])
    elif plane == "vq":
        fn = vq_matmul_f32x if f32x else vq_matmul
        out = fn(xf, leaf["vq_idx"], leaf["codebook"])
    else:
        fn = dpot_w8_matmul_f32x if f32x else dpot_w8_matmul
        out = fn(xf, leaf["packed"], leaf["scale"])
    return out.reshape(*lead, out.shape[-1])


def shifted_prev(seq: torch.Tensor, first: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Token-shift previous-value sequence under a per-slot PREFIX mask.

    seq (B, C, D) are the per-position carry candidates; first (B, D) the
    incoming pool carry.  Position t sees seq[t-1] inside the valid prefix,
    the LAST valid entry once the prefix ends (the per-op oracle freezes
    its carry there), and `first` at t = 0 or on lanes with no valid
    token."""
    B, C = valid.shape
    nv = valid.to(torch.int32).sum(dim=1)
    j = torch.minimum(torch.arange(C, device=seq.device)[None, :],
                      nv[:, None]) - 1                           # (B, C)
    idx = j.clamp(min=0)[..., None].expand(B, C, seq.shape[-1])
    got = torch.gather(seq, 1, idx)
    return torch.where((j >= 0)[..., None], got, first[:, None])


def gather_last_valid(seq: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """seq (B, C, ...) -> (B, ...): the row of lane b at position idx[b]."""
    return seq[torch.arange(seq.shape[0], device=seq.device), idx]


def last_valid_select(seq: torch.Tensor, old: torch.Tensor,
                      n_valid: torch.Tensor) -> torch.Tensor:
    """Final-state helper: the last valid position of `seq` cast to `old`'s
    dtype, or `old` itself on lanes whose chunk had no valid token."""
    got = gather_last_valid(seq, (n_valid - 1).clamp(min=0)).to(old.dtype)
    anyv = (n_valid > 0).reshape((-1,) + (1,) * (old.ndim - 1))
    return torch.where(anyv, got, old)
