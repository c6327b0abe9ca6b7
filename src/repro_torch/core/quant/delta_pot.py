"""Δ-PoT quantization (paper §3.1): the formats W9, W8, W4 and PoT4.

Port of `repro/core/quant/delta_pot.py`: the format description, the level
table, nearest-code quantization (per-channel or tensor-wide scale, with
the optional MSE grid search of the scale), the int8 packing of the W8
plane and the nibble packing of the W4 plane.  A W8 level is 2^-q0 + 2^-(q0+q1)
with the differential exponents Δq0 (3 bits) and Δq1 (4 bits) packed
low-to-high; a zero Δ kills every later term.  Bit 7 of the packed byte
is the sign.  A W4 level is the single term 2^-q (q in 1..7, 0 for
q = 0); sign and code fill a nibble, two nibbles a byte.

Quantization matches the JAX package bit for bit on the CPU: the same
f32 midpoints (computed in float64, then rounded), `searchsorted` with
side left, and the per-channel scale amax / max_level in f32.  Decoding
(`dpot_decode_codes`, `dpot_dequantize`) gathers from the exact level
table: bit for bit with JAX for W8 and W4, whose exp2 sums land on the
exact levels; for W9 and PoT4 XLA's exp2 on the CPU is inexact at
2^-13 and from 2^-15 down, so 36 of W9's 256 levels (2 of PoT4's 16)
differ from the exact ones there, by at most 4.8e-7 relative.

`dpot_fake_quant` is quantize -> dequantize with a straight-through
gradient (a `torch.autograd.Function` whose backward is the identity).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DPotFormat:
    """Static description of a Δ-PoT code format."""

    ks: tuple[int, ...] = (4, 4)

    @property
    def code_bits(self) -> int:
        return int(sum(self.ks))

    @property
    def total_bits(self) -> int:
        """Code bits + 1 sign bit (the hardware packing's bits a weight)."""
        return self.code_bits + 1

    def __post_init__(self):
        if not self.ks:
            raise ValueError("need at least one term")
        if any(k < 1 for k in self.ks):
            raise ValueError(f"term widths must be >= 1, got {self.ks}")
        if self.code_bits > 8:
            raise ValueError(
                f"code bits {self.code_bits} > 8 unsupported (uint8 storage)")


# sign + ks=(4,4): the paper's "proposed" 8-code-bit format (W9 with the
# sign, the Table-1 row), the quantizer's default
FORMAT_W9 = DPotFormat(ks=(4, 4))
# sign + ks=(3,4): packs with its sign into one uint8 (the serving plane)
FORMAT_W8 = DPotFormat(ks=(3, 4))
# sign + ks=(3,): two weights per uint8 (nibble pairs), half W8's bytes
FORMAT_W4 = DPotFormat(ks=(3,))
# a single 4-bit term: classic power-of-two levels
FORMAT_POT4 = DPotFormat(ks=(4,))


@functools.lru_cache(maxsize=None)
def _level_table(ks: tuple[int, ...]) -> np.ndarray:
    """All 2^Σk unsigned levels, indexed by code (term 0 in the low bits)."""
    n_codes = 1 << sum(ks)
    levels = np.zeros((n_codes,), dtype=np.float64)
    for code in range(n_codes):
        c, p_prev, total = code, 1.0, 0.0
        for k in ks:
            dq = c & ((1 << k) - 1)
            c >>= k
            if dq == 0:
                break
            p_prev *= 2.0 ** (-dq)
            total += p_prev
        levels[code] = total
    return levels


@functools.lru_cache(maxsize=None)
def _sorted_levels(ks: tuple[int, ...]):
    """(sorted unique levels, code of each sorted level, midpoints)."""
    levels = _level_table(ks)
    order = np.argsort(levels, kind="stable")
    sorted_levels = levels[order]
    uniq = np.ones_like(sorted_levels, dtype=bool)
    uniq[1:] = sorted_levels[1:] != sorted_levels[:-1]
    codes = order[uniq].astype(np.int64)
    sorted_levels = sorted_levels[uniq]
    mids = 0.5 * (sorted_levels[1:] + sorted_levels[:-1])
    return sorted_levels, codes, mids


def dpot_levels(fmt: DPotFormat, device="cuda") -> torch.Tensor:
    """Dense code -> level table (2^code_bits entries), unsigned, before
    the scale, exact in f32."""
    return torch.as_tensor(_level_table(fmt.ks).astype(np.float32),
                           device=resolve_device(device))


def dpot_max_level(fmt: DPotFormat) -> float:
    return float(_level_table(fmt.ks).max())


@dataclasses.dataclass
class DPotQuantized:
    """codes uint8 (sign not included), signs int8 ±1, scale f32
    broadcastable to the tensor."""
    codes: torch.Tensor
    signs: torch.Tensor
    scale: torch.Tensor
    ks: tuple[int, ...] = (4, 4)

    @property
    def fmt(self) -> DPotFormat:
        return DPotFormat(self.ks)

    @property
    def shape(self):
        return self.codes.shape

    def nbytes_hardware(self) -> int:
        """Bytes at the hardware packing: code_bits + 1 bits a weight,
        rounded up to a byte, plus one f32 a scale."""
        n = math.prod(self.codes.shape)
        return (n * self.fmt.total_bits + 7) // 8 + self.scale.numel() * 4


def dpot_scale(amax: torch.Tensor, fmt: DPotFormat) -> torch.Tensor:
    """The per-channel scale from the channel's max |w|: amax / max_level
    in f32, 1 where the channel is all zero."""
    # tensor / tensor (not a python scalar) keeps IEEE f32 division
    base = amax / torch.full_like(amax, dpot_max_level(fmt))
    return torch.where(base <= 0, torch.ones_like(base), base)


# the multiplicative refinements of the scale that `mse_search` tries
# (delta_pot.py:_choose_scale)
MSE_CANDIDATES = (0.6, 0.7, 0.8, 0.9, 1.0, 1.1, 1.2)


def _nearest_level(x: torch.Tensor, fmt: DPotFormat) -> torch.Tensor:
    """x -> the nearest level value (not its code), by `searchsorted` on
    the f32 midpoints; a negative x falls to the lowest level, 0."""
    levels, _, mids = _sorted_levels(fmt.ks)
    lv = torch.as_tensor(levels.astype(np.float32), device=x.device)
    md = torch.as_tensor(mids.astype(np.float32), device=x.device)
    return lv[torch.searchsorted(md, x.contiguous(), right=False)]


def _reduce_axes(ndim: int, axis) -> tuple[int, ...]:
    """Every axis but the channel axes `axis` (an int or a tuple)."""
    keep = {a % ndim for a in ((axis,) if isinstance(axis, int) else axis)}
    return tuple(i for i in range(ndim) if i not in keep)


def _choose_scale(w: torch.Tensor, absw: torch.Tensor, axis, fmt,
                  mse_search: bool) -> torch.Tensor:
    """amax / max_level per channel (one scalar for axis=None), refined
    with `mse_search` by the candidate that gives the least squared error,
    the first on a tie.  As in JAX, the error is taken on the signed w,
    so a negative weight counts as quantized to level 0 there."""
    if axis is None:
        red = tuple(range(w.ndim))
        amax = absw.amax()
    else:
        red = _reduce_axes(w.ndim, axis)
        amax = absw.amax(dim=red, keepdim=True) if red else absw
    base = dpot_scale(amax, fmt)
    if not mse_search:
        return base
    cands = torch.tensor(MSE_CANDIDATES, dtype=torch.float32,
                         device=w.device)

    def err_for(c):
        s = base * c
        d = (_nearest_level(w / s, fmt) * s - w) ** 2
        if axis is None:
            return d.sum()
        return d.sum(dim=red, keepdim=True) if red else d

    errs = torch.stack([err_for(c) for c in cands])
    return base * cands[torch.argmin(errs, dim=0)]


def dpot_quantize(w: torch.Tensor, fmt: DPotFormat = FORMAT_W9, *,
                  axis: int | tuple | None = 0, mse_search: bool = False,
                  scale: torch.Tensor | None = None) -> DPotQuantized:
    """Quantize to Δ-PoT codes with one scale per index of `axis` (the
    output channel), reduced over every other axis, or ONE tensor-wide
    scale for axis=None; `mse_search` refines each scale over
    MSE_CANDIDATES.  The defaults are JAX's: W9, axis 0.  A stacked (L, K,
    N) weight under axis=-1 gets ONE (1, 1, N) scale.  A given `scale`
    (broadcastable to w) is used as it is: `serving.pack_leaf` quantizes a
    stacked leaf one layer at a time under the scale of the whole leaf."""
    w = w.to(torch.float32)
    absw = w.abs()
    if scale is None:
        scale = _choose_scale(w, absw, axis, fmt, mse_search)
    _, codes, mids = _sorted_levels(fmt.ks)
    md = torch.as_tensor(mids.astype(np.float32), device=w.device)
    cd = torch.as_tensor(codes, device=w.device)
    idx = torch.searchsorted(md, (absw / scale).contiguous(), right=False)
    signs = torch.where(w < 0, -1, 1).to(torch.int8)
    return DPotQuantized(codes=cd[idx].to(torch.uint8), signs=signs,
                         scale=scale, ks=fmt.ks)


def dpot_decode_codes(codes: torch.Tensor, ks) -> torch.Tensor:
    """Code -> unsigned level in f32, by lookup in the exact level table.

    Each level has at most two set bits within 30 binary places, so it is
    exact in f32; a table gather gives those exact values on any device.
    The JAX package peels terms with exp2: its W8 and W4 sums round to the
    same exact levels, its W9 and PoT4 ones miss some (module docstring)."""
    table = torch.as_tensor(_level_table(tuple(ks)).astype(np.float32),
                            device=codes.device)
    return table[codes.to(torch.int64)]


def dpot_dequantize(q: DPotQuantized) -> torch.Tensor:
    """signs · level · scale in f32, in that order (one rounding, at the
    scale)."""
    lvl = dpot_decode_codes(q.codes, q.ks)
    return q.signs.to(torch.float32) * lvl * q.scale


class _DPotFakeQuant(torch.autograd.Function):
    """Quantize -> dequantize in w's dtype; the gradient passes straight
    through, as the reference's custom_vjp defines it."""

    @staticmethod
    def forward(ctx, w, ks, axis, mse_search):
        q = dpot_quantize(w, DPotFormat(tuple(ks)), axis=axis,
                          mse_search=mse_search)
        return dpot_dequantize(q).to(w.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def dpot_fake_quant(w: torch.Tensor, ks: tuple[int, ...] = (4, 4),
                    axis: int | tuple | None = 0,
                    mse_search: bool = False) -> torch.Tensor:
    """quantize -> dequantize with a straight-through gradient."""
    return _DPotFakeQuant.apply(w, tuple(ks), axis, mse_search)


def dpot_pack_int8(q: DPotQuantized) -> torch.Tensor:
    """Sign + code in one byte: bit 7 sign (1 = negative), bits 6:0 code."""
    if DPotFormat(q.ks).code_bits > 7:
        raise ValueError(f"format {q.ks} does not pack into int8 with a sign")
    sign_bit = (q.signs < 0).to(torch.uint8) << 7
    return q.codes | sign_bit


def dpot_unpack_int8(packed: torch.Tensor, scale: torch.Tensor,
                     ks) -> DPotQuantized:
    """Inverse of `dpot_pack_int8`: codes = bits 6:0, sign from bit 7."""
    ones = torch.ones(packed.shape, dtype=torch.int8, device=packed.device)
    signs = torch.where(((packed >> 7) & 1).bool(), -ones, ones)
    return DPotQuantized(codes=packed & 0x7F, signs=signs, scale=scale,
                         ks=tuple(ks))


def dpot_pack_nibbles(q: DPotQuantized) -> torch.Tensor:
    """Two sign+code nibbles per byte, paired along axis -2 (the
    contraction axis of a (K, N) weight): row 2k is the LOW nibble and
    row 2k+1 the high nibble of packed row k.  Nibble bit 3 is the sign
    (1 = negative), bits 2:0 the code.  (..., K, N) -> (..., K/2, N)."""
    if DPotFormat(q.ks).code_bits > 3:
        raise ValueError(f"format {q.ks} does not pack into a nibble with "
                         "a sign; use FORMAT_W4")
    if q.codes.ndim < 2 or q.codes.shape[-2] % 2:
        raise ValueError(f"nibble packing pairs along axis -2; shape "
                         f"{tuple(q.codes.shape)} needs an even axis -2")
    word = q.codes | ((q.signs < 0).to(torch.uint8) << 3)
    return word[..., 0::2, :] | (word[..., 1::2, :] << 4)


def dpot_unpack_nibbles(packed: torch.Tensor, scale: torch.Tensor,
                        ks) -> DPotQuantized:
    """Inverse of `dpot_pack_nibbles`: (..., K/2, N) -> codes and signs
    of shape (..., K, N), the rows re-interleaved."""
    words = torch.stack([packed & 0xF, (packed >> 4) & 0xF], dim=-2)
    words = words.reshape(packed.shape[:-2] + (2 * packed.shape[-2],
                                               packed.shape[-1]))
    ones = torch.ones(words.shape, dtype=torch.int8, device=words.device)
    signs = torch.where(((words >> 3) & 1).bool(), -ones, ones)
    return DPotQuantized(codes=words & 0x7, signs=signs, scale=scale,
                         ks=tuple(ks))
