"""Baseline quantization schemes for the Table-1 ablation (port of
`repro/core/quant/schemes.py`).

The paper compares its Δ-PoT scheme against three baselines, all
simulating the precision loss of an equivalent W9A9 quantization:

  RTN  — round-to-nearest uniform symmetric
  PoT  — one power-of-two level per weight
  LogQ — logarithmic levels with a fractional log step

Each is a fake-quant `f(w, bits, axis) -> w_hat` in w's dtype, so the
ablation can swap schemes over the same model.

PoT and LogQ take log2, round and a power of two.  The port computes
them as exact arithmetic would: log2 in float64, and each level 2^-e
(2^(-i/2) for LogQ) built from exponent bits in float64, then rounded
once to f32.  XLA's f32 exp2 on the CPU is inexact at most integers from
±13 out (ROADMAP "Reference status"), so JAX's levels sit within a few
f32 ulps of these; where -log2|w|/s lies within an ulp of a rounding tie,
JAX's f32 log2 can pick the neighbouring level.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.quant.delta_pot import dpot_fake_quant
from repro_torch.core.quant.uniform import _amax, uniform_fake_quant


def rtn_fake_quant(w: torch.Tensor, bits: int = 9, axis=None
                   ) -> torch.Tensor:
    """Round-to-nearest uniform: uniform symmetric fake-quant."""
    return uniform_fake_quant(w, bits, axis)


def _pow2_f64(e: torch.Tensor) -> torch.Tensor:
    """2^e exactly, for integer e in [-1022, 1023], from exponent bits."""
    bits = (e.to(torch.int64) + 1023) << 52
    return bits.view(torch.float64)


def _log_levels(w: torch.Tensor, bits: int, axis, log_step: float):
    """(w32, per-channel scale s, a = |w|/s, i = round(-log2(a)/step)
    clipped to [0, n_codes - 1], n_codes): the shared front of PoT and
    LogQ.  A zero channel takes s = 1; a < 1e-38 counts as 1e-38."""
    w32 = w.to(torch.float32)
    s = _amax(w32, axis)
    s = torch.where(s <= 0, torch.ones_like(s), s)
    n_codes = (1 << (bits - 1)) - 1
    a = w32.abs() / s
    loga = torch.log2(torch.clamp_min(a.double(), 1e-38)) / log_step
    i = torch.clamp(torch.round(-loga), 0, n_codes - 1)
    return w32, s, a, i, n_codes


def _apply(w, w32, s, a, lvl, smallest):
    # the zero code: values nearer 0 than to the smallest level (the
    # threshold in f32, as JAX's weakly typed scalar becomes)
    thr = torch.tensor(smallest / 2, dtype=torch.float32, device=a.device)
    lvl = torch.where(a < thr, torch.zeros_like(lvl), lvl)
    return (torch.sign(w32) * lvl * s).to(w.dtype)


def pot_fake_quant(w: torch.Tensor, bits: int = 9, axis=None
                   ) -> torch.Tensor:
    """Single-term powers of two: w_hat = s · sign(w) · 2^-e, e =
    round(-log2(|w|/s)) clipped to the (bits-1)-bit exponent range below
    the per-channel max, with a zero code for |w| below half the smallest
    level."""
    w32, s, a, e, n_exp = _log_levels(w, bits, axis, 1.0)
    lvl = _pow2_f64(-e).to(torch.float32)
    return _apply(w, w32, s, a, lvl, 2.0 ** (-(n_exp - 1)))


def logq_fake_quant(w: torch.Tensor, bits: int = 9, axis=None,
                    log_step: float = 0.5) -> torch.Tensor:
    """Logarithmic levels s · 2^(-i·step): with the default step 0.5 an
    odd i's level is 2^-(i//2) · √½, rounded once to f32; another step
    takes float64 exp2."""
    w32, s, a, i, n_codes = _log_levels(w, bits, axis, log_step)
    if log_step == 0.5:
        half = torch.div(i, 2, rounding_mode="floor")
        root = torch.where((i - 2 * half).bool(),
                           torch.full_like(i, math.sqrt(0.5)),
                           torch.ones_like(i))
        lvl64 = _pow2_f64(-half) * root
    else:
        lvl64 = torch.exp2(-i * log_step)
    return _apply(w, w32, s, a, lvl64.to(torch.float32),
                  2.0 ** (-(n_codes - 1) * log_step))


def proposed_fake_quant(w: torch.Tensor, bits: int = 9, axis=None
                        ) -> torch.Tensor:
    """The paper's scheme at the Table-1 operating point: Δ-PoT sign +
    ks=(4, 4) (9 bits), per-channel MSE-refined scales."""
    del bits  # fixed by the format
    return dpot_fake_quant(w, (4, 4), axis, True)


# name -> fake-quant fn, as compared in Table 1
SCHEMES = {
    "fp": lambda w, bits=9, axis=None: w,
    "rtn": rtn_fake_quant,
    "pot": pot_fake_quant,
    "logq": logq_fake_quant,
    "proposed": proposed_fake_quant,
}
