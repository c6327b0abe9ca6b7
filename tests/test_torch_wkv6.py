"""Port vs JAX: the WKV-6 recurrence and the masked sequential kernel K6's
plain version, on the CPU at the smoke head size.

`wkv6_seq_pallas` does not run under jax >= 0.5 (pl.load/pl.store are
gone), so K6's plain version is held against a loop of JAX's
`core/wkv/wkv6.py:wkv6_step` applying the same commit mask and bf16 carry
snap as `kernels/wkv6.py:_seq_kernel`.

Tolerances (tests/port_helpers.py terms): f32 throughout, the outputs sum
n in another order than XLA's dot, so F32_RTOL = 2^-20 relative to the
largest |ref| without the snap; with the bf16 carry a last-bit difference
can flip one bf16 rounding of the state, and the port_helpers rule
applies.  The states are held bit for bit where no sum feeds them.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from port_helpers import assert_close, f32
from repro.core.wkv.wkv6 import wkv6_scan as j_scan
from repro.core.wkv.wkv6 import wkv6_step as j_step
from repro.kernels.common import exact_jit
from repro_torch.core.wkv.wkv6 import wkv6_init_state
from repro_torch.core.wkv.wkv6 import wkv6_scan as t_scan
from repro_torch.core.wkv.wkv6 import wkv6_step as t_step
from repro_torch.kernels.wkv6 import (
    wkv6_seq, wkv6_seq_inorder, wkv6_seq_plain)

B, T, H, N = 4, 7, 4, 16
PREFIX = (T, 3, 0, 1)      # full, partial, no valid token, single
F32_RTOL = 2.0 ** -20


def _inputs(rng):
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    return dict(r=f(B, T, H, N), k=f(B, T, H, N), v=f(B, T, H, N),
                # the decay of the model: exp(-exp(·)) in (0, 1)
                w=np.exp(-np.exp(0.5 * f(B, T, H, N))).astype(np.float32),
                u=(0.5 * f(H, N)).astype(np.float32),
                s0=bf(f(B, H, N, N)))


def _valid():
    valid = np.zeros((B, T), bool)
    for i, n in enumerate(PREFIX):
        valid[i, :n] = True
    return valid


def _close_f32(want, got, what=""):
    np.testing.assert_allclose(f32(got), f32(want), rtol=F32_RTOL,
                               atol=F32_RTOL * np.abs(f32(want)).max(),
                               err_msg=what)


def _jax_masked_loop(inp, valid, carry):
    """kernels/wkv6.py:_seq_kernel's step semantics, built from
    wkv6_step."""
    snap = ((lambda x: x) if carry is None else
            (lambda x: x.astype(jnp.bfloat16).astype(jnp.float32)))

    def run(r, k, v, w, u, s0, valid):
        S, ys = s0, []
        for t in range(T):
            new, y = j_step(S, r[:, t], k[:, t], v[:, t], w[:, t], u)
            ys.append(y)
            S = snap(jnp.where(valid[:, t, None, None, None], new, S))
        return jnp.stack(ys, 1), S
    args = [jnp.asarray(inp[n]) for n in ("r", "k", "v", "w", "u", "s0")]
    return exact_jit(run)(*args, jnp.asarray(valid))


def _torch(inp):
    return {n: torch.from_numpy(a) for n, a in inp.items()}


def test_wkv6_step_matches_jax(rng):
    inp = _inputs(rng)
    args = [inp[n][:, 0] for n in "rkvw"] + [inp["u"]]
    js, jy = exact_jit(j_step)(inp["s0"], *args)
    ts, ty = t_step(torch.from_numpy(inp["s0"]),
                    *map(torch.from_numpy, args))
    _close_f32(jy, ty, "y")
    _close_f32(js, ts, "state")


def test_wkv6_scan_matches_jax(rng):
    inp = _inputs(rng)
    seq = [inp[n] for n in ("r", "k", "v", "w", "u")]
    jy, jfin = exact_jit(j_scan)(*seq, jnp.asarray(inp["s0"]))
    ty, tfin = t_scan(*map(torch.from_numpy, seq),
                      torch.from_numpy(inp["s0"]))
    _close_f32(jy, ty, "y")
    _close_f32(jfin, tfin, "state")
    # from the zero state when none is given
    jy0, _ = exact_jit(j_scan)(*seq)
    ty0, _ = t_scan(*map(torch.from_numpy, seq))
    _close_f32(jy0, ty0, "y from zeros")
    assert torch.equal(wkv6_init_state(2, H, N, device="cpu"),
                       torch.zeros((2, H, N, N)))


@pytest.mark.parametrize("carry", ["bfloat16", None])
def test_wkv6_seq_plain_matches_masked_step_loop(rng, carry):
    """Plain K6 == the JAX step loop with the same mask and carry snap,
    over full, partial, empty and single-token prefix masks."""
    inp = _inputs(rng)
    valid = _valid()
    jy, jfin = _jax_masked_loop(inp, valid, carry)
    t = _torch(inp)
    ty, tfin = wkv6_seq_plain(t["r"], t["k"], t["v"], t["w"], t["u"],
                              t["s0"], valid=torch.from_numpy(valid),
                              carry_dtype=carry)
    assert ty.dtype == tfin.dtype == torch.float32
    _close_f32(jy, ty, "y")
    if carry is None:
        _close_f32(jfin, tfin, "state")
    else:
        assert_close(jfin, tfin, "state")


@pytest.mark.parametrize("carry", ["bfloat16", None])
def test_wkv6_seq_inorder_matches_plain_state_and_jax(rng, carry):
    """The in-order reference (K6's y order: n in order from +0, eager
    ops) carries the plain version's state bit for bit; its y sits within
    F32_RTOL of JAX's `core/wkv` scan without a mask or snap, and of the
    JAX step loop with them (the port_helpers rule for the snapped
    state)."""
    inp = _inputs(rng)
    t = _torch(inp)
    args = [t[n] for n in ("r", "k", "v", "w", "u", "s0")]
    valid = torch.from_numpy(_valid())
    ty, tfin = wkv6_seq_inorder(*args, valid=valid, carry_dtype=carry)
    py, pfin = wkv6_seq_plain(*args, valid=valid, carry_dtype=carry)
    assert torch.equal(tfin, pfin)
    _close_f32(py, ty, "y against the plain version")
    jy, jfin = _jax_masked_loop(inp, _valid(), carry)
    _close_f32(jy, ty, "y against the JAX step loop")
    if carry is None:
        _close_f32(jfin, tfin, "state")
    else:
        assert_close(jfin, tfin, "state")
    seq = [inp[n] for n in ("r", "k", "v", "w", "u")]
    jy, jfin = exact_jit(j_scan)(*seq, jnp.asarray(inp["s0"]))
    ty, tfin = wkv6_seq_inorder(*args)
    _close_f32(jy, ty, "y against JAX's scan")
    _close_f32(jfin, tfin, "state against JAX's scan")


def test_wkv6_seq_takes_the_bf16_pool_state(rng):
    """The wrapper reads a bf16 initial state as it is (bf16 -> f32 is
    exact), launching nothing for CPU tensors; a lane with no valid token
    returns its incoming state exactly."""
    t = _torch(_inputs(rng))
    valid = torch.from_numpy(_valid())
    args = [t[n] for n in ("r", "k", "v", "w", "u")]
    before = wkv6_seq.launches
    y32, s32 = wkv6_seq(*args, t["s0"], valid=valid, carry_dtype="bfloat16")
    y16, s16 = wkv6_seq(*args, t["s0"].to(torch.bfloat16), valid=valid,
                        carry_dtype="bfloat16")
    assert wkv6_seq.launches == before
    assert torch.equal(y32, y16) and torch.equal(s32, s16)
    lane = PREFIX.index(0)
    assert torch.equal(s16[lane], t["s0"][lane])
    # the carried state lies on the bf16 grid after every step
    assert torch.equal(s16, s16.to(torch.bfloat16).float())


def test_wkv6_seq_rejects_unknown_carry(rng):
    t = _torch(_inputs(rng))
    with pytest.raises(ValueError):
        wkv6_seq(*(t[n] for n in ("r", "k", "v", "w", "u", "s0")),
                 carry_dtype="float16")
