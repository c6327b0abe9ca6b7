"""Port vs JAX: the WKV-4 recurrence and the masked sequence kernel K2's
plain version, on the CPU.

`wkv4_pallas` does not run under jax >= 0.5 (pl.load/pl.store are gone),
so K2's plain version is held against a loop of JAX's
`core/wkv/wkv4.py:wkv4_step` applying the same commit mask and bf16 carry
snap as `kernels/wkv4.py:61-85`.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from port_helpers import assert_close, f32
from repro.core.wkv.wkv4 import WKV4State as JState
from repro.core.wkv.wkv4 import wkv4_scan as j_scan
from repro.core.wkv.wkv4 import wkv4_step as j_step
from repro.kernels.common import exact_jit
from repro_torch.core.wkv.wkv4 import WKV4State as TState
from repro_torch.core.wkv.wkv4 import wkv4_scan as t_scan
from repro_torch.core.wkv.wkv4 import wkv4_step as t_step
from repro_torch.kernels.wkv4 import wkv4_seq

B, T, C = 4, 7, 32
PREFIX = (T, 3, 0, 1)      # full, partial, no valid token, single

# f32 throughout: the only differences are exp's last bits (XLA's and
# torch's exp differ by a few ulp), so 2^-20 relative is generous
F32_RTOL = 2.0 ** -20


def _inputs(rng):
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    return dict(k=f(B, T, C), v=f(B, T, C),
                w=np.exp(0.5 * f(C)).astype(np.float32),
                u=(0.5 * f(C)).astype(np.float32),
                a0=bf(f(B, C)), b0=bf(np.abs(f(B, C)) + 0.5),
                o0=bf(f(B, C) - 1.0))


def _valid():
    valid = np.zeros((B, T), bool)
    for i, n in enumerate(PREFIX):
        valid[i, :n] = True
    return valid


def _jax_masked_loop(inp, valid, carry):
    """kernels/wkv4.py:_kernel's step semantics, built from wkv4_step."""
    snap = ((lambda x: x) if carry is None else
            (lambda x: x.astype(jnp.bfloat16).astype(jnp.float32)))

    def run(k, v, w, u, a0, b0, o0, valid):
        a, b, o = a0, b0, o0
        ys = []
        for t in range(T):
            new, y = j_step(JState(a, b, o), k[:, t], v[:, t], w, u)
            ys.append(y)
            ok = valid[:, t, None]
            a = snap(jnp.where(ok, new.a, a))
            b = snap(jnp.where(ok, new.b, b))
            o = snap(jnp.where(ok, new.o, o))
        return jnp.stack(ys, 1), (a, b, o)
    args = [jnp.asarray(inp[n]) for n in ("k", "v", "w", "u", "a0", "b0",
                                          "o0")]
    return exact_jit(run)(*args, jnp.asarray(valid))


def test_wkv4_step_matches_jax(rng):
    inp = _inputs(rng)
    args = [inp["k"][:, 0], inp["v"][:, 0], inp["w"], inp["u"]]
    st = (inp["a0"], inp["b0"], inp["o0"])
    jn, jy = exact_jit(lambda s, *a: j_step(JState(*s), *a))(st, *args)
    tn, ty = t_step(TState(*map(torch.from_numpy, st)),
                    *map(torch.from_numpy, args))
    for want, got in zip((jy, *jn), (ty, *tn)):
        np.testing.assert_allclose(f32(got), f32(want), rtol=F32_RTOL,
                                   atol=F32_RTOL * np.abs(f32(want)).max())


def test_wkv4_scan_matches_jax(rng):
    inp = _inputs(rng)
    jy, jfin = exact_jit(j_scan)(inp["k"], inp["v"], inp["w"], inp["u"])
    ty, tfin = t_scan(*(torch.from_numpy(inp[n]) for n in "kvwu"))
    for want, got in zip((jy, *jfin), (ty, *tfin)):
        np.testing.assert_allclose(f32(got), f32(want), rtol=F32_RTOL,
                                   atol=F32_RTOL * np.abs(f32(want)).max())


@pytest.mark.parametrize("carry", ["bfloat16", None])
def test_wkv4_seq_plain_matches_masked_step_loop(rng, carry):
    """Plain K2 == the JAX step loop with the same mask and carry snap;
    the bf16 snap can turn exp's last-bit differences into one bf16 step,
    hence the port_helpers rule for the bf16 carry, f32 bounds without."""
    inp = _inputs(rng)
    valid = _valid()
    jy, jfin = _jax_masked_loop(inp, valid, carry)
    t = {n: torch.from_numpy(a) for n, a in inp.items()}
    ty, tfin = wkv4_seq(t["k"], t["v"], t["w"], t["u"], t["a0"], t["b0"],
                        t["o0"], valid=torch.from_numpy(valid),
                        carry_dtype=carry)
    for name, want, got in zip("yabo", (jy, *jfin), (ty, *tfin)):
        if carry is None:
            np.testing.assert_allclose(
                f32(got), f32(want), rtol=F32_RTOL,
                atol=F32_RTOL * np.abs(f32(want)).max(), err_msg=name)
        else:
            assert_close(want, got, name)


def test_wkv4_seq_lane_without_valid_token_keeps_state(rng):
    """A lane with no valid position returns its incoming state exactly."""
    inp = _inputs(rng)
    t = {n: torch.from_numpy(a) for n, a in inp.items()}
    _, (a, b, o) = wkv4_seq(t["k"], t["v"], t["w"], t["u"], t["a0"],
                            t["b0"], t["o0"],
                            valid=torch.from_numpy(_valid()),
                            carry_dtype="bfloat16")
    lane = PREFIX.index(0)
    for got, want in ((a, t["a0"]), (b, t["b0"]), (o, t["o0"])):
        assert torch.equal(got[lane], want[lane])


def test_wkv4_seq_rejects_unknown_carry(rng):
    inp = {n: torch.from_numpy(a) for n, a in _inputs(rng).items()}
    with pytest.raises(ValueError):
        wkv4_seq(*(inp[n] for n in ("k", "v", "w", "u", "a0", "b0", "o0")),
                 carry_dtype="float16")
