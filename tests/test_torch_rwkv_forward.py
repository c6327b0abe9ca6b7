"""Port vs JAX: the RWKV whole-sequence forward on the smoke configs of
rwkv6-7b (L2 D64 H4 N16 F128 V256) and rwkv4-169m (L2 D64 F256 V256) —
the chunked WKV-6 (K10's plain version and the port's `wkv6_chunked`),
the single-pass LayerNorm (K11's plain version), `Model.forward` of both
families (rwkv4 under both numerics), the routing through the kernel
wrappers, the prefill step builders and the refusals.

JAX's K10 (`wkv6_pallas`) does not run under jax >= 0.5 (`pl.load` is
gone), so K10's plain version is held against JAX's `wkv6_scan`,
`wkv6_chunked` and `kernels/ref.py:wkv6_ref`; JAX's K11 runs its Pallas
kernel in interpret mode.  The JAX models compile with `exact_jit`.

Tolerances:
  * WKV-6, f32: y and the final state within WKV_TOL = 2^-12 of their
    magnitude, the same recurrence run on |r|, |k|, |v|, |u|, |s0| (each
    output's sum of absolute terms).  Every chunked exponent is a
    difference of two cumulative sums of log w rounded in f32, so e^(Lprev
    − L) carries a relative error of up to ~C·2^-24·max|L|: with strong
    decays (|L| in the thousands) that reaches 1e-4 against the scan,
    which takes no log (read: at most 5.5e-5).
  * LayerNorm: f32 within 2^-20 of max|ref| (sums in another order); bf16
    within one bf16 step, 2^-7 |ref|, plus 2^-20 max|ref|.
  * forward logits: the port_helpers rule (max |d| <= 2^-5 max|ref|, mean
    |d| <= 2^-8 mean|ref|).  Read: rwkv6 mean 4.1e-4 (S 128, the chunked
    WKV: K10's one-level scheme against JAX's two-level one) and 4.8e-5
    (S 40, the scan); rwkv4 mean 1.1e-7 (exact) and 5.7e-8 (hw).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from port_helpers import assert_bitwise, assert_close, f32, to_port
from repro.core.wkv.wkv6 import wkv6_chunked as j_chunked
from repro.core.wkv.wkv6 import wkv6_scan as j_scan
from repro.kernels.common import exact_jit
from repro.kernels.fused_layernorm import fused_layernorm as j_layernorm
from repro.kernels.ref import fused_layernorm_ref, wkv6_ref
from repro.models.registry import get_model as j_get_model
from repro_torch.core.wkv.wkv6 import wkv6_chunked as t_chunked
from repro_torch.kernels import expsig
from repro_torch.kernels import wkv4 as K2
from repro_torch.kernels import wkv6 as K6_10
from repro_torch.kernels.fused_layernorm import (
    fused_layernorm, fused_layernorm_plain)
from repro_torch.kernels.wkv6 import (
    chunk_length, wkv6_chunked_kernel, wkv6_chunked_plain)
from repro_torch.launch.steps import build_prefill_step, build_step_for_cell
from repro_torch.launch.train import train
from repro_torch.models import layers as TL
from repro_torch.models import rwkv4 as t_rwkv4
from repro_torch.models import rwkv6 as t_rwkv6
from repro_torch.models.registry import get_model as t_get_model

WKV_TOL = 2.0 ** -12
ARCHS = ("rwkv4-169m", "rwkv6-7b")


# --- the chunked WKV-6 -----------------------------------------------------

# (B, T, H, N, s0, decay shift): a chunk's worth and more, with and without
# s0, ragged T (96: the chunk halves to 32), strong decay (log w ~ -20,
# down to the 1e-38 clamp)
WKV_CASES = {
    "T128": (2, 128, 2, 16, False, 0.0),
    "T128-s0": (2, 128, 2, 16, True, 0.0),
    "T96-ragged": (2, 96, 2, 16, True, 0.0),
    "T256-N32": (1, 256, 2, 32, True, 0.5),
    "strong-decay": (1, 64, 2, 16, True, 3.0),
}


def _wkv_inputs(B, T, H, N, shift, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(r=f(B, T, H, N), k=f(B, T, H, N), v=f(B, T, H, N),
                w=np.exp(-np.exp(0.5 * f(B, T, H, N) + shift)).astype(
                    np.float32),
                u=(0.5 * f(H, N)).astype(np.float32), s0=f(B, H, N, N))


def _within_magnitude(got, want, mag, what):
    d = np.abs(f32(got) - f32(want))
    assert np.isfinite(f32(got)).all(), what
    assert (d <= WKV_TOL * f32(mag)).all(), (what, float(d.max()))


@pytest.mark.parametrize("case", sorted(WKV_CASES))
def test_wkv6_chunked_against_jax(case):
    """K10's plain version (one-level) and the port's `wkv6_chunked`
    (JAX's two-level form) against JAX's scan, `wkv6_ref` and
    `wkv6_chunked`: y and the final state.  Under strong decay JAX's
    chunked form is left out: its clamp 1e-38 is subnormal, XLA on the
    CPU flushes it to 0 and log gives -inf, then NaN (ROADMAP, "Reference
    status"); the port keeps subnormals, as the card does."""
    B, T, H, N, with_s0, shift = WKV_CASES[case]
    d = _wkv_inputs(B, T, H, N, shift)
    s0 = d["s0"] if with_s0 else None
    args = [d[k] for k in ("r", "k", "v", "w", "u")]
    C = chunk_length(T)
    refs = {"scan": exact_jit(j_scan)(*args, s0),
            "ref": exact_jit(wkv6_ref)(*args, s0)}
    if case != "strong-decay":
        refs["chunked"] = exact_jit(
            lambda *a: j_chunked(*a, chunk=C))(*args, s0)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    ts0 = t["s0"] if with_s0 else None
    targs = [t[k] for k in ("r", "k", "v", "w", "u")]
    mag = wkv6_chunked_plain(*(x.abs() if i != 3 else x
                               for i, x in enumerate(targs)),
                             None if ts0 is None else ts0.abs())
    outs = {"K10 plain": wkv6_chunked_plain(*targs, ts0),
            "wkv6_chunked": t_chunked(*targs, ts0, chunk=C)}
    for name, (y, S) in outs.items():
        assert y.dtype == torch.float32 and S.dtype == torch.float32
        for rname, (ry, rS) in refs.items():
            _within_magnitude(y, ry, mag[0], f"{case} {name} y vs {rname}")
            _within_magnitude(S, rS, mag[1], f"{case} {name} S vs {rname}")


def test_wkv6_chunked_bf16_operands():
    """The model hands K10 bf16 r, k, v and an f32 w: the plain version
    widens them exactly, so the result equals the f32 call on the widened
    values bit for bit, and JAX's chunked form on the bf16 operands within
    WKV_TOL."""
    d = _wkv_inputs(2, 128, 2, 16, 0.0, seed=3)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    bf = {k: t[k].to(torch.bfloat16) for k in ("r", "k", "v")}
    y, S = wkv6_chunked_plain(bf["r"], bf["k"], bf["v"], t["w"], t["u"])
    y32, S32 = wkv6_chunked_plain(*(bf[k].float() for k in "rkv"), t["w"],
                                  t["u"])
    assert torch.equal(y, y32) and torch.equal(S, S32)
    jy, jS = exact_jit(lambda *a: j_chunked(*a))(
        *(jnp.asarray(d[k], jnp.bfloat16) for k in "rkv"), d["w"], d["u"])
    mag = wkv6_chunked_plain(*(bf[k].float().abs() for k in "rkv"), t["w"],
                             t["u"].abs())
    # JAX casts its y to r's dtype: hold the port's f32 y rounded likewise
    _within_magnitude(S, jS, mag[1], "S")
    assert_close(jy, y.to(torch.bfloat16), "y (bf16)")


@pytest.mark.parametrize("T,chunk,C", [(128, 64, 64), (96, 64, 32),
                                       (40, 64, 40), (100, 64, 4),
                                       (16, 64, 16)])
def test_chunk_length(T, chunk, C):
    """JAX's wrapper rule: min(chunk, T), halved until it divides T."""
    assert chunk_length(T, chunk) == C


def test_wkv6_chunked_kernel_on_cpu_is_the_plain_version():
    d = _wkv_inputs(1, 96, 2, 16, 0.0, seed=4)
    t = [torch.from_numpy(d[k]) for k in ("r", "k", "v", "w", "u", "s0")]
    before = wkv6_chunked_kernel.launches
    y, S = wkv6_chunked_kernel(*t)
    y_p, S_p = wkv6_chunked_plain(*t)
    assert torch.equal(y, y_p) and torch.equal(S, S_p)
    assert wkv6_chunked_kernel.launches == before


# --- the single-pass LayerNorm ----------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_layernorm_against_jax(dtype):
    """K11's plain version against JAX's fused_layernorm (its Pallas kernel
    in interpret mode) and `fused_layernorm_ref`, rows ragged against the
    kernel's block; on the CPU the wrapper is the plain version and equals
    `apply_norm`'s layernorm bit for bit."""
    rng = np.random.default_rng(1)
    jdt = jnp.dtype(dtype)
    x = jnp.asarray(rng.normal(size=(3, 37, 96)) * 2 + 0.5, jdt)
    g = jnp.asarray(rng.normal(size=96), jdt)
    b = jnp.asarray(rng.normal(size=96), jdt)
    tx, tg, tb = to_port(x), to_port(g), to_port(b)
    got = fused_layernorm_plain(tx, tg, tb)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    for want in (j_layernorm(x, g, b, interpret=True),
                 exact_jit(fused_layernorm_ref)(x, g, b)):
        r, o = f32(want), f32(got)
        floor = 2.0 ** -20 * np.abs(r).max()
        rel = 2.0 ** -7 if dtype == "bfloat16" else 0.0
        assert (np.abs(o - r) <= rel * np.abs(r) + floor).all(), \
            float(np.abs(o - r).max())
    before = fused_layernorm.launches
    assert torch.equal(fused_layernorm(tx, tg, tb), got)
    assert torch.equal(TL.apply_norm({"scale": tg, "bias": tb}, tx), got)
    assert fused_layernorm.launches == before


# --- the forwards against JAX ------------------------------------------------


def _models(arch):
    jm, tm = j_get_model(arch, smoke=True), t_get_model(arch, smoke=True)
    return jm, tm, jm.init_params(jax.random.PRNGKey(0))


def _tokens(vocab, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _jax_forward(jm, params, toks, **kw):
    return exact_jit(lambda p, t: jm.module.forward(
        jm.cast_params(p), {"tokens": t}, jm.cfg, **kw)[0])(
        params, jnp.asarray(toks))


@pytest.mark.parametrize("S", [128, 40])
def test_rwkv6_forward_against_jax(S):
    """`Model.forward` on the bridged tree against JAX's `rwkv6.forward`:
    S = 128 takes the chunked WKV (K10's plain version; JAX's two-level
    `wkv6_chunked`), S = 40 the exact scan (K6's plain version; JAX's
    `wkv6_scan`)."""
    jm, tm, params = _models("rwkv6-7b")
    toks = _tokens(jm.cfg.vocab, 2, S)
    want = _jax_forward(jm, params, toks)
    logits, aux = tm.forward(to_port(params),
                             {"tokens": torch.from_numpy(toks)})
    assert logits.dtype == torch.bfloat16 and float(aux) == 0.0
    assert_close(want, logits, f"rwkv6 S={S}")


@pytest.mark.parametrize("hw", [False, True])
def test_rwkv4_forward_against_jax(hw):
    """rwkv4's `forward` under both numerics against JAX's: the WKV over
    the sequence through K2's plain version (its LUT form under hw), σ
    under hw through K9's, A9 over the whole (B, S, ·) tensor."""
    jm, tm, params = _models("rwkv4-169m")
    toks = _tokens(jm.cfg.vocab, 2, 48, seed=2)
    want = _jax_forward(jm, params, toks, hw=hw)
    logits, _ = tm.forward(to_port(params),
                           {"tokens": torch.from_numpy(toks)}, hw=hw)
    assert_close(want, logits, f"rwkv4 hw={hw}")


def test_cast_params_matches_jax():
    """The bf16 cast of the leaves the RWKV-6 forward reads outside a
    matmul (time_faaaa, the ddlerp and decay low-rank leaves, time_maa*)
    equals JAX's `cast_params` bit for bit."""
    jm, tm, params = _models("rwkv6-7b")
    want = jm.cast_params(params)["blocks"]["att"]
    got = tm.cast_params(to_port(params))["blocks"]["att"]
    for key in ("time_faaaa", "td_w1", "td_w2", "maa_w1", "maa_w2",
                "time_maa", "time_maa_x", "time_decay"):
        assert got[key].dtype == torch.bfloat16, key
        assert_bitwise(want[key], got[key], key)


# --- routing through the kernel wrappers -------------------------------------


class _Spy:
    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        fn = getattr(module, name)

        def spy(*a, **kw):
            self.calls += 1
            return fn(*a, **kw)
        monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("arch,S,hw", [("rwkv6-7b", 128, False),
                                       ("rwkv6-7b", 40, False),
                                       ("rwkv4-169m", 16, False),
                                       ("rwkv4-169m", 16, True)])
def test_forward_routes_through_kernels(monkeypatch, arch, S, hw):
    """The forwards call the kernel wrappers — K10 (S % 64 == 0, S > 64)
    or K6 for rwkv6, K2 for rwkv4, K9's σ under hw, K11 for every
    LayerNorm (2L + 2) — and never `apply_norm`'s layernorm branch."""
    mod = t_rwkv6 if arch == "rwkv6-7b" else t_rwkv4
    names = ({"wkv6_chunked_kernel": "k10", "wkv6_seq": "k6"}
             if mod is t_rwkv6 else {"wkv4_seq": "k2"})
    spies = {v: _Spy(monkeypatch, mod, k) for k, v in names.items()}
    # both families' LayerNorms go through `layers.layernorm_kernel`
    spies["ln"] = _Spy(monkeypatch, TL, "fused_layernorm")
    sig = _Spy(monkeypatch, t_rwkv4, "sigmoid_kernel")
    norms = _Spy(monkeypatch, TL, "apply_norm")
    tm = t_get_model(arch, smoke=True)
    params = tm.init_params(0, device="cpu")
    kw = {"hw": True} if hw else {}
    logits, _ = tm.forward(params, {"tokens": torch.from_numpy(
        _tokens(tm.cfg.vocab, 2, S))}, **kw)
    L = tm.cfg.n_layers
    assert logits.shape == (2, S, tm.cfg.vocab) and norms.calls == 0
    got = {k: s.calls for k, s in spies.items()}
    if mod is t_rwkv6:
        want = {"ln": 2 * L + 2, "k10": L if S == 128 else 0,
                "k6": 0 if S == 128 else L}
    else:
        want = {"ln": 2 * L + 2, "k2": L}
    assert got == want
    assert sig.calls == (2 * L if hw else 0)


# --- step builders, the launcher and the refusals ----------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_for_cell(arch):
    """build_step_for_cell(arch, "prefill_32k") gives the prefill step and
    meta arguments at the cell's shape (B 32, S 32768); the step built
    from the smoke model returns Model.forward's logits bit for bit (rwkv4
    also under hw)."""
    step, (params, batch), kind = build_step_for_cell(arch, "prefill_32k",
                                                      smoke=True)
    tm = t_get_model(arch, smoke=True)
    assert kind == "prefill_step" and callable(step)
    assert batch["tokens"].shape == (32, 32_768)
    assert batch["tokens"].device.type == "meta"
    assert params["embed"].device.type == "meta"
    assert params["embed"].shape == (tm.cfg.vocab, tm.cfg.d_model)
    assert params["blocks"]["ffn"]["wk"].shape == (
        tm.cfg.n_layers, tm.cfg.d_model, tm.cfg.d_ff)
    real = tm.init_params(1, device="cpu")
    toks = {"tokens": torch.from_numpy(_tokens(tm.cfg.vocab, 2, 24))}
    assert torch.equal(build_prefill_step(tm)(real, toks),
                       tm.forward(real, toks)[0])
    if arch == "rwkv4-169m":
        hw_step, _, _ = build_step_for_cell(arch, "prefill_32k", smoke=True,
                                            hw=True)
        assert torch.equal(hw_step(real, toks),
                           tm.forward(real, toks, hw=True)[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_refuses_rwkv(arch):
    """The launcher trains both RWKV archs on the CPU; what stays refused
    on the card is a gradient K10-bwd and K6-bwd do not cover: K10 or K6
    from an initial state that requires grad, K6 with a valid mask
    (meta tensors stand in for the card: the refusal comes before
    anything is built).  The forward's own calls go on to the kernels
    (the build raises here), as rwkv4's K2 goes to K2-bwd."""
    out = train(arch, steps=1, global_batch=1, seq_len=8, device="cpu")
    assert np.isfinite(out["losses"]).all()
    meta = lambda *s: torch.empty(s, device="meta")
    g = meta(2, 32).requires_grad_()
    rkvw = [meta(1, 128, 2, 32) for _ in range(4)]
    s0g = meta(1, 2, 32, 32).requires_grad_()
    wkv = K6_10.wkv6_chunked_kernel if arch == "rwkv6-7b" else \
        K6_10.wkv6_seq
    with pytest.raises(NotImplementedError,
                       match="initial state that takes no gradient"):
        if arch == "rwkv6-7b":
            wkv(*rkvw, g, s0g)
        else:
            wkv(*rkvw, g, meta(1, 2, 32, 32), valid=meta(1, 128))
    with pytest.raises(RuntimeError):
        wkv(*rkvw, g, *(() if arch == "rwkv6-7b"
                        else (meta(1, 2, 32, 32),)))


def test_plain_versions_stay_differentiable():
    """On the CPU the forward runs the plain versions, which carry
    gradients: the loss of the rwkv4 smoke forward reaches every leaf."""
    tm = t_get_model("rwkv4-169m", smoke=True)
    params = tm.init_params(0, device="cpu")
    leaves = [params["ln0"]["scale"], params["blocks"]["att"]["time_decay"],
              params["blocks"]["ln1"]["bias"], params["head"]]
    for t in leaves:
        t.requires_grad_()
    logits, _ = tm.forward(params, {"tokens": torch.from_numpy(
        _tokens(tm.cfg.vocab, 1, 16))})
    logits.float().square().mean().backward()
    for t in leaves:
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
        assert float(t.grad.abs().max()) > 0


def test_new_wrappers_raise_off_cpu():
    """K10 and K11 on tensors that are not on the CPU go to their kernels
    or raise (meta tensors stand in for a device: without nvcc the build
    raises); under grad with an operand that requires it, K10 and K6 from
    an initial state that requires grad, K9 and K2 with the LUT tables
    raise NotImplementedError naming what their gradient needs before
    anything is built, and never take the plain versions, while K11's,
    K2's, K10's and K6's own calls go on to their kernels and backward
    kernels (the build raises)."""
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,
                                                    device="meta")
    counters = (wkv6_chunked_kernel, fused_layernorm)
    before = [c.launches for c in counters]
    rkvw = lambda: [meta(1, 128, 2, 16) for _ in range(4)]
    with pytest.raises((RuntimeError, NotImplementedError)):
        wkv6_chunked_kernel(*rkvw(), meta(2, 16))
    with pytest.raises((RuntimeError, NotImplementedError)):
        fused_layernorm(meta(4, 64, dt=torch.bfloat16), meta(64), meta(64))
    assert [c.launches for c in counters] == before
    g = meta(64).requires_grad_()
    k2 = lambda **kw: K2.wkv4_seq(meta(1, 8, 64), meta(1, 8, 64), g,
                                  meta(64), meta(1, 64), meta(1, 64),
                                  meta(1, 64), **kw)
    s0g = meta(1, 2, 16, 16).requires_grad_()
    own = "initial state that takes no gradient"
    calls = (
        (lambda: wkv6_chunked_kernel(*rkvw(), g.view(4, 16)[:2], s0g), own),
        (lambda: K6_10.wkv6_seq(*rkvw(), g.view(4, 16)[:2], s0g), own),
        (lambda: k2(exp_table=meta(256), div_table=meta(256)),
         "hardware numerics"),
        (lambda: expsig.sigmoid_kernel(g), "hardware numerics"))
    for call, why in calls:
        with pytest.raises(NotImplementedError, match=why):
            call()
    for call in (k2, lambda: fused_layernorm(meta(4, 64), g, meta(64)),
                 lambda: wkv6_chunked_kernel(*rkvw(), g.view(4, 16)[:2]),
                 lambda: K6_10.wkv6_seq(*rkvw(), g.view(4, 16)[:2],
                                        meta(1, 2, 16, 16))):
        with pytest.raises(RuntimeError):
            call()
    with torch.no_grad():   # without grad mode they go on to the build
        with pytest.raises(RuntimeError):
            fused_layernorm(meta(4, 64), g, meta(64))
    assert [c.launches for c in counters] == before
