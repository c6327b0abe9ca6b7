"""Port vs JAX: the RWKV-6 WKV backward — K10-bwd's and K6-bwd's plain
versions (`wkv6_chunked_bwd`, `wkv6_seq_bwd` on CPU tensors) and the two
autograd Functions that run K10 and K6 with them (`_WKV6Chunked`,
`_WKV6Seq`), against `jax.vjp` of JAX's `wkv6_chunked` and `wkv6_scan`
(f32, pure jnp).  B 2, H 2, N 16 and 32, T 40 and 128, chunks of 16 and
64, k at 1x and 8x scale, a seeded N(0, 1) output gradient, every input
from a numpy seed.

Tolerance (the rwkv6 chunked rule of `tests/test_torch_rwkv_train.py`):
each output (dr, dk, dv, dw, du) within 2^-12 of its max magnitude and
2^-14 of its mean (max |d| <= 2^-12 max|ref|, mean |d| <= 2^-14
mean|ref|).  Both sides compute in f32, in other orders and by other
schemes: JAX's two-level chunked form or its scan under XLA's autodiff
against the port's one-level chunks (whose dw walks each chunk's
running state forward) or its windowed reverse walk; every chunked
exponent is a difference of cumulative sums of log w rounded in f32
(`tests/test_torch_rwkv_forward.py` says how far that moves).

JAX's `wkv6_chunked` takes its dw through XLA's autodiff of the log
cumsum: dℓ / w, with dℓ the difference of two reverse cumulative sums
that cancel where w is small, so its dw reads up to 1e8 relative off
`wkv6_scan`'s on these inputs (w = exp(-exp(x)), x ~ N(0, 1), reaches
1e-27).  The chunked cases hold dr, dk, dv and du to JAX's
`wkv6_chunked` and dw to `wkv6_scan`, which takes no log.

The strong-decay case draws w down to the clamp, 1e-38: JAX's
`wkv6_chunked` gives NaN there (XLA flushes the subnormal clamp to zero,
ROADMAP "Reference status"), so the port's chunked backward is held to
`wkv6_scan`'s, which takes no log, under the same tolerance.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core.wkv.wkv6 import wkv6_chunked as j_chunked
from repro.core.wkv.wkv6 import wkv6_scan as j_scan
from repro_torch.kernels import wkv6 as K

MAX_REL, MEAN_REL = 2.0 ** -12, 2.0 ** -14
NAMES = ("dr", "dk", "dv", "dw", "du")
B, H = 2, 2


class _Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


def _inputs(T, N, k_scale, seed, strong=False):
    """r, k, v, w (B, T, H, N), u (H, N), dy (B, T, H, N), f32 numpy: w =
    exp(-exp(x)), x ~ N(0, 1), or under `strong` w = exp(-87 z³), z ~ U(0,
    1), which reaches 1.6e-38, just above the clamp."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    r, k, v = n(B, T, H, N), k_scale * n(B, T, H, N), n(B, T, H, N)
    if strong:
        w = np.exp(-87.0 * rng.random((B, T, H, N)) ** 3)
    else:
        w = np.exp(-np.exp(n(B, T, H, N)))
    w = np.maximum(w.astype(np.float32), np.float32(1.1e-38))
    return r, k, v, w, n(H, N), n(B, T, H, N)


def _jax_grads(fn, r, k, v, w, u, dy):
    _, vjp = jax.vjp(lambda *a: fn(*a)[0], *map(jnp.asarray,
                                                (r, k, v, w, u)))
    return [np.asarray(g) for g in vjp(jnp.asarray(dy))]


def _chunked_refs(chunk, r, k, v, w, u, dy):
    """dr, dk, dv and du from `jax.vjp` of `wkv6_chunked`, dw from that of
    `wkv6_scan` (the module docstring says why)."""
    ref = _jax_grads(lambda *a: j_chunked(*a, chunk=chunk), r, k, v, w, u,
                     dy)
    ref[3] = _jax_grads(j_scan, r, k, v, w, u, dy)[3]
    return ref


def _check(got, ref):
    for name, a, b in zip(NAMES, got, ref):
        a = a.detach().float().numpy()
        d = np.abs(a - b)
        mx = float(d.max() / np.abs(b).max())
        mean = float(d.mean() / np.abs(b).mean())
        assert np.isfinite(a).all(), name
        assert mx <= MAX_REL and mean <= MEAN_REL, (name, mx, mean)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("k_scale", [1.0, 8.0])
@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("N", [16, 32])
def test_chunked_bwd_plain_matches_jax_vjp(N, chunk, k_scale):
    """K10-bwd's plain version against `jax.vjp` of JAX's `wkv6_chunked`
    at T 128 (several chunks, so the state gradients chain), from the
    zero state, within the module's tolerance."""
    r, k, v, w, u, dy = _inputs(128, N, k_scale, N + chunk + int(k_scale))
    _check(K.wkv6_chunked_bwd(*_t(r, k, v, w, u, dy), chunk=chunk),
           _chunked_refs(chunk, r, k, v, w, u, dy))


@pytest.mark.parametrize("k_scale", [1.0, 8.0])
@pytest.mark.parametrize("T", [40, 128])
@pytest.mark.parametrize("N", [16, 32])
def test_seq_bwd_plain_matches_jax_vjp(N, T, k_scale):
    """K6-bwd's plain version (windows of K6_BWD_WINDOW steps) against
    `jax.vjp` of JAX's `wkv6_scan` from the zero state, within the module's
    tolerance."""
    r, k, v, w, u, dy = _inputs(T, N, k_scale, N + T + int(k_scale))
    ref = _jax_grads(j_scan, r, k, v, w, u, dy)
    s0 = torch.zeros((B, H, N, N))
    _check(K.wkv6_seq_bwd(*_t(r, k, v, w, u), s0, torch.from_numpy(dy)),
           ref)


@pytest.mark.parametrize("window", [1, 7, 200])
def test_seq_bwd_plain_window_moves_no_bit(window):
    """The recomputed windows repeat the forward's state updates, so the
    window moves no bit of any output (T 40: windows of 1, 7 and one
    window of the whole run, against the default 32)."""
    r, k, v, w, u, dy = _t(*_inputs(40, 16, 1.0, 5))
    s0 = torch.zeros((B, H, 16, 16))
    ref = K.wkv6_seq_bwd_plain(r, k, v, w, u, s0, dy)
    got = K.wkv6_seq_bwd_plain(r, k, v, w, u, s0, dy, window=window)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("chunk", [16, 64])
def test_chunked_bwd_strong_decay_matches_scan(chunk):
    """Strong decay, w down to 1.6e-38 and k at 8x: K10-bwd's plain
    version against `jax.vjp` of `wkv6_scan` (JAX's `wkv6_chunked` gives
    NaN there), within the module's tolerance; dw stays finite and close
    because the plain version takes it from each chunk's running state
    with w's own factor divided out, not as dℓ / w."""
    r, k, v, w, u, dy = _inputs(128, 16, 8.0, 11, strong=True)
    assert float(w.min()) < 1e-37
    ref = _jax_grads(j_scan, r, k, v, w, u, dy)
    _check(K.wkv6_chunked_bwd(*_t(r, k, v, w, u, dy), chunk=chunk), ref)


def test_seq_bwd_strong_decay_matches_scan():
    """The same strong-decay inputs through K6-bwd's plain version against
    `wkv6_scan`'s autodiff (T 40)."""
    r, k, v, w, u, dy = _inputs(40, 16, 8.0, 12, strong=True)
    ref = _jax_grads(j_scan, r, k, v, w, u, dy)
    s0 = torch.zeros((B, H, 16, 16))
    _check(K.wkv6_seq_bwd(*_t(r, k, v, w, u), s0, torch.from_numpy(dy)),
           ref)


def test_below_the_clamp_takes_no_gradient():
    """w below 1e-38 passes no gradient to w, as torch's clamp gives it:
    K10-bwd's plain version matches autograd of K10's plain forward there
    (zeros), and the other outputs stay finite."""
    r, k, v, w, u, dy = _t(*_inputs(64, 16, 1.0, 13))
    w[:, 5] = 0.0
    w[:, 9] = 1e-39
    ins = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    y, _ = K.wkv6_chunked_plain(*ins, chunk=16)
    ref = torch.autograd.grad(y, ins, dy)
    got = K.wkv6_chunked_bwd(r, k, v, w, u, dy, chunk=16)
    assert bool((got[3][:, 5] == 0).all()) and bool((got[3][:, 9] == 0).all())
    assert bool((ref[3][:, 5] == 0).all())
    assert all(bool(torch.isfinite(g).all()) for g in got)


@pytest.mark.parametrize("k_scale", [1.0, 8.0])
def test_chunked_function_matches_jax_autodiff(monkeypatch, k_scale):
    """`_WKV6Chunked` on CPU tensors (its forward K10's plain version, its
    backward `wkv6_chunked_bwd`, whose plain version holds K10-bwd's
    passes) against JAX's autodiff of `wkv6_chunked` (dw: `wkv6_scan`'s;
    T 128, chunk 64):
    y bit for bit with the plain forward, the gradients within the
    module's tolerance, the backward called once."""
    r, k, v, w, u, dy = _inputs(128, 16, k_scale, 21 + int(k_scale))
    ref = _chunked_refs(64, r, k, v, w, u, dy)
    spy = _Spy(K.wkv6_chunked_bwd)
    monkeypatch.setattr(K, "wkv6_chunked_bwd", spy)
    ins = [t.requires_grad_() for t in _t(r, k, v, w, u)]
    y, sf = K._WKV6Chunked.apply(*ins, None, 64)
    got = torch.autograd.grad(y, ins, torch.from_numpy(dy))
    assert spy.calls == 1 and not sf.requires_grad
    with torch.no_grad():
        assert torch.equal(y, K.wkv6_chunked_plain(*ins, chunk=64)[0])
    _check(got, ref)


def test_chunked_function_bf16_rounds_once():
    """On bf16 r, k, v the Function returns bf16 dr, dk, dv, each K10-bwd's
    f32 value rounded once, as autograd of a `.to(f32)` rounds it: within
    one bf16 step (at most 2^-7 relative) plus 2^-12 of the max (f32 sums
    in other orders) of autograd of the port's `wkv6_scan` on the same
    bf16 inputs; dw and du, f32, within the module's tolerance of it.
    (Autograd of K10's plain forward is no reference for dw: its dℓ / w
    cancels, as JAX's does, and reads 1e14 here.)"""
    from repro_torch.core.wkv.wkv6 import wkv6_scan
    r, k, v, w, u, dy = _t(*_inputs(64, 16, 1.0, 22))
    r, k, v = (t.to(torch.bfloat16) for t in (r, k, v))
    ins = [t.requires_grad_() for t in (r, k, v, w, u)]
    y, _ = K._WKV6Chunked.apply(*ins, None, 16)
    got = torch.autograd.grad(y, ins, dy)
    ref_ins = [t.detach().clone().requires_grad_() for t in ins]
    y_ref, _ = wkv6_scan(*(t.float() for t in ref_ins))
    ref = torch.autograd.grad(y_ref, ref_ins, dy)
    for name, a, b in zip(NAMES[:3], got, ref):
        assert a.dtype == b.dtype == torch.bfloat16, name
        d = (a.float() - b.float()).abs()
        lim = 2.0 ** -7 * b.float().abs() + 2.0 ** -12 * b.float().abs().max()
        assert bool((d <= lim).all()), (name, float(d.max()))
    for name, a, b in zip(NAMES[3:], got[3:], ref[3:]):
        d = (a - b).abs()
        assert float(d.max()) <= MAX_REL * float(b.abs().max()), name
        assert float(d.mean()) <= MEAN_REL * float(b.abs().mean()), name


@pytest.mark.parametrize("k_scale", [1.0, 8.0])
def test_seq_function_matches_jax_autodiff(monkeypatch, k_scale):
    """`_WKV6Seq` on CPU tensors (its forward K6's plain version, its
    backward `wkv6_seq_bwd`) against JAX's autodiff of `wkv6_scan` from
    the zero state (T 40): y bit for bit with the plain forward, the
    gradients within the module's tolerance, the backward called once and
    the zero state given no gradient."""
    r, k, v, w, u, dy = _inputs(40, 32, k_scale, 23 + int(k_scale))
    ref = _jax_grads(j_scan, r, k, v, w, u, dy)
    spy = _Spy(K.wkv6_seq_bwd)
    monkeypatch.setattr(K, "wkv6_seq_bwd", spy)
    ins = [t.requires_grad_() for t in _t(r, k, v, w, u)]
    s0 = torch.zeros((B, H, 32, 32))
    y, sf = K._WKV6Seq.apply(*ins, s0)
    got = torch.autograd.grad(y, ins, torch.from_numpy(dy))
    assert spy.calls == 1 and not sf.requires_grad
    with torch.no_grad():
        assert torch.equal(y, K.wkv6_seq_plain(*ins, s0)[0])
    _check(got, ref)
