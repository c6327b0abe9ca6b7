"""Port vs JAX: the dense transformer's serving slice on the smoke configs
of smollm-135m (L2 D64 H4 KVH2, RMSNorm, SwiGLU, tied), phi3-mini (D96
H4, MHA, hd 24) and minitron-4b (D96 H6 KVH2, LayerNorm, squared ReLU) —
the layers, the attention routing, `forward` with its attention through
the K13 wrapper (the plain version on the CPU), the KV-cache `decode_step`
chain, the bridged weights, the registry, the step builders and
`serve_legacy`.

The JAX side compiles with `exact_jit`, whose rounding is the trace's, as
eager torch's is; JAX's K13 runs its Pallas kernel in interpret mode.

Tolerances:
  * layers: the port_helpers rule (max |d| <= 2^-5 max|ref|, mean |d| <=
    2^-8 mean|ref|); attention in f32 within 2e-5 (order only).
  * `forward` at S = 512: the witness recipe of `chip_smoke.py`'s
    TF_BOUNDS.  Every bf16 path sits ~1% (mean) from an f32 witness of the
    same model (JAX's f32 forward on the same weights); the port must sit
    no farther than JAX's own bf16 path does, with a quarter of headroom,
    and nearer to JAX's bf16 logits than JAX's bf16 logits sit to the
    witness.  The port is not held to JAX's flash-vs-plain spread (mean
    5e-4 to 2e-3 of mean|logit| over five seeds): those two JAX paths
    differ only in the attention's summation order, the port in every
    matmul's, and attention over near-uniform weights at 512 keys turns a
    0.1% share of flipped bf16 roundings in k and v into ~11% of flipped
    outputs; the port-vs-JAX gap read up to 5.7e-3 of mean|logit| (against
    the witness's 1.2e-2) over five seeds of each config.
  * `decode_step` chains: the port_helpers rule against JAX's chain, and
    `tests/test_models.py`'s rtol = atol = 0.06 against the port's own
    forward (the bound the JAX package holds its decode to its forward).
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from port_helpers import assert_close, f32, to_port
from repro.configs.base import get_config as j_get_config
from repro.configs.base import smoke_config as j_smoke_config
from repro.kernels.common import exact_jit
from repro.models import layers as JL
from repro.models.registry import Model as JModel
from repro.models.registry import get_model as j_get_model
from repro_torch.configs.base import ModelConfig, get_config, smoke_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.serve import serve_legacy
from repro_torch.launch.steps import build_prefill_step, build_step_for_cell
from repro_torch.models import layers as TL
from repro_torch.models import transformer
from repro_torch.models.registry import get_model as t_get_model
from repro_torch.serving import ServingEngine
from repro_torch.tree import leaves_with_path

ARCHS = ["smollm-135m", "phi3-mini-3.8b", "minitron-4b"]
WITNESS_HEADROOM = 1.25


def _j_model(arch, **over):
    m = j_get_model(arch, smoke=True)
    return JModel(cfg=dataclasses.replace(m.cfg, **over), module=m.module)


def _t_model(arch, **over):
    m = t_get_model(arch, smoke=True)
    return type(m)(cfg=dataclasses.replace(m.cfg, **over), module=m.module)


def _params(arch, seed=0):
    """JAX master params (f32) from a seed, and the port's copy."""
    p = j_get_model(arch, smoke=True).init_params(jax.random.PRNGKey(seed))
    return p, to_port(p)


def _layer0(arch):
    jm = j_get_model(arch, smoke=True)
    cp = jm.cast_params(jm.init_params(jax.random.PRNGKey(0)))
    lp = jax.tree_util.tree_map(lambda a: a[0, 0], cp["blocks"]["dense"])
    return jm.cfg, lp, to_port(lp)


def _x(shape, seed=0, dtype=jnp.bfloat16):
    x = jnp.asarray(np.random.default_rng(seed).normal(size=shape), dtype)
    return x, to_port(x)


# --- configs, tree and registry -------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    fields = ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab", "head_dim", "act", "norm",
              "rope_theta", "tie_embeddings", "use_flash_kernel", "dtype",
              "resolved_head_dim", "remat", "optimizer")
    for j, t in ((j_get_config(arch), get_config(arch)),
                 (j_smoke_config(arch), smoke_config(arch))):
        assert {f: getattr(t, f) for f in fields} == \
            {f: getattr(j, f) for f in fields}


@pytest.mark.parametrize("arch", ARCHS)
def test_bridged_tree_matches_spec(arch):
    """A bridged JAX tree has the port's spec paths and shapes (the
    stacked `blocks.dense` leaves with their (L, 1, ...) axes), bf16 bits
    kept, and the registry sends the dense family to the transformer."""
    tm = t_get_model(arch, smoke=True)
    assert tm.module is transformer and not tm.position_free_decode
    jm = j_get_model(arch, smoke=True)
    jp = jm.cast_params(jm.init_params(jax.random.PRNGKey(0)))
    tp = to_port(jp)
    spec = dict(leaves_with_path(tm.abstract_params()))
    got = dict(leaves_with_path(tp))
    assert spec.keys() == got.keys()
    for path, meta in spec.items():
        assert got[path].shape == meta.shape, path
        assert got[path].dtype == torch.bfloat16, path
    np.testing.assert_array_equal(
        f32(tp["blocks"]["dense"]["attn"]["wq"]),
        np.asarray(jp["blocks"]["dense"]["attn"]["wq"], np.float32))
    L = tm.cfg.n_layers
    assert tp["blocks"]["dense"]["ln1"]["scale"].shape[:2] == (L, 1)
    assert (("head",) in spec) == (not tm.cfg.tie_embeddings)


def test_registry_refusals():
    with pytest.raises(NotImplementedError, match="moe"):
        t_get_model(ModelConfig(name="x", n_layers=1, d_model=8, d_ff=8,
                                vocab=8, family="moe"))
    cfg = dataclasses.replace(smoke_config("smollm-135m"), use_mla=True)
    with pytest.raises(NotImplementedError, match="MLA"):
        t_get_model(cfg).spec()
    # the RWKV forwards serve now (tests/test_torch_rwkv_forward.py); what
    # stays refused is their training (launch/train.py)
    rwkv = t_get_model("rwkv4-169m", smoke=True)
    logits, _ = rwkv.forward(rwkv.init_params(0, device="cpu"),
                             {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    assert logits.shape == (1, 4, rwkv.cfg.vocab)
    # decode_step reads its position: the engine refuses it, as in JAX
    with pytest.raises(ValueError):
        ServingEngine("smollm-135m", smoke=True, device="cpu")


def test_step_for_cell():
    """The (arch, shape) entry: the prefill step with meta arguments at
    the cell's shape, the serve step with a meta KV cache, the train step
    with meta params, optimizer state and batch."""
    step, (params, batch), kind = build_step_for_cell(
        "smollm-135m", "prefill_32k",
        cfg_overrides={"use_flash_kernel": True})
    assert kind == "prefill_step" and callable(step)
    assert batch["tokens"].shape == (32, 32_768)
    assert params["embed"].device.type == "meta"
    assert params["embed"].shape == (49152, 576)
    step, (params, state, tok, pos), kind = build_step_for_cell(
        "smollm-135m", "decode_32k")
    assert kind == "serve_step[base]" and tok.shape == (128, 1)
    assert state["k"].shape == (30, 128, 32_768, 3, 64)
    assert params["embed"].dtype == torch.bfloat16
    step, (params, opt, batch), kind = build_step_for_cell(
        "smollm-135m", "train_4k")
    assert kind == "train_step" and callable(step)
    assert batch["tokens"].shape == (256, 4096)
    assert opt.nu["embed"].device.type == "meta"


# --- layers ----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    arch = "smollm-135m" if kind == "rmsnorm" else "minitron-4b"
    _, lp, tlp = _layer0(arch)
    jx, tx = _x((2, 5, lp["ln1"]["scale"].shape[0]))
    want = exact_jit(lambda p, x: JL.apply_norm(p, x, kind))(lp["ln1"], jx)
    assert_close(want, TL.apply_norm(tlp["ln1"], tx, kind), kind)


@pytest.mark.parametrize("head_dim,theta", [(64, 10_000.0), (128, 1e6)])
def test_rope_freqs(head_dim, theta):
    """The inverse frequencies on the device the caller names, as JAX's."""
    got = TL.rope_freqs(head_dim, theta, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert_close(exact_jit(lambda: JL.rope_freqs(head_dim, theta))(), got)
    with pytest.raises(TypeError):
        TL.rope_freqs(head_dim, theta)


def test_apply_rope():
    jx, tx = _x((2, 40, 3, 16), seed=1)
    pos = np.arange(40) + 7
    want = exact_jit(lambda x, p: JL.apply_rope(x, p, 10_000.0))(
        jx, jnp.asarray(pos))
    assert_close(want, TL.apply_rope(tx, torch.from_numpy(pos), 10_000.0))


@pytest.mark.parametrize("arch,act", [("smollm-135m", "swiglu"),
                                      ("minitron-4b", "relu_sq"),
                                      ("minitron-4b", "gelu")])
def test_apply_mlp(arch, act):
    cfg, lp, tlp = _layer0(arch)
    jcfg = dataclasses.replace(cfg, act=act)
    tcfg = dataclasses.replace(smoke_config(arch), act=act)
    jx, tx = _x((2, 9, cfg.d_model), seed=2)
    want = exact_jit(lambda p, x: JL.apply_mlp(p, x, jcfg))(lp["mlp"], jx)
    assert_close(want, TL.apply_mlp(tlp["mlp"], tx, tcfg), act)


@pytest.mark.parametrize("Sq,Skv,q_offset,threshold", [
    (24, 24, 0, 2048),       # plain, causal prefill
    (1, 40, 17, 2048),       # plain, a decode step against a cache
    (32, 64, 32, 16),        # the online-softmax oracle over key blocks
])
def test_attention_matches_jax(Sq, Skv, q_offset, threshold):
    """The two XLA-form routes of `attention` in f32, GQA 4/2."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in (
        (2, Sq, 4, 16), (2, Skv, 2, 16), (2, Skv, 2, 16)))
    want = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        q_offset=q_offset, flash_threshold=threshold)
    got = TL.attention(*map(torch.from_numpy, (q, k, v)), q_offset=q_offset,
                       flash_threshold=threshold)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


class _Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


@pytest.mark.parametrize("S,flash,want_k13", [(512, True, True),
                                              (256, True, False),
                                              (512, False, False)])
def test_forward_routes_attention(monkeypatch, S, flash, want_k13):
    """`forward` with use_flash_kernel at S >= 512 sends every layer's
    attention through the K13 wrapper and nothing through the XLA forms;
    below 512, or with the flag off, every layer takes the plain score
    matrix (the routing rule of layers.py:175-177)."""
    k13 = _Spy(flash_attention)
    plain = _Spy(TL._plain_attention)
    oracle = _Spy(TL._flash_attention)
    monkeypatch.setattr(TL, "flash_attention", k13)
    monkeypatch.setattr(TL, "_plain_attention", plain)
    monkeypatch.setattr(TL, "_flash_attention", oracle)
    tm = _t_model("smollm-135m", use_flash_kernel=flash)
    params = tm.init_params(0, "cpu")
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, tm.cfg.vocab, (1, S)))
    with torch.inference_mode():
        logits = build_prefill_step(tm)(params, {"tokens": tok})
    L = tm.cfg.n_layers
    assert logits.shape == (1, S, tm.cfg.vocab)
    assert (k13.calls, plain.calls, oracle.calls) == \
        ((L, 0, 0) if want_k13 else (0, L, 0))


# --- forward and decode against JAX ----------------------------------------


def _gap(out, ref):
    d = np.abs(out - ref)
    return float(d.max() / np.abs(ref).max()), \
        float(d.mean() / np.abs(ref).mean())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax_flash(arch):
    """The prefill forward at S = 512 with use_flash_kernel: every layer
    through K13 on both sides, held by the witness recipe (docstring)."""
    jm = _j_model(arch, use_flash_kernel=True)
    j32 = _j_model(arch, dtype="float32")
    params, tp = _params(arch)
    tok = np.random.default_rng(0).integers(0, jm.cfg.vocab, (2, 512))
    jt = jnp.asarray(tok, jnp.int32)
    fwd = lambda m: exact_jit(lambda p, t: m.forward(p, {"tokens": t})[0])
    ref = f32(fwd(jm)(params, jt))
    wit = f32(fwd(j32)(params, jt))
    tm = _t_model(arch, use_flash_kernel=True)
    with torch.inference_mode():
        got = f32(tm.forward(tp, {"tokens": torch.from_numpy(tok)})[0])
    assert got.shape == ref.shape and np.isfinite(got).all()
    jax_max, jax_mean = _gap(ref, wit)
    port_max, port_mean = _gap(got, wit)
    assert port_mean <= WITNESS_HEADROOM * jax_mean, (port_mean, jax_mean)
    assert port_max <= WITNESS_HEADROOM * jax_max, (port_max, jax_max)
    pj_max, pj_mean = _gap(got, ref)
    assert pj_mean <= jax_mean and pj_max <= jax_max, (pj_max, pj_mean)


@pytest.mark.parametrize("arch", ["smollm-135m", "minitron-4b"])
def test_decode_chain_matches_jax_and_forward(arch):
    """16 teacher-forced `decode_step` calls through the KV cache (written
    in place) against JAX's chain, and against the port's own forward."""
    jm, tm = j_get_model(arch, smoke=True), t_get_model(arch, smoke=True)
    params, tp = _params(arch, seed=1)
    B, S = 2, 16
    tok = np.random.default_rng(1).integers(0, jm.cfg.vocab, (B, S))
    jstep = exact_jit(lambda p, s, t, pos: jm.decode_step(p, s, t, pos))
    jst = jm.init_decode_state(B, S)
    tst = tm.init_decode_state(B, S, device="cpu")
    want, got = [], []
    with torch.inference_mode():
        for t in range(S):
            lg, jst = jstep(params, jst, jnp.asarray(tok[:, t:t + 1],
                                                     jnp.int32),
                            jnp.int32(t))
            want.append(f32(lg[:, 0]))
            lg_t, tst = tm.decode_step(tp, tst,
                                       torch.from_numpy(tok[:, t:t + 1]), t)
            got.append(f32(lg_t[:, 0]))
        fwd = f32(tm.forward(tp, {"tokens": torch.from_numpy(tok)})[0])
    want, got = np.stack(want, 1), np.stack(got, 1)
    assert_close(want, got, "decode chain")
    for key in ("k", "v"):
        assert_close(jst[key], tst[key], f"cache {key}")
    np.testing.assert_allclose(fwd, got, rtol=0.06, atol=0.06)


def test_decode_cache_overflow_raises():
    """More tokens than the cache has positions cannot be written (JAX's
    dynamic_update_slice refuses them too); a start past the end is
    clamped (`test_kv_cache_write_clamps_like_jax`)."""
    tm = t_get_model("smollm-135m", smoke=True)
    params = tm.init_params(0, "cpu")
    st = tm.init_decode_state(1, 2, device="cpu")
    tok = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="cache"):
        tm.decode_step(params, st, tok, 0)


def test_kv_cache_write_clamps_like_jax():
    """A cache_pos past the cache's end: JAX's dynamic_update_slice writes
    at Smax - S and the attention keeps q_offset = cache_pos; the port's
    output and both cache tensors equal JAX's (the port_helpers rule)."""
    cfg, lp, tlp = _layer0("smollm-135m")
    B, S, Smax = 2, 3, 8
    pos = Smax - S + 2
    rng = np.random.default_rng(5)
    jx, tx = _x((B, S, cfg.d_model), seed=4)
    shape = (B, Smax, cfg.n_kv_heads, cfg.resolved_head_dim)
    jc = {k: jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
          for k in ("k", "v")}
    tc = {k: to_port(v).clone() for k, v in jc.items()}
    want, wc = exact_jit(lambda p, x, c: JL.apply_attention(
        p, x, cfg, kv_cache=c, cache_pos=pos))(lp["attn"], jx, jc)
    got, gc = TL.apply_attention(tlp["attn"], tx, smoke_config(
        "smollm-135m"), kv_cache=tc, cache_pos=pos)
    assert_close(want, got, "attention past the end")
    for key in ("k", "v"):
        assert_close(wc[key], gc[key], f"cache {key}")
        # rows before Smax - S keep their values; the write lands at the end
        np.testing.assert_array_equal(f32(wc[key])[:, :Smax - S],
                                      f32(jc[key])[:, :Smax - S])


def test_serve_legacy_runs_kv_cache_decode():
    toks = serve_legacy("smollm-135m", smoke=True, batch=3, n_tokens=6,
                        device="cpu")
    assert toks.shape == (3, 7) and toks.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < 256
