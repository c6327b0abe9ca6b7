"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test asks for the `cuda` fixture, which skips when
there is no GPU (decided at run time, never at import).  Run them on a
machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.

Tolerances: K5 and K2 outputs may move by one bf16 step against the plain
version (both accumulate in f32 in another order, then round to bf16 or
snap a bf16 carry): |d| <= 2^-7 |ref| + 2^-20 max|ref|.  K3 chains bf16
roundings, so a flip can travel a few steps: max|d| <= 2^-6 max|ref| and
mean|d| <= 2^-11 mean|ref|.  Batch invariance is bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.quant.delta_pot import (
    FORMAT_W8, dpot_pack_int8, dpot_quantize)
from repro_torch.core.quant.serving import (
    broadcast_packed_scales, pack_params, unpack_leaf)
from repro_torch.kernels.fused_decode import (
    rwkv4_block_decode, rwkv4_block_decode_plain)
from repro_torch.kernels.fused_prefill import (
    dpot_w8_matmul, dpot_w8_matmul_plain)
from repro_torch.kernels.wkv4 import wkv4_seq, wkv4_seq_plain
from repro_torch.models.registry import get_model
from repro_torch.models.rwkv4 import STATE_KEYS, _layer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _elementwise(out, ref):
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    assert bool((d <= 2.0 ** -7 * r + 2.0 ** -20 * r.max()).all()), \
        float(d.max())


def _spread(out, ref):
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    assert float(d.max()) <= 2.0 ** -6 * float(r.max())
    assert float(d.mean()) <= 2.0 ** -11 * float(r.mean())


@pytest.mark.parametrize("M", [1, 8, 37, 128])
def test_dpot_w8_matmul(cuda, M):
    g = torch.Generator(device=cuda).manual_seed(M)
    K, N = 96, 203                        # ragged N edge
    q = dpot_quantize(torch.randn((K, N), generator=g, device=cuda),
                      FORMAT_W8, axis=-1)
    wq, scale = dpot_pack_int8(q), q.scale.reshape(-1)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    before = dpot_w8_matmul.launches
    out = dpot_w8_matmul(x, wq, scale)
    torch.cuda.synchronize()
    assert dpot_w8_matmul.launches == before + 1
    _elementwise(out, dpot_w8_matmul_plain(x, wq, scale))
    eye = torch.eye(K, dtype=torch.bfloat16, device=cuda)
    assert torch.equal(dpot_w8_matmul(eye, wq, scale),
                       unpack_leaf({"packed": wq, "scale": scale[None]}))
    # batch invariance: a row's result does not depend on the other rows
    assert torch.equal(dpot_w8_matmul(x[:1], wq, scale), out[:1])


@pytest.mark.parametrize("carry", ["bfloat16", None])
def test_wkv4_seq(cuda, carry):
    g = torch.Generator(device=cuda).manual_seed(2)
    B, T, C = 4, 9, 160
    rn = lambda *s: torch.randn(s, generator=g, device=cuda)
    bf = lambda t: t.to(torch.bfloat16).float()
    args = (rn(B, T, C), rn(B, T, C), torch.exp(0.5 * rn(C)), 0.5 * rn(C),
            bf(rn(B, C)), bf(rn(B, C).abs() + 0.5), bf(rn(B, C) - 1))
    valid = torch.zeros((B, T), dtype=torch.bool, device=cuda)
    for i, n in enumerate((T, 3, 0, 1)):
        valid[i, :n] = True
    y, fin = wkv4_seq(*args, valid=valid, carry_dtype=carry)
    y_p, fin_p = wkv4_seq_plain(*args, valid=valid, carry_dtype=carry)
    for o, r in zip((y, *fin), (y_p, *fin_p)):
        _elementwise(o, r)
    for o, a0 in zip(fin, args[4:]):      # the empty lane keeps its state
        assert torch.equal(o[2], a0[2])


def _layer0(cuda):
    model = get_model("rwkv4-169m", smoke=True)
    params = model.cast_params(pack_params(model.init_params(0, cuda)))
    blocks = broadcast_packed_scales(params["blocks"], model.cfg.n_layers)
    return model, _layer(blocks, 0)


@pytest.mark.parametrize("bb", [1, 2, 4])
def test_rwkv4_block_decode(cuda, bb):
    model, lp = _layer0(cuda)
    B, D = 4, model.cfg.d_model
    g = torch.Generator(device=cuda).manual_seed(3)
    rn = lambda: torch.randn((B, D), generator=g, device=cuda)
    st = {k: rn().to(torch.bfloat16) for k in STATE_KEYS}
    st["wkv_b"] = (st["wkv_b"].float().abs() + 0.5).to(torch.bfloat16)
    x = rn().to(torch.bfloat16)
    x2, new = rwkv4_block_decode(lp, st, x, bb=bb)
    x2_p, new_p = rwkv4_block_decode_plain(lp, st, x)
    _spread(x2, x2_p)
    for k in STATE_KEYS:
        _spread(new[k], new_p[k])
    # batch invariance: any tile size, and a lane alone, bit for bit
    x2_full, new_full = rwkv4_block_decode(lp, st, x, bb=B)
    assert torch.equal(x2, x2_full)
    one, one_st = rwkv4_block_decode(
        lp, {k: v[1:2] for k, v in st.items()}, x[1:2], bb=1)
    assert torch.equal(one[0], x2_full[1])
    assert all(torch.equal(one_st[k][0], new_full[k][1]) for k in STATE_KEYS)


def test_engine_kernel_path(cuda):
    """The engine's kernel path launches all three kernels and serves each
    request as it would alone."""
    from repro_torch.serving import ServingEngine
    eng = ServingEngine("rwkv4-169m", smoke=True, quantized=True,
                        fused_decode="block", fused_prefill=True,
                        max_batch=4, prefill_chunk=4, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, eng.model.cfg.vocab, int(n)).tolist()
               for n in (3, 9, 1, 6)]
    counters = (dpot_w8_matmul, wkv4_seq, rwkv4_block_decode)
    before = [c.launches for c in counters]
    handles = [eng.submit(p, max_new_tokens=5) for p in prompts]
    eng.run()
    assert all(c.launches > b for c, b in zip(counters, before))
    for p, h in zip(prompts, handles):
        solo = eng.submit(p, max_new_tokens=5)
        eng.run()
        assert solo.tokens == h.tokens
