#!/usr/bin/env python3
"""On-card proof that the PyTorch/CUDA port serves RWKV-4 through its kernels.

    python3 chip_smoke.py            (from the root of a checkout, one GPU)

Phases, each of which raises on failure (the script then exits non-zero):

 1. Build: nvcc compiles every `src/repro_torch/csrc/*.cu` for sm_90a, one
    process per source, all started together, into one shared library.
 2. Kernels at the full width of rwkv4-169m (L12 D768 F3072 V50277), each
    against its plain PyTorch version on the same inputs (TF32 off):
      dpot_w8_matmul (K5)      M in {128, 8} x (K, N) in {(768, 768),
                               (768, 3072), (3072, 768), (768, 50277)},
                               plus a bit-exact W8 decode check
                               (x = identity rows against unpack_leaf)
      wkv4_seq (K2)            (B, T, C) = (8, 16, 768), prefix masks
      rwkv4_block_decode (K3)  B = 8, D = 768, F = 3072
    Tolerances, against the plain version's output `ref`:
      K5, K2  elementwise |d| <= 2^-7 |ref| + 2^-20 max|ref|: both sides
              accumulate in f32 in another order and round to bf16 (K5) or
              snap a bf16 carry (K2), so an output may move by one bf16
              step (at most 2^-7 relative), and by nothing more.
      K3      max|d| <= 2^-6 max|ref| and mean|d| <= 2^-11 mean|ref| per
              output: a LayerNorm sum in another order can flip one bf16
              rounding, which then travels through later matvecs as a few
              bf16 steps at most; a misplaced rounding moves most elements
              and shows in the mean.
    Times come from CUDA events around single launches, with the 50 MB L2
    flushed (a 512 MB memset) before each, as the serving loop meets them,
    and the card kept busy while the host enqueues the launch (`_time_ms`).
 3. Engine: ServingEngine("rwkv4-169m", quantized=True, fused_decode=
    "block", fused_prefill=True, max_batch=8, prefill_chunk=16) serves 8
    seeded requests (prompts of 5-40 tokens, 32 greedy tokens each) with
    every launch counter set to 0 just before and read just after; each
    kernel must have launched.  Each request's stream must equal the same
    engine serving that request alone, bit for bit.  Teacher-forced
    logits of the kernel path (a 16-token prefill chunk, then 32 decode
    steps) are held with fixed bounds (TF_*) against an f32 witness of the
    same model and against the plain bf16 per-op path on the card; the
    plain bf16 paths on the card and on the CPU are held against the
    witness beside it, so the line shows how far bf16 alone moves the
    logits (`phase_teacher_forced`).
 4. The `kernels` JSON line, the card's name and power limit, and the last
    line {"ok": true, "device": {...}}.

Weights are random, from a seed.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
PEAK_BF16_FLOPS = 989e12       # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12         # H100 SXM f32 outside the tensor cores
REPS = 10
SLEEP_CYCLES = 4_000_000       # ~2 ms at the H100's 1.98 GHz boost clock
# Teacher-forced bounds on the kernel path's logits (phase_teacher_forced):
# 1.25x what the plain bf16 paths alone read on an H100 (PERF.md, PR 11
# run 4: to the f32 witness mean 0.01409 (card) / 0.01403 (CPU), max
# 0.0143 of max|f32|, argmax agreement 0.9545 at the least; CPU vs card
# mean 0.01511, max 0.0163 of max|ref|).
TF_MEAN_REL_F32 = 0.018      # mean |d| / mean |f32| against the witness
TF_MAX_REL_F32 = 0.018       # max |d| / max |f32| against the witness
TF_ARGMAX_F32 = 0.94         # argmax agreement with the witness
TF_MEAN_REL_PLAIN = 0.019    # mean |d| / mean |ref| against the plain path
TF_MAX_REL_PLAIN = 0.021     # max |d| / max |ref| against the plain path


def _bound(nbytes: float, ops: float, peak: float):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _time_ms(fn, flush) -> float:
    """Device time of one call of `fn`, L2-cold, averaged over REPS: a
    512 MB memset flushes the L2, then a device-side sleep keeps the card
    busy while the host runs the wrapper and enqueues the launch, so the
    events bracket the device's work and not the host's."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(REPS):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / REPS


def _elementwise_ok(out, ref):
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    ok = bool((d <= 2.0 ** -7 * r + 2.0 ** -20 * r.max()).all())
    return ok, float(d.max())


def _spread_ok(out, ref, max_rel, mean_rel):
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    ok = bool(d.max() <= max_rel * r.max()) and bool(
        d.mean() <= mean_rel * r.mean())
    return ok, float(d.max()), float(d.mean() / r.mean())


def _line(obj):
    print(json.dumps(obj), flush=True)


def phase_build():
    from repro_torch.kernels.build import build, load_library
    t0 = time.perf_counter()
    _, log = build()
    load_library()
    usage = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    _line({"phase": "build", "seconds": time.perf_counter() - t0,
           "ptxas": usage})


def phase_k5(params, cfg, flush):
    from repro_torch.core.quant.serving import unpack_leaf
    from repro_torch.device import exact_matmuls
    from repro_torch.kernels.fused_prefill import (
        dpot_w8_matmul, dpot_w8_matmul_plain)
    blocks = params["blocks"]
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab
    leaves = {(D, D): blocks["att"]["wr"], (D, F): blocks["ffn"]["wk"],
              (F, D): blocks["ffn"]["wv"], (D, V): params["head"]}
    gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    rows = []

    def lib_ms(x, w_bf):
        with exact_matmuls():     # f32 reductions, as K5 and its plain
            return _time_ms(lambda: torch.matmul(x, w_bf), flush)
    for (K, N), leaf in leaves.items():
        wq = leaf["packed"] if leaf["packed"].dim() == 2 else \
            leaf["packed"][0]
        scale = leaf["scale"].reshape(-1)
        w_bf = unpack_leaf({"packed": wq, "scale": scale.reshape(1, -1)})
        # bit-exact decode: identity rows pick out the decoded weights
        eye = torch.eye(K, dtype=torch.bfloat16, device=DEV)
        if not torch.equal(dpot_w8_matmul(eye, wq, scale), w_bf):
            raise AssertionError(f"K5 W8 decode differs from unpack_leaf "
                                 f"at (K, N) = {(K, N)}")
        for M in (128, 8):
            x = torch.randn((M, K), generator=gen, device=DEV).to(
                torch.bfloat16)
            out = dpot_w8_matmul(x, wq, scale)
            ref = dpot_w8_matmul_plain(x, wq, scale)
            ok, err = _elementwise_ok(out, ref)
            if not ok:
                raise AssertionError(f"K5 {(M, K, N)}: max |d| {err}")
            nbytes = M * K * 2 + K * N + N * 4 + M * N * 2
            bms, by = _bound(nbytes, 2.0 * M * N * K, PEAK_BF16_FLOPS)
            row = {"kernel": "dpot_w8_matmul", "M": M, "K": K, "N": N,
                   "max_abs_err": err, "decode_bit_exact": True,
                   "kernel_ms": _time_ms(
                       lambda: dpot_w8_matmul(x, wq, scale), flush),
                   "plain_ms": _time_ms(
                       lambda: dpot_w8_matmul_plain(x, wq, scale), flush),
                   "library_ms": lib_ms(x, w_bf),
                   "bound_ms": bms, "bound_by": by}
            _line(row)
            rows.append(row)
    return rows


def phase_k2(cfg, flush):
    from repro_torch.kernels.wkv4 import wkv4_seq, wkv4_seq_plain
    B, T, C = 8, 16, cfg.d_model
    g = torch.Generator(device=DEV).manual_seed(SEED + 2)
    rn = lambda *s: torch.randn(s, generator=g, device=DEV)
    k, v = rn(B, T, C), rn(B, T, C)
    w, u = torch.exp(0.5 * rn(C)), 0.5 * rn(C)
    bf = lambda t: t.to(torch.bfloat16).float()   # a bf16 pool state
    a0, b0, o0 = bf(rn(B, C)), bf(rn(B, C).abs() + 0.5), bf(rn(B, C) - 1)
    valid = torch.zeros((B, T), dtype=torch.bool, device=DEV)
    for i, n in enumerate((16, 9, 0, 1, 16, 5, 12, 16)):
        valid[i, :n] = True
    args = (k, v, w, u, a0, b0, o0)
    kw = {"valid": valid, "carry_dtype": "bfloat16"}
    y, fin = wkv4_seq(*args, **kw)
    y_p, fin_p = wkv4_seq_plain(*args, **kw)
    err = 0.0
    for name, o, r in zip(("y", "a", "b", "o"), (y, *fin), (y_p, *fin_p)):
        ok, e = _elementwise_ok(o, r)
        if not ok:
            raise AssertionError(f"K2 {name}: max |d| {e}")
        err = max(err, e)
    nbytes = 4 * (3 * B * T * C + 2 * C + 6 * B * C) + 4 * B * T
    bms, by = _bound(nbytes, 20.0 * B * T * C, PEAK_F32_FLOPS)
    row = {"kernel": "wkv4_seq", "B": B, "T": T, "C": C,
           "max_abs_err": err,
           "kernel_ms": _time_ms(lambda: wkv4_seq(*args, **kw), flush),
           "plain_ms": _time_ms(lambda: wkv4_seq_plain(*args, **kw), flush),
           "library_ms": None, "bound_ms": bms, "bound_by": by}
    _line(row)
    return row


def phase_k3(params, cfg, flush):
    from repro_torch.core.quant.serving import (
        broadcast_packed_scales, cast_compute)
    from repro_torch.kernels.fused_decode import (
        rwkv4_block_decode, rwkv4_block_decode_plain)
    from repro_torch.models.rwkv4 import STATE_KEYS, _layer
    B, D, F = 8, cfg.d_model, cfg.d_ff
    blocks = broadcast_packed_scales(
        cast_compute(params, torch.bfloat16)["blocks"], cfg.n_layers)
    lp = _layer(blocks, 0)
    g = torch.Generator(device=DEV).manual_seed(SEED + 3)
    rn = lambda: torch.randn((B, D), generator=g, device=DEV)
    bf = torch.bfloat16
    x = rn().to(bf)
    st = {"att_x": rn().to(bf), "ffn_x": rn().to(bf),
          "wkv_a": rn().to(bf), "wkv_b": (rn().abs() + 0.5).to(bf),
          "wkv_o": (rn() - 1).to(bf)}
    x2, new = rwkv4_block_decode(lp, st, x)
    x2_p, new_p = rwkv4_block_decode_plain(lp, st, x)
    err, mean_rel = 0.0, 0.0
    for name, o, r in [("x", x2, x2_p)] + [
            (k, new[k], new_p[k]) for k in STATE_KEYS]:
        ok, e, m = _spread_ok(o, r, 2.0 ** -6, 2.0 ** -11)
        if not ok:
            raise AssertionError(f"K3 {name}: max |d| {e}, mean rel {m}")
        err, mean_rel = max(err, e), max(mean_rel, m)
    w_bytes = 5 * D * D + 2 * D * F
    nbytes = (w_bytes + 4 * (6 * D + F) + 2 * 11 * D   # codes, scales, vecs
              + 2 * 6 * B * D + 2 * 6 * B * D)         # x + state in, out
    bms, by = _bound(nbytes, 2.0 * B * w_bytes, PEAK_BF16_FLOPS)
    row = {"kernel": "rwkv4_block_decode", "B": B, "D": D, "F": F,
           "max_abs_err": err, "max_mean_rel_err": mean_rel,
           "kernel_ms": _time_ms(lambda: rwkv4_block_decode(lp, st, x),
                                 flush),
           "plain_ms": _time_ms(lambda: rwkv4_block_decode_plain(lp, st, x),
                                flush),
           "library_ms": None, "bound_ms": bms, "bound_by": by}
    _line(row)
    return row


def phase_engine(engine, counters):
    V = engine.model.cfg.vocab
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, V, int(n)).tolist()
               for n in rng.integers(5, 41, 8)]
    for fn in counters:
        fn.launches = 0
    handles = [engine.submit(p, max_new_tokens=32) for p in prompts]
    stats = engine.run()
    launches = {fn.__name__: fn.launches for fn in counters}
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    streams = [h.tokens for h in handles]
    for s in streams:
        if len(s) != 32 or not all(0 <= t < V for t in s):
            raise AssertionError(f"bad stream {s}")
    for i, p in enumerate(prompts):
        h = engine.submit(p, max_new_tokens=32)
        engine.run()
        if h.tokens != streams[i]:
            raise AssertionError(f"request {i}: batched stream differs from "
                                 f"serving it alone")
    _line({"phase": "engine", "requests": 8, "new_tokens": 32,
           "prompt_lens": [len(p) for p in prompts],
           "tokens_per_s": stats["tokens_per_s"], "seconds": stats["seconds"],
           "ticks": stats["ticks"], "launches": launches,
           "solo_equals_batched": True})
    return launches


def _kernel_logits(model, params, toks, C):
    """Kernel path: one prefill chunk (K5 + K2), then decode steps (K3 per
    layer, the head through K5).  Logits after the chunk and each step."""
    B = toks.shape[0]
    valid = torch.ones((B, C), dtype=torch.bool, device=toks.device)
    with torch.inference_mode():
        s = model.init_decode_state(B, 0, device=toks.device)
        s, lg = model.prefill_chunk(params, s, toks[:, :C], valid)
        out = [lg]
        for j in range(C, toks.shape[1]):
            lg, s = model.decode_step_fused(params, s, toks[:, j:j + 1], 0)
            out.append(lg)
    return torch.stack(out).float()


def _plain_logits(model, params, toks, C, dtype=torch.bfloat16):
    """The plain per-op path over the same tokens, token by token.  With
    dtype=float32 it is the f32 witness: the same W8 weights (decoded and
    rounded to bf16 as every path sees them, then widened exactly), with
    the state, the activations and every product in f32."""
    from repro_torch.core.quant.serving import cast_compute
    from repro_torch.models.registry import get_model
    from repro_torch.serving.plan import maybe_unpack
    p = cast_compute(maybe_unpack(params, True), torch.bfloat16)
    if dtype != torch.bfloat16:
        model = get_model(dataclasses.replace(
            model.cfg, dtype=str(dtype).replace("torch.", "")))
        p = cast_compute(p, dtype)
    out = []
    with torch.inference_mode():
        s = model.init_decode_state(toks.shape[0], 0, dtype=dtype,
                                    device=toks.device)
        for j in range(toks.shape[1]):
            lg, s = model.decode_step(p, s, toks[:, j:j + 1], 0)
            if j >= C - 1:
                out.append(lg)
    return torch.stack(out).float()


def _gap(out, ref):
    """max |d|, mean |d| / mean |ref|, and the share of points whose
    argmax over the vocabulary agrees."""
    d = (out - ref).abs()
    return {"max_abs": float(d.max()),
            "mean_rel": float(d.mean() / ref.abs().mean()),
            "argmax_agree": float((out.argmax(-1) == ref.argmax(-1))
                                  .float().mean())}


def phase_teacher_forced(engine):
    """Kernel path vs the plain per-op path on the card, on the same tokens
    (8 lanes: a 16-token prefill chunk, then 32 decode steps), both held
    against an f32 witness of the same model.

    Every bf16 path at this width sits a bf16 noise distance from the f32
    witness; the kernel path must sit no farther than the plain bf16 paths
    do (on the card and on the CPU, which differ only in summation order),
    within the fixed bounds TF_*.  The bounds come from the readings of
    the committed script on an H100 (PERF.md, PR 11 run 4): what the plain
    bf16 paths alone read, against the witness and against each other,
    with a quarter of headroom.  They catch a kernel that is wrong (its
    logits move by their own size); a rounding made at the wrong place is
    caught by the per-kernel checks of phase 2, not here."""
    from repro_torch.tree import tree_map
    model, cfg = engine.model, engine.model.cfg
    params = engine.plan.prepared.raw
    g = torch.Generator(device=DEV).manual_seed(SEED + 7)
    B, C, S = 8, 16, 32
    toks = torch.randint(0, cfg.vocab, (B, C + S), generator=g,
                         device=DEV, dtype=torch.int32)
    out = _kernel_logits(model, params, toks, C)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("kernel-path logits are not finite")
    if out.shape != (S + 1, B, 1, cfg.vocab):
        raise AssertionError(f"logits shape {tuple(out.shape)}")
    ref = _plain_logits(model, params, toks, C)
    f32 = _plain_logits(model, params, toks, C, torch.float32)
    cpu = _plain_logits(model, tree_map(lambda t: t.cpu(), params),
                        toks.cpu(), C).to(DEV)
    max_f32, max_ref = float(f32.abs().max()), float(ref.abs().max())
    gaps = {"kernel_vs_plain": _gap(out, ref),
            "kernel_vs_f32": _gap(out, f32),
            "plain_card_vs_f32": _gap(ref, f32),
            "plain_cpu_vs_f32": _gap(cpu, f32),
            "plain_cpu_vs_card": _gap(cpu, ref)}
    kp, kf = gaps["kernel_vs_plain"], gaps["kernel_vs_f32"]
    ok = (kf["mean_rel"] <= TF_MEAN_REL_F32
          and kf["max_abs"] <= TF_MAX_REL_F32 * max_f32
          and kf["argmax_agree"] >= TF_ARGMAX_F32
          and kp["mean_rel"] <= TF_MEAN_REL_PLAIN
          and kp["max_abs"] <= TF_MAX_REL_PLAIN * max_ref)
    _line({"phase": "teacher_forced", "steps": S + 1, "lanes": B,
           "max_abs_f32": max_f32, "gaps": gaps,
           "bounds": {"kernel_vs_f32": {"mean_rel": TF_MEAN_REL_F32,
                                        "max_abs": TF_MAX_REL_F32 * max_f32,
                                        "argmax_agree": TF_ARGMAX_F32},
                      "kernel_vs_plain": {
                          "mean_rel": TF_MEAN_REL_PLAIN,
                          "max_abs": TF_MAX_REL_PLAIN * max_ref}},
           "within_bound": ok})
    if not ok:
        raise AssertionError(f"teacher-forced logits out of bounds: {gaps}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels.fused_decode import rwkv4_block_decode
    from repro_torch.kernels.fused_prefill import dpot_w8_matmul
    from repro_torch.kernels.wkv4 import wkv4_seq
    from repro_torch.serving import ServingEngine

    phase_build()
    engine = ServingEngine("rwkv4-169m", smoke=False, quantized=True,
                           fused_decode="block", fused_prefill=True,
                           max_batch=8, prefill_chunk=16, seed=SEED,
                           device=DEV)
    params, cfg = engine.plan.prepared.raw, engine.model.cfg
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=DEV)
    k5 = phase_k5(params, cfg, flush)
    k2 = phase_k2(cfg, flush)
    k3 = phase_k3(params, cfg, flush)
    del flush
    launches = phase_engine(
        engine, (dpot_w8_matmul, wkv4_seq, rwkv4_block_decode))
    phase_teacher_forced(engine)

    total = lambda key: sum(r[key] for r in k5)
    kernels = [
        {"name": "dpot_w8_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/dpot_w8_matmul.cu",
         "replaces": "src/repro/kernels/fused_prefill.py:84",
         "launches": launches["dpot_w8_matmul"],
         "max_abs_err": max(r["max_abs_err"] for r in k5),
         "ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
         "bound_ms": total("bound_ms"),
         "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in k5)
         else "operations",
         "library_ms": total("library_ms"),
         "shapes": [[r["M"], r["K"], r["N"]] for r in k5],
         "note": "times and bounds summed over the shapes, one call each"},
        {"name": "wkv4_seq", "route": "cuda",
         "source": "src/repro_torch/csrc/wkv4_seq.cu",
         "replaces": "src/repro/kernels/wkv4.py:101",
         "launches": launches["wkv4_seq"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["kernel_ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None, "shapes": [[k2["B"], k2["T"], k2["C"]]]},
        {"name": "rwkv4_block_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/rwkv4_block_decode.cu",
         "replaces": "src/repro/kernels/fused_decode.py:77",
         "launches": launches["rwkv4_block_decode"],
         "max_abs_err": k3["max_abs_err"], "ms": k3["kernel_ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None,
         "shapes": [[k3["B"], k3["D"], k3["F"]]]},
    ]
    _line({"kernels": kernels})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    _line({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
