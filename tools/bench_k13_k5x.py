"""Time K13 (the bf16 flash-attention forward of the PyTorch port), its
backward kernels K13-dq and K13-dkv, and K5's f32-x forms (W8, W4, VQ) on
one CUDA card, beside their library calls.

K13 runs at smollm-135m's prefill shape (B 8, S 2048, H 9, KVH 3, d 64,
causal) and at the d 96 and d 128 layouts of `chip_smoke.py:K13_SHAPES`,
with `F.scaled_dot_product_attention` (is_causal, enable_gqa) beside it;
K13-dq and K13-dkv at the same three cases, beside SDPA's backward
(torch.autograd.grad through it, less its forward), each held to the plain
backward within `bwd_bounds` (taken from this checkout's
`kernels/flash_attention.py`, so an older tree under `--src` is held to
the same bound); K5 f32-x at att.wo's (128, 768, 768) of rwkv4-169m on
planes quantized from random weights, with `torch.matmul` in f32 beside
it.  Each is timed as `chip_smoke.py` times it (L2 flushed, the host
hidden behind a device sleep, CUDA events, mean of `--reps`) and checked
against its plain version (`err`: max |kernel - plain|; `ok`: within the
bound that `chip_smoke.py` holds).  The build's ptxas lines of the K13
and K5 kernels are printed first.  One JSON line per case.

`--src` names the `src` directory whose `repro_torch` is timed (default:
this checkout's), so one process per tree compares two versions of the
port on the same card:

    python tools/bench_k13_k5x.py --label change
    python tools/bench_k13_k5x.py --src OTHER/src --label parent
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import torch

SEED = 0
DEV = "cuda"
SLEEP_CYCLES = 4_000_000       # ~2 ms at the H100's 1.98 GHz boost clock
K13_CASES = ((8, 2048, 9, 3, 64, True), (2, 1024, 32, 32, 96, True),
             (2, 1024, 24, 8, 128, True))
F32X_SHAPE = (128, 768, 768)


def _time_ms(fn, flush, reps):
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / reps


def bench_k13(case, flush, reps):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    B, S, H, KVH, d, causal = case
    g = torch.Generator(device=DEV).manual_seed(SEED + 40)
    rn = lambda *s: torch.randn(s, generator=g, device=DEV).to(
        torch.bfloat16)
    q, k, v = rn(B, S, H, d), rn(B, S, KVH, d), rn(B, S, KVH, d)
    out = flash_attention(q, k, v, causal=causal)
    ref = flash_attention_plain(q, k, v, causal=causal)
    floor = (S + d + 8) * 2.0 ** -24 * flash_attention_plain(
        q.float(), k.float(), v.float().abs(), causal=causal)
    dd = (out.float() - ref.float()).abs()
    ok = bool((dd <= 2.0 ** -7 * ref.float().abs() + floor).all())
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return {"kernel": "K13", "B": B, "S": S, "H": H, "KVH": KVH, "d": d,
            "causal": causal, "err": float(dd.max()), "ok": ok,
            "ms": _time_ms(lambda: flash_attention(q, k, v, causal=causal),
                           flush, reps),
            "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), flush,
                reps)}


def _bwd_bounds():
    """`bwd_bounds` from this checkout's kernels/flash_attention.py, loaded
    by path: the tree under `--src` may predate it."""
    import importlib.util
    path = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
            / "kernels" / "flash_attention.py")
    spec = importlib.util.spec_from_file_location("_bench_k13_bounds", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.bwd_bounds


def bench_k13_bwd(case, flush, reps, bounds):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        _delta, flash_attention, flash_attention_bwd,
        flash_attention_bwd_plain, flash_attention_dkv, flash_attention_dq)
    B, S, H, KVH, d, causal = case
    g = torch.Generator(device=DEV).manual_seed(SEED + 60)
    rn = lambda *s: torch.randn(s, generator=g, device=DEV).to(
        torch.bfloat16)
    q, k, v, do = rn(B, S, H, d), rn(B, S, KVH, d), rn(B, S, KVH, d), \
        rn(B, S, H, d)
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    ref = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    ok, err = True, {}
    for name, x, r, bnd in zip(("dq", "dk", "dv"), got, ref,
                               bounds(q, k, v, o, lse, do, causal, ref)):
        dd = (x.float() - r.float()).abs()
        ok = ok and bool((dd <= bnd).all())
        err[name] = float(dd.max())
    del ref
    delta = _delta(o, do)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    lib_fb = _time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot),
                      flush, reps)
    lib_f = _time_ms(sdpa, flush, reps)
    return {"kernel": "K13-bwd", "B": B, "S": S, "H": H, "KVH": KVH,
            "d": d, "causal": causal, "err": err, "ok": ok,
            "dq_ms": _time_ms(lambda: flash_attention_dq(
                q, k, v, o, lse, do, causal=causal, delta=delta), flush,
                reps),
            "dkv_ms": _time_ms(lambda: flash_attention_dkv(
                q, k, v, o, lse, do, causal=causal, delta=delta), flush,
                reps),
            "library_ms": lib_fb - lib_f}


def _plane(plane, K, N, g):
    """(codes, aux, the decoded bf16 weights) of a random plane."""
    from repro_torch.core.quant.delta_pot import (
        FORMAT_W4, FORMAT_W8, dpot_pack_int8, dpot_pack_nibbles,
        dpot_quantize)
    from repro_torch.core.quant.serving import unpack_leaf
    from repro_torch.core.quant.vq import vq_quantize
    w = torch.randn((K, N), generator=g, device=DEV)
    if plane == "vq":
        codes, aux = vq_quantize(w, 256)
        leaf = {"vq_idx": codes, "codebook": aux}
    elif plane == "w4":
        q = dpot_quantize(w, FORMAT_W4, axis=-1)
        codes, aux = dpot_pack_nibbles(q), q.scale.reshape(-1)
        leaf = {"packed4": codes, "scale": aux[None]}
    else:
        q = dpot_quantize(w, FORMAT_W8, axis=-1)
        codes, aux = dpot_pack_int8(q), q.scale.reshape(-1)
        leaf = {"packed": codes, "scale": aux[None]}
    return codes, aux, unpack_leaf(leaf)


def bench_f32x(plane, flush, reps):
    from repro_torch.kernels import fused_prefill as fp
    name = {"w8": "dpot_w8_matmul", "w4": "dpot_w4_matmul",
            "vq": "vq_matmul"}[plane]
    fn, plain = getattr(fp, name + "_f32x"), getattr(fp, name + "_plain")
    M, K, N = F32X_SHAPE
    g = torch.Generator(device=DEV).manual_seed(SEED + 13)
    codes, aux, w_bf = _plane(plane, K, N, g)
    x = torch.randn((M, K), generator=g, device=DEV)
    out, ref = fn(x, codes, aux), plain(x, codes, aux)
    w32 = w_bf.float()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        bound = K * 2.0 ** -24 * (x.abs() @ w32.abs())
        lib = _time_ms(lambda: torch.matmul(x, w32), flush, reps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    d = (out - ref).abs()
    return {"kernel": f"K5 f32-x {plane}", "M": M, "K": K, "N": N,
            "err": float(d.max()), "ok": bool((d <= bound).all()),
            "ms": _time_ms(lambda: fn(x, codes, aux), flush, reps),
            "library_ms": lib}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="this")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_k13_k5x: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.build import build, load_library
    _, log = build()
    load_library()
    keep, lines = False, []
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            keep = "flash_" in ln or "chunk_mm" in ln
        if keep and ("Compiling entry" in ln or "registers" in ln
                     or "spill" in ln):
            lines.append(ln.strip())
    print(json.dumps({"label": args.label, "ptxas": lines}), flush=True)
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=DEV)
    rows = [bench_k13(c, flush, args.reps) for c in K13_CASES]
    bounds = _bwd_bounds()
    rows += [bench_k13_bwd(c, flush, args.reps, bounds) for c in K13_CASES]
    rows += [bench_f32x(p, flush, args.reps) for p in ("w8", "w4", "vq")]
    for row in rows:
        print(json.dumps({"label": args.label, **row}), flush=True)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
