"""Time K1 (`dpot_matmul`) and K8 (`dpot_matmul_w4`) of the PyTorch port
on one CUDA card, beside `torch.matmul` in f32 and K5's own instance at
the same shape, and print hashes of K5's outputs.

The cases are `chip_smoke.py:phase_k1_k8`'s, on planes quantized here from
random weights (seeded): rwkv6-7b's att.wr (4096, 4096), ffn.wk (4096,
14336), ffn.wv (14336, 4096) and head (4096, 65536), W8 and W4, at M 8 and
128 with a bf16 x; bench_kernels' (8, 1024, 1024) W8 with an f32 x; and
rwkv4-169m's att.wk (768, 768) and head (768, 50277) W4 at M 8 and 128.
Each kernel is timed as `chip_smoke.py` times it (L2 flushed, the host
hidden behind a device sleep, CUDA events, mean of `--reps`) and checked
against its plain version within K·2^-24·(|x| @ |w|) plus one step of
x's dtype (`over`: the largest |d| over that bound; `ok`: at most 1).
Beside it: `torch.matmul` of x in f32 on the decoded f32 plane (TF32
off), and K5 (`dpot_w8_matmul` / `dpot_w4_matmul`, their `_f32x` forms
for an f32 x) on the same codes, which rounds each weight to bf16.

Then, for K5, K5-W4, K5-VQ and their f32-x forms at fixed seeds and
shapes (one slice and several, 16-byte rows and byte rows), a SHA-256 of
each output's bytes: a run on another tree must print the same hashes
where K5 is unchanged.  The build's ptxas lines of `chunk_mm_kernel`'s
instances (and of any other `dpot` kernel) are printed first.  One JSON
line per case.

`--src` names the `src` directory whose `repro_torch` is timed (default:
this checkout's), so one process per tree compares two versions of the
port on the same card:

    python tools/bench_k1_k8.py --label change
    python tools/bench_k1_k8.py --src OTHER/src --label parent
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import torch

SEED = 0
DEV = "cuda"
SLEEP_CYCLES = 4_000_000       # ~2 ms at the H100's 1.98 GHz boost clock
RWKV6 = (("att.wr", 4096, 4096), ("ffn.wk", 4096, 14336),
         ("ffn.wv", 14336, 4096), ("head", 4096, 65536))
RWKV4_W4 = (("rwkv4 att.wk", 768, 768), ("rwkv4 head", 768, 50277))
# (plane, M, K, N, x dtype) of the K5 hashes
K5_HASHES = tuple((p, M, K, N, dt) for p in ("w8", "w4", "vq")
                  for M, K, N in ((128, 768, 768), (8, 768, 50277),
                                  (128, 4096, 4096))
                  for dt in (torch.bfloat16, torch.float32))


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


def _plane(plane, K, N, g):
    """(codes, aux) of a plane quantized from a random (K, N) weight."""
    from repro_torch.core.quant.delta_pot import (
        FORMAT_W4, FORMAT_W8, dpot_pack_int8, dpot_pack_nibbles,
        dpot_quantize)
    from repro_torch.core.quant.vq import vq_quantize
    w = torch.randn((K, N), generator=g, device=DEV) * 0.05
    if plane == "vq":
        return vq_quantize(w, 256)
    q = dpot_quantize(w, FORMAT_W4 if plane == "w4" else FORMAT_W8, axis=-1)
    codes = dpot_pack_nibbles(q) if plane == "w4" else dpot_pack_int8(q)
    return codes, q.scale.reshape(-1).contiguous()


def _cases():
    """(name, plane, M, K, N, x dtype) of every K1 / K8 case."""
    out = []
    for plane in ("w8", "w4"):
        for name, K, N in RWKV6:
            out += [(f"rwkv6-7b {name}", plane, M, K, N, torch.bfloat16)
                    for M in (8, 128)]
    out.append(("bench_kernels 1024x1024", "w8", 8, 1024, 1024,
                torch.float32))
    for name, K, N in RWKV4_W4:
        out += [(name, "w4", M, K, N, torch.bfloat16) for M in (8, 128)]
    return out


def bench_case(case, flush, reps):
    from repro_torch.core.quant.delta_pot import (
        FORMAT_W4, FORMAT_W8, dpot_dequantize, dpot_unpack_int8,
        dpot_unpack_nibbles)
    from repro_torch.kernels import fused_prefill as fp
    from repro_torch.kernels import ops
    from repro_torch.kernels.dpot_matmul import (
        dpot_matmul_plain, dpot_matmul_w4_plain)
    name, plane, M, K, N, dt = case
    w4 = plane == "w4"
    g = torch.Generator(device=DEV).manual_seed(SEED + K + N)
    codes, scale = _plane(plane, K, N, g)
    x = torch.randn((M, K), generator=g, device=DEV).to(dt)
    fn = ops.dpot_matmul_w4 if w4 else ops.dpot_matmul
    plain = dpot_matmul_w4_plain if w4 else dpot_matmul_plain
    k5 = getattr(fp, ("dpot_w4_matmul" if w4 else "dpot_w8_matmul")
                 + ("_f32x" if dt == torch.float32 else ""))
    unpack = dpot_unpack_nibbles if w4 else dpot_unpack_int8
    w32 = dpot_dequantize(unpack(codes, scale[None, :],
                                 FORMAT_W4.ks if w4 else FORMAT_W8.ks))
    out, ref = fn(x, codes, scale), plain(x, codes, scale)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        mag = x.double().abs() @ w32.double().abs()
        xf = x.float()
        lib = _time_ms(lambda: torch.matmul(xf, w32), flush, reps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    o, r = out.double(), ref.double()
    bound = K * 2.0 ** -24 * mag + torch.finfo(dt).eps * torch.maximum(
        o.abs(), r.abs())
    over = float(((o - r).abs() / bound).max())
    return {"kernel": fn.__name__, "operand": name, "M": M, "K": K, "N": N,
            "x": str(dt).replace("torch.", ""),
            "err": float((o - r).abs().max()), "over": over,
            "ok": over <= 1.0,
            "ms": _time_ms(lambda: fn(x, codes, scale), flush, reps),
            "library_ms": lib,
            "k5_ms": _time_ms(lambda: k5(x, codes, scale), flush, reps)}


def k5_hash(case):
    """SHA-256 of one K5-form output at a fixed seed."""
    from repro_torch.kernels import fused_prefill as fp
    plane, M, K, N, dt = case
    g = torch.Generator(device=DEV).manual_seed(SEED + 7 * M + K + N)
    codes, aux = _plane(plane, K, N, g)
    x = torch.randn((M, K), generator=g, device=DEV).to(dt)
    name = {"w8": "dpot_w8_matmul", "w4": "dpot_w4_matmul",
            "vq": "vq_matmul"}[plane]
    fn = getattr(fp, name + ("_f32x" if dt == torch.float32 else ""))
    out = fn(x, codes, aux)
    torch.cuda.synchronize()
    raw = out.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return {"kernel": fn.__name__, "M": M, "K": K, "N": N,
            "sha256": hashlib.sha256(raw).hexdigest()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="this")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_k1_k8: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.build import BUILD_DIR, load_library
    load_library()               # builds the tree's kernels if stale
    keep, lines = False, []
    for ln in (BUILD_DIR / "ptxas.log").read_text().splitlines():
        if "Compiling entry" in ln:
            keep = "chunk_mm" in ln or "dpot" in ln
        if keep and ("Compiling entry" in ln or "registers" in ln
                     or "spill" in ln):
            lines.append(ln.strip())
    print(json.dumps({"label": args.label, "ptxas": lines}), flush=True)
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=DEV)
    rows = []
    with torch.no_grad():
        for case in _cases():
            rows.append(bench_case(case, flush, args.reps))
            print(json.dumps({"label": args.label, **rows[-1]}), flush=True)
        for case in K5_HASHES:
            print(json.dumps({"label": args.label, **k5_hash(case)}),
                  flush=True)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
