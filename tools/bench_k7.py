"""Time K7 (the RWKV-6 decode kernels of the PyTorch port) at rwkv6-7b's
full width and depth, B 8, on one CUDA card, per weight form.

For each form asked (`w8`: the default plane policy; `mixed`: W4 att.wk
and head, VQ ffn.wv; `bf16`: plain weights) it draws the weights from a
seed on the card, then times K7-block on layer 0 and K7-model over all
layers as `chip_smoke.py` does (L2 flushed, the host hidden behind a
device sleep, CUDA events, mean of `--reps`), and back to back (`loop_ms`,
host and device together).  `xsum` is a checksum of the bits of each
call's x out, so runs of two source trees on the same seed can be held to
the same bits.  One JSON line per form.

`--src` names the `src` directory whose `repro_torch` is timed (default:
this checkout's), so one process per tree compares two versions of the
port on the same card:

    python tools/bench_k7.py --label change --forms w8,mixed,bf16
    python tools/bench_k7.py --src OTHER/src --label parent --forms w8
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

SEED = 0
DEV = "cuda"
SLEEP_CYCLES = 4_000_000       # ~2 ms at the H100's 1.98 GHz boost clock
MIXED_OVERRIDES = ((r"\['att'\]\['wk'\]", "w4"),
                   (r"\['ffn'\]\['wv'\]", "vq"),
                   (r"\['head'\]", "w4"))


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


def _loop_ms(fn, reps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _xsum(x) -> int:
    return int(x.view(torch.int16).to(torch.int64).sum())


def _trees(form):
    """(cfg, layer-0 params, slab stack) of rwkv6-7b in `form`."""
    from repro_torch.core.quant.serving import (
        broadcast_packed_scales, cast_compute)
    from repro_torch.models.rwkv4 import _layer
    if form == "bf16":
        from repro_torch.models.registry import get_model
        from repro_torch.models.rwkv6 import prepare_fused_model_params
        model = get_model("rwkv6-7b")
        raw = model.init_params(SEED, DEV, torch.bfloat16)
        stack = prepare_fused_model_params(raw, model.cfg)["blocks"]
    else:
        from repro_torch.core.quant.policy import PlanePolicy
        from repro_torch.serving import ServingEngine
        kw = {} if form == "w8" else {"plane_policy": PlanePolicy(
            default="w8", overrides=MIXED_OVERRIDES)}
        eng = ServingEngine("rwkv6-7b", fused_decode="model", smoke=False,
                            quantized=True, fused_prefill=True, max_batch=8,
                            prefill_chunk=16, seed=SEED, device=DEV, **kw)
        model, raw = eng.model, eng.plan.prepared.raw
        stack = eng.plan.prepared.decode["blocks"]
    cfg = model.cfg
    blocks = broadcast_packed_scales(
        cast_compute(raw, torch.bfloat16)["blocks"], cfg.n_layers)
    return cfg, _layer(blocks, 0), stack


def bench(form, flush, reps):
    from repro_torch.kernels.fused_decode import (
        rwkv6_block_decode, rwkv6_model_decode)
    cfg, lp, stack = _trees(form)
    L, B, D = cfg.n_layers, 8, cfg.d_model
    H, N = cfg.n_heads, cfg.rwkv_head_dim
    g = torch.Generator(device=DEV).manual_seed(SEED + 30)
    rn = lambda *s: torch.randn(s, generator=g, device=DEV).to(
        torch.bfloat16)
    st = {"att_x": rn(L, B, D), "ffn_x": rn(L, B, D),
          "wkv_s": rn(L, B, H, N, N)}
    x = rn(B, D)
    st0 = {k: v[0] for k, v in st.items()}
    block = lambda: rwkv6_block_decode(lp, st0, x, cfg)
    model = lambda: rwkv6_model_decode(stack, st, x, cfg)
    return {"form": form, "L": L, "B": B,
            "block_ms": _time_ms(block, flush, reps),
            "model_ms": _time_ms(model, flush, reps),
            "block_loop_ms": _loop_ms(block, reps),
            "model_loop_ms": _loop_ms(model, reps),
            "block_xsum": _xsum(block()[0]), "model_xsum": _xsum(model()[0])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="this")
    ap.add_argument("--forms", default="w8,mixed,bf16")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_k7: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.build import build, load_library
    build()
    load_library()
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=DEV)
    for form in args.forms.split(","):
        row = bench(form, flush, args.reps)
        print(json.dumps({"label": args.label, "src": args.src, **row}),
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
