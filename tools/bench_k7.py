"""Time K7 (the RWKV-6 decode kernels of the PyTorch port) at rwkv6-7b's
full width and depth, B 8, on one CUDA card, per weight form, on this tree
and, with `--parent`, on another tree in the same call.

For each form asked (`w8`: the default plane policy; `mixed`: W4 att.wk
and head, VQ ffn.wv; `bf16`: plain weights) it draws the weights from a
seed on the card, then times K7-block on layer 0 and K7-model over all
layers with `chip_smoke.py`'s timer (`_time_ms`: L2 flushed, the host
hidden behind a device sleep, CUDA events, mean of `--reps`), and back to
back (`loop_ms`, host and device together).  `bound_ms` is
`chip_smoke.py:_bound` of the call's bytes (`_k7_block_bytes`,
`_k7_model_bytes`) and operations (`_k7_ops`), `x_bound` the time over
it.  `xsum` is a checksum of the bits of each call's x out, so two runs
of one tree on the same seed can be held to the same bits.
`chip_smoke.py` is loaded by path from this checkout, so another tree is
timed and bounded the same way.  The build's ptxas lines of K7's sources
(registers, spills) and the `nvidia-smi` name and power limit come first.
One JSON line per form.

With `--parent OTHER/src` the tool runs itself four times, one process a
tree, in the order parent, change, change, parent, then prints each
form's mean time per tree and their ratio:

    python tools/bench_k7.py --parent build/parent/src --forms w8,mixed,bf16
    python tools/bench_k7.py --src OTHER/src --label other --forms w8
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
DEV = "cuda"
K7_SOURCES = ("rwkv6_block_decode.cu", "rwkv6_model_decode.cu")


def _smoke():
    """This checkout's chip_smoke.py as a module (its timer, bounds and
    the MIXED policy)."""
    spec = importlib.util.spec_from_file_location(
        "_bench_k7_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ptxas(log: str):
    """The ptxas lines of K7's sources, and the most registers and spill
    bytes among their kernels."""
    keep, lines = False, []
    for ln in log.splitlines():
        if ln.startswith("== "):
            keep = ln.strip()[3:] in K7_SOURCES
            continue
        if keep and ("Compiling entry" in ln or "registers" in ln
                     or "spill" in ln):
            lines.append(ln.strip())
    regs = [int(m) for ln in lines for m in re.findall(r"Used (\d+) reg", ln)]
    spills = [int(a) + int(b) for ln in lines for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)]
    return lines, max(regs, default=0), max(spills, default=0)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi failed"


def _loop_ms(fn, reps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _xsum(x) -> int:
    return int(x.view(torch.int16).to(torch.int64).sum())


def _trees(form, smoke):
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
            default="w8", overrides=smoke.MIXED_OVERRIDES)}
        eng = ServingEngine("rwkv6-7b", fused_decode="model", smoke=False,
                            quantized=True, fused_prefill=True, max_batch=8,
                            prefill_chunk=16, seed=SEED, device=DEV, **kw)
        model, raw = eng.model, eng.plan.prepared.raw
        stack = eng.plan.prepared.decode["blocks"]
    cfg = model.cfg
    blocks = broadcast_packed_scales(
        cast_compute(raw, torch.bfloat16)["blocks"], cfg.n_layers)
    return cfg, _layer(blocks, 0), stack


def bench(form, smoke, flush, reps):
    from repro_torch.kernels.fused_decode import (
        rwkv6_block_decode, rwkv6_model_decode)
    cfg, lp, stack = _trees(form, smoke)
    L, B = cfg.n_layers, 8
    g = torch.Generator(device=DEV).manual_seed(SEED + 30)
    D, H, N = cfg.d_model, cfg.n_heads, cfg.rwkv_head_dim
    rn = lambda *s: torch.randn(s, generator=g, device=DEV).to(
        torch.bfloat16)
    st = {"att_x": rn(L, B, D), "ffn_x": rn(L, B, D),
          "wkv_s": rn(L, B, H, N, N)}
    x = rn(B, D)
    st0 = {k: v[0] for k, v in st.items()}
    block = lambda: rwkv6_block_decode(lp, st0, x, cfg)
    model = lambda: rwkv6_model_decode(stack, st, x, cfg)
    bb, _ = smoke._bound(smoke._k7_block_bytes(lp, st0, x),
                         smoke._k7_ops(cfg, B), smoke.PEAK_BF16_FLOPS)
    mb, _ = smoke._bound(smoke._k7_model_bytes(stack, st, x),
                         smoke._k7_ops(cfg, B, L), smoke.PEAK_BF16_FLOPS)
    row = {"form": form, "L": L, "B": B,
           "block_ms": smoke._time_ms(block, flush, reps),
           "model_ms": smoke._time_ms(model, flush, reps),
           "block_bound_ms": bb, "model_bound_ms": mb,
           "block_loop_ms": _loop_ms(block, reps),
           "model_loop_ms": _loop_ms(model, reps),
           "block_xsum": _xsum(block()[0]), "model_xsum": _xsum(model()[0])}
    row["block_x_bound"] = row["block_ms"] / bb
    row["model_x_bound"] = row["model_ms"] / mb
    return row


def run_tree(args) -> int:
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.build import BUILD_DIR, load_library
    load_library()               # builds the tree's kernels if stale
    lines, regs, spills = _ptxas((BUILD_DIR / "ptxas.log").read_text())
    print(json.dumps({"label": args.label, "src": args.src, "card": _card(),
                      "ptxas": lines, "max_registers": regs,
                      "max_spill_bytes": spills}), flush=True)
    smoke = _smoke()
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=DEV)
    with torch.no_grad():
        for form in args.forms.split(","):
            row = bench(form, smoke, flush, args.reps)
            print(json.dumps({"label": args.label, **row}), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 0


def run_ab(args) -> int:
    """parent, change, change, parent: one process a run; then each form's
    mean per tree."""
    order = (("parent", args.parent), ("change", args.src),
             ("change", args.src), ("parent", args.parent))
    times, rc = {}, 0
    for label, src in order:
        out = subprocess.run(
            [sys.executable, __file__, "--src", src, "--label", label,
             "--reps", str(args.reps), "--forms", args.forms],
            capture_output=True, text=True)
        sys.stdout.write(out.stdout)
        sys.stderr.write(out.stderr[-4000:])
        rc = rc or out.returncode
        for ln in out.stdout.splitlines():
            row = json.loads(ln)
            for k in ("block_ms", "model_ms"):
                if k in row:
                    times.setdefault((row["form"], k), {}).setdefault(
                        label, []).append(row[k])
    for (form, k), t in times.items():
        mean = {lab: sum(v) / len(v) for lab, v in t.items()}
        print(json.dumps({"form": form, "what": k, "runs_ms": t,
                          "mean_ms": mean,
                          "parent_over_change": mean.get("parent", 0.0)
                          / mean["change"] if "change" in mean else None}),
              flush=True)
    return rc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--parent", default=None,
                    help="another tree's src: run parent, change, change, "
                         "parent")
    ap.add_argument("--label", default="this")
    ap.add_argument("--forms", default="w8,mixed,bf16")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_k7: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    return run_ab(args) if args.parent else run_tree(args)


if __name__ == "__main__":
    sys.exit(main())
