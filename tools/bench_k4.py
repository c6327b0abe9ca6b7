"""Time K4 (`rwkv4_model_decode`) of the PyTorch port on one CUDA card
beside 12 launches of K3 on the same layers, and print hashes of K4's
outputs.

K4 runs all 12 layers of rwkv4-169m (random weights from the seed,
prepared as the model path prepares them: packed MIXED (W4 att.wk, VQ
ffn.wv, W8 elsewhere) or W8, or plain bf16 weights), B 8, under the exact
numerics (MIXED, W8, bf16) and the hardware numerics (W8 with the `_luts`
tables); per form a SHA-256 of the output x and of the five new state
leaves, which a run on another tree must print unchanged where K4 keeps
its bits, and its time as `chip_smoke.py` takes it (L2 flushed, the host
hidden behind a device sleep, CUDA events, mean of `--reps`).  `k3x12_ms`
is the same step as 12 K3 launches chained through the layers, timed the
same way behind a sleep 12 times as long, and `equals_k3x12` says whether
their outputs are K4's bit for bit.  Where the tree's K4 takes `grid=`,
each form runs again on grids of 1 and 7 blocks: `grid_equal` says
whether every output is the full grid's bit for bit.  The build's ptxas lines of the RWKV-4 decode
kernels' instances are printed first, with the most registers and spill
bytes among them.  One JSON line per case.

`--src` names the `src` directory whose `repro_torch` is timed (default:
this checkout's), so one process per tree compares two versions of the
port on the same card:

    python tools/bench_k4.py --label change
    python tools/bench_k4.py --src OTHER/src --label parent
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import re
import sys
from pathlib import Path

import torch

SEED = 0
DEV = "cuda"
SLEEP_CYCLES = 4_000_000       # ~2 ms at the H100's 1.98 GHz boost clock
B = 8
# the MIXED plane policy of chip_smoke.py
MIXED = ((r"\['att'\]\['wk'\]", "w4"), (r"\['ffn'\]\['wv'\]", "vq"),
         (r"\['head'\]", "w4"))
STATE = ("att_x", "ffn_x", "wkv_a", "wkv_b", "wkv_o")


def _time_ms(fn, flush, reps, sleeps=1):
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES * sleeps)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / reps


def _sha(t) -> str:
    raw = t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()


def _ptxas(log: str):
    """The ptxas lines of the RWKV-4 decode kernels' instances, and the
    most registers and spill bytes among them."""
    keep, lines = False, []
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            keep = "rwkv4" in ln
        if keep and ("Compiling entry" in ln or "registers" in ln
                     or "spill" in ln):
            lines.append(ln.strip())
    regs = [int(m) for ln in lines for m in re.findall(r"Used (\d+) reg", ln)]
    spills = [int(a) + int(b) for ln in lines for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)]
    return lines, max(regs, default=0), max(spills, default=0)


def _stack(form, hw):
    """rwkv4-169m's prepared slab stack in `form`."""
    from repro_torch.core.quant.policy import PlanePolicy
    from repro_torch.core.quant.serving import pack_params
    from repro_torch.models.registry import get_model
    from repro_torch.models.rwkv4 import prepare_fused_model_params
    model = get_model("rwkv4-169m")
    params = model.init_params(SEED, DEV)
    if form == "w8":
        params = pack_params(params)
    elif form == "mixed":
        params = pack_params(params, PlanePolicy(default="w8",
                                                 overrides=MIXED))
    cfg = model.cfg
    return cfg, prepare_fused_model_params(params, cfg, hw=hw)["blocks"]


def _k3_chain(stack):
    """12 K3 launches over the stack's layers, each layer's tree unfused
    once beforehand."""
    from repro_torch.core.quant.serving import unfuse_layer
    from repro_torch.kernels.fused_decode import rwkv4_block_decode
    aux = [a[0] for a in stack.aux]
    layers = []
    for l in range(stack.n_layers):
        lp = unfuse_layer({k: s[l] for k, s in stack.slabs.items()}, aux,
                          stack.manifest, stack.tdef)
        layers.append((lp, lp.pop("_luts", None)))

    def run(st, x):
        new = []
        for l, (lp, luts) in enumerate(layers):
            x, s = rwkv4_block_decode(lp, {k: st[k][l] for k in STATE}, x,
                                      luts=luts)
            new.append(s)
        return x, {k: torch.stack([s[k] for s in new]) for k in STATE}
    return run


def bench_k4(form, hw, flush, reps):
    from repro_torch.kernels.fused_decode import rwkv4_model_decode
    cfg, stack = _stack(form, hw)
    L, D = cfg.n_layers, cfg.d_model
    g = torch.Generator(device=DEV).manual_seed(SEED + 4)
    rn = lambda *s: torch.randn(s, generator=g, device=DEV)
    bf = torch.bfloat16
    x = rn(B, D).to(bf)
    st = {"att_x": rn(L, B, D).to(bf), "ffn_x": rn(L, B, D).to(bf),
          "wkv_a": rn(L, B, D).to(bf),
          "wkv_b": (rn(L, B, D).abs() + 0.5).to(bf),
          "wkv_o": (rn(L, B, D) - 1).to(bf)}
    out, new = rwkv4_model_decode(stack, st, x)
    k3 = _k3_chain(stack)
    out3, new3 = k3(st, x)
    torch.cuda.synchronize()
    outs = [out] + [new[k] for k in STATE]
    row = {"kernel": "rwkv4_model_decode", "form": form,
           "numerics": "hw" if hw else "exact", "L": L, "B": B, "D": D,
           "F": cfg.d_ff,
           "grid": getattr(rwkv4_model_decode, "grid", None),
           "sha256": {name: _sha(t) for name, t in zip(("x",) + STATE,
                                                       outs)},
           "equals_k3x12": torch.equal(out3, out) and all(
               torch.equal(new3[k], new[k]) for k in STATE),
           "ms": _time_ms(lambda: rwkv4_model_decode(stack, st, x), flush,
                          reps),
           "k3x12_ms": _time_ms(lambda: k3(st, x), flush, reps, sleeps=L)}
    row["k3x12_over_k4"] = row["k3x12_ms"] / row["ms"]
    if "grid" in inspect.signature(rwkv4_model_decode).parameters:
        same = True
        for grid in (1, 7):
            o, n = rwkv4_model_decode(stack, st, x, grid=grid)
            same = same and torch.equal(o, out) and all(
                torch.equal(n[k], new[k]) for k in STATE)
        row["grid_equal"] = same
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="this")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_k4: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.build import BUILD_DIR, load_library
    load_library()               # builds the tree's kernels if stale
    lines, regs, spills = _ptxas((BUILD_DIR / "ptxas.log").read_text())
    print(json.dumps({"label": args.label, "ptxas": lines,
                      "max_registers": regs, "max_spill_bytes": spills}),
          flush=True)
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=DEV)
    ok = True
    with torch.no_grad():
        for form, hw in (("mixed", False), ("w8", False), ("bf16", False),
                         ("w8", True)):
            row = bench_k4(form, hw, flush, args.reps)
            ok = ok and row["equals_k3x12"] and row.get("grid_equal", True)
            print(json.dumps({"label": args.label, **row}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
