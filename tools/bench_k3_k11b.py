"""Time K3 (`rwkv4_block_decode`) and K11-bwd (`fused_layernorm_bwd`) of
the PyTorch port on one CUDA card, and print hashes of K3's outputs.

K3 runs on layer 0 of rwkv4-169m (random weights from the seed, packed
W8, or MIXED: W4 att.wk, VQ ffn.wv, W8 elsewhere, or plain bf16), B 8,
under the exact numerics (W8, MIXED, bf16) and the hardware numerics
(W8 with the EXP and DIV tables); per form a SHA-256 of the output x and
of the five new state leaves, which a run on another tree must print
unchanged where K3 keeps its bits, and its time as `chip_smoke.py` takes
it (L2 flushed, the host hidden behind a device sleep, CUDA events, mean
of `--reps`).  Where the tree's K3 takes `grid=`, each form runs again on
grids of 1 and 7 blocks: `grid_equal` says whether every output is the
full grid's bit for bit.  K11-bwd runs at (8192, 768) bf16 (rwkv4-169m's
ln1 rows in its train step; x = 2·N(0, 1) + 0.5, γ, β and dy N(0, 1)),
twice (`bit_repeat`), timed beside `F.layer_norm`'s autograd backward on
the same operands.  The build's ptxas lines of both kernels' instances
are printed first, with the most registers and spill bytes among them.
One JSON line per case.

`--src` names the `src` directory whose `repro_torch` is timed (default:
this checkout's), so one process per tree compares two versions of the
port on the same card:

    python tools/bench_k3_k11b.py --label change
    python tools/bench_k3_k11b.py --src OTHER/src --label parent
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
LN_SHAPE = (8192, 768)
# the MIXED plane policy of chip_smoke.py
MIXED = ((r"\['att'\]\['wk'\]", "w4"), (r"\['ffn'\]\['wv'\]", "vq"),
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


def _sha(t) -> str:
    raw = t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()


def _ptxas(log: str):
    """The ptxas lines of K3's and K11-bwd's instances, and the most
    registers and spill bytes among them."""
    keep, lines = False, []
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            keep = ("rwkv4_block_decode" in ln
                    or "layernorm_bwd" in ln)
        if keep and ("Compiling entry" in ln or "registers" in ln
                     or "spill" in ln):
            lines.append(ln.strip())
    regs = [int(m) for ln in lines for m in re.findall(r"Used (\d+) reg", ln)]
    spills = [int(a) + int(b) for ln in lines for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)]
    return lines, max(regs, default=0), max(spills, default=0)


def _layer0(form):
    """Layer 0 of rwkv4-169m's compute-cast tree in `form`."""
    from repro_torch.core.quant.policy import PlanePolicy
    from repro_torch.core.quant.serving import (
        broadcast_packed_scales, cast_compute, pack_params)
    from repro_torch.models.registry import get_model
    from repro_torch.models.rwkv4 import _layer
    model = get_model("rwkv4-169m")
    params = model.init_params(SEED, DEV)
    if form == "w8":
        params = pack_params(params)
    elif form == "mixed":
        params = pack_params(params, PlanePolicy(default="w8",
                                                 overrides=MIXED))
    cfg = model.cfg
    blocks = broadcast_packed_scales(
        cast_compute(params, torch.bfloat16)["blocks"], cfg.n_layers)
    return cfg, _layer(blocks, 0)


def bench_k3(form, hw, flush, reps):
    from repro_torch.kernels.fused_decode import rwkv4_block_decode
    cfg, lp = _layer0(form)
    D = cfg.d_model
    g = torch.Generator(device=DEV).manual_seed(SEED + 3)
    rn = lambda: torch.randn((B, D), generator=g, device=DEV)
    bf = torch.bfloat16
    x = rn().to(bf)
    st = {"att_x": rn().to(bf), "ffn_x": rn().to(bf),
          "wkv_a": rn().to(bf), "wkv_b": (rn().abs() + 0.5).to(bf),
          "wkv_o": (rn() - 1).to(bf)}
    kw = {}
    if hw:
        from repro_torch.core.approx.units import lut_tensor
        kw["luts"] = {"exp": lut_tensor("exp", DEV),
                      "div": lut_tensor("div", DEV)}
    out, new = rwkv4_block_decode(lp, st, x, **kw)
    torch.cuda.synchronize()
    outs = [out] + [new[k] for k in sorted(new)]
    row = {"kernel": "rwkv4_block_decode", "form": form,
           "numerics": "hw" if hw else "exact", "B": B, "D": D,
           "F": cfg.d_ff,
           "sha256": {name: _sha(t) for name, t in
                      zip(["x"] + sorted(new), outs)},
           "ms": _time_ms(lambda: rwkv4_block_decode(lp, st, x, **kw),
                          flush, reps)}
    if "grid" in inspect.signature(rwkv4_block_decode).parameters:
        same = True
        for grid in (1, 7):
            o, n = rwkv4_block_decode(lp, st, x, grid=grid, **kw)
            same = same and torch.equal(o, out) and all(
                torch.equal(n[k], new[k]) for k in new)
        row["grid_equal"] = same
    return row


def bench_k11b(flush, reps):
    import torch.nn.functional as F
    from repro_torch.kernels.fused_layernorm import fused_layernorm_bwd
    R, D = LN_SHAPE
    g = torch.Generator(device=DEV).manual_seed(SEED + 92)
    rn = lambda *s: torch.randn(s, generator=g, device=DEV)
    bf = torch.bfloat16
    x = (2 * rn(R, D) + 0.5).to(bf)
    gamma, beta, dy = rn(D).to(bf), rn(D).to(bf), rn(R, D).to(bf)
    got = fused_layernorm_bwd(x, gamma, beta, dy)
    again = fused_layernorm_bwd(x, gamma, beta, dy)
    ins = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    out = F.layer_norm(ins[0], (D,), ins[1], ins[2], 1e-5)
    return {"kernel": "fused_layernorm_bwd", "R": R, "D": D,
            "dtype": "bfloat16",
            "bit_repeat": all(torch.equal(a, b) for a, b in zip(got, again)),
            "sha256": {n: _sha(t) for n, t in zip(("dx", "dgamma", "dbeta"),
                                                   got)},
            "ms": _time_ms(lambda: fused_layernorm_bwd(x, gamma, beta, dy),
                           flush, reps),
            "library_ms": _time_ms(lambda: torch.autograd.grad(
                out, ins, dy, retain_graph=True), flush, reps)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="this")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_k3_k11b: torch.cuda.is_available() is False",
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
        for form, hw in (("w8", False), ("mixed", False), ("bf16", False),
                         ("w8", True)):
            row = bench_k3(form, hw, flush, args.reps)
            ok = ok and row.get("grid_equal", True)
            print(json.dumps({"label": args.label, **row}), flush=True)
    row = bench_k11b(flush, args.reps)     # autograd on: F.layer_norm's
    ok = ok and row["bit_repeat"]
    print(json.dumps({"label": args.label, **row}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
