"""Time K10 (`wkv6_chunked_kernel`, the chunked WKV-6 of the PyTorch
port's RWKV-6 forward) on one CUDA card, on this tree and, with
`--parent`, on another tree in the same call, and hold each to its plain
version.

The cases: rwkv6-7b's shape at B1 T32768 H64 N64 with the forward's types
(bf16 r, k, v; f32 w = exp(-exp(0.5·z)); u and no initial state; random
operands from the seed, not the model's), then every shape of
`chip_smoke.py:K10_SHAPES`.  Each is timed as `chip_smoke.py` times it (L2
flushed, the host hidden behind a device sleep, CUDA events, mean of
`--reps`), checked against `wkv6_chunked_plain` under
`chip_smoke.py:_k10_bound` (`ok`; `err_per_bound`: the largest |kernel -
plain| over its bound), and run twice at the first shape (`repeatable`: the
same bits).  `bound_ms` and its parts are `chip_smoke.py:_k10_bound_ms`'s
(bytes, or the two-level form's operations; the one-level figure beside
it as `one_level_f32_bound_ms`).  `chip_smoke.py` is
loaded by path from this checkout, so another tree is held to the same
bound and shapes.  The build's ptxas lines of `csrc/wkv6_chunked.cu`
(registers, spills) and the `nvidia-smi` name and power limit are printed
first.  One JSON line per case.

With `--parent OTHER/src` the tool runs itself four times, one process a
tree, in the order parent, change, change, parent, then prints each case's
mean time per tree and their ratio:

    python tools/bench_k10.py --parent build/parent/src
    python tools/bench_k10.py --src OTHER/src --label other
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
DEV = "cuda"
TIMED = (1, 32768, 64, 64, False, 0.0, True)


def _smoke():
    """This checkout's chip_smoke.py as a module (its K10 shapes, bound and
    cost)."""
    spec = importlib.util.spec_from_file_location(
        "_bench_k10_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ptxas(log: str):
    """The ptxas lines of the kernels in wkv6_chunked.cu, and the most
    registers and spill bytes among them."""
    keep, lines = False, []
    for ln in log.splitlines():
        if ln.startswith("== "):
            keep = ln.strip() == "== wkv6_chunked.cu"
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


def _operands(case, i):
    B, T, H, N, with_s0, shift, bf = case
    g = torch.Generator(device=DEV).manual_seed(SEED + 60 + i)
    rn = lambda *s: torch.randn(s, generator=g, device=DEV)
    dt = torch.bfloat16 if bf else torch.float32
    r, k, v = (rn(B, T, H, N).to(dt) for _ in range(3))
    w = torch.exp(-torch.exp(0.5 * rn(B, T, H, N) + shift))
    s0 = rn(B, H, N, N) if with_s0 else None
    return r, k, v, w, 0.5 * rn(H, N), s0


def bench(case, i, smoke, flush, reps):
    from repro_torch.kernels.wkv6 import (
        wkv6_chunked_kernel, wkv6_chunked_plain)
    ops_ = _operands(case, i)
    y, S = wkv6_chunked_kernel(*ops_)
    torch.cuda.synchronize()
    y_p, S_p = wkv6_chunked_plain(*ops_)
    by, bS, rel = smoke._k10_bound(*ops_)
    dy, dS = (y - y_p).abs(), (S - S_p).abs()
    row = {"case": list(case), "ok": bool((dy <= by).all())
           and bool((dS <= bS).all()) and bool(torch.isfinite(y).all()),
           "err_per_bound": float(torch.maximum(
               (dy / by.clamp(min=1e-30)).max(),
               (dS / bS.clamp(min=1e-30)).max())),
           "max_abs_err": float(torch.maximum(dy.max(), dS.max())),
           **smoke._k10_bound_ms(ops_[0], ops_[2], ops_[3], ops_[5]),
           "ms": smoke._time_ms(lambda: wkv6_chunked_kernel(*ops_), flush,
                                reps)}
    if i == 0:
        y2, S2 = wkv6_chunked_kernel(*ops_)
        row["repeatable"] = torch.equal(y, y2) and torch.equal(S, S2)
    return row


def run_tree(args) -> int:
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.build import BUILD_DIR, load_library
    load_library()               # builds the tree's kernels if stale
    lines, regs, spills = _ptxas((BUILD_DIR / "ptxas.log").read_text())
    print(json.dumps({"label": args.label, "card": _card(), "ptxas": lines,
                      "max_registers": regs, "max_spill_bytes": spills}),
          flush=True)
    smoke = _smoke()
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=DEV)
    ok = True
    with torch.no_grad():
        for i, case in enumerate((TIMED,) + tuple(smoke.K10_SHAPES)):
            row = bench(case, i, smoke, flush, args.reps)
            ok = ok and row["ok"] and row.get("repeatable", True)
            print(json.dumps({"label": args.label, **row}), flush=True)
    return 0 if ok else 1


def run_ab(args) -> int:
    """parent, change, change, parent: one process a run; then each case's
    mean per tree."""
    order = (("parent", args.parent), ("change", args.src),
             ("change", args.src), ("parent", args.parent))
    times, rc = {}, 0
    for label, src in order:
        out = subprocess.run(
            [sys.executable, __file__, "--src", src, "--label", label,
             "--reps", str(args.reps)], capture_output=True, text=True)
        sys.stdout.write(out.stdout)
        sys.stderr.write(out.stderr[-4000:])
        rc = rc or out.returncode
        for ln in out.stdout.splitlines():
            row = json.loads(ln)
            if "ms" in row:
                times.setdefault(tuple(row["case"]), {}).setdefault(
                    label, []).append(row["ms"])
    for case, t in times.items():
        mean = {k: sum(v) / len(v) for k, v in t.items()}
        print(json.dumps({"case": list(case), "runs_ms": t, "mean_ms": mean,
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
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_k10: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    return run_ab(args) if args.parent else run_tree(args)


if __name__ == "__main__":
    sys.exit(main())
