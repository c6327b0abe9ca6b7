"""Time K2 (`wkv4_seq`, the RWKV-4 WKV sequence) and K2-bwd
(`wkv4_seq_bwd`, its backward) of the PyTorch port on one CUDA card, on
this tree and, with `--parent`, on another tree in the same call, and print
hashes of every output so that the two trees' bits can be compared.

The cases, at rwkv4-169m's width (C 768) and B 8, random operands from the
seed (not the model's):
  k2-t16-masked   T 16, prefix masks, the bf16 carry, a bf16 pool state
                  (the serving chunk, as `chip_smoke.py:phase_k2`)
  k2-t1024        T 1024 from the zero state, exact (the forward's call)
  k2-t1024-hw     the same under the LUT tables
  k2bwd-t1024     K2-bwd at T 1024 from the zero state, N(0, 1) output
                  gradient (the train step's call)
then the sweep: K2 exact from the zero state at T 1024 for B 1, 8 and 16,
and at T 256, 512 and 1024 for B 8 (how the time grows with T and B).
Each is timed as `chip_smoke.py` times it (L2 flushed, the host hidden
behind a device sleep, CUDA events, mean of `--reps`) beside its bound
(`chip_smoke.py:_bound`: the function's bytes at 3.35 TB/s or its f32
operations at 67 TFLOP/s, as `phase_k2` and `phase_k2_bwd` count them);
each case row carries a SHA-256 of every output.  `chip_smoke.py` is loaded
by path from this checkout, so another tree is timed and bounded alike.
The build's ptxas lines of `csrc/wkv4_seq.cu` and `csrc/wkv4_bwd.cu`
(registers, spills) and the `nvidia-smi` name and power limit are printed
first.  One JSON line per case.

With `--parent OTHER/src` the tool runs itself four times, one process a
tree, in the order parent, change, change, parent, then prints each case's
mean time per tree, their ratio, and whether the trees' hashes agree:

    python tools/bench_k2.py --parent build/parent/src
    python tools/bench_k2.py --src OTHER/src --label other
"""
from __future__ import annotations

import argparse
import hashlib
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
C = 768
SWEEP = ((1, 1024), (8, 1024), (16, 1024), (8, 256), (8, 512))


def _smoke():
    """This checkout's chip_smoke.py as a module (its timer and bound)."""
    spec = importlib.util.spec_from_file_location(
        "_bench_k2_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ptxas(log: str, sources=("wkv4_seq.cu", "wkv4_bwd.cu")):
    """The ptxas lines of the kernels in `sources` (K2's and K2-bwd's by
    default), and the most registers and spill bytes among them."""
    keep, lines = False, []
    for ln in log.splitlines():
        if ln.startswith("== "):
            keep = ln.strip()[3:] in sources
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


def _sha(t) -> str:
    raw = t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()


def _operands(B, T, seed, masked):
    """K2's operands: the zero state (the forward's), or under `masked` a
    bf16 pool state and prefix masks with the bf16 carry."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=DEV)
    k, v = rn(B, T, C), rn(B, T, C)
    w, u = torch.exp(0.5 * rn(C)), 0.5 * rn(C)
    if not masked:
        z = torch.zeros((B, C), device=DEV)
        return (k, v, w, u, z, z.clone(), torch.full_like(z, -1e38)), {}
    bf = lambda t: t.to(torch.bfloat16).float()
    state = (bf(rn(B, C)), bf(rn(B, C).abs() + 0.5), bf(rn(B, C) - 1))
    valid = torch.zeros((B, T), dtype=torch.bool, device=DEV)
    for i, n in enumerate((16, 9, 0, 1, 16, 5, 12, 16)[:B]):
        valid[i, :n] = True
    return (k, v, w, u) + state, {"valid": valid, "carry_dtype": "bfloat16"}


def bench_k2(smoke, flush, reps, name, B, T, masked=False, hw=False):
    from repro_torch.core.approx.units import lut_tensor
    from repro_torch.kernels.wkv4 import wkv4_seq
    args, kw = _operands(B, T, SEED + 2 + T, masked)
    if hw:
        kw = {**kw, "exp_table": lut_tensor("exp", DEV),
              "div_table": lut_tensor("div", DEV)}
    y, fin = wkv4_seq(*args, **kw)
    torch.cuda.synchronize()
    nbytes = 4 * (3 * B * T * C + 2 * C + 6 * B * C) + (
        4 * B * T if masked else 0) + (2048 if hw else 0)
    bms, by = smoke._bound(nbytes, (40.0 if hw else 20.0) * B * T * C,
                           smoke.PEAK_F32_FLOPS)
    ms = smoke._time_ms(lambda: wkv4_seq(*args, **kw), flush, reps)
    return {"case": name, "B": B, "T": T, "C": C, "ms": ms, "bound_ms": bms,
            "bound_by": by, "us_per_step": 1e3 * ms / T,
            "sha256": {n: _sha(t) for n, t in zip("yabo", (y, *fin))}}


def bench_k2_bwd(smoke, flush, reps, B=8, T=1024):
    from repro_torch.kernels.wkv4 import wkv4_seq_bwd
    g = torch.Generator(device=DEV).manual_seed(SEED + 91)
    rn = lambda *s: torch.randn(s, generator=g, device=DEV)
    k, v, gy = 2 * rn(B, T, C), rn(B, T, C), rn(B, T, C)
    w, u = torch.exp(0.5 * rn(C) - 1), rn(C)
    z = torch.zeros((B, C), device=DEV)
    ops_ = (k, v, w, u, z, z.clone(), torch.full_like(z, -1e38), gy)
    out = wkv4_seq_bwd(*ops_)
    again = wkv4_seq_bwd(*ops_)
    torch.cuda.synchronize()
    bms, by = smoke._bound(4 * (5 * B * T * C + 4 * C), 60.0 * B * T * C,
                           smoke.PEAK_F32_FLOPS)
    ms = smoke._time_ms(lambda: wkv4_seq_bwd(*ops_), flush, reps)
    return {"case": "k2bwd-t1024", "B": B, "T": T, "C": C, "ms": ms,
            "bound_ms": bms, "bound_by": by, "us_per_step": 1e3 * ms / T,
            "repeatable": all(torch.equal(a, b) for a, b in zip(out, again)),
            "sha256": {n: _sha(t) for n, t in zip(("gk", "gv", "gw", "gu"),
                                                   out)}}


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
    rows = []
    with torch.no_grad():
        rows.append(bench_k2(smoke, flush, args.reps, "k2-t16-masked", 8,
                             16, masked=True))
        rows.append(bench_k2(smoke, flush, args.reps, "k2-t1024", 8, 1024))
        rows.append(bench_k2(smoke, flush, args.reps, "k2-t1024-hw", 8,
                             1024, hw=True))
        rows.append(bench_k2_bwd(smoke, flush, args.reps))
        for B, T in SWEEP:
            row = bench_k2(smoke, flush, args.reps, f"sweep-b{B}-t{T}", B, T)
            del row["sha256"]
            rows.append(row)
    for row in rows:
        print(json.dumps({"label": args.label, **row}), flush=True)
    return 0 if all(r.get("repeatable", True) for r in rows) else 1


def run_ab(args, script=__file__) -> int:
    """parent, change, change, parent: one process of `script` a run; then
    each case's mean per tree and whether the trees' hashes agree."""
    order = (("parent", args.parent), ("change", args.src),
             ("change", args.src), ("parent", args.parent))
    times, shas, rc = {}, {}, 0
    for label, src in order:
        out = subprocess.run(
            [sys.executable, script, "--src", src, "--label", label,
             "--reps", str(args.reps)], capture_output=True, text=True)
        sys.stdout.write(out.stdout)
        sys.stderr.write(out.stderr[-4000:])
        rc = rc or out.returncode
        for ln in out.stdout.splitlines():
            row = json.loads(ln)
            if "ms" in row:
                times.setdefault(row["case"], {}).setdefault(
                    label, []).append(row["ms"])
            if "sha256" in row:
                shas.setdefault(row["case"], {}).setdefault(
                    label, []).append(row["sha256"])
    for case, t in times.items():
        mean = {k: sum(v) / len(v) for k, v in t.items()}
        h = shas.get(case, {})
        same = None
        if h:
            runs = [s for v in h.values() for s in v]
            same = {n: all(r[n] == runs[0][n] for r in runs)
                    for n in runs[0]}
        print(json.dumps({"case": case, "runs_ms": t, "mean_ms": mean,
                          "parent_over_change": mean.get("parent", 0.0)
                          / mean["change"] if "change" in mean else None,
                          "bits_equal": same}), flush=True)
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
        print("bench_k2: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    return run_ab(args) if args.parent else run_tree(args)


if __name__ == "__main__":
    sys.exit(main())
