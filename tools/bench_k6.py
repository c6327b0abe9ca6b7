"""Time K6 (`wkv6_seq`, the sequential RWKV-6 WKV of the prefill chunk) of
the PyTorch port on one CUDA card, on this tree and, with `--parent`, on
another tree in the same call, and print hashes of every output so that
the two trees' bits can be compared.

The cases, at rwkv6-7b's heads (H 64, N 64), random operands from the seed
(not the model's):
  prefill        B8 T16, prefix masks, a bf16 pool state, the bf16 carry:
                 `chip_smoke.py:phase_k6`'s operands
  forward        B2 T40, r, k, v widened from bf16, the zero f32 state, no
                 mask, the f32 carry (the forward's call at S 40)
then the sweep in the prefill's form with every step valid: T 4, 16 and
64 at B8, and B 1, 8 and 16 at T16 (how the time grows with T and B);
then K6-bwd (`wkv6_seq_bwd`) at the S 40 train step's shape, B2 T40,
`forward`'s operands and a N(0, 1) output gradient (`train-bwd`: its
bound `chip_smoke.py:phase_k6_bwd`'s, hashes of its five outputs).
`prefill-f32carry` is the prefill without the bf16 snap (what the snap
costs).  Each case is timed as `chip_smoke.py` times it
(L2 flushed, the host hidden behind a device sleep, CUDA events, mean of
`--reps`) beside its bound (`chip_smoke.py:_k6_bound`: the function's bytes
at 3.35 TB/s, or its 7 f32 operations a term at 67 TFLOP/s); each row
carries a SHA-256 of y and of the final state.  `chip_smoke.py` is loaded
by path from this checkout, so another tree is timed and bounded alike.
The build's ptxas lines of `csrc/wkv6_seq.cu` and `csrc/wkv6_seq_bwd.cu`
(registers, spills), the
`nvidia-smi` name and power limit, and the SM clocks are printed first.
One JSON line per case.  `--sass FILE` writes the SASS of the tree's K6
instances (`cuobjdump`) to FILE and prints each instance's instruction
counts by opcode.

With `--parent OTHER/src` the tool runs itself four times, one process a
tree, in the order parent, change, change, parent (`tools/bench_k2.py`'s
runner, loaded by path), then prints each case's mean time per tree,
their ratio, and whether the trees' hashes agree:

    python tools/bench_k6.py --parent build/parent/src
    python tools/bench_k6.py --src OTHER/src --label other --sass out.sass
"""
from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
DEV = "cuda"
H, N = 64, 64
SWEEP = ((8, 4), (8, 16), (8, 64), (1, 16), (16, 16))   # (B, T)


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _forward_operands(B, T, seed):
    g = torch.Generator(device=DEV).manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=DEV)
    bf = lambda t: t.to(torch.bfloat16).float()
    return (bf(rn(B, T, H, N)), bf(rn(B, T, H, N)), bf(rn(B, T, H, N)),
            torch.exp(-torch.exp(0.5 * rn(B, T, H, N))), 0.5 * rn(H, N),
            torch.zeros((B, H, N, N), device=DEV)), {}


def bench_case(smoke, k2, flush, reps, name, args, kw):
    from repro_torch.kernels.wkv6 import wkv6_seq
    y, sf = wkv6_seq(*args, **kw)
    torch.cuda.synchronize()
    B, T = args[0].shape[:2]
    s0_bytes = args[5].element_size()
    _, bms, by = smoke._k6_bound(B, T, H, N, s0_bytes, "valid" in kw)
    ms = smoke._time_ms(lambda: wkv6_seq(*args, **kw), flush, reps)
    return {"case": name, "B": B, "T": T, "H": H, "N": N,
            "ms": ms, "bound_ms": bms, "bound_by": by,
            "us_per_step": 1e3 * ms / T, "terms": B * T * H * N * N,
            "sha256": {"y": k2._sha(y), "S": k2._sha(sf)}}


def bench_bwd(smoke, k2, flush, reps, args):
    """K6-bwd on the forward case's operands with a seeded output
    gradient, beside its bound (14 operations a term, as
    `chip_smoke.py:phase_k6_bwd` counts them)."""
    from repro_torch.kernels.wkv6 import wkv6_seq_bwd
    r, k, v, w, u, s0 = args
    B, T = r.shape[:2]
    dy = torch.randn(r.shape, device=DEV,
                     generator=torch.Generator(device=DEV).manual_seed(
                         SEED + 94))
    out = wkv6_seq_bwd(r, k, v, w, u, s0, dy)
    torch.cuda.synchronize()
    bms, by = smoke._bound(9 * 4 * B * T * H * N, 14.0 * B * T * H * N * N,
                           smoke.PEAK_F32_FLOPS)
    return {"case": "train-bwd", "B": B, "T": T, "H": H, "N": N,
            "ms": smoke._time_ms(lambda: wkv6_seq_bwd(r, k, v, w, u, s0, dy),
                                 flush, reps),
            "bound_ms": bms, "bound_by": by,
            "sha256": {n: k2._sha(t) for n, t in zip(
                ("dr", "dk", "dv", "dw", "du"), out)}}


def _sass(lib: Path, out: Path):
    """The SASS of every wkv6_seq_kernel instance into `out`; per
    instance, its instruction count by opcode."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    keep, lines, counts, fn = False, [], {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            keep = "wkv6_seq_kernel" in fn
            if keep:
                counts[fn] = collections.Counter()
        if keep:
            lines.append(ln)
            op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                           ln)
            if op:
                counts[fn][op.group(1)] += 1
    out.write_text("\n".join(lines) + "\n")
    return {f: dict(c.most_common()) for f, c in counts.items()}


def run_tree(args) -> int:
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.build import BUILD_DIR, LIB_NAME, load_library
    load_library()               # builds the tree's kernels if stale
    k2 = _load("_bench_k6_k2", ROOT / "tools" / "bench_k2.py")
    smoke = _load("_bench_k6_smoke", ROOT / "chip_smoke.py")
    lines, regs, spills = k2._ptxas((BUILD_DIR / "ptxas.log").read_text(),
                                    ("wkv6_seq.cu", "wkv6_seq_bwd.cu"))
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"label": args.label, "card": k2._card(),
                      "clocks_sm_now_max": clocks.stdout.strip(),
                      "ptxas": lines, "max_registers": regs,
                      "max_spill_bytes": spills}), flush=True)
    if args.sass:
        print(json.dumps({"label": args.label, "sass_counts": _sass(
            BUILD_DIR / LIB_NAME, Path(args.sass))}), flush=True)
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=DEV)
    prefill = smoke._k6_operands(8, 16, H, N, smoke.SEED + 8,
                                 smoke.K6_PREFIXES)
    forward = _forward_operands(2, 40, SEED + 40)
    f32carry = (prefill[0], {"valid": prefill[1]["valid"]})
    cases = (("prefill", prefill), ("prefill-f32carry", f32carry),
             ("forward", forward))
    rows = []
    with torch.no_grad():
        for name, (a, kw) in cases:
            rows.append(bench_case(smoke, k2, flush, args.reps, name, a, kw))
        for B, T in SWEEP:
            a, kw = smoke._k6_operands(B, T, H, N, SEED + 100 + B * T)
            rows.append(bench_case(smoke, k2, flush, args.reps,
                                   f"sweep-b{B}-t{T}", a, kw))
        rows.append(bench_bwd(smoke, k2, flush, args.reps, forward[0]))
    for row in rows:
        print(json.dumps({"label": args.label, **row}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--parent", default=None,
                    help="another tree's src: run parent, change, change, "
                         "parent")
    ap.add_argument("--label", default="this")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", default=None,
                    help="write this tree's K6 SASS here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_k6: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if args.parent:
        k2 = _load("_bench_k6_k2", ROOT / "tools" / "bench_k2.py")
        return k2.run_ab(args, script=__file__)
    return run_tree(args)


if __name__ == "__main__":
    sys.exit(main())
