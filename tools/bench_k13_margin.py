"""How close K13-dq and K13-dkv come to the bound their checks hold them to,
on one CUDA card: for each output of (dq, dk, dv), max |kernel - plain| /
`bwd_bounds` (the bound of `kernels/flash_attention.py`; 0/0 where an
output is 0 with a bound of 0 reads NaN).

The cases are the bf16 ones of `tests/test_torch_cuda.py`'s
`test_flash_attention_bwd` (random inputs, the test's seeds) and of its
`test_flash_attention_dominated_keys` (inputs where a few keys dominate
each row, `_dominated`), then smollm-135m's train shape (B 8, S 2048, H
9, KVH 3, d 64, causal) with dominated and with random inputs.  One JSON
line per case.

`--src` names the `src` directory whose `repro_torch` runs (default: this
checkout's; it must have `bwd_bounds`), so a throwaway copy of the
kernels (another split of p and ds, say) reads against the same cases:

    python tools/bench_k13_margin.py --label two
    python tools/bench_k13_margin.py --src OTHER/src --label one
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _cases(fn):
    return [m for m in fn.pytestmark if m.name == "parametrize"][0].args[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_k13_margin: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT / "tests")]
    import repro_torch
    import test_torch_cuda as T
    from repro_torch.kernels.flash_attention import (
        bwd_bounds, flash_attention, flash_attention_bwd,
        flash_attention_bwd_plain)
    print(json.dumps({"label": args.label,
                      "repro_torch": repro_torch.__file__}), flush=True)
    dev = torch.device("cuda")
    rows = []
    for c in _cases(T.test_flash_attention_bwd):
        B, Sq, Skv, H, KVH, d, causal, dt = c
        if dt != torch.bfloat16:
            continue
        g = torch.Generator(device=dev).manual_seed(Sq + 3 * d)
        rn = lambda *s: torch.randn(s, generator=g, device=dev).to(dt)
        q, k, v = rn(B, Sq, H, d), rn(B, Skv, KVH, d), rn(B, Skv, KVH, d)
        rows.append(("random", c[:7], (q, k, v, rn(B, Sq, H, d)), causal))
    train = (8, 2048, 2048, 9, 3, 64, True)
    for c in _cases(T.test_flash_attention_dominated_keys) + [train]:
        B, Sq, Skv, H, KVH, d, causal = c
        rows.append(("dominated", c, T._dominated(B, Sq, Skv, H, KVH, d,
                                                  Sq + d, dev), causal))
    g = torch.Generator(device=dev).manual_seed(60)
    rn = lambda *s: torch.randn(s, generator=g, device=dev).to(
        torch.bfloat16)
    rows.append(("random", train, (rn(8, 2048, 9, 64), rn(8, 2048, 3, 64),
                                   rn(8, 2048, 3, 64), rn(8, 2048, 9, 64)),
                 True))
    for kind, c, (q, k, v, do), causal in rows:
        o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        ref = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
        r = {}
        for n, x, w, b in zip(("dq", "dk", "dv"), got, ref, bwd_bounds(
                q, k, v, o, lse, do, causal, ref)):
            r[n] = round(float(((x.float() - w.float()).abs() / b).max()),
                         4)
        print(json.dumps({"label": args.label, "inputs": kind,
                          "case": list(c), "err_over_bound": r}), flush=True)
        del o, lse, got, ref
    return 0


if __name__ == "__main__":
    sys.exit(main())
