"""Dry run: count every (arch x shape) cell on meta tensors, on one card.

The port's counterpart of `repro/launch/dryrun.py`, which lowers and
compiles each cell for a 512-device mesh: here each cell's step
(`launch/steps.py:build_step_for_cell`, whose arguments are meta
tensors) runs once under `launch/op_analysis.py`.  Nothing is allocated
and no kernel launches (the wrappers return empty meta outputs), so a
full-size cell counts in seconds on any host.  Each record keeps JAX's
keys where they mean the same thing (`memory` holds the arguments' and
outputs' bytes); `count_s`, the count's own seconds, replaces `lower_s`
and `compile_s`.  The multi-pod mesh and its collective term wait for
the port's meshes (ROADMAP Queue 1 item 10a); archs the port does not
model yet are skipped (item 9).

    python -m repro_torch.launch.dryrun --smoke [--arch A] [--shape S]
        [--rwkv4] [--skip-done]

Records go to `build/dryrun/<cell>.json` in the checkout (gitignored);
the exit code is 1 if any cell errs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs.base import (
    ASSIGNED_ARCHS, RWKV4_ARCHS, SHAPES, get_config, list_configs,
    smoke_config, supported_shapes)
from repro_torch.launch import roofline as RL
from repro_torch.launch.op_analysis import analyze_call
from repro_torch.launch.steps import build_step_for_cell

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
NOT_PORTED = "skip: not ported yet (ROADMAP item 9)"


def run_cell(arch: str, shape_name: str, *, smoke: bool = False,
             save: bool = True, serve_variant: str = "base",
             cfg_overrides: dict | None = None,
             variant_tag: str = "") -> dict:
    """Count one cell: a record with status "ok" (kind, memory,
    roofline), "skip" (reason) or "error" (the exception)."""
    cell_id = f"{arch}__{shape_name}__single"
    if serve_variant != "base":
        cell_id += f"__{serve_variant}"
    if variant_tag:
        cell_id += f"__{variant_tag}"
    if arch not in list_configs():
        rec = {"cell": cell_id, "status": "skip", "reason": NOT_PORTED}
    else:
        support = supported_shapes(get_config(arch))[shape_name]
        rec = ({"cell": cell_id, "status": "skip", "reason": support}
               if support != "ok" else None)
    if rec is None:
        try:
            rec = _count(cell_id, arch, shape_name, smoke, serve_variant,
                         cfg_overrides)
        except Exception as e:  # a failing cell is a bug in the port
            rec = {"cell": cell_id, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
    if save:
        _save(cell_id, rec)
    return rec


def _count(cell_id, arch, shape_name, smoke, serve_variant, cfg_overrides):
    t0 = time.perf_counter()
    step, args, kind = build_step_for_cell(
        arch, shape_name, smoke=smoke, serve_variant=serve_variant,
        cfg_overrides=cfg_overrides)
    metrics = analyze_call(step, *args)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind in ("train", "prefill") else shape.global_batch)
    roof = RL.analyze(metrics, chips=1, model_flops=RL.model_flops_estimate(
        cfg, shape.kind, tokens))
    return {
        "cell": cell_id, "status": "ok", "kind": kind, "arch": arch,
        "shape": shape_name, "mesh": "single", "chips": 1,
        "count_s": round(time.perf_counter() - t0, 1),
        "memory": {"argument_size_in_bytes": metrics.argument_bytes,
                   "output_size_in_bytes": metrics.output_bytes},
        "kernels": metrics.kernels,
        "roofline": roof.as_dict(),
    }


def _save(cell_id: str, rec: dict):
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / f"{cell_id}.json").write_text(json.dumps(rec, indent=1))


def all_cells(include_rwkv4: bool = False):
    archs = list(ASSIGNED_ARCHS) + (RWKV4_ARCHS if include_rwkv4 else [])
    for arch in archs:
        for shape_name in SHAPES:
            yield arch, shape_name


def line(rec: dict) -> str:
    """One cell's line: its bottleneck and the three terms, its skip
    reason or its error."""
    if rec["status"] == "ok":
        r = rec["roofline"]
        return (f"[ok]   {rec['cell']}: bottleneck={r['bottleneck']} "
                f"compute={r['compute_s']:.2e}s memory={r['memory_s']:.2e}s "
                f"coll={r['collective_s']:.2e}s (count {rec['count_s']}s)")
    if rec["status"] == "skip":
        return f"[skip] {rec['cell']}: {rec['reason']}"
    return f"[ERR]  {rec['cell']}: {rec['error']}"


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs (machinery test)")
    ap.add_argument("--rwkv4", action="store_true",
                    help="include the paper's rwkv4-* family")
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells with an existing ok/skip record")
    args = ap.parse_args()

    cells = [(a, s) for a, s in all_cells(args.rwkv4)
             if (args.arch is None or a == args.arch)
             and (args.shape is None or s == args.shape)]
    n = {"ok": 0, "skip": 0, "error": 0}
    for arch, shape_name in cells:
        if args.skip_done:
            p = OUT_DIR / f"{arch}__{shape_name}__single.json"
            if p.exists() and json.loads(p.read_text()).get("status") in (
                    "ok", "skip"):
                continue
        rec = run_cell(arch, shape_name, smoke=args.smoke)
        n[rec["status"]] += 1
        print(line(rec), flush=True)
    print(f"\ndone: {n['ok']} ok, {n['skip']} skip, {n['error']} error")
    raise SystemExit(1 if n["error"] else 0)


if __name__ == "__main__":
    main()
