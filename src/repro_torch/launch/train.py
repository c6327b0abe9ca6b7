"""Training launcher: the train step over the synthetic data pipeline,
with async checkpoints (port of `repro/launch/train.py` on one device,
without a mesh).

    python -m repro_torch.launch.train --arch rwkv4-169m --smoke \
        --steps 2 [--batch 8] [--seq 128] [--device cuda|cpu] \
        [--ckpt-dir DIR]

rwkv4 trains with its WKV through K2 and K2-bwd, its LayerNorms through
K11 and K11-bwd; every model's loss goes through K12 and K12-bwd; the
dense transformers' attention through K13 and its backward when the
model's cfg has use_flash_kernel (call `train_model` on such a model, or
build the step with `build_step_for_cell(..., cfg_overrides=
{"use_flash_kernel": True})`).  rwkv6 trains on the CPU only: on the card
K10 and K6 have no backward yet.  With `ckpt_dir` the params are saved
every `ckpt_every` steps and, with `resume`, restored from the latest
committed step, as JAX's launcher does (the optimizer state starts
fresh); the CLI saves every 50 steps, as JAX's does.  The device
defaults to "cuda" and raises without a GPU.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import (
    AsyncCheckpointer, latest_step, restore_checkpoint)
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_train_step
from repro_torch.models.registry import get_model
from repro_torch.runtime import StragglerDetector


def train(arch: str, *, smoke: bool = True, **kw):
    return train_model(get_model(arch, smoke=smoke), **kw)


def train_model(model, *, steps: int = 100, global_batch: int = 8,
                seq_len: int = 128, seed: int = 0,
                ckpt_dir: str | None = None, ckpt_every: int = 50,
                log_every: int = 10, resume: bool = True, device="cuda"):
    """Train steps `start .. steps - 1` from seeded weights on `SyntheticLM`
    batches, where start is 0 or, with `ckpt_dir` and `resume`, the latest
    committed step (its params restored).  Returns {"losses", "wall_s",
    "params", "step_s"}: `step_s` holds each step's seconds, the batch's
    transfer included, up to the loss read back on the host."""
    device = resolve_device(device)
    cfg = model.cfg
    shape = ShapeConfig("custom", seq_len, global_batch, "train")
    step_fn, _, (init_opt, _) = build_train_step(model, shape)
    params = model.init_params(seed, device)
    start_step, ckpt = 0, None
    if ckpt_dir:
        ckpt = AsyncCheckpointer(ckpt_dir)
        last = latest_step(ckpt_dir) if resume else None
        if last is not None:
            params = restore_checkpoint(ckpt_dir, last, params)
            start_step = last
            print(f"resumed from step {last}")
    opt_state = init_opt(params)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=seq_len,
                     global_batch=global_batch, seed=seed)
    losses, step_s = [], []
    detector = StragglerDetector([0])
    t_start = time.time()
    for step in range(start_step, steps):
        t0 = time.time()
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in ds.batch(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        losses.append(loss)
        step_s.append(dt)
        detector.record(0, dt)
        if step % log_every == 0 or step == steps - 1:
            tok_s = global_batch * seq_len / max(dt, 1e-9)
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"{dt*1e3:6.1f} ms/step  {tok_s:,.0f} tok/s", flush=True)
        if ckpt and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, params)
    if ckpt:
        ckpt.wait()
    wall = time.time() - t_start
    return {"losses": losses, "wall_s": wall, "params": params,
            "step_s": step_s}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv4-169m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = train(args.arch, smoke=args.smoke, steps=args.steps,
                global_batch=args.batch, seq_len=args.seq,
                ckpt_dir=args.ckpt_dir, device=args.device)
    print(f"final loss {out['losses'][-1]:.4f}  "
          f"wall {out['wall_s']:.1f}s")


if __name__ == "__main__":
    main()
