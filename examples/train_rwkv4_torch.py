"""End-to-end run of the PyTorch/CUDA port: train a ~100M-class RWKV-4
for a few hundred steps on the synthetic pipeline, with checkpoints and
the fault-tolerance drill (port of `examples/train_rwkv4.py`).

    PYTHONPATH=src python examples/train_rwkv4_torch.py [--steps 300]
        [--batch 16] [--seq 128] [--full-169m] [--drill]
        [--device cuda|cpu] [--ckpt-dir DIR] [--ckpt-every K]

The default model is `rwkv4-mini` (L6 D384 F1536 V8192, f32, no remat;
built here, nothing downloaded); --full-169m trains the paper's 169M
config.  On the card the step runs K2, K2-bwd, K11, K11-bwd, K12 and
K12-bwd.

--drill runs the steps under `TrainingSupervisor`: each step trains and
every K steps the params are checkpointed; a `HostFailure` fires at 60%
of the run, the supervisor restores the latest committed checkpoint
(`latest_step`; the optimizer starts fresh, as the launcher's resume
does) and resumes there.  The restored params must equal the committed
ones bit for bit.  Then `train_model` resumes from the same checkpoint
and its final params are compared with the supervised run's, both runs
under deterministic algorithms.

Checkpoints go to DIR (default `build/train_rwkv4_torch/` in the
checkout, cleared first); a given DIR must hold no checkpoint yet.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import sys
import time
from pathlib import Path

import torch

from repro_torch.checkpoint import (
    AsyncCheckpointer, latest_step, restore_checkpoint)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_train_step
from repro_torch.launch.train import train_model
from repro_torch.models.registry import get_model
from repro_torch.runtime import FailureInjector, TrainingSupervisor
from repro_torch.tree import leaves_with_path, tree_map

ROOT = Path(__file__).resolve().parents[1]

CFG_100M = ModelConfig(          # ~15M params: 100M-class structure
    name="rwkv4-mini", family="rwkv",
    n_layers=6, d_model=384, n_heads=1, n_kv_heads=1,
    d_ff=1536, vocab=8192, norm="layernorm", rwkv_version=4, remat=False,
    dtype="float32",
)
DEFAULT_CKPT_DIR = ROOT / "build" / "train_rwkv4_torch"
_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


@contextlib.contextmanager
def deterministic():
    """`torch.use_deterministic_algorithms` inside the block, the process's
    settings restored after: the embedding's gradient (an `index_put_`
    that accumulates) otherwise sums in an order that varies from run to
    run, on the card's atomics and on the CPU's threads, and the resumed
    run could not equal the supervised one bit for bit.  cuBLAS takes its
    workspace setting for its part."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env


def tree_bits_equal(a, b) -> bool:
    """Whether two trees of tensors hold the same paths and the same bits."""
    fa, fb = leaves_with_path(a), leaves_with_path(b)
    if [p for p, _ in fa] != [p for p, _ in fb]:
        return False
    for (_, x), (_, y) in zip(fa, fb):
        x, y = x.detach().cpu(), y.detach().cpu()
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        view = _BITS.get(x.dtype)
        if not torch.equal(x.view(view) if view else x,
                           y.view(view) if view else y):
            return False
    return True


def run_drill(model, *, steps: int, batch: int, seq: int, ckpt_dir,
              ckpt_every: int, device="cuda", seed: int = 0) -> dict:
    """The supervised run: `steps` train steps under TrainingSupervisor, a
    HostFailure injected at 60% of the run, a restore from the latest
    committed checkpoint (params; a fresh optimizer) and the rest of the
    run.  The checkpoint restored is also copied to `ckpt_dir/resume/`,
    for `resume_run`.  Returns the supervisor's log and restarts, the
    step it ended at, the restored step and whether the restored params
    equal the committed ones bit for bit, the losses in the order the
    steps ran, the final params and the seconds."""
    device = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    if latest_step(str(ckpt_dir)) is not None:
        raise ValueError(f"{ckpt_dir} already holds checkpoints")
    step_fn, _, (init_opt, _) = build_train_step(
        model, ShapeConfig("drill", seq, batch, "train"))
    ds = SyntheticLM(vocab=model.cfg.vocab, seq_len=seq, global_batch=batch,
                     seed=seed)
    fail_at = int(steps * 0.6)
    injector = FailureInjector({fail_at: [3]})
    ckpt = AsyncCheckpointer(str(ckpt_dir))
    st = {"params": model.init_params(seed, device), "saved": None}
    st["opt"] = init_opt(st["params"])
    out = {"fail_at": fail_at, "losses": [], "restored_step": None,
           "restored_equal": None}

    def step(i: int):
        injector.check(i)
        b = {k: torch.from_numpy(v).to(device)
             for k, v in ds.batch(i).items()}
        st["params"], st["opt"], metrics = step_fn(st["params"], st["opt"],
                                                   b)
        out["losses"].append(float(metrics["loss"]))
        if (i + 1) % ckpt_every == 0:
            ckpt.save(i + 1, st["params"])
            st["saved"] = (i + 1, tree_map(lambda t: t.detach().cpu()
                                           .clone(), st["params"]))

    def restore(hosts) -> int:
        ckpt.wait()
        last = latest_step(str(ckpt_dir)) or 0
        print(f"  hosts {hosts} lost; restoring checkpoint step {last}")
        if last:
            st["params"] = restore_checkpoint(str(ckpt_dir), last,
                                              st["params"])
            shutil.copytree(ckpt_dir / f"step_{last:08d}",
                            ckpt_dir / "resume" / f"step_{last:08d}")
            saved_step, saved = st["saved"]
            out["restored_equal"] = saved_step == last and tree_bits_equal(
                st["params"], saved)
        else:
            st["params"] = model.init_params(seed, device)
        st["opt"] = init_opt(st["params"])
        out["restored_step"] = last
        return last

    sup = TrainingSupervisor(step, restore)
    t0 = time.perf_counter()
    out["end_step"] = sup.run(steps)
    ckpt.wait()
    out.update(seconds=time.perf_counter() - t0, log=list(sup.log),
               restarts=sup.restarts, params=st["params"])
    return out


def resume_run(model, *, steps: int, batch: int, seq: int,
               ckpt_dir, ckpt_every: int, device="cuda",
               seed: int = 0) -> dict:
    """`train_model` resumed from the checkpoint the drill restored
    (`ckpt_dir/resume/`): the same steps on the same batches, from the
    same params and a fresh optimizer."""
    return train_model(model, steps=steps, global_batch=batch, seq_len=seq,
                       seed=seed, ckpt_dir=str(Path(ckpt_dir) / "resume"),
                       ckpt_every=ckpt_every, resume=True, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-169m", action="store_true")
    ap.add_argument("--drill", action="store_true",
                    help="inject a host failure mid-run and recover")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    args = ap.parse_args(argv)

    model = get_model("rwkv4-169m" if args.full_169m else CFG_100M)
    ckpt_dir = Path(args.ckpt_dir) if args.ckpt_dir else DEFAULT_CKPT_DIR
    if not args.ckpt_dir:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    kw = dict(steps=args.steps, batch=args.batch, seq=args.seq,
              ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every,
              device=args.device)

    if not args.drill:
        out = train_model(model, steps=args.steps, global_batch=args.batch,
                          seq_len=args.seq, ckpt_dir=str(ckpt_dir),
                          ckpt_every=args.ckpt_every, device=args.device)
        print(f"\nloss: {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f} "
              f"over {args.steps} steps ({out['wall_s']:.0f}s)")
        if not out["losses"][-1] < out["losses"][0]:
            raise SystemExit("loss must go down")
        return 0

    with deterministic():
        drill = run_drill(model, **kw)
        print(f"drill complete: {drill['restarts']} restart(s); log: "
              f"{drill['log']}")
        print(f"restored step {drill['restored_step']}: params equal to "
              f"the committed checkpoint bit for bit: "
              f"{drill['restored_equal']}")
        out = resume_run(model, **kw)
    same = tree_bits_equal(out["params"], drill["params"])
    print(f"loss {drill['losses'][0]:.3f} -> {drill['losses'][-1]:.3f}; "
          f"train_model resumed from step {drill['restored_step']}: final "
          f"params equal to the supervised run's bit for bit: {same}")
    return 0 if drill["restored_equal"] is not False else 1


if __name__ == "__main__":
    sys.exit(main())
