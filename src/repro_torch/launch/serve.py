"""Serving launcher for the port — a small CLI over the engine.

    python -m repro_torch.launch.serve --arch {rwkv4-169m,rwkv6-7b} \
        --quantized --fused {block,model} --fused-prefill [--batch 8] \
        [--tokens 32] [--smoke] [--device cuda|cpu] \
        [--prefix-cache [--prefix-cache-slots N] \
         [--prefix-cache-host-slots N]] [--speculative K [--draft-depth D]] \
        [--max-queue N [--overload backpressure|shed]] [--prefill-budget T] \
        [--deadline S] [--sentinel-every N] \
        [--snapshot-dir DIR [--snapshot-every N] [--resume] \
         [--supervise [--max-restarts N]]]
    python -m repro_torch.launch.serve --legacy [--arch smollm-135m] \
        [--hw-numerics] [--smoke] [--batch 4] [--tokens 32] \
        [--device cuda|cpu]

`--fused block` decodes through one kernel launch per layer (K3 for
rwkv4, K7-block for rwkv6), `--fused model` through one launch for all
layers (K4, K7-model), each with the head through K5; `--fused-prefill`
absorbs prompt chunks through K5 and the masked WKV kernel (K2 for rwkv4,
K6 for rwkv6).  Without them the engine runs the plain per-op PyTorch
path.  The kernels take every weight form: `--quantized` packs every
matmul weight Δ-PoT W8, without it they read the plain bf16 weights;
per-tensor planes (W4, VQ) are chosen through
`ServingEngine(plane_policy=)`, as in the JAX package.  The device
defaults to "cuda" and raises without a GPU.

`--prefix-cache` turns on the recurrent-state prefix cache (device tier
`--prefix-cache-slots` lane states over `--prefix-cache-host-slots` host
copies); the demo traffic then shares one system prompt, served once
first, so that the other requests resume from its cached state, and the
cache's snapshot is printed.  `--speculative K` decodes K tokens a tick
at most: the first `--draft-depth` layers (default half) draft K-1 on the
decode path's kernel, one chunk-shaped verify call scores the window.

The SLO layer: `--max-queue N` bounds the admission queue, and a full one
refuses a submission with a typed `Overloaded` (`--overload backpressure`,
reported and counted) or drops the least urgent queued request (`shed`);
`--prefill-budget T` caps the prompt tokens prefilled per tick while lanes
decode; `--deadline S` evicts requests still running S seconds after
their submission.  `--sentinel-every N` sweeps the pool for NaN/Inf lanes
every N ticks and replays a poisoned request.  Crash safety:
`--snapshot-dir DIR` writes a tick-boundary snapshot every
`--snapshot-every` ticks, `--resume` restores the newest committed one and
drains it (a fresh start when there is none), and `--supervise` runs the
serve command in a child process and relaunches it with `--resume` after
an abnormal exit, at most `--max-restarts` times.

`--legacy` is the seed's serving mode (`serve_legacy`): one fixed batch
of random first tokens, the per-op `decode_step` in a host loop
(`greedy_decode`); there `--quantized` fake-quantizes the weights under
the paper's W9/A9 policy, as the JAX launcher does.  It is the one mode
of the dense transformers (`--arch smollm-135m`, `phi3-mini-3.8b`,
`minitron-4b`): their decode step writes a KV cache (sized tokens + 8) at
its position, which the slotted engine does not serve.  `--hw-numerics` (rwkv4 only; implies
`--legacy`) runs that loop under the paper's hardware numerics, which the
engine does not serve: their A9 scale spans the batch, so a lane's bits
depend on its batchmates.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.quant.policy import QuantPolicy, fake_quantize_tree
from repro_torch.core.quant.serving import (
    is_packed_leaf, leaf_plane, unpack_params)
from repro_torch.device import resolve_device
from repro_torch.tree import leaves_with_path


@torch.inference_mode()
def sequential_decode(model, params, prompt: list[int], n_new: int,
                      device="cuda") -> list[int]:
    """Batch-1 greedy decode of one request through the per-op
    `decode_step`: feed the prompt token by token, then argmax-chain
    `n_new` tokens.  Packed params are decoded first; `params` must lie on
    `device`."""
    device = resolve_device(device)
    params = unpack_params(params)
    state = model.init_decode_state(1, 0, device=device)
    logits = None
    for t in prompt:
        tok = torch.tensor([[t]], dtype=torch.int32, device=device)
        logits, state = model.decode_step(params, state, tok, 0)
    out = []
    for _ in range(n_new):
        nxt = int(torch.argmax(logits[0, -1].float()))
        out.append(nxt)
        tok = torch.tensor([[nxt]], dtype=torch.int32, device=device)
        logits, state = model.decode_step(params, state, tok, 0)
    return out


@torch.inference_mode()
def greedy_decode(model, params, state, first_token, n_tokens: int,
                  start_pos: int = 0, *, sample_temp: float = 0.0,
                  rng: torch.Generator | None = None):
    """Chain `n_tokens` tokens from `first_token` (B, 1) int32 through
    `model.decode_step`, the seed's host loop: the argmax, or with
    `sample_temp > 0` and `rng` (a `torch.Generator` on the state's
    device) a draw from softmax(logits / sample_temp) by
    `torch.multinomial`, so the same generator seed gives the same tokens
    (not JAX's PRNG bits).  Returns (tokens (B, n_tokens + 1), the
    state)."""
    tok, out, pos = first_token, [first_token], start_pos
    for _ in range(n_tokens):
        logits, state = model.decode_step(params, state, tok, pos)
        last = logits[:, -1].float()
        if sample_temp > 0 and rng is not None:
            tok = torch.multinomial(torch.softmax(last / sample_temp, -1),
                                    1, generator=rng)
        else:
            tok = torch.argmax(last, dim=-1)[:, None]
        tok = tok.to(torch.int32)
        pos += 1
        out.append(tok)
    return torch.cat(out, dim=1), state


class HwModel:
    """A model whose `decode_step` runs rwkv4's per-op step under the
    hardware numerics, as the JAX launcher wraps it."""

    def __init__(self, model):
        self.model, self.cfg = model, model.cfg

    def decode_step(self, params, state, tokens, pos):
        from repro_torch.models import rwkv4
        return rwkv4.decode_step(self.model.cast_params(params), state,
                                 tokens, pos, self.cfg, hw=True)


def serve_legacy(arch: str, *, smoke: bool = True, batch: int = 4,
                 n_tokens: int = 32, quantized: bool = False, seed: int = 0,
                 hw_numerics: bool = False, device: str = "cuda"):
    """The seed's serving mode: one fixed batch of seeded first tokens,
    decoded by the per-op step in a host loop; `hw_numerics` (rwkv4)
    under the paper's numerics; `quantized` fake-quantizes the weights
    first (`fake_quantize_tree` under `QuantPolicy()`: W9 Δ-PoT matmuls,
    9-bit uniform additive weights).  Prints tokens/s; returns the
    tokens."""
    from repro_torch.models.registry import get_model
    device = resolve_device(device)
    model = get_model(arch, smoke=smoke)
    params = model.init_params(seed, device)
    if quantized:
        t0 = time.perf_counter()
        params = fake_quantize_tree(params, QuantPolicy())
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"quantized (Δ-PoT W9/A9 policy) in "
              f"{time.perf_counter() - t0:.1f}s")
    state = model.init_decode_state(batch, n_tokens + 8, device=device)
    rng = np.random.default_rng(seed)
    first = torch.tensor(rng.integers(0, model.cfg.vocab, (batch, 1)),
                         dtype=torch.int32, device=device)
    m = HwModel(model) if hw_numerics and model.cfg.rwkv_version == 4 \
        else model
    t0 = time.perf_counter()
    toks, _ = greedy_decode(m, params, state, first, n_tokens)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"{arch}: decoded {n_tokens} tokens x {batch} seqs in {dt:.2f}s "
          f"({batch * n_tokens / max(dt, 1e-9):,.0f} tok/s"
          f"{', hw numerics' if m is not model else ''})")
    return toks


def weights_label(params) -> str:
    """The planes of a weight tree, for the printed line: "fp", "Δ-PoT W8"
    when every matmul is W8, else the count of each plane."""
    counts: dict = {}
    for _, leaf in leaves_with_path(params, is_leaf=is_packed_leaf):
        plane = leaf_plane(leaf)
        if plane is not None:
            counts[plane] = counts.get(plane, 0) + 1
    if not counts:
        return "fp"
    if set(counts) == {"w8"}:
        return "Δ-PoT W8"
    return "planes " + " ".join(f"{p.upper()}×{counts[p]}"
                                for p in ("w8", "w4", "vq") if p in counts)


def _print_snapshot(snap: dict):
    for k, v in snap.items():
        print(f"  {k}: {v:.3f}" if isinstance(v, float) else f"  {k}: {v}")


def serve(arch: str, *, smoke: bool = False, batch: int = 8,
          n_tokens: int = 32, quantized: bool = False, prompt_len: int = 8,
          fused: str | None = None, fused_prefill: bool = False,
          prefix_cache: bool = False, cache_slots: int = 64,
          cache_host_slots: int = 256, speculative: int | None = None,
          draft_depth: int | None = None, max_queue: int = 0,
          overload: str = "backpressure", prefill_budget: int = 0,
          deadline_s: float | None = None, snapshot_dir: str | None = None,
          snapshot_every: int = 8, sentinel_every: int = 0,
          resume: bool = False, device: str = "cuda"):
    """`batch` concurrent greedy requests (seeded prompts, weights from
    seed 0) through the engine; prints the run's throughput (tokens over
    its wall time) and the counters' snapshot, and returns the handles.
    With `prefix_cache` every prompt starts with one shared system prompt
    (a warm-up request serves it first, since boundary states publish
    when their request finishes) and the cache's snapshot is printed;
    `speculative` is the verify window K.  `max_queue`, `overload`,
    `prefill_budget` and `deadline_s` configure the SLO layer (the
    defaults: unbounded, unlimited, no deadline); a submission the full
    queue refuses is reported and counted.  `snapshot_dir` writes a
    snapshot every `snapshot_every` ticks; with `resume` the newest
    committed one is restored and drained instead (a fresh start when
    there is none).  `sentinel_every` turns on the NaN/Inf sentinel."""
    from repro_torch.serving import (AdmissionPolicy, Overloaded,
                                     PrefixCacheConfig, ServingEngine,
                                     ServingSLO, SnapshotConfig)
    if resume and snapshot_dir:
        try:
            engine = ServingEngine.restore(snapshot_dir)
        except FileNotFoundError:
            print(f"no committed snapshot under {snapshot_dir!r} — "
                  "starting fresh")
        else:
            handles = list(engine.handles.values())
            print(f"resumed {len(handles)} request(s) from "
                  f"{snapshot_dir!r} at tick {engine.scheduler._tick_no}")
            snap = engine.run()
            if engine.snapshot_manager is not None:
                engine.snapshot_manager.wait()
            done = sum(len(h.resumed) + len(h.tokens) for h in handles)
            print(f"{arch}: resumed run drained — {done} tokens across "
                  f"{len(handles)} stream(s) (resumed + continued)")
            _print_snapshot(snap)
            return handles
    cache = PrefixCacheConfig(device_slots=cache_slots,
                              host_slots=cache_host_slots) \
        if prefix_cache else None
    slo = ServingSLO(prefill_budget=prefill_budget,
                     default_deadline_s=deadline_s,
                     admission=AdmissionPolicy(max_queue=max_queue,
                                               overload=overload))
    engine = ServingEngine(arch, smoke=smoke, max_batch=batch,
                           quantized=quantized, fused_decode=fused,
                           fused_prefill=fused_prefill,
                           speculative=speculative, draft_depth=draft_depth,
                           prefix_cache=cache, slo=slo,
                           snapshot=None if snapshot_dir is None else
                           SnapshotConfig(directory=snapshot_dir,
                                          every=snapshot_every),
                           sentinel_every=sentinel_every, device=device)
    rng = np.random.default_rng(0)
    vocab = engine.model.cfg.vocab
    shared = []
    if prefix_cache:
        shared = rng.integers(0, vocab, max(engine.plan.prefill_chunk,
                                            prompt_len)).tolist()
        engine.submit(shared + [int(rng.integers(0, vocab))],
                      max_new_tokens=1)
        engine.run()
    t0 = time.perf_counter()
    # admission happens in ticks, so every submission lands in the queue
    # first: a --max-queue below the batch meets backpressure here
    handles, refused = [], 0
    for _ in range(batch):
        prompt = shared + rng.integers(0, vocab, prompt_len).tolist()
        try:
            handles.append(engine.submit(prompt, max_new_tokens=n_tokens))
        except Overloaded as exc:
            refused += 1
            print(f"backpressured: {exc}")
    snap = engine.run()
    if engine.snapshot_manager is not None:
        engine.snapshot_manager.wait()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    if refused:
        print(f"{refused}/{batch} submissions backpressured (--max-queue "
              f"{max_queue}, --overload {overload})")
    name = torch.cuda.get_device_name(engine.device) \
        if engine.device.type == "cuda" else "cpu"
    print(f"{arch}{' (smoke)' if smoke else ''} on {name}: {batch} requests "
          f"x {n_tokens} tokens ({weights_label(engine.plan.prepared.raw)} "
          f"weights, decode={fused or 'per_op'}, "
          f"prefill={'chunked' if fused_prefill else 'per_op'}"
          f"{f', speculative={speculative}' if speculative else ''}) — "
          f"{snap['decode_tokens'] / dt:.1f} tok/s over {snap['ticks']} "
          f"ticks, TTFT {snap['mean_ttft_s'] * 1e3:.0f} ms, latency "
          f"{snap['mean_latency_s'] * 1e3:.0f} ms")
    _print_snapshot(snap)
    if engine.prefix_cache is not None:
        print("prefix cache:")
        _print_snapshot(engine.prefix_cache.snapshot())
    return handles


def supervise(argv: list[str], *, max_restarts: int = 3) -> int:
    """The restart-and-resume supervisor: run the serve CLI
    (`python -m repro_torch.launch.serve` with `argv` less `--supervise`)
    in a child process and, after any abnormal exit (an injected crash, a
    SIGKILL, an out-of-memory kill), relaunch it with `--resume`, so that
    it restores the newest committed snapshot and continues every stream.
    Gives up after `max_restarts` abnormal exits and returns the child's
    last exit code (0 once a run ends normally)."""
    import subprocess
    import sys
    args = [a for a in argv if a != "--supervise"]
    rc = 0
    for attempt in range(max_restarts + 1):
        rc = subprocess.call([sys.executable, "-m",
                              "repro_torch.launch.serve", *args])
        if rc == 0:
            return 0
        if attempt == max_restarts:
            print(f"supervisor: giving up after {max_restarts} restarts "
                  f"(last rc={rc})")
            return rc
        print(f"supervisor: serve exited rc={rc}; restarting with "
              f"--resume ({attempt + 1}/{max_restarts})")
        if "--resume" not in args:
            args.append("--resume")
    return rc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv4-169m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--quantized", action="store_true")
    ap.add_argument("--fused", nargs="?", const="block", default=None,
                    choices=["block", "model"],
                    help="decode through one kernel launch per layer "
                    "(block: K3, K7) or one for all layers (model: K4, K7)")
    ap.add_argument("--fused-prefill", action="store_true",
                    help="chunked prefill through kernels K5 and K2 / K6")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="recurrent-state prefix cache: repeated prompt "
                    "prefixes resume from cached chunk-boundary states "
                    "(the same tokens); the demo shares a system prompt")
    ap.add_argument("--prefix-cache-slots", type=int, default=64,
                    help="device-tier cache entries (lane states)")
    ap.add_argument("--prefix-cache-host-slots", type=int, default=256,
                    help="host spill-tier entries; 0 disables spilling")
    ap.add_argument("--speculative", type=int, default=None, metavar="K",
                    help="self-speculative decode: a truncated-stack "
                    "drafter proposes K-1 tokens a tick, one chunk-shaped "
                    "verify call scores the window")
    ap.add_argument("--draft-depth", type=int, default=None, metavar="D",
                    help="layers the drafter keeps (default: half)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bounded admission queue, 0 = unbounded; a full "
                    "queue backpressures (typed Overloaded with a retry "
                    "hint) or sheds, per --overload")
    ap.add_argument("--overload", default="backpressure",
                    choices=["backpressure", "shed"],
                    help="full-queue behaviour: refuse the arrival, or "
                    "drop the least urgent queued request")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="prompt tokens prefilled per tick while lanes "
                    "decode (0 = unlimited): bounds the inter-token "
                    "latency a prefill burst adds")
    ap.add_argument("--deadline", type=float, default=None, metavar="S",
                    help="default per-request deadline in seconds; a "
                    "request past it is evicted with outcome 'deadline'")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="write a tick-boundary engine snapshot into DIR "
                    "every --snapshot-every ticks (atomic commits, "
                    "background writes)")
    ap.add_argument("--snapshot-every", type=int, default=8,
                    help="snapshot cadence in scheduler ticks")
    ap.add_argument("--sentinel-every", type=int, default=0,
                    help="NaN/Inf lane sweep every N ticks (0 = off); a "
                    "poisoned lane's request is requeued and replayed")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest committed snapshot from "
                    "--snapshot-dir and drain it (fresh start if none)")
    ap.add_argument("--supervise", action="store_true",
                    help="run serve in a child process and relaunch it "
                    "with --resume after an abnormal exit (needs "
                    "--snapshot-dir)")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="the supervisor's restart budget")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--legacy", action="store_true",
                    help="the seed's fixed-batch per-op decode loop")
    ap.add_argument("--hw-numerics", action="store_true",
                    help="the paper's LUT/PWL/A9 numerics (rwkv4; implies "
                    "--legacy)")
    args = ap.parse_args(argv)
    if args.supervise:
        import sys
        if not args.snapshot_dir:
            ap.error("--supervise needs --snapshot-dir (nothing to "
                     "resume from otherwise)")
        raise SystemExit(supervise(
            sys.argv[1:] if argv is None else list(argv),
            max_restarts=args.max_restarts))
    if args.legacy or args.hw_numerics:
        serve_legacy(args.arch, smoke=args.smoke, batch=args.batch,
                     n_tokens=args.tokens, quantized=args.quantized,
                     hw_numerics=args.hw_numerics, device=args.device)
        return
    serve(args.arch, smoke=args.smoke, batch=args.batch,
          n_tokens=args.tokens, quantized=args.quantized,
          prompt_len=args.prompt_len, fused=args.fused,
          fused_prefill=args.fused_prefill, prefix_cache=args.prefix_cache,
          cache_slots=args.prefix_cache_slots,
          cache_host_slots=args.prefix_cache_host_slots,
          speculative=args.speculative, draft_depth=args.draft_depth,
          max_queue=args.max_queue, overload=args.overload,
          prefill_budget=args.prefill_budget, deadline_s=args.deadline,
          snapshot_dir=args.snapshot_dir,
          snapshot_every=args.snapshot_every,
          sentinel_every=args.sentinel_every, resume=args.resume,
          device=args.device)


if __name__ == "__main__":
    main()
