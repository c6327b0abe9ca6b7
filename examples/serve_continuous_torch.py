"""Continuous-batching serving demo on the PyTorch/CUDA port: many requests,
one state pool.

    PYTHONPATH=src python examples/serve_continuous_torch.py --smoke --device cpu
    PYTHONPATH=src python examples/serve_continuous_torch.py      (full width, one GPU)
    ... [--prefix-cache] [--speculative K [--draft-depth D]]

Submits several concurrent requests with different prompt lengths and
budgets, streams their tokens as the engine interleaves chunked prefill
with batched decode (`step` and `RequestHandle.drain`), checks every
request's output against decoding it alone with the per-op batch-1 loop
(`sequential_decode`), serves one request again through `run`, and prints
the engine's `ServingCounters` snapshot.  `--fused model` decodes through
one kernel launch for all layers and `--fused-prefill` prefills through
the chunk kernels; on the CPU the kernels' plain versions run.
`--prefix-cache` gives the prompts a shared 16-token prefix and serves a
warm-up request first, so the others resume from its cached state;
`--speculative K` decodes through the truncated-stack drafter and the
K-token verifier.  On a GPU a speculative stream is the verify program's,
whose sums run in another order than the decode kernels', so there each
request is checked against itself served alone instead.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.launch.serve import sequential_decode
from repro_torch.models.registry import get_model
from repro_torch.serving import ServingEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv4-169m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=3,
                    help="pool slots (< requests exercises queueing)")
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--quantized", action="store_true")
    ap.add_argument("--fused", default=None, choices=["block", "model"])
    ap.add_argument("--fused-prefill", action="store_true")
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--speculative", type=int, default=None, metavar="K")
    ap.add_argument("--draft-depth", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    model = get_model(args.arch, smoke=args.smoke)
    params = model.init_params(0, args.device)
    engine = ServingEngine(model, params=params, max_batch=args.max_batch,
                           prefill_chunk=8, quantized=args.quantized,
                           fused_decode=args.fused,
                           fused_prefill=args.fused_prefill,
                           speculative=args.speculative,
                           draft_depth=args.draft_depth,
                           prefix_cache=args.prefix_cache,
                           device=args.device)

    rng = np.random.default_rng(0)
    shared = rng.integers(0, model.cfg.vocab, 16).tolist() \
        if args.prefix_cache else []
    prompts = [shared + rng.integers(0, model.cfg.vocab,
                                     size=int(rng.integers(3, 20))).tolist()
               for _ in range(args.requests)]
    if args.prefix_cache:
        # boundary states publish when their request finishes
        engine.submit(shared + [0], max_new_tokens=1)
        engine.run()
    handles = [engine.submit(p, max_new_tokens=args.tokens)
               for p in prompts]
    print(f"{args.requests} requests -> {args.max_batch}-slot pool on "
          f"{engine.device} (decode={args.fused or 'per_op'}, prefill="
          f"{'chunked' if args.fused_prefill else 'per_op'})\n")

    # stream: drive the engine and print tokens as each request emits them
    streamed: dict[int, list[int]] = {h.rid: [] for h in handles}
    more = True
    while more:
        more = engine.step()
        for h in handles:
            for tok in h.drain():
                streamed[h.rid].append(tok)
                print(f"  req{h.rid} +{tok}", end="")
        print()
    print()

    # the sequential reference decodes the same (packed or plain) weights
    ok = True
    solo = args.speculative is not None and engine.device.type == "cuda"
    for h, p in zip(handles, prompts):
        if solo:
            ref = engine.submit(p, max_new_tokens=args.tokens)
            engine.run()
            ref = ref.tokens
        else:
            ref = sequential_decode(model, engine.plan.prepared.raw, p,
                                    args.tokens, device=args.device)
        match = streamed[h.rid] == ref == h.tokens
        ok &= match
        print(f"req{h.rid}: engine == "
              f"{'itself alone' if solo else 'sequential decode'}: {match}")
    again = engine.submit(prompts[0], max_new_tokens=args.tokens)
    snap = engine.run()
    ok &= again.tokens == handles[0].tokens
    print(f"req{again.rid} (req0 again, through run()): "
          f"{again.tokens == handles[0].tokens}")
    print(f"\n{snap['decode_tokens']} tokens in {snap['ticks']} ticks "
          f"({snap['decode_tokens_per_s']:,.0f} tok/s, "
          f"TTFT {snap['mean_ttft_s'] * 1e3:.0f} ms); trace_counts "
          f"{engine.trace_counts}")
    for k, v in snap.items():
        print(f"  {k}: {v:.4f}" if isinstance(v, float) else f"  {k}: {v}")
    if engine.prefix_cache is not None:
        print("prefix cache:", engine.prefix_cache.snapshot())
    if not ok:
        raise SystemExit("outputs diverged from the reference")
    print("all outputs equal to "
          f"{'serving alone' if solo else 'sequential decode'}, bit for bit")


if __name__ == "__main__":
    main()
