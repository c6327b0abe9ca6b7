"""How far the RWKV train step's gradients move under bf16 rounding, through
the PyTorch port, and which part of the bf16 step moves them.

For rwkv4 and rwkv6 (cut to a width and depth that fit), one step 0
(`launch/steps.py:loss_and_grads`) on random master weights from the seed
and seeded tokens, and per leaf the gap mean |g - g_f32| / mean |g_f32| to
the f32 witness (the f32 config, the plain versions of the kernels) of:

  bf16         the bf16 config: the kernels on the card, their plain
               versions on the CPU
  rounded      the f32 config on the master weights rounded to bf16,
               nothing else rounded: the gradient's conditioning alone
and, on the CPU, for rwkv6 at a length that takes K10:
  bf16 walk    the bf16 config with K10's backward taken by the plain
               version of K10-bwd's passes (`wkv6_chunked_bwd_plain`)
               instead of autograd of K10's plain forward
and, on the card:
  plain X      the bf16 config with X's plain version in place of its
               kernel, X one of the WKV (K10 / K6 or K2), the LayerNorm
               (K11) and the loss (K12)

`chip_smoke.py:_train_gaps` reads the bf16, plain and rounded gaps at
rwkv6-7b's full width on the card.

Run: PYTHONPATH=src python tools/grad_conditioning.py [--width 512]
     [--layers 4] [--batch 1] [--seq 256] [--vocab 4096] [--device cpu]
     [--arch rwkv6-7b]
On the card at rwkv6-7b's train shape: --device cuda --arch rwkv6-7b
     --width 4096 --layers 4 --batch 4 --seq 1024 --vocab 65536
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.launch.steps import loss_and_grads
from repro_torch.models.registry import get_model
from repro_torch.tree import leaves_with_path, tree_map


def _model(arch: str, width: int, layers: int, vocab: int, dtype: str):
    cfg = get_model(arch).cfg
    kw = {"n_heads": width // 64, "d_ff": int(3.5 * width)} \
        if arch == "rwkv6-7b" else {"d_ff": 4 * width}
    return get_model(dataclasses.replace(cfg, d_model=width,
                                         n_layers=layers, vocab=vocab,
                                         dtype=dtype, **kw))


@contextlib.contextmanager
def _swapped(*swaps):
    """(module, name, fn): each module attribute replaced inside."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, fn in swaps:
        setattr(m, n, fn)
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def _plain(what: str):
    """The swaps that put `what`'s plain version in its kernel's place."""
    from repro_torch.kernels import fused_ce, fused_layernorm, wkv4, wkv6
    from repro_torch.models import layers, registry, rwkv4, rwkv6
    return {
        "wkv": ((rwkv6, "wkv6_chunked_kernel", wkv6.wkv6_chunked_plain),
                (rwkv6, "wkv6_seq", wkv6.wkv6_seq_plain),
                (rwkv4, "wkv4_seq", wkv4.wkv4_seq_plain)),
        "ln": ((layers, "fused_layernorm",
                fused_layernorm.fused_layernorm_plain),),
        "ce": ((registry, "fused_cross_entropy",
                fused_ce.fused_cross_entropy_plain),)}[what]


class _Walk(torch.autograd.Function):
    """K10's plain forward, its backward the plain version of K10-bwd's
    passes (the kernel's algorithm in torch ops)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk):
        from repro_torch.kernels.wkv6 import wkv6_chunked_plain
        ctx.save_for_backward(r, k, v, w, u)
        ctx.chunk = chunk
        return wkv6_chunked_plain(r, k, v, w, u, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, _):
        from repro_torch.kernels.wkv6 import wkv6_chunked_bwd_plain
        r, k, v, w, u = ctx.saved_tensors
        dr, dk, dv, dw, du = wkv6_chunked_bwd_plain(
            r, k, v, w, u, dy.contiguous(), chunk=ctx.chunk)
        return dr, dk, dv, dw, du.to(u.dtype), None


def _walk(r, k, v, w, u, s0=None, *, chunk: int = 64):
    y, sf = _Walk.apply(r, k, v, w, u, chunk)
    return y, sf.detach()


def gaps(arch: str, width: int, layers: int, batch: int, seq: int,
         vocab: int, device: str = "cpu", seed: int = 0) -> dict:
    """{variant: {leaf: gap to the f32 witness}} for the variants above
    that apply to `device` and `arch`."""
    from repro_torch.models import rwkv6
    m16 = _model(arch, width, layers, vocab, "bfloat16")
    m32 = _model(arch, width, layers, vocab, "float32")
    params = m32.init_params(seed, device)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (batch, seq + 1)).astype(np.int32)).to(device)
    data = {"tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous()}

    def grads(m, p):
        return dict(leaves_with_path(loss_and_grads(m, p, data)[1]))

    with _swapped(*_plain("wkv"), *_plain("ln"), *_plain("ce")):
        g32 = grads(m32, params)

    def gap(g):
        return {".".join(p): float((g[p].float() - g32[p]).abs().mean()
                                   / g32[p].abs().mean()) for p in g32}
    out = {"bf16": gap(grads(m16, params))}
    rounded = tree_map(lambda t: t.float(), m16.cast_params(params))
    with _swapped(*_plain("wkv"), *_plain("ln"), *_plain("ce")):
        out["rounded"] = gap(grads(m32, rounded))
    del rounded
    if device == "cpu":
        if arch == "rwkv6-7b" and seq % 64 == 0 and seq > 64:
            with _swapped((rwkv6, "wkv6_chunked_kernel", _walk)):
                out["bf16 walk"] = gap(grads(m16, params))
    else:
        for what in ("wkv", "ln", "ce"):
            with _swapped(*_plain(what)):
                out[f"plain {what}"] = gap(grads(m16, params))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--arch", default=None,
                    help="rwkv4-169m or rwkv6-7b (default: both)")
    a = ap.parse_args()
    if a.device == "cpu":
        torch.set_num_threads(min(4, torch.get_num_threads()))
    for arch in [a.arch] if a.arch else ["rwkv4-169m", "rwkv6-7b"]:
        res = gaps(arch, a.width, a.layers, a.batch, a.seq, a.vocab,
                   a.device)
        names = list(res)
        print(f"{arch} D {a.width} L {a.layers} B {a.batch} S {a.seq} "
              f"V {a.vocab} on {a.device}: gap to the f32 witness, "
              + " / ".join(names))
        for leaf in res["bf16"]:
            print(f"  {leaf:26s} "
                  + " / ".join(f"{res[n][leaf]:.3g}" for n in names))


if __name__ == "__main__":
    main()
