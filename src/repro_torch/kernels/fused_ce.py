"""Cross-entropy over a large vocabulary (kernel K12) and its backward
(K12-bwd).

Port of `repro/kernels/fused_ce.py:fused_cross_entropy`: per row, one pass
over the logits keeps an online max and sum-exp and picks the label's
logit, giving the row's NLL and log-sum-exp (`_fwd_kernel`); the backward
is dx = (softmax − onehot)·g from the saved lse, written in the logits'
dtype (`_bwd_kernel`).  The CUDA kernels are `csrc/fused_ce.cu`; its
header says what bounds them on an H100 and how the design answers that.

`models/registry.py:loss_fn` takes its per-token NLL from here, so the
(N, V) f32 logits and log-probs that a log-softmax materialises are
never made on the card.

A CPU tensor takes the plain version, the oracle of
`repro/kernels/ref.py:fused_cross_entropy_ref` (the f32 log-softmax and
the label's entry), differentiated by autograd as before, so every CPU
number of `loss_fn` stays what it was.  A CUDA tensor launches K12 and,
under grad, carries gradients through an autograd Function whose backward
launches K12-bwd; it never falls back to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (
    check, counted, kernel_route, load_library, meta_empty, meta_like,
    stream_ptr)

_DTYPES = (torch.float32, torch.bfloat16)


def fused_cross_entropy_plain(logits, labels):
    """-log_softmax(logits in f32)[label]: (..., V), (...) -> (...) f32."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


def fused_cross_entropy_bwd_plain(x, labels, lse, g):
    """K12-bwd's formula: (exp(x − lse) − onehot(label))·g in f32, cast to
    x's dtype.  x (N, V), labels (N,), lse and g (N,) f32."""
    p = torch.exp(x.to(torch.float32) - lse[:, None])
    cols = torch.arange(x.shape[-1], device=x.device)
    hit = (cols[None, :] == labels[:, None].long()).to(torch.float32)
    return ((p - hit) * g[:, None]).to(x.dtype)


def _check(x, labels, who):
    if x.dtype not in _DTYPES:
        raise TypeError(f"{who} takes f32 or bf16 logits, got {x.dtype}")
    if x.dim() != 2 or labels.shape != x.shape[:1] or x.shape[1] < 1:
        raise ValueError(f"{who}: logits {tuple(x.shape)} and labels "
                         f"{tuple(labels.shape)} do not pair")
    if labels.device != x.device:
        raise ValueError(f"{who}: operands on other devices")
    if x.device.type != "cuda":
        raise RuntimeError(f"{who}: no kernel for device {x.device}")


def _fwd_meta(x, labels):
    return (meta_empty(x.shape[:1], torch.float32),
            meta_empty(x.shape[:1], torch.float32))


@counted("fused_cross_entropy", meta=_fwd_meta)
def _forward(x, labels):
    """K12 on (N, V) logits and (N,) int32 labels -> (nll, lse) f32; on
    the CPU (an op count's route) the plain NLL and the rows'
    log-sum-exp."""
    if x.device.type == "cpu":
        return (fused_cross_entropy_plain(x, labels),
                torch.logsumexp(x.to(torch.float32), dim=-1))
    _check(x, labels, "fused_cross_entropy")
    N, V = x.shape
    nll = torch.empty(N, dtype=torch.float32, device=x.device)
    lse = torch.empty(N, dtype=torch.float32, device=x.device)
    if N == 0:
        return nll, lse
    check(load_library().fused_ce_fwd(
        x.data_ptr(), labels.data_ptr(), nll.data_ptr(), lse.data_ptr(), N,
        V, int(x.dtype == torch.bfloat16), stream_ptr(x)),
        "fused_cross_entropy")
    fused_cross_entropy.launches += 1
    return nll, lse


@counted("fused_cross_entropy_bwd", meta=lambda x, *_: meta_like(x))
def fused_cross_entropy_bwd(x, labels, lse, g):
    """dx (N, V) in x's dtype of the NLL rows for their cotangent g (N,):
    the plain formula on the CPU, K12-bwd on the card."""
    if x.device.type == "cpu":
        return fused_cross_entropy_bwd_plain(x, labels, lse, g)
    _check(x, labels, "fused_cross_entropy_bwd")
    N, V = x.shape
    if lse.shape != (N,) or g.shape != (N,) or any(
            t.dtype != torch.float32 or t.device != x.device
            for t in (lse, g)):
        raise ValueError("fused_cross_entropy_bwd: lse and g must be (N,) "
                         "f32 on the logits' device")
    labels = labels.to(torch.int32).contiguous()
    lse, g = lse.contiguous(), g.contiguous()
    dx = torch.empty_like(x)
    if N == 0:
        return dx
    # 16-byte loads and stores need dx at x's offset modulo 16 bytes
    vec = int(x.data_ptr() % 16 == dx.data_ptr() % 16)
    check(load_library().fused_ce_bwd(
        x.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
        dx.data_ptr(), N, V, int(x.dtype == torch.bfloat16), vec,
        stream_ptr(x)), "fused_cross_entropy_bwd")
    fused_cross_entropy_bwd.launches += 1
    return dx


fused_cross_entropy_bwd.launches = 0


class _FusedCE(torch.autograd.Function):
    """K12 with its backward: the forward keeps (logits, labels, lse), as
    JAX's `_ce_fwd` does; the backward is K12-bwd."""

    @staticmethod
    def forward(ctx, x, labels):
        nll, lse = _forward(x, labels)
        ctx.save_for_backward(x, labels, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        x, labels, lse = ctx.saved_tensors
        return fused_cross_entropy_bwd(
            x, labels, lse, g.to(torch.float32).contiguous()), None


def fused_cross_entropy(logits, labels):
    """logits (..., V) f32 or bf16, labels (...) int -> the per-row NLL
    (...) f32.  On the card, with grad mode on and logits that require
    grad, the result carries gradients through K12-bwd."""
    if not kernel_route(logits):
        return fused_cross_entropy_plain(logits, labels)
    V = logits.shape[-1]
    lead = logits.shape[:-1]
    if labels.shape != lead:
        raise ValueError(f"fused_cross_entropy: logits {tuple(logits.shape)}"
                         f" and labels {tuple(labels.shape)} do not pair")
    x = logits.reshape(-1, V).contiguous()
    lbl = labels.reshape(-1).to(torch.int32).contiguous()
    if torch.is_grad_enabled() and logits.requires_grad:
        nll = _FusedCE.apply(x, lbl)
    else:
        nll, _ = _forward(x, lbl)
    return nll.reshape(lead)


fused_cross_entropy.launches = 0
