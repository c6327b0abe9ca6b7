"""The RWKV-6 WKV kernels: the masked sequential form (kernel K6) and the
chunked form (kernel K10).

K6 is the port of `repro/kernels/wkv6.py:wkv6_seq_pallas` (`_seq_kernel`):
the exact per-step `wkv6_step` recurrence over a prompt chunk, each head's
(N, N) state kept on chip for the whole window, with the `valid` commit
mask and the `carry_dtype` snap of the chunked prefill.  Its CUDA kernel
is `csrc/wkv6_seq.cu`: a block a (b, h) pair, each state column in the
registers of one or two threads, the window's operands staged in a ring of
shared-memory tiles (`k6_plan`, the twin of the source's `plan_of`).  Its
y sums n in order from +0, as `wkv6_seq_inorder` does with eager ops, so
the two agree bit for bit; the plain version's einsum sums in its own
order.

K10 is the port of `wkv6_pallas` (`_kernel`): the chunked WKV-6 of the
whole-sequence forward over chunks of C tokens, each chunk an inter-chunk
product against the carried state, the exact pairwise decays masked
strictly lower before the exp, the u-bonus and the state update (the
one-level scheme, `wkv6_chunked_plain`; `core/wkv/wkv6.py:wkv6_chunked`
is JAX's two-level form of the same function).  Its CUDA source
`csrc/wkv6_chunked.cu` spreads every head's chunks over the card in three
launches (`k10_plan`): the chunks' state increments, the in-order state
recurrence, and the chunks' outputs, whose products run on the tensor
cores in exact bf16 pieces through sub-chunks of 16.  Each source's header says what bounds it on an H100 and how its
design answers that.

The initial state may be f32 or the bf16 pool state itself: bf16 -> f32
is exact, so the kernel reads the pool's bf16 bytes and widens them on
chip instead of taking an f32 copy.  The final state is f32 (snapped
through bf16 when the carry is bf16), as the JAX kernel returns it.

Their backward kernels replace no TPU kernel: JAX lets XLA
differentiate `core/wkv/wkv6.py:wkv6_chunked` and `wkv6_scan`.  K10-bwd
(`csrc/wkv6_chunked_bwd.cu`, `wkv6_chunked_bwd`) takes the forward's
workspace, which holds S_(g-1) of every chunk, and K6-bwd
(`csrc/wkv6_seq_bwd.cu`, `wkv6_seq_bwd`) walks the steps backward from
checkpoints of the state every K6_BWD_WINDOW steps; each source's header
derives the gradients.  On the card, with grad mode on and an operand
that requires grad, the forward's own call runs through an autograd
Function (`_WKV6Chunked`, `_WKV6Seq`) whose backward is that kernel: K10
from an initial state that takes no gradient, K6 from one too, without a
valid mask or a carry snap.  Any other call under grad raises before it
launches (`OWN_CALLS`): the prefill's masked and snapped K6 is never
trained, as JAX trains from a zero carry.

A CPU tensor takes the plain version, which autograd differentiates;
`wkv6_chunked_bwd` and `wkv6_seq_bwd` on CPU tensors are the backward
kernels' plain versions, the same passes in torch ops, chunk by chunk and
window by window.  A CUDA tensor launches the kernels or raises.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.wkv.wkv6 import wkv6_step
from repro_torch.kernels.build import (
    check, counted, kernel_route, load_library, meta_empty, nbytes,
    refuse_grad, stream_ptr)

OWN_CALLS = ("K10-bwd and K6-bwd differentiate the whole-sequence "
             "forward's own calls: from an initial state that takes no "
             "gradient (f32 for K6), without a valid mask or a carry "
             "snap (the prefill's masked, snapped K6 is never trained: "
             "JAX trains from a zero carry)")

_CARRY = {None: None, "float32": None, "bfloat16": torch.bfloat16}


def _seq_loop(r, k, v, w, u, s0, valid, carry_dtype, y_of):
    """T calls of `wkv6_step`, each committed only where `valid`, the carry
    snapped through `carry_dtype` after every step; each step's y from
    `y_of(S, r_t, k_t, v_t, u, wkv6_step's y)`."""
    snap_dt = _CARRY[carry_dtype]
    snap = (lambda t: t) if snap_dt is None else \
        (lambda t: t.to(snap_dt).to(torch.float32))
    S = s0.to(torch.float32)
    ys = []
    for t in range(r.shape[1]):
        new, y = wkv6_step(S, r[:, t], k[:, t], v[:, t], w[:, t], u)
        ys.append(y_of(S, r[:, t], k[:, t], v[:, t], u, y))
        if valid is not None:
            new = torch.where(valid[:, t, None, None, None] != 0, new, S)
        S = snap(new)
    return torch.stack(ys, dim=1), S


def wkv6_seq_plain(r, k, v, w, u, s0, *, valid=None,
                   carry_dtype: Optional[str] = None):
    """The plain version: T calls of `wkv6_step`, each committed only where
    `valid`, the carry snapped through `carry_dtype` after every step."""
    return _seq_loop(r, k, v, w, u, s0, valid, carry_dtype,
                     lambda S, rt, kt, vt, u_, y: y)


def _y_inorder(S, rt, kt, vt, u, _):
    y = torch.zeros_like(vt, dtype=torch.float32)
    for n in range(rt.shape[-1]):
        kv = kt[..., n, None] * vt
        y = y + rt[..., n, None] * (S[..., n, :] + u[:, n, None] * kv)
    return y


def wkv6_seq_inorder(r, k, v, w, u, s0, *, valid=None,
                     carry_dtype: Optional[str] = None):
    """The plain version's state with y in K6's order: each step's y =
    ((+0 + t_0) + t_1) + ... over n, t_n = r[n]·(S[n] + u[n]·(k[n]·v)),
    one eager multiply or add at a time, so its bits are the kernel's."""
    return _seq_loop(r, k, v, w, u, s0, valid, carry_dtype, _y_inorder)


# The plan's constants (csrc/wkv6_seq.cu, which owns them)
K6_MAX_N = 64
K6_TILE = 4             # steps a ring stage
K6_STAGES = 6           # ring stages a block
K6_LANES = 2            # lanes a column (a ragged N: one)
K6_MIN_BLOCKS = 4       # blocks an SM holds (the source's launch bounds)
K6_MAX_SMEM = 232448    # the most shared memory a block may take


class K6Plan(NamedTuple):
    """A K6 call's launch (`csrc/wkv6_seq.cu:Plan`, field for field)."""
    blocks: int    # one a (b, h) pair
    threads: int   # np·lanes: thread j·np + m holds rows j·rows .. of
                   # column m, j steps behind lane 0
    lanes: int     # threads a state column
    rows: int      # rows of the column a thread holds, np / lanes
    np: int        # the instance's rows: N, or 64 for a ragged N
    tile: int      # steps a ring stage
    stages: int    # ring stages
    smem: int      # dynamic shared bytes a block: the ring, the running
                   # sums the lanes hand on (2, lanes - 1, np), u (np)
                   # and the initial state (N, N)
    ragged: int    # 1 where N is not 16, 32 or 64


def k6_stage_floats(np_: int) -> int:
    """Floats of one ring stage: the tile's r, k, w, v rows, then its
    valid flags."""
    return 4 * K6_TILE * np_ + K6_TILE


def k6_plan(B: int, T: int, H: int, N: int) -> K6Plan:
    """K6's launch for (B, T, H, N): the twin of the source's `plan_of`,
    held to it on the card by its C query `wkv6_seq_plan`.  A column takes
    K6_LANES lanes, a ragged N one.  Raises ValueError where the source
    refuses."""
    if not (B >= 1 and T >= 1 and H >= 1 and 1 <= N <= K6_MAX_N):
        raise ValueError(f"k6_plan: (B, T, H, N) {(B, T, H, N)} out of "
                         f"range (N <= {K6_MAX_N})")
    ragged = N not in (16, 32, 64)
    np_ = K6_MAX_N if ragged else N
    q = 1 if ragged else K6_LANES
    plan = K6Plan(B * H, np_ * q, q, np_ // q, np_, K6_TILE, K6_STAGES,
                  4 * (K6_STAGES * k6_stage_floats(np_) + 2 * (q - 1) * np_
                       + np_ + N * N), int(ragged))
    if plan.blocks > 2 ** 31 - 1 or plan.smem > K6_MAX_SMEM:
        raise ValueError(f"k6_plan: {plan} does not fit the card")
    return plan


def seq_flops(r, *_, **__):
    """2·B·T·H·N²: each step's r·S contraction, the one product JAX's HLO
    analysis counts in `wkv6_scan`, and in its VJP."""
    B, T, H, N = r.shape
    return 2 * B * T * H * N * N


def _seq_meta(r, *_, **__):
    B, T, H, N = r.shape
    return (meta_empty(r.shape, torch.float32),
            meta_empty((B, H, N, N), torch.float32))


@counted("wkv6_seq", meta=_seq_meta, flops=seq_flops)
def _seq_forward(r, k, v, w, u, s0, *, valid=None,
                 carry_dtype: Optional[str] = None):
    """One forward: the plain version on the CPU, K6 on the card."""
    if r.device.type == "cpu":
        return wkv6_seq_plain(r, k, v, w, u, s0, valid=valid,
                              carry_dtype=carry_dtype)
    B, T, H, N = r.shape
    ops = [r, k, v, w, u]
    if any(t.dtype != torch.float32 or t.device != r.device for t in ops):
        raise TypeError("wkv6_seq takes f32 r, k, v, w, u on one device")
    if s0.dtype not in (torch.float32, torch.bfloat16) or \
            s0.device != r.device:
        raise TypeError(f"wkv6_seq: s0 must be f32 or bf16 on {r.device}, "
                        f"got {s0.dtype} on {s0.device}")
    if any(t.shape != r.shape for t in (k, v, w)) or u.shape != (H, N) \
            or s0.shape != (B, H, N, N):
        raise ValueError("wkv6_seq: operand shapes do not agree")
    k6_plan(B, T, H, N)
    ops = [t.contiguous() for t in ops]
    s0 = s0.contiguous()
    vmask = None
    if valid is not None:
        if valid.shape != (B, T):
            raise ValueError(f"valid {tuple(valid.shape)} != {(B, T)}")
        vmask = valid.to(device=r.device, dtype=torch.int32).contiguous()
    y = torch.empty((B, T, H, N), dtype=torch.float32, device=r.device)
    sf = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    check(load_library().wkv6_seq(
        *(t.data_ptr() for t in ops), s0.data_ptr(),
        None if vmask is None else vmask.data_ptr(), y.data_ptr(),
        sf.data_ptr(), B, T, H, N, int(s0.dtype == torch.bfloat16),
        int(_CARRY[carry_dtype] is not None), stream_ptr(r)), "wkv6_seq")
    wkv6_seq.launches += 1
    return y, sf


# K6-bwd (csrc/wkv6_seq_bwd.cu, which owns them)
K6_BWD_WINDOW = 8       # steps between checkpoints of the state: a group
K6_BWD_HEAD_DIMS = (16, 32, 64)
K6_BWD_ROW_LANES = 4    # threads a state row, N / 4 columns each


class K6BwdPlan(NamedTuple):
    """A K6-bwd call's launch (`csrc/wkv6_seq_bwd.cu:plan_of`)."""
    blocks: int          # one a (b, h) pair
    threads: int         # 4N: thread 4n + j holds columns j·N/4 .. of row n
    window: int          # steps a group: one checkpoint, one barrier
    smem: int            # dynamic shared bytes: the group's states (then
                         # its G), two buffers of a group's r, k, v, w, dy
                         # (the next staged while this one is worked on),
                         # the bonus's terms and sums
    scratch_floats: int  # the checkpoints, then du's partials


def k6_bwd_plan(B: int, T: int, H: int, N: int) -> K6BwdPlan:
    """K6-bwd's launch for (B, T, H, N): the twin of the source's
    `plan_of`, held to it on the card by its C query `wkv6_seq_bwd_plan`.
    Raises ValueError where the source refuses."""
    if not (B >= 1 and T >= 1 and H >= 1 and N in K6_BWD_HEAD_DIMS):
        raise ValueError(f"k6_bwd_plan: (B, T, H, N) {(B, T, H, N)} out of "
                         f"range (N in {K6_BWD_HEAD_DIMS})")
    W, lanes = K6_BWD_WINDOW, K6_BWD_ROW_LANES
    smem = 4 * (W * N * N + 2 * 5 * W * N + W * N + W)
    plan = K6BwdPlan(B * H, lanes * N, W, smem,
                     B * H * (-(-T // W) * N * N + N))
    if plan.blocks > 2 ** 31 - 1 or plan.smem > K6_MAX_SMEM:
        raise ValueError(f"k6_bwd_plan: {plan} does not fit the card")
    return plan


def _seq_state_step(S, kt, vt, wt):
    """wkv6_step's state update, its ops in order: w·S + k⊗v."""
    return wt[..., :, None] * S + kt[..., :, None] * vt[..., None, :]


def wkv6_seq_bwd_plain(r, k, v, w, u, s0, dy, *,
                       window: Optional[int] = None):
    """K6-bwd's passes in torch ops (the derivation is in
    `csrc/wkv6_seq_bwd.cu`): the state forward from s0, kept at the start
    of every window of `window` steps (default K6_BWD_WINDOW); then the
    windows from the last, each window's states S_(t-1) recomputed from
    its checkpoint (the forward's update, so the forward's bits) and its
    steps walked backward, carrying G_t = dS_t from G_T = 0:
      dr_t = (S_(t-1) + u·(k_t ⊗ v_t)) dy_t,  dk_t = u·r_t (v_t·dy_t) +
      G_t v_t,  dv_t = (Σ r_t u k_t) dy_t + G_tᵀ k_t,  dw_t = rowsum(
      S_(t-1) ⊙ G_t),  du += r_t k_t (v_t·dy_t),  G_(t-1) = w_t ⊙rows G_t
      + r_t ⊗ dy_t;
    du summed over the batch in order.  -> (dr, dk, dv, dw (B, T, H, N),
    du (H, N)), all f32."""
    f32 = torch.float32
    r, k, v, w, u, dy = (t.to(f32) for t in (r, k, v, w, u, dy))
    T = r.shape[1]
    W = window or K6_BWD_WINDOW
    S = s0.to(f32)
    ckpt = []
    for t in range(T):
        if t % W == 0:
            ckpt.append(S)
        S = _seq_state_step(S, k[:, t], v[:, t], w[:, t])
    G = torch.zeros_like(S)
    du = torch.zeros_like(r[:, 0])
    out = [[None] * T for _ in range(4)]
    for j in range(len(ckpt) - 1, -1, -1):
        t0, t1 = j * W, min(T, (j + 1) * W)
        S, prev = ckpt[j], []
        for t in range(t0, t1):
            prev.append(S)
            S = _seq_state_step(S, k[:, t], v[:, t], w[:, t])
        for t in range(t1 - 1, t0 - 1, -1):
            Sp = prev[t - t0]
            rt, kt, vt, wt, gt = (x[:, t] for x in (r, k, v, w, dy))
            vdy = (vt * gt).sum(-1, keepdim=True)
            X = Sp + u[:, :, None] * (kt[..., :, None] * vt[..., None, :])
            out[0][t] = torch.einsum("bhnm,bhm->bhn", X, gt)
            out[1][t] = u * rt * vdy + torch.einsum("bhnm,bhm->bhn", G, vt)
            out[2][t] = (rt * u * kt).sum(-1, keepdim=True) * gt + \
                torch.einsum("bhnm,bhn->bhm", G, kt)
            out[3][t] = (Sp * G).sum(-1)
            du = du + rt * kt * vdy
            G = wt[..., :, None] * G + rt[..., :, None] * gt[..., None, :]
    du_sum = torch.zeros_like(u)
    for b in range(du.shape[0]):
        du_sum = du_sum + du[b]
    return (*(torch.stack(o, dim=1) for o in out), du_sum)


def _seq_bwd_meta(r, k, v, w, u, *_):
    f32 = torch.float32
    return (*(meta_empty(r.shape, f32) for _ in range(4)),
            meta_empty(u.shape, f32))


@counted("wkv6_seq_bwd", meta=_seq_bwd_meta, flops=seq_flops)
def wkv6_seq_bwd(r, k, v, w, u, s0, dy):
    """(dr, dk, dv, dw, du) of K6's y from the f32 initial state s0 (which
    takes no gradient), without a valid mask or a carry snap, for the
    output gradient dy (B, T, H, N) f32: the plain passes on the CPU,
    K6-bwd on the card, whose N must be 16, 32 or 64."""
    if r.device.type == "cpu":
        return wkv6_seq_bwd_plain(r, k, v, w, u, s0, dy)
    B, T, H, N = r.shape
    ops = [r, k, v, w, u, s0, dy]
    if any(t.dtype != torch.float32 or t.device != r.device for t in ops):
        raise TypeError("wkv6_seq_bwd takes f32 r, k, v, w, u, s0, dy on "
                        "one device")
    if any(t.shape != r.shape for t in (k, v, w, dy)) or \
            u.shape != (H, N) or s0.shape != (B, H, N, N):
        raise ValueError("wkv6_seq_bwd: operand shapes do not agree")
    plan = k6_bwd_plan(B, T, H, N)
    ops = [t.contiguous() for t in ops]
    f32 = dict(dtype=torch.float32, device=r.device)
    grads = [torch.empty((B, T, H, N), **f32) for _ in range(4)]
    du = torch.empty((H, N), **f32)
    scratch = torch.empty(plan.scratch_floats, **f32)
    check(load_library().wkv6_seq_bwd(
        *(t.data_ptr() for t in ops), *(g.data_ptr() for g in grads),
        du.data_ptr(), scratch.data_ptr(), B, T, H, N, stream_ptr(r)),
        "wkv6_seq_bwd")
    wkv6_seq_bwd.launches += 1
    return (*grads, du)


wkv6_seq_bwd.launches = 0


class _WKV6Seq(torch.autograd.Function):
    """K6 with its backward, for the forward's own call: the forward keeps
    its operands; the backward is `wkv6_seq_bwd`.  The final state carries
    no gradient."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        y, sf = _seq_forward(r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.mark_non_differentiable(sf)
        return y, sf

    @staticmethod
    def backward(ctx, dy, _):
        return (*wkv6_seq_bwd(*ctx.saved_tensors, dy.contiguous()), None)


def wkv6_seq(r, k, v, w, u, s0, *, valid=None,
             carry_dtype: Optional[str] = None):
    """r, k, v, w (B, T, H, N) f32; u (H, N) f32; s0 (B, H, N, N) f32 or
    bf16; valid (B, T) or None -> (y (B, T, H, N) f32, S (B, H, N, N)
    f32).  On the card the launch is `k6_plan`'s; under grad the
    forward's own call (no valid, no carry snap, an f32 s0 that takes no
    gradient, N 16, 32 or 64) runs through `_WKV6Seq`."""
    if carry_dtype not in _CARRY:
        raise ValueError(f"carry_dtype {carry_dtype!r}: expected one of "
                         f"{sorted(c for c in _CARRY if c)} or None")
    ops = (r, k, v, w, u, s0)
    if kernel_route(r) and torch.is_grad_enabled() and any(
            t.requires_grad for t in ops):
        if valid is None and _CARRY[carry_dtype] is None and \
                s0.dtype == torch.float32 and not s0.requires_grad and \
                r.shape[-1] in K6_BWD_HEAD_DIMS:
            return _WKV6Seq.apply(r, k, v, w, u, s0)
        refuse_grad("wkv6_seq", *ops, why=OWN_CALLS + "; K6-bwd takes an "
                    f"f32 s0 and N in {K6_BWD_HEAD_DIMS}")
    return _seq_forward(r, k, v, w, u, s0, valid=valid,
                        carry_dtype=carry_dtype)


wkv6_seq.launches = 0


# ---------------------------------------------------------------------------
# K10: the chunked form
# ---------------------------------------------------------------------------

K10_HEAD_DIMS = (16, 32, 64)
K10_MAX_CHUNK = 64
_K10_DTYPES = (torch.float32, torch.bfloat16)


def chunk_length(T: int, chunk: int = 64) -> int:
    """The chunk the TPU kernel's wrapper takes: min(chunk, T), halved
    until it divides T."""
    C = min(chunk, T)
    while T % C != 0:
        C //= 2
    return C


def _cum_logs(w5):
    """w (B, G, C, H, N) f32 -> (L, Lprev): the inclusive cumsum of log
    max(w, 1e-38) over each chunk in order of the positions (the kernels'
    order), and L - log w."""
    logw = torch.log(torch.clamp(w5, min=1e-38))
    cum = [logw[:, :, 0]]
    for c in range(1, w5.shape[2]):
        cum.append(cum[-1] + logw[:, :, c])
    L = torch.stack(cum, dim=2)
    return L, L - logw


def wkv6_chunked_plain(r, k, v, w, u, s0=None, *, chunk: int = 64):
    """The plain version, K10's one-level algorithm in torch: log max(w,
    1e-38), its inclusive cumsum L over each chunk taken in order of the
    positions (the kernel's order), Lprev = L - log w; then per chunk the
    inter-chunk (r e^Lprev) @ S, the exact (C, C, N) pairwise decay masked
    strictly lower to -1e30 before the exp and its att @ v, the u-bonus,
    and S <- e^Ltot S + (k e^(Ltot - L))ᵀ v.  All in f32."""
    B, T, H, N = r.shape
    C = chunk_length(T, chunk)
    G = T // C
    f32 = torch.float32
    resh = lambda x: x.to(f32).reshape(B, G, C, H, N)
    rs, ks, vs = resh(r), resh(k), resh(v)
    L, Lprev = _cum_logs(resh(w))
    u32 = u.to(f32)
    S = torch.zeros((B, H, N, N), dtype=f32, device=r.device) \
        if s0 is None else s0.to(f32)
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    ys = []
    for g in range(G):
        rc, kc, vc, Lc, Lp = rs[:, g], ks[:, g], vs[:, g], L[:, g], \
            Lprev[:, g]
        y = torch.einsum("bchn,bhnm->bchm", rc * torch.exp(Lp), S)
        D = Lp[:, :, None] - Lc[:, None, :]           # (B, C, C, H, N)
        D = torch.where(mask[None, :, :, None, None], D, -1e30)
        att = torch.einsum("bshn,bihn,bsihn->bhsi", rc, kc, torch.exp(D))
        y = y + torch.einsum("bhsi,bihn->bshn", att, vc)
        y = y + torch.sum(rc * u32 * kc, dim=-1, keepdim=True) * vc
        Ltot = Lc[:, -1:]                              # (B, 1, H, N)
        k_fut = kc * torch.exp(Ltot - Lc)
        S = torch.exp(Ltot[:, 0])[..., None] * S + torch.einsum(
            "bchn,bchm->bhnm", k_fut, vc)
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(B, T, H, N), S


K10_SUB = 16            # a sub-chunk: one m16n8k16 row block
K10_STATE_THREADS = 128  # launch A's block
K10_SCAN_THREADS = 256   # launch B's block
K10_OUT_THREADS = 256    # launch C's block


class K10Plan(NamedTuple):
    """What one K10 call launches (`csrc/wkv6_chunked.cu`)."""
    C: int                # the chunk, `chunk_length(T, chunk)`
    G: int                # chunks a sequence
    Cp: int               # C padded to whole sub-chunks (rows >= C zero)
    n_sub: int            # sub-chunks of K10_SUB rows a chunk
    passes: tuple         # (name, blocks, threads, shared bytes), in order
    workspace_bytes: int  # ΔS_g / S_(g-1) and e^Ltot_g of every chunk


def k10_plan(B: int, T: int, H: int, N: int, chunk: int = 64, *,
             rkv_bytes: int = 2) -> K10Plan:
    """K10's launches for (B, T, H, N): A (`chunk_state_kernel`, a block a
    chunk: L and ΔS_g = (k e^(Ltot-L))ᵀ v), B (`state_scan_kernel`, a
    thread a (b, h, n, m) chain over the G chunks in order) and C
    (`chunk_output_kernel`, a block a chunk: y).  The passes are the twin
    of the source's `plan_of` (shared bytes as its `smem_state` /
    `smem_output`; PV: v's pieces, 1 for bf16 r, k, v and 3 for f32),
    held to it on the card by its C query `wkv6_chunked_plan`."""
    C = chunk_length(T, chunk)
    G = T // C
    Cp = -(-C // K10_SUB) * K10_SUB
    n_sub = Cp // K10_SUB
    pv = 1 if rkv_bytes == 2 else 3
    chunks = B * H * G
    smem_a = 2 * Cp * (N + 4) * 4 + pv * Cp * (N + 8) * 2
    smem_c = 4 * Cp * (N + 8) * 4 + max(3 * N * (N + 8) * 2,
                                        Cp * (Cp + 8) * 4) \
        + pv * Cp * (N + 8) * 2 + (N + Cp) * 4
    scan = B * H * N * N
    passes = (
        ("chunk_state", chunks, K10_STATE_THREADS, smem_a),
        ("state_scan", -(-scan // K10_SCAN_THREADS), K10_SCAN_THREADS, 0),
        ("chunk_output", chunks, K10_OUT_THREADS, smem_c),
    )
    return K10Plan(C, G, Cp, n_sub, passes, 4 * chunks * (N * N + N))


# K10-bwd (csrc/wkv6_chunked_bwd.cu, which owns them)
K10_BWD_STATE_THREADS = 128  # launch 1's block: (r e^Lp)ᵀ dy
K10_BWD_SCAN_THREADS = 256   # launch 2's: the state gradients' chains
K10_BWD_GRAD_THREADS = 256   # launch 3's: a chunk's gradients
K10_BWD_SUM_THREADS = 128    # launch 4's: du's sum


class K10BwdPlan(NamedTuple):
    """What one K10-bwd call launches (`csrc/wkv6_chunked_bwd.cu`)."""
    C: int                # the chunk, `chunk_length(T, chunk)`
    G: int                # chunks a sequence
    Cp: int               # C padded to whole sub-chunks (rows >= C zero)
    n_sub: int            # sub-chunks of K10_SUB rows a chunk
    passes: tuple         # (name, blocks, threads, shared bytes), in order
    scratch_bytes: int    # the state gradients G_g, then du's partials


def k10_bwd_pieces(rkv_bytes: int) -> int:
    """The bf16 pieces an f32 operand of K10-bwd's products takes: two
    (the rounded split, `kernels/flash_attention.py:split_bf16x2`) when r,
    k, v are bf16, whose gradients round to bf16; three (the exact split,
    `kernels/fused_prefill.py:split_bf16x3`) for f32 r, k, v."""
    return 2 if rkv_bytes == 2 else 3


def k10_bwd_smem(N: int, Cp: int, pieces: int) -> tuple:
    """Launch 1's and launch 3's dynamic shared bytes (the source's
    `smem_state` and `smem_grad`).  Launch 1: r e^Lp and log w as f32
    tiles of row stride N + 4, dy in `pieces` bf16 tiles of stride N + 8.
    Launch 3, f32 throughout (v is read from device memory): R', K'', dy
    (later XI, then dy again) of stride N + 8 and PT (S_(g-1), then P̃'s
    own rows, then G_g: max(Cp, N) rows) of stride N + 8, VD (later A) of
    stride Cp + 8, and per column the sub-chunk decays, e^Lb, the c
    factors, σ, ρ, rowsum(S ⊙ G), u and du's partials, and A's diagonal
    blocks in two halves of the columns."""
    ns = Cp // K10_SUB
    state = 2 * Cp * (N + 4) * 4 + pieces * Cp * (N + 8) * 2
    small = N * (4 * ns + ns * (ns + 1) // 2 + ns * ns + 2) \
        + 2 * ns * K10_SUB * K10_SUB
    grad = 4 * ((3 * Cp + max(Cp, N)) * (N + 8) + Cp * (Cp + 8) + small)
    return state, grad


def k10_bwd_plan(B: int, T: int, H: int, N: int, chunk: int = 64, *,
                 rkv_bytes: int = 2) -> K10BwdPlan:
    """K10-bwd's launches for (B, T, H, N): 1 (`state_grad_kernel`, a block
    a chunk: (r e^Lp)ᵀ dy on the tensor cores), 2 (`grad_scan_kernel`, a
    thread a (b, h, n, m) chain over the chunks from the last), 3
    (`chunk_grad_kernel`, a block a chunk: dr, dk, dv, dw, du's partials)
    and 4 (`du_sum_kernel`, a thread a (h, n)).  The twin of the source's
    `plan_of`, held to it on the card by its C query
    `wkv6_chunked_bwd_plan`; r's type (`rkv_bytes`) sets launch 1's pieces
    of dy (`k10_bwd_pieces`)."""
    fwd = k10_plan(B, T, H, N, chunk)
    chunks = B * H * fwd.G
    scan = B * H * N * N
    state, grad = k10_bwd_smem(N, fwd.Cp, k10_bwd_pieces(rkv_bytes))
    passes = (
        ("state_grad", chunks, K10_BWD_STATE_THREADS, state),
        ("grad_scan", -(-scan // K10_BWD_SCAN_THREADS),
         K10_BWD_SCAN_THREADS, 0),
        ("chunk_grad", chunks, K10_BWD_GRAD_THREADS, grad),
        ("du_sum", -(-(H * N) // K10_BWD_SUM_THREADS),
         K10_BWD_SUM_THREADS, 0),
    )
    return K10BwdPlan(fwd.C, fwd.G, fwd.Cp, fwd.n_sub, passes,
                      fwd.workspace_bytes)


def _subchunks(T: int, chunk: int):
    """(C, S, sub-chunks a chunk) of JAX's `wkv6_chunked` at K10's chunk:
    sub-chunks of min(16, C), or one where 16 does not divide C."""
    C = chunk_length(T, chunk)
    S = min(16, C)
    if C % S:
        S = C
    return C, S, C // S


def chunked_flops(r, *_, chunk: int = 64, **__):
    """The products JAX's HLO analysis counts in `wkv6_chunked`, per
    (b, t, h, n): 2N for the inter-chunk y and 2N for the state update,
    4C for the earlier keys' scores and their values, 4S for the
    diagonal sub-chunk's, 2 for the bonus."""
    B, T, H, N = r.shape
    C, S, _ = _subchunks(T, chunk)
    return B * T * H * N * (4 * N + 4 * (C + S) + 2)


def chunked_bwd_flops(r, *_, chunk: int = 64, **__):
    """The products JAX's HLO analysis counts in the VJP of
    `wkv6_chunked` for y's cotangent (`jax.vjp`; the final state takes
    none), per (b, t, h, n): 8N, two products each for the inter-chunk y
    and the state update, or 2N where T is one chunk (no state gradient
    to carry: only y's own product against the initial state is left);
    8C (the earlier keys' scores and values); 6S (the diagonal block: one
    product for its scores, whose other cotangent is an outer product,
    two for its values); and 2S more where a chunk has two sub-chunks or
    more (XLA keeps one more product of the earlier keys' kind there)."""
    B, T, H, N = r.shape
    C, S, n_sub = _subchunks(T, chunk)
    state = 8 * N if T > C else 2 * N
    return B * T * H * N * (state + 8 * C + 6 * S + (2 * S if n_sub > 1
                                                     else 0))


def _chunked_meta(r, k, v, w, u, s0=None, *, chunk: int = 64):
    B, T, H, N = r.shape
    f32 = torch.float32
    return (meta_empty(r.shape, f32), meta_empty((B, H, N, N), f32),
            meta_empty((k10_plan(B, T, H, N, chunk).workspace_bytes // 4,),
                       f32))


@counted("wkv6_chunked_kernel", meta=_chunked_meta, flops=chunked_flops)
def _chunked_forward(r, k, v, w, u, s0=None, *, chunk: int = 64):
    """One forward -> (y, final S, workspace): the plain version on the
    CPU (no workspace), K10 on the card, whose workspace then holds
    S_(g-1) and e^Ltot_g of every chunk (`k10_plan`)."""
    if r.device.type == "cpu":
        return (*wkv6_chunked_plain(r, k, v, w, u, s0, chunk=chunk), None)
    B, T, H, N = r.shape
    if r.dtype not in _K10_DTYPES or k.dtype != r.dtype or \
            v.dtype != r.dtype or w.dtype not in _K10_DTYPES:
        raise TypeError("wkv6_chunked_kernel takes r, k, v of one type and "
                        "w, each f32 or bf16; got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}, {w.dtype}")
    if any(t.shape != r.shape for t in (k, v, w)) or u.shape != (H, N) or (
            s0 is not None and s0.shape != (B, H, N, N)):
        raise ValueError("wkv6_chunked_kernel: operand shapes do not agree")
    if N not in K10_HEAD_DIMS:
        raise ValueError(f"wkv6_chunked_kernel: head dim {N} not in "
                         f"{K10_HEAD_DIMS}")
    C = chunk_length(T, chunk)
    if C > K10_MAX_CHUNK:
        raise ValueError(f"wkv6_chunked_kernel: chunk {C} > "
                         f"{K10_MAX_CHUNK}")
    if any(t.device != r.device for t in (k, v, w, u)) or (
            s0 is not None and s0.device != r.device):
        raise ValueError("wkv6_chunked_kernel: operands on other devices")
    r, k, v, w = _aligned(r, k, v, w)
    u = u.to(torch.float32).contiguous()
    if s0 is not None:
        s0 = s0.to(torch.float32).contiguous()
    y = torch.empty((B, T, H, N), dtype=torch.float32, device=r.device)
    sf = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    plan = k10_plan(B, T, H, N, chunk)
    ws = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32,
                     device=r.device)
    check(load_library().wkv6_chunked(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), None if s0 is None else s0.data_ptr(), y.data_ptr(),
        sf.data_ptr(), ws.data_ptr(), B, T, H, N, C,
        int(r.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
        stream_ptr(r)), "wkv6_chunked_kernel")
    wkv6_chunked_kernel.launches += 1
    return y, sf, ws


def _aligned(*ts):
    """The kernels read 16-byte vectors: a view off a 16-byte boundary is
    copied to one that starts on it."""
    return [t if t.is_contiguous() and t.data_ptr() % 16 == 0
            else t.clone(memory_format=torch.contiguous_format) for t in ts]


def wkv6_chunked_bwd_plain(r, k, v, w, u, dy, s0=None, *, chunk: int = 64):
    """K10-bwd's passes in torch ops (the derivation is in
    `csrc/wkv6_chunked_bwd.cu`), over the chunks of `wkv6_chunked_plain`:
    the states S_(g-1) by K10's own chain (launches A and B); the state
    gradients G_g = dS_g by the reverse chain from G = 0, dS_(g-1) =
    e^Ltot ⊙rows G_g + (r e^Lprev)ᵀ dy; then chunk by chunk, with the
    exact pairwise decays E[t, i] = e^(Lprev_t - L_i) (i < t) and VD[t, i]
    = v_i·dy_t,
      dr_t = e^Lprev_t (S dy_t) + Σ_(i<t) k_i E[t, i] VD[t, i]
             + u k_t VD[t, t]
      dk_i = Σ_(t>i) r_t E[t, i] VD[t, i] + e^(Ltot - L_i) (G v_i)
             + u r_i VD[i, i]
      dv_i = Σ_(t>i) A[t, i] dy_t + (Σ r_i u k_i) dy_i + Gᵀ (k_i
             e^(Ltot - L_i)),  A[t, i] = Σ_n r_t k_i E[t, i]
      dw_s = Σ_(t>s) r_t e^(Lprev_t - L_s) X_s[t] + e^(Ltot - L_s) Y_s
    where w >= 1e-38 (torch's clamp gradient), else 0: X_s[t] = (S_(s-1)
    dy_t) and Y_s = rowsum(S_(s-1) ⊙ G) over the chunk's running state,
    walked forward from X_0[t] = S dy_t, Y_0 = rowsum(S ⊙ G) by X_(s+1) =
    w_s X_s + k_s VD[:, s] and Y_(s+1) = w_s Y_s + k_s (G v_s), w_s =
    e^(log max(w, 1e-38)): dℓ / w with its one factor w_s divided out, so
    no term cancels another (the reverse-cumsum form of dℓ does, under
    strong decay).  du is the sum of r_t k_t VD[t, t] over the chunks and
    the batch, in order.  -> (dr, dk, dv in r's dtype, dw in w's, du
    (H, N) f32), each rounded once from f32, as autograd of
    `wkv6_chunked_plain` rounds them.  On |r|, |k|, |v|, |u|, |dy| every
    term is positive, and each output the magnitude of what it sums."""
    B, T, H, N = r.shape
    C = chunk_length(T, chunk)
    G = T // C
    f32 = torch.float32
    resh = lambda x: x.to(f32).reshape(B, G, C, H, N)
    rs, ks, vs, dys, w32 = (resh(x) for x in (r, k, v, dy, w))
    u32 = u.to(f32)
    L, Lp = _cum_logs(w32)
    ew = torch.exp(torch.log(torch.clamp(w32, min=1e-38)))
    Ltot = L[:, :, -1]                                 # (B, G, H, N)
    eLt = torch.exp(Ltot)[..., None]
    S = torch.zeros((B, H, N, N), dtype=f32, device=r.device) \
        if s0 is None else s0.to(f32)
    Sprev = []
    for g in range(G):
        Sprev.append(S)
        dS = torch.einsum("bchn,bchm->bhnm",
                          ks[:, g] * torch.exp(Ltot[:, g, None] - L[:, g]),
                          vs[:, g])
        S = eLt[:, g] * S + dS
    Gd = torch.zeros_like(S)
    Gs = [None] * G
    for g in range(G - 1, -1, -1):
        Gs[g] = Gd
        Gd = eLt[:, g] * Gd + torch.einsum(
            "bchn,bchm->bhnm", rs[:, g] * torch.exp(Lp[:, g]), dys[:, g])
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    outs = [[] for _ in range(4)]
    du = []
    for g in range(G):
        rc, kc, vc, dyc, Lc, Lpc = (x[:, g] for x in (rs, ks, vs, dys, L,
                                                        Lp))
        Sg, Gg = Sprev[g], Gs[g]
        D = Lpc[:, :, None] - Lc[:, None, :]           # (B, Ct, Ci, H, N)
        E = torch.exp(torch.where(mask[None, :, :, None, None], D, -1e30))
        VD = torch.einsum("bihm,bthm->btih", vc, dyc)  # (B, Ct, Ci, H)
        vdy = (vc * dyc).sum(-1, keepdim=True)         # VD's diagonal
        ef = torch.exp(Ltot[:, g, None] - Lc)          # e^(Ltot - L)
        SD = torch.einsum("bhnm,bthm->bthn", Sg, dyc)
        GV = torch.einsum("bhnm,bihm->bihn", Gg, vc)
        dr = torch.exp(Lpc) * SD + torch.einsum(
            "btihn,bihn,btih->bthn", E, kc, VD)
        dk = torch.einsum("btihn,bthn,btih->bihn", E, rc, VD) + ef * GV
        A = torch.einsum("bthn,bihn,btihn->btih", rc, kc, E)
        dv = torch.einsum("btih,bthm->bihm", A, dyc) + torch.einsum(
            "bihn,bhnm->bihm", kc * ef, Gg)
        X, Y = SD, (Sg * Gg).sum(-1)
        dw = [None] * C
        for s_ in range(C):
            later = rc[:, s_ + 1:] * torch.exp(
                Lpc[:, s_ + 1:] - Lc[:, s_:s_ + 1])
            dw[s_] = (later * X[:, s_ + 1:]).sum(1) + torch.exp(
                Ltot[:, g] - Lc[:, s_]) * Y
            e_s = ew[:, g, s_]
            X = e_s[:, None] * X + kc[:, s_:s_ + 1] * VD[:, :, s_, :, None]
            Y = e_s * Y + kc[:, s_] * GV[:, s_]
        outs[0].append(dr + u32 * kc * vdy)
        outs[1].append(dk + u32 * rc * vdy)
        outs[2].append(dv + (rc * u32 * kc).sum(-1, keepdim=True) * dyc)
        outs[3].append(torch.stack(dw, dim=1))
        du.append((rc * kc * vdy).sum(1))              # (B, H, N)
    dr, dk, dv, dw = (torch.stack(o, dim=1).reshape(B, T, H, N)
                      for o in outs)
    dw = torch.where(w.to(f32) >= 1e-38, dw, torch.zeros_like(dw))
    du_sum = torch.zeros((H, N), dtype=f32, device=r.device)
    for g in range(G):
        for b in range(B):
            du_sum = du_sum + du[g][b]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du_sum)


def _chunked_bwd_meta(r, k, v, w, u, *_, **__):
    return (*(meta_empty(t.shape, t.dtype) for t in (r, k, v, w)),
            meta_empty(u.shape, torch.float32))


def _chunked_bwd_reads(r, k, v, w, u, dy, s0=None, *, chunk: int = 64,
                       workspace=None):
    """K10-bwd's operands and the forward's workspace it reads, whichever
    device holds them (the CPU's plain forward makes no workspace)."""
    B, T, H, N = r.shape
    return (nbytes((r, k, v, w, u, dy, s0))
            + k10_plan(B, T, H, N, chunk).workspace_bytes)


@counted("wkv6_chunked_bwd", meta=_chunked_bwd_meta, flops=chunked_bwd_flops,
         operand_bytes=_chunked_bwd_reads)
def wkv6_chunked_bwd(r, k, v, w, u, dy, s0=None, *, chunk: int = 64,
                     workspace=None):
    """(dr, dk, dv, dw, du) of K10's y from the initial state s0 (zeros
    when None; it takes no gradient) for the output gradient dy
    (B, T, H, N) f32: the plain passes on the CPU (s0 used, `workspace`
    not), K10-bwd on the card, which reads S_(g-1) and e^Ltot_g from the
    forward's `workspace` (the third output of `_chunked_forward`) and
    four launches, counted as one.  dr, dk, dv in r's
    dtype, dw in w's, du (H, N) f32, as `wkv6_chunked_bwd_plain`."""
    if r.device.type == "cpu":
        return wkv6_chunked_bwd_plain(r, k, v, w, u, dy, s0, chunk=chunk)
    B, T, H, N = r.shape
    if workspace is None:
        raise ValueError("wkv6_chunked_bwd takes the forward's workspace "
                         "on the card")
    if r.dtype not in _K10_DTYPES or k.dtype != r.dtype or \
            v.dtype != r.dtype or w.dtype not in _K10_DTYPES or \
            dy.dtype != torch.float32:
        raise TypeError("wkv6_chunked_bwd takes r, k, v of one type, w f32 "
                        "or bf16 and dy f32")
    if any(t.shape != r.shape for t in (k, v, w, dy)) or \
            u.shape != (H, N) or N not in K10_HEAD_DIMS:
        raise ValueError("wkv6_chunked_bwd: operand shapes do not agree "
                         f"or head dim {N} not in {K10_HEAD_DIMS}")
    C = chunk_length(T, chunk)
    plan = k10_plan(B, T, H, N, chunk)
    if C > K10_MAX_CHUNK or workspace.dtype != torch.float32 or \
            workspace.numel() * 4 != plan.workspace_bytes:
        raise ValueError("wkv6_chunked_bwd: chunk or workspace does not "
                         "fit the call")
    r, k, v, w, dy = _aligned(r, k, v, w, dy)
    u = u.to(torch.float32).contiguous()
    grads = [torch.empty_like(t) for t in (r, k, v, w)]
    du = torch.empty((H, N), dtype=torch.float32, device=r.device)
    scratch = torch.empty_like(workspace)   # G_g, then du's partial sums
    check(load_library().wkv6_chunked_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), dy.data_ptr(), workspace.data_ptr(),
        *(g.data_ptr() for g in grads), du.data_ptr(), scratch.data_ptr(),
        B, T, H, N, C, int(r.dtype == torch.bfloat16),
        int(w.dtype == torch.bfloat16), stream_ptr(r)), "wkv6_chunked_bwd")
    wkv6_chunked_bwd.launches += 1
    return (*grads, du)


wkv6_chunked_bwd.launches = 0


class _WKV6Chunked(torch.autograd.Function):
    """K10 with its backward, for the forward's own call: the forward
    keeps its operands and its workspace (S_(g-1) of every chunk); the
    backward is `wkv6_chunked_bwd`.  The final state carries no
    gradient."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, chunk):
        y, sf, ws = _chunked_forward(r, k, v, w, u, s0, chunk=chunk)
        ctx.save_for_backward(r, k, v, w, u, s0, ws)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(sf)
        return y, sf

    @staticmethod
    def backward(ctx, dy, _):
        r, k, v, w, u, s0, ws = ctx.saved_tensors
        dr, dk, dv, dw, du = wkv6_chunked_bwd(
            r, k, v, w, u, dy.contiguous(), s0, chunk=ctx.chunk,
            workspace=ws)
        return dr, dk, dv, dw, du.to(u.dtype), None, None


def wkv6_chunked_kernel(r, k, v, w, u, s0=None, *, chunk: int = 64):
    """r, k, v (B, T, H, N) f32 or bf16 (one type); w (B, T, H, N) f32 or
    bf16; u (H, N); s0 (B, H, N, N) f32 or None (zeros) -> (y (B, T, H, N)
    f32, final S (B, H, N, N) f32), over chunks of `chunk_length(T,
    chunk)` tokens.  On the card N must be 16, 32 or 64 and the chunk at
    most 64; one call is three CUDA launches (`k10_plan`) and counts one,
    with a workspace of `k10_plan(...).workspace_bytes`.  Under grad the
    forward's own call (an s0 that takes no gradient) runs through
    `_WKV6Chunked`, which keeps the workspace for `wkv6_chunked_bwd`."""
    if kernel_route(r) and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, s0)):
        if s0 is not None and s0.requires_grad:
            refuse_grad("wkv6_chunked_kernel", r, k, v, w, u, s0,
                        why=OWN_CALLS)
        return _WKV6Chunked.apply(r, k, v, w, u, s0, chunk)
    return _chunked_forward(r, k, v, w, u, s0, chunk=chunk)[:2]


wkv6_chunked_kernel.launches = 0
