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

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises, also when grad mode is on and an operand requires grad: the
kernels have no backward yet, and rwkv6's training on the card waits for
theirs (`kernels/build.py:WAITS`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.wkv.wkv6 import wkv6_step
from repro_torch.kernels.build import (
    check, load_library, refuse_grad, stream_ptr)

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


def wkv6_seq(r, k, v, w, u, s0, *, valid=None,
             carry_dtype: Optional[str] = None):
    """r, k, v, w (B, T, H, N) f32; u (H, N) f32; s0 (B, H, N, N) f32 or
    bf16; valid (B, T) or None -> (y (B, T, H, N) f32, S (B, H, N, N)
    f32).  On the card the launch is `k6_plan`'s."""
    if carry_dtype not in _CARRY:
        raise ValueError(f"carry_dtype {carry_dtype!r}: expected one of "
                         f"{sorted(c for c in _CARRY if c)} or None")
    if r.device.type == "cpu":
        return wkv6_seq_plain(r, k, v, w, u, s0, valid=valid,
                              carry_dtype=carry_dtype)
    refuse_grad("wkv6_seq", r, k, v, w, u, s0)
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
    logw = torch.log(torch.clamp(resh(w), min=1e-38))
    cum = [logw[:, :, 0]]
    for c in range(1, C):
        cum.append(cum[-1] + logw[:, :, c])
    L = torch.stack(cum, dim=2)                       # (B, G, C, H, N)
    Lprev = L - logw
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


def wkv6_chunked_kernel(r, k, v, w, u, s0=None, *, chunk: int = 64):
    """r, k, v (B, T, H, N) f32 or bf16 (one type); w (B, T, H, N) f32 or
    bf16; u (H, N); s0 (B, H, N, N) f32 or None (zeros) -> (y (B, T, H, N)
    f32, final S (B, H, N, N) f32), over chunks of `chunk_length(T,
    chunk)` tokens.  On the card N must be 16, 32 or 64 and the chunk at
    most 64; one call is three CUDA launches (`k10_plan`) and counts one,
    with a workspace of `k10_plan(...).workspace_bytes`."""
    if r.device.type == "cpu":
        return wkv6_chunked_plain(r, k, v, w, u, s0, chunk=chunk)
    refuse_grad("wkv6_chunked_kernel", r, k, v, w, u, s0)
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
    # the kernels read 16-byte vectors: a view off a 16-byte boundary is
    # copied to one that starts on it
    r, k, v, w = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                  else t.clone(memory_format=torch.contiguous_format)
                  for t in (r, k, v, w))
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
    return y, sf


wkv6_chunked_kernel.launches = 0
