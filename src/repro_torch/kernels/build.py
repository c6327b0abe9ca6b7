"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

At first use, every `csrc/*.cu` source is compiled for `sm_90a` by its own
nvcc process, all started together, and the objects are linked into
`<checkout>/build/repro_torch/libkernels.so`, which ctypes then loads.
The library has a plain C interface: device pointers and the stream are
passed as integers, and each entry point returns `cudaGetLastError()`.

No `--use_fast_math`: it changes `expf` and division, and both feed the WKV
arithmetic.  `-fmad=false` keeps every elementwise a*b+c as a multiply and
an add, each rounded, as eager PyTorch computes it; the matvec loops call
`fmaf` explicitly.

`counted` is the hook every kernel wrapper's launching function carries:
it lets an op count (`launch/op_analysis.py`) record each launch as one
op, and lets meta tensors pass through the kernels without a launch
while the count runs.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libkernels.so"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_PP, _PI = ctypes.POINTER(_P), ctypes.POINTER(_I)
_LL = ctypes.c_longlong
_PL = ctypes.POINTER(_LL)
_F = ctypes.c_float

# C entry points: argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    "dpot_w8_matmul": [_P] * 6 + [_I] * 9 + [_P],
    "dpot_w8_matmul_f32x": [_P] * 6 + [_I] * 9 + [_P],
    "dpot_w4_matmul_f32x": [_P] * 6 + [_I] * 9 + [_P],
    "vq_matmul_f32x": [_P, _P, _P, _I, _P, _P] + [_I] * 9 + [_P],
    "dpot_w4_matmul": [_P] * 6 + [_I] * 9 + [_P],
    "vq_matmul": [_P, _P, _P, _I, _P, _P] + [_I] * 9 + [_P],
    "wkv4_seq": [_P] * 14 + [_I] * 6 + [_P],
    "wkv4_plan": [_I] * 7 + [_PL],
    "wkv4_div_fast": [_P] * 5 + [_LL, _P],
    "expsig": [_P, _P, _P, _LL, _I, _I, _P],
    "rwkv4_block_decode": [_PP, _I, _PI] + [_I] * 10 + [_P],
    "rwkv4_block_decode_grid": [_PI, _I, _I, _PI, _PI],
    "rwkv4_model_decode": [_PP, _I, _PL, _I, _PI] + [_I] * 11 + [_P],
    "wkv6_seq": [_P] * 9 + [_I] * 6 + [_P],
    "wkv6_seq_plan": [_I] * 4 + [_PL],
    "wkv6_snap_check": [_P, _P],
    "wkv6_chunked": [_P] * 9 + [_I] * 7 + [_P],
    "wkv6_chunked_plan": [_I] * 6 + [_PI],
    "fused_layernorm": [_P] * 4 + [_I, _I, _F] + [_I] * 4 + [_P],
    "rwkv6_block_decode": [_PP, _I, _PI] + [_I] * 6 + [_P],
    "rwkv6_model_decode": [_PP, _I, _PL, _I, _PI] + [_I] * 8 + [_P],
    "rwkv6_block_decode_grid": [_PI, _PI, _PI],
    "rwkv6_model_decode_grid": [_PI, _PI, _PI],
    "rwkv6_decode_plan": [_PI] + [_I] * 6 + [_PI],
    "flash_attention_fwd": [_P] * 5 + [_I] * 8 + [_F, _I, _P],
    "flash_attention_dq": [_P] * 7 + [_I] * 8 + [_F, _I, _P],
    "flash_attention_dkv": [_P] * 8 + [_I] * 8 + [_F, _I, _P],
    "fused_ce_fwd": [_P] * 4 + [_I] * 3 + [_P],
    "fused_ce_bwd": [_P] * 5 + [_I] * 4 + [_P],
    "fused_layernorm_bwd": [_P] * 7 + [_I] * 5 + [_F] + [_I] * 4 + [_P],
    "wkv4_seq_bwd": [_P] * 14 + [_I] * 4 + [_P],
    "wkv6_chunked_bwd": [_P] * 13 + [_I] * 7 + [_P],
    "wkv6_seq_bwd": [_P] * 13 + [_I] * 4 + [_P],
    "wkv6_chunked_bwd_plan": [_I] * 6 + [_PI],
    "wkv6_seq_bwd_plan": [_I] * 4 + [_PL],
    "dpot_matmul": [_P] * 6 + [_I] * 10 + [_P],
    "dpot_matmul_w4": [_P] * 6 + [_I] * 10 + [_P],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _stale(lib: Path) -> bool:
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir())
    return lib.stat().st_mtime < newest


def build() -> tuple[Path, str]:
    """Compile every source in parallel and link the library; returns the
    library path and the compilers' combined output (-Xptxas -v: each
    kernel's registers, shared memory and spills)."""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    lib = BUILD_DIR / LIB_NAME
    os.replace(tmp, lib)          # atomic: a concurrent loader sees old or new
    text = "\n".join(log)
    (BUILD_DIR / "ptxas.log").write_text(text)
    return lib, text


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if missing or stale."""
    lib_path = BUILD_DIR / LIB_NAME
    if _stale(lib_path):
        lib_path, _ = build()
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rwkv6_decode_scratch_bytes.argtypes = [_I, _I]
    lib.rwkv6_decode_scratch_bytes.restype = ctypes.c_longlong
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = load_library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


HW_UNTRAINED = ("the hardware numerics are not trained (JAX's loss_fn "
                "runs the standard ones)")


def refuse_grad(name: str, *tensors, why: str):
    """Raise where a kernel with no backward would be asked for gradients:
    grad mode on and an operand that requires grad.  `why` says what the
    gradient waits for, or which calls a backward kernel covers.  The plain versions on CPU tensors stay
    differentiable; a CUDA call never falls back to them."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: this call has no backward kernel; {why}. Run it under "
            "torch.no_grad(), or on CPU tensors for the differentiable "
            "plain version")


def stream_ptr(t) -> int:
    """The current CUDA stream of `t`'s device, as an integer handle."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# The op count's hook (launch/op_analysis.py)
# ---------------------------------------------------------------------------


def op_count():
    """The op count (`launch/op_analysis.OpCount`, a dispatch mode) active
    on this thread, or None.  The autograd engine carries the mode stack
    to its backward threads, so a backward sees the count too."""
    import torch
    if not torch._C._len_torch_dispatch_stack():
        return None
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if getattr(mode, "counts_kernels", False):
            return mode
    return None


def kernel_route(t) -> bool:
    """Whether a call on `t` takes the kernels' route (their autograd
    Functions and reshapes): any tensor not on the CPU, and a CPU tensor
    while an op count runs, so that a count records the same kernel ops
    on every device.  Outside a count a CPU tensor takes the plain
    version's own route, under autograd."""
    return t.device.type != "cpu" or op_count() is not None


def tensors(tree) -> list:
    """Every tensor in a tree of dicts, lists, tuples and dataclasses,
    each once."""
    import torch
    out, seen, stack = [], set(), [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                out.append(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))
    return out


def nbytes(tree) -> int:
    """The bytes of every tensor in `tree` at its stored dtype."""
    return sum(t.numel() * t.element_size() for t in tensors(tree))


def counted(name: str, *, meta, flops=None, launches=None,
            operand_bytes=None):
    """The launch-site hook of a kernel wrapper: decorates the function
    that launches the kernel (the one that adds to `.launches`).

    - No op count running: the call is what it was (a CUDA tensor
      launches or raises, a CPU tensor takes the plain version, any other
      device goes to the kernel, whose checks or build raise).
    - An op count running: on meta operands nothing launches and
      `meta(*args, **kw)` returns empty meta tensors of the kernel's
      output shapes and dtypes; on others the call runs with the count
      paused, so the plain version's own ops are not counted.  Either way
      the count records one op `name`: its bytes at the boundary (every
      tensor operand read once, or `operand_bytes(*args, **kw)`, plus
      `meta`'s outputs written once, at their stored dtypes), its FLOPs
      (`flops(*args, **kw)`: products only, as JAX's HLO analysis counts
      them; 0 when None) and its launches (`launches(*args, **kw)`,
      default 1, as the wrapper's `.launches` counts them).
    """
    def deco(fn):
        @functools.wraps(fn)
        def hooked(*args, **kw):
            count = op_count()
            if count is None:
                return fn(*args, **kw)
            with count.paused():
                on_meta = tensors(args)[0].device.type == "meta"
                out = meta(*args, **kw) if on_meta else fn(*args, **kw)
                read = (operand_bytes(*args, **kw) if operand_bytes
                        else nbytes((args, kw)))
                count.record_kernel(
                    name, read + nbytes(meta(*args, **kw)),
                    0.0 if flops is None else float(flops(*args, **kw)),
                    1 if launches is None else launches(*args, **kw))
            return out
        return hooked
    return deco


def meta_like(*ts):
    """Empty meta tensors shaped and typed as `ts`."""
    import torch
    out = [torch.empty(t.shape, dtype=t.dtype, device="meta") for t in ts]
    return out[0] if len(out) == 1 else tuple(out)


def meta_empty(shape, dtype):
    import torch
    return torch.empty(shape, dtype=dtype, device="meta")
