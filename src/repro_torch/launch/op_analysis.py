"""Op analysis: FLOPs, device-memory bytes and collective bytes of one
eager call, op by op (the port's counterpart of `repro/launch/
hlo_analysis.py`, which derives the same three roofline inputs from a
compiled HLO module).

`OpCount` is a `TorchDispatchMode`: every aten op the call dispatches
passes through it, on any device (meta tensors included, so a step can
be counted at full size without allocating: under a count the kernel
wrappers return empty meta outputs and launch nothing), and every
hand-written kernel records itself through its wrapper's hook
(`kernels/build.py:counted`) as one op under the kernel's name.

  * FLOPs: products only, as JAX's HLO analysis counts `dot`s:
    torch's own formulas (`torch.utils.flop_counter`) for mm, addmm,
    bmm, baddbmm, convolution and SDPA, plus each kernel's figure, which
    is the dot count of the JAX function the port's tests hold that
    kernel against (2·M·N·K for K1, K5 and K8; the matvecs of K3, K4 and
    K7; `wkv6_chunked`'s einsums for K10; the attention dots for K13 and
    its backward; 0 for K2, K9, K11 and K12).
  * Bytes: each op's tensor operands plus its results, at their stored
    dtypes.  Views and other layout-only ops are free, as JAX's
    `_FREE_OPS` are.  These are eager op boundaries: each op reads its
    operands from device memory and writes its results there, which is
    what eager PyTorch does, and an upper bound on what a fused program
    moves (JAX's analysis counts at XLA's fusion boundaries instead).  A
    kernel's bytes are its own boundary: what it reads once and writes
    once, whatever it reads again.
  * Collective bytes: 0 on one card; the field stays for the port's
    meshes (ROADMAP Queue 1 item 10a).
  * Loops need no trip counts: eager PyTorch dispatches every iteration
    (every layer, every chunk, every step), so the count is exact by
    construction, where the HLO analysis multiplies while-loop bodies by
    the trip counts it reads from their conditions.  `loops` stays empty.

While a kernel's plain version runs (a CPU tensor) the count is paused:
the count is the kernel's on every device, and under a count CPU tensors
take the kernels' route (`kernels/build.py:kernel_route`), their autograd
Functions included.

    metrics = analyze_call(step, *args)          # totals and the op table
    metrics = analyze_call(step, *args, stack=True)   # keyed by model line

`launch/roofline.py` turns the metrics into the three roofline terms,
`launch/dryrun.py` counts every (arch, shape) cell on meta tensors.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten

# layout-only ops that are not views: free, as JAX's _FREE_OPS
_FREE_OPS = {aten.empty, aten.empty_like, aten.empty_strided,
             aten.new_empty, aten.new_empty_strided, aten.lift_fresh,
             aten._local_scalar_dense, aten.sym_size, aten.sym_stride,
             aten.sym_numel, aten.sym_storage_offset}

_MODELS_DIR = os.sep + os.path.join("repro_torch", "models") + os.sep


@dataclasses.dataclass
class OpStat:
    count: int = 0
    flops: float = 0.0
    bytes: float = 0.0


@dataclasses.dataclass
class OpMetrics:
    """`HloMetrics`' fields, the op table and the count's own figures.

    ops      — {aten op or kernel name (or model line): OpStat}
    kernels  — {kernel name: launches}, as the wrappers' `.launches`
               count them
    seconds  — the count's own wall time
    argument_bytes, output_bytes — the call's arguments and results
    flop_counter_flops — torch's `FlopCounterMode` over the same call:
               the aten products alone, blind to the hand-written
               kernels (the cross-check, as JAX's cost_analysis is blind
               to loop trips)
    """
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_breakdown: dict = dataclasses.field(default_factory=dict)
    loops: list = dataclasses.field(default_factory=list)
    ops: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    seconds: float = 0.0
    argument_bytes: int = 0
    output_bytes: int = 0
    flop_counter_flops: float = 0.0

    def top(self, n: int = 10, by: str = "bytes") -> list:
        """The n largest entries of the op table by `by` ("bytes",
        "flops" or "count"): [(key, OpStat)]."""
        return sorted(self.ops.items(), key=lambda kv: -getattr(kv[1], by))[:n]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def model_line() -> str | None:
    """The first frame under `repro_torch/models/` on the Python stack,
    as "models/<file>:<line> <function>", or None."""
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename
        i = name.find(_MODELS_DIR)
        if i >= 0:
            rel = name[i + len(os.sep + "repro_torch" + os.sep):]
            return f"{rel}:{f.f_lineno} {f.f_code.co_name}"
        f = f.f_back
    return None


class OpCount(TorchDispatchMode):
    """Counts every op dispatched inside the `with` block and every
    kernel launch recorded by the wrappers' hook.  `stack=True` keys the
    table by the model line that issued each op (ops issued outside
    `repro_torch/models/` keep their op name)."""

    counts_kernels = True      # found by kernels/build.py:op_count

    def __init__(self, *, stack: bool = False):
        super().__init__()
        self.stack = stack
        self.metrics = OpMetrics()
        self._paused = 0

    @contextlib.contextmanager
    def paused(self):
        """Ops dispatched inside are not counted (a kernel's plain
        version, the hook's own bookkeeping)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def _key(self, name: str) -> str:
        if self.stack:
            line = model_line()
            if line is not None:
                return line
        return name

    def _add(self, key: str, flops: float, nbytes: float, n: int = 1):
        st = self.metrics.ops.setdefault(key, OpStat())
        st.count += n
        st.flops += flops
        st.bytes += nbytes
        self.metrics.flops += flops
        self.metrics.hbm_bytes += nbytes

    def record_kernel(self, name: str, nbytes: int, flops: float,
                      launches: int):
        """One hand-written kernel's launches as one op (the hook)."""
        self._add(self._key(name), flops, nbytes, launches)
        self.metrics.kernels[name] = \
            self.metrics.kernels.get(name, 0) + launches

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        packet = func.overloadpacket
        if func.is_view or packet in _FREE_OPS:
            return out
        formula = flop_registry.get(packet)
        flops = 0.0 if formula is None else float(
            formula(*args, **kwargs, out_val=out))
        self._add(self._key(packet.__name__), flops,
                  _nbytes((args, kwargs)) + _nbytes(out))
        return out


def analyze_call(fn, *args, stack: bool = False, **kwargs) -> OpMetrics:
    """Count one call of `fn(*args, **kwargs)`: its `OpMetrics`, with
    `FlopCounterMode`'s figure beside it."""
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, OpCount(stack=stack) as oc:
        out = fn(*args, **kwargs)
    m = oc.metrics
    m.seconds = time.perf_counter() - t0
    m.argument_bytes = _nbytes((args, kwargs))
    m.output_bytes = _nbytes(out)
    m.flop_counter_flops = float(fc.get_total_flops())
    return m
