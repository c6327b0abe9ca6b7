"""Kernels of the port: CUDA C++ for sm_90a, each beside its plain version.

The public kernel entry point is `repro_torch.kernels.ops` (the JAX
package's `repro.kernels.ops`).  Its names are importable from this
package too, looked up at first use, so importing the package imports no
kernel module (and nothing needs a GPU until a kernel's first CUDA call
builds it) — except `dpot_matmul`, `flash_attention` and
`fused_layernorm`, which here name the submodules that hold them, as the
port's code imports them; take those three from `ops`.
"""
_FROM_OPS = ("dpot_matmul_w4", "exp_kernel", "fused_cross_entropy",
             "sigmoid_kernel", "wkv4_seq", "wkv6_chunked_kernel")


def __getattr__(name):
    if name in _FROM_OPS:
        from repro_torch.kernels import ops
        return getattr(ops, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
