"""The port's public kernel entry point (port of `repro/kernels/ops.py`).

Each of the JAX package's public kernel names points at the port's
counterpart; the WKV kernels keep the names the port gives them:

  dpot_matmul, dpot_matmul_w4   K1, K8   kernels/dpot_matmul.py
  flash_attention               K13      kernels/flash_attention.py
  fused_cross_entropy           K12      kernels/fused_ce.py
  fused_layernorm               K11      kernels/fused_layernorm.py
  exp_kernel, sigmoid_kernel    K9       kernels/expsig.py
  wkv4_seq                      K2       (JAX's wkv4_pallas)
  wkv6_chunked_kernel           K10      (JAX's wkv6_pallas)

A CPU tensor takes each kernel's plain version; a CUDA tensor launches the
kernel or raises.  Importing this module builds nothing: the kernels are
compiled at their first CUDA call.
"""
from repro_torch.kernels.dpot_matmul import dpot_matmul, dpot_matmul_w4
from repro_torch.kernels.expsig import exp_kernel, sigmoid_kernel
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_ce import fused_cross_entropy
from repro_torch.kernels.fused_layernorm import fused_layernorm
from repro_torch.kernels.wkv4 import wkv4_seq
from repro_torch.kernels.wkv6 import wkv6_chunked_kernel

__all__ = ["dpot_matmul", "dpot_matmul_w4", "flash_attention",
           "fused_cross_entropy", "fused_layernorm", "wkv4_seq",
           "wkv6_chunked_kernel", "exp_kernel", "sigmoid_kernel"]
