"""Serving GEMMs (port of ``brevitas_tpu/kernels``; ported: ``int8_matmul``
and ``int4_weight_only_matmul``).

Each wrapper launches its hand-written CUDA kernel (``csrc/``) on a CUDA
tensor, raises if it cannot, and takes the plain PyTorch version beside it
only for a tensor on the CPU. ``<wrapper>.launches`` counts kernel launches.
"""

from brevitas_tpu_torch.kernels.int4 import (
    int4_weight_only_matmul,
    int4_weight_only_matmul_reference,
    pack_int4_rows,
    unpack_int4_rows,
)
from brevitas_tpu_torch.kernels.int_matmul import int8_matmul, int8_matmul_reference

__all__ = ["int8_matmul", "int8_matmul_reference", "int4_weight_only_matmul",
           "int4_weight_only_matmul_reference", "pack_int4_rows",
           "unpack_int4_rows"]
