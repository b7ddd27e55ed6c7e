"""Serving kernels (port of ``brevitas_tpu/kernels``; ported: ``int8_matmul``,
``int4_matmul``, ``int4_weight_only_matmul``, ``int8_attention`` and
``int4kv_decode_attention``).

Each wrapper launches its hand-written CUDA kernel (``csrc/``) on a CUDA
tensor, raises if it cannot, and takes the plain PyTorch version beside it
only for a tensor on the CPU. ``<wrapper>.launches`` counts kernel launches.
"""

from brevitas_tpu_torch.kernels.int4 import (
    int4_matmul,
    int4_matmul_reference,
    int4_weight_only_matmul,
    int4_weight_only_matmul_reference,
    pack_int4_rows,
    unpack_int4_rows,
)
from brevitas_tpu_torch.kernels.int8_attention import (
    int4kv_decode_attention,
    int4kv_decode_attention_reference,
    int8_attention,
    int8_attention_dispatch,
    int8_attention_reference,
    int8_decode_attention,
    pack_kv_halves,
    unpack_kv_halves,
    update_kv_packed,
)
from brevitas_tpu_torch.kernels.int_matmul import int8_matmul, int8_matmul_reference

__all__ = ["int8_matmul", "int8_matmul_reference", "int4_matmul",
           "int4_matmul_reference", "int4_weight_only_matmul",
           "int4_weight_only_matmul_reference", "pack_int4_rows",
           "unpack_int4_rows", "int8_attention", "int8_attention_reference",
           "int8_attention_dispatch", "int8_decode_attention",
           "int4kv_decode_attention", "int4kv_decode_attention_reference",
           "pack_kv_halves", "unpack_kv_halves", "update_kv_packed"]
