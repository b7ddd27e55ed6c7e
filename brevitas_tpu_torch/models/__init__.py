"""Models (port of ``brevitas_tpu/models``; ported: the FC family, CNV,
QuantLlama and QuantTransformer)."""

from brevitas_tpu_torch.models.cnv import CNV, cnv
from brevitas_tpu_torch.models.fc import FC, lfc, sfc, tfc
from brevitas_tpu_torch.models.llama import QuantLlama, quant_llama_tiny
from brevitas_tpu_torch.models.transformer import (
    QuantTransformer,
    QuantTransformerBlock,
    quant_transformer_tiny,
)

__all__ = ["CNV", "cnv", "FC", "lfc", "sfc", "tfc", "QuantLlama", "quant_llama_tiny",
           "QuantTransformer", "QuantTransformerBlock", "quant_transformer_tiny"]
