"""Misc quant layers (port of ``brevitas_tpu/nn/misc.py``; ported:
QuantEmbedding)."""

from typing import Optional

import torch
from torch import nn

from brevitas_tpu_torch.nn.quant_layer import QuantLayerMixin
from brevitas_tpu_torch.quant.config import QuantConfig
from brevitas_tpu_torch.quant.presets import Int8WeightPerTensorFloat, NoneWeightQuant
from brevitas_tpu_torch.quant.quantizers import ParameterQuantizer
from brevitas_tpu_torch.quant_tensor import QuantTensor


class QuantEmbedding(QuantLayerMixin, nn.Module):
    """Lookup in a fake-quantized table. A gather keeps the grid, so with a
    per-tensor scale the output carries its quantization metadata."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 weight_quant: Optional[QuantConfig] = Int8WeightPerTensorFloat,
                 return_quant_tensor: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # standard normal, drawn on the CPU so a seed gives the same table on
        # every device
        w = torch.randn((num_embeddings, embedding_dim), generator=generator)
        self.weight = nn.Parameter(w)
        # per-channel scaling gives each vocabulary row its own scale
        self.weight_quant = ParameterQuantizer(weight_quant or NoneWeightQuant, w,
                                               channel_axis=0)
        self.return_quant_tensor = return_quant_tensor

    def forward(self, ids: torch.Tensor):
        qw = self.weight_quant(self.weight)
        out = qw.value[ids]
        if qw.scale is not None and qw.scale.ndim == 0:
            return self.pack_output(QuantTensor(
                out, qw.scale, qw.zero_point, qw.bit_width, signed=qw.signed))
        return self.pack_output(QuantTensor(out))
