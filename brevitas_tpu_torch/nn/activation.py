"""Quant activations (port of ``brevitas_tpu/nn/activation.py``; ported:
the base layer, QuantIdentity and QuantReLU)."""

from typing import Callable, Optional

import torch
from torch import nn

from brevitas_tpu_torch.nn.quant_layer import QuantLayerMixin
from brevitas_tpu_torch.quant.config import QuantConfig
from brevitas_tpu_torch.quant.presets import (
    Int8ActPerTensorFloat,
    NoneActQuant,
    Uint8ActPerTensorFloat,
)
from brevitas_tpu_torch.quant.quantizers import ActQuantizer


class QuantNonLinearActLayer(QuantLayerMixin, nn.Module):
    """act_fn, then act_quant."""

    def __init__(self, act_fn: Optional[Callable], act_quant: Optional[QuantConfig],
                 return_quant_tensor: bool = False):
        super().__init__()
        self.act_fn = act_fn
        self.act_quant = ActQuantizer(act_quant if act_quant is not None
                                      else NoneActQuant)
        self.return_quant_tensor = return_quant_tensor

    def forward(self, x):
        v = self.unpack_input(x).value
        if self.act_fn is not None:
            v = self.act_fn(v)
        return self.pack_output(self.act_quant(v))


class QuantIdentity(QuantNonLinearActLayer):

    def __init__(self, act_quant: Optional[QuantConfig] = Int8ActPerTensorFloat,
                 return_quant_tensor: bool = False):
        super().__init__(None, act_quant, return_quant_tensor)


class QuantReLU(QuantNonLinearActLayer):
    """ReLU, then an unsigned activation quantizer."""

    def __init__(self, act_quant: Optional[QuantConfig] = Uint8ActPerTensorFloat,
                 return_quant_tensor: bool = False):
        super().__init__(torch.relu, act_quant, return_quant_tensor)
