"""Quant activations (port of ``brevitas_tpu/nn/activation.py``; ported:
the base layer, QuantIdentity, QuantReLU and QuantHardTanh).

``num_channels`` (QuantReLU and the base layer) gives the activation
quantizer one scale per channel, over axis 1 of the port's (N, C, ...)
activations."""

from typing import Callable, Optional

import torch
from torch import nn

from brevitas_tpu_torch.nn.quant_layer import QuantLayerMixin
from brevitas_tpu_torch.quant.config import QuantConfig, ScalingImplType
from brevitas_tpu_torch.quant.presets import (
    Int8ActPerTensorFloat,
    NoneActQuant,
    Uint8ActPerTensorFloat,
)
from brevitas_tpu_torch.quant.quantizers import ActQuantizer


class QuantNonLinearActLayer(QuantLayerMixin, nn.Module):
    """act_fn, then act_quant."""

    def __init__(self, act_fn: Optional[Callable], act_quant: Optional[QuantConfig],
                 return_quant_tensor: bool = False, num_channels: Optional[int] = None):
        super().__init__()
        self.act_fn = act_fn
        self.act_quant = ActQuantizer(act_quant if act_quant is not None
                                      else NoneActQuant, num_channels)
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
                 return_quant_tensor: bool = False, num_channels: Optional[int] = None):
        super().__init__(torch.relu, act_quant, return_quant_tensor, num_channels)


class QuantHardTanh(QuantNonLinearActLayer):
    """Clipped identity: no act function, the quantizer's range is the clip.
    Its threshold covers both bounds, ``max(|min_val|, |max_val|)``, and is
    the scaling constant when the config leaves that unset."""

    def __init__(self, act_quant: Optional[QuantConfig] = None, max_val: float = 1.0,
                 min_val: float = -1.0, return_quant_tensor: bool = False):
        threshold = max(abs(min_val), abs(max_val))
        if act_quant is None:
            act_quant = Int8ActPerTensorFloat.let(
                scaling_impl=ScalingImplType.PARAMETER, scaling_const=threshold,
                narrow_range=True)
        elif (ScalingImplType(act_quant.scaling_impl) in (ScalingImplType.CONST,
                                                          ScalingImplType.PARAMETER)
              and act_quant.scaling_const is None):
            act_quant = act_quant.let(scaling_const=threshold)
        super().__init__(None, act_quant, return_quant_tensor)
