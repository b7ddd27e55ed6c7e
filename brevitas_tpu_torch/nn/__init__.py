"""Quant layers (port of ``brevitas_tpu/nn``)."""

from brevitas_tpu_torch.nn.activation import QuantIdentity, QuantNonLinearActLayer
from brevitas_tpu_torch.nn.linear import QuantLinear
from brevitas_tpu_torch.nn.quant_layer import QuantLayerMixin, QuantWBIOL

__all__ = ["QuantIdentity", "QuantNonLinearActLayer", "QuantLinear",
           "QuantLayerMixin", "QuantWBIOL"]
