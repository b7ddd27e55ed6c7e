"""Quant layers (port of ``brevitas_tpu/nn``)."""

from brevitas_tpu_torch.nn.activation import (
    QuantHardTanh,
    QuantIdentity,
    QuantNonLinearActLayer,
    QuantReLU,
)
from brevitas_tpu_torch.nn.attention import QuantMultiheadAttention, apply_rope
from brevitas_tpu_torch.nn.conv import QuantConv1d, QuantConv2d
from brevitas_tpu_torch.nn.linear import QuantLinear
from brevitas_tpu_torch.nn.misc import QuantEmbedding
from brevitas_tpu_torch.nn.pool import QuantAvgPool2d, QuantMaxPool1d, QuantMaxPool2d
from brevitas_tpu_torch.nn.quant_layer import QuantLayerMixin, QuantWBIOL
from brevitas_tpu_torch.nn.rnn import QuantLSTM

__all__ = ["QuantHardTanh", "QuantIdentity", "QuantNonLinearActLayer", "QuantReLU",
           "QuantMultiheadAttention", "apply_rope", "QuantConv1d", "QuantConv2d", "QuantLinear",
           "QuantAvgPool2d", "QuantMaxPool1d", "QuantMaxPool2d", "QuantEmbedding",
           "QuantLayerMixin", "QuantWBIOL", "QuantLSTM"]
