"""Quant layers (port of ``brevitas_tpu/nn``)."""

from brevitas_tpu_torch.nn.activation import (
    QuantHardTanh,
    QuantIdentity,
    QuantNonLinearActLayer,
    QuantReLU,
)
from brevitas_tpu_torch.nn.attention import QuantMultiheadAttention, apply_rope
from brevitas_tpu_torch.nn.conv import FloatConv1d, FloatConv2d, QuantConv1d, QuantConv2d
from brevitas_tpu_torch.nn.linear import QuantLinear
from brevitas_tpu_torch.nn.misc import (
    FoldedBatchNorm,
    QuantEmbedding,
    QuantScaleBias,
    ScaleBias,
    batch_norm_to_quant_scale_bias,
    merge_bn,
    mul_add_from_bn,
)
from brevitas_tpu_torch.nn.pool import QuantAvgPool2d, QuantMaxPool1d, QuantMaxPool2d
from brevitas_tpu_torch.nn.quant_layer import QuantLayerMixin, QuantWBIOL
from brevitas_tpu_torch.nn.rnn import QuantLSTM

__all__ = ["QuantHardTanh", "QuantIdentity", "QuantNonLinearActLayer", "QuantReLU",
           "QuantMultiheadAttention", "apply_rope", "QuantConv1d", "QuantConv2d", "QuantLinear",
           "QuantAvgPool2d", "QuantMaxPool1d", "QuantMaxPool2d", "QuantEmbedding",
           "QuantLayerMixin", "QuantWBIOL", "QuantLSTM", "FloatConv1d", "FloatConv2d",
           "FoldedBatchNorm", "QuantScaleBias", "ScaleBias", "batch_norm_to_quant_scale_bias",
           "merge_bn", "mul_add_from_bn"]
