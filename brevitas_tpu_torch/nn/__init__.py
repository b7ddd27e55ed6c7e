"""Quant layers (port of ``brevitas_tpu/nn``)."""

from brevitas_tpu_torch.nn.activation import QuantIdentity, QuantNonLinearActLayer, QuantReLU
from brevitas_tpu_torch.nn.attention import QuantMultiheadAttention, apply_rope
from brevitas_tpu_torch.nn.linear import QuantLinear
from brevitas_tpu_torch.nn.misc import QuantEmbedding
from brevitas_tpu_torch.nn.quant_layer import QuantLayerMixin, QuantWBIOL
from brevitas_tpu_torch.nn.rnn import QuantLSTM

__all__ = ["QuantIdentity", "QuantNonLinearActLayer", "QuantReLU", "QuantMultiheadAttention",
           "apply_rope", "QuantLinear", "QuantEmbedding", "QuantLayerMixin",
           "QuantWBIOL", "QuantLSTM"]
