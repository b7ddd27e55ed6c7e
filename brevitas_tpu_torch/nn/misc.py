"""Misc quant layers (port of ``brevitas_tpu/nn/misc.py``; ported:
QuantEmbedding, the per-channel affine layers ``ScaleBias`` and
``QuantScaleBias``, and BatchNorm folding: ``mul_add_from_bn``,
``batch_norm_to_quant_scale_bias``, ``merge_bn`` and the identity
``FoldedBatchNorm`` that takes a folded BatchNorm's place).

The port's weights put the output channel first (a linear's (out, in), a
conv's (O, I, *kernel)), so a fold scales axis 0 where the JAX package's
channels-last kernels scale the last axis. A per-channel affine layer
broadcasts its (C,) weight over the input's channel axis: axis 1 of a
conv's (N, C, ...) output (``channel_axis=1``) or the last axis.
"""

from typing import Optional

import torch
from torch import nn

from brevitas_tpu_torch.nn.quant_layer import QuantLayerMixin, QuantWBIOL
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


def _channel_shape(ndim: int, channel_axis: Optional[int]):
    """The shape a (C,) value takes against the channel axis of an
    ``ndim``-D input (None: the last axis)."""
    if channel_axis is None or ndim < 2:
        return (-1,)
    return (-1, *(1,) * (ndim - 1 - channel_axis % ndim))


class ScaleBias(nn.Module):
    """Float per-channel ``y = x * weight + bias``."""

    def __init__(self, num_features: int, use_bias: bool = True,
                 channel_axis: Optional[int] = None):
        super().__init__()
        self.num_features = num_features
        self.channel_axis = channel_axis
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features)) if use_bias else None

    def forward(self, x):
        shape = _channel_shape(x.ndim, self.channel_axis)
        y = x * self.weight.reshape(shape)
        return y + self.bias.reshape(shape) if self.bias is not None else y


class QuantScaleBias(QuantWBIOL):
    """``y = x * weight + bias`` with a quantized per-channel weight: the
    fused form of a BatchNorm. Pass the real multipliers as ``weight_init``
    when folding one in: a scale from the weight's statistics is solved on
    the weights the quantizer is built with."""

    def __init__(self, num_features: int, *,
                 weight_quant: Optional[QuantConfig] = Int8WeightPerTensorFloat,
                 bias_quant: Optional[QuantConfig] = None,
                 input_quant: Optional[QuantConfig] = None,
                 output_quant: Optional[QuantConfig] = None,
                 return_quant_tensor: bool = False,
                 weight_init: Optional[torch.Tensor] = None,
                 bias_init: Optional[torch.Tensor] = None,
                 channel_axis: Optional[int] = None):
        super().__init__()
        self.num_features = num_features
        self.channel_axis = channel_axis
        w = (torch.as_tensor(weight_init, dtype=torch.float32).clone()
             if weight_init is not None else torch.ones(num_features))
        b = (torch.as_tensor(bias_init, dtype=torch.float32).clone()
             if bias_init is not None else torch.zeros(num_features))
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(b)
        self.init_quant(weight_quant, bias_quant, input_quant, output_quant,
                        weight_init=w, return_quant_tensor=return_quant_tensor,
                        channel_axis=0)

    @property
    def reduce_size(self) -> int:
        return 1

    _input_ndim = 2

    def output_channel_view(self, v: torch.Tensor) -> torch.Tensor:
        return v.reshape(_channel_shape(self._input_ndim, self.channel_axis))

    def forward(self, x):
        self._input_ndim = (x.value if isinstance(x, QuantTensor) else x).ndim

        def inner(xv, wv, bv):
            shape = _channel_shape(xv.ndim, self.channel_axis)
            y = xv * wv.reshape(shape)
            if bv is not None:
                y = y + bv.reshape(shape)
            return y

        return self.forward_quant(x, inner)


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a float32 tensor: formed in
    float64 (exact enough that one rounding to float32 is the right one)."""
    return torch.sqrt(x.double()).to(x.dtype)


def mul_add_from_bn(bn_scale: torch.Tensor, bn_bias: torch.Tensor, bn_mean: torch.Tensor,
                    bn_var: torch.Tensor, eps: float = 1e-5):
    """BatchNorm statistics as the equivalent (mul, add) pair, in the JAX
    package's order: a float32 square root, then the division, then
    ``-mean * mul + bias``. XLA's float32 square root is correctly rounded
    and torch's is not (on the CPU it misses by an ulp), so the root is
    ``sqrt32``'s: the same float32 on the CPU, the card and in JAX."""
    mul = bn_scale / sqrt32(bn_var + eps)
    add = -bn_mean * mul + bn_bias
    return mul, add


def batch_norm_to_quant_scale_bias(bn, **scale_bias_kwargs) -> QuantScaleBias:
    """A trained BatchNorm (``models.common.BatchNorm``) as the equivalent
    ``QuantScaleBias`` on the same channel axis."""
    with torch.no_grad():
        mul, add = mul_add_from_bn(bn.scale.reshape(-1), bn.bias.reshape(-1),
                                   bn.mean.reshape(-1), bn.var.reshape(-1), bn.eps)
    layer = QuantScaleBias(mul.shape[0], weight_init=mul.cpu(), bias_init=add.cpu(),
                           channel_axis=bn.channel_axis, **scale_bias_kwargs)
    return layer.to(mul.device)


class FoldedBatchNorm(nn.Module):
    """Identity left in place of a BatchNorm folded into the layer before
    it. The call site stays, so the module must stay an identity in every
    mode: a BatchNorm set to its running statistics would normalize with
    batch statistics again the next time training or calibration mode
    runs."""

    folded_away = True

    def __init__(self, num_features: int):
        super().__init__()
        self.num_features = num_features

    def forward(self, x, *args, **kwargs):
        return x


def merge_bn(layer, bn_scale: torch.Tensor, bn_bias: torch.Tensor, bn_mean: torch.Tensor,
             bn_var: torch.Tensor, eps: float = 1e-5) -> None:
    """Fold BatchNorm statistics into ``layer``'s weight (its output
    channel on axis 0: a float or quant linear or conv) and bias, in place;
    a layer without a bias gets one."""
    with torch.no_grad():
        mul, add = mul_add_from_bn(bn_scale, bn_bias, bn_mean, bn_var, eps)
        w = layer.weight
        w.copy_(w * mul.reshape(-1, *(1,) * (w.ndim - 1)))
        if layer.bias is not None:
            layer.bias.copy_(layer.bias * mul + add)
        else:
            layer.bias = nn.Parameter(add.clone())
