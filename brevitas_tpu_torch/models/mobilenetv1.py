"""Quantized MobileNetV1, the 4-bit ImageNet recipe (port of
``brevitas_tpu/models/mobilenetv1.py``).

DwsConvBlock: a depthwise 3 x 3 and a pointwise 1 x 1 ConvBlock, each
QuantConv2d -> BatchNorm over channels -> QuantReLU. The first layer's
weights are 8-bit and it pads nothing (224 -> 111). Weights are scaled per
output channel; the ReLU of every pointwise block is scaled per channel
except in the last stage; the thresholds are learned in the log domain
from 6.0. A truncating QuantAvgPool2d hands its QuantTensor to the head, a
QuantLinear with ``IntBias`` and no input quantizer. Channels
[[32], [64], [128, 128], [256, 256], [512] x 6, [1024, 1024]].

Inputs are (N, 3, H, W); the JAX package's are NHWC. Module and parameter
names and list indices follow the JAX package, so ``interop.jax_state``
maps its state across by path.
"""

from typing import Optional, Sequence

import torch
from torch import nn

from brevitas_tpu_torch.core.restrict import RestrictType
from brevitas_tpu_torch.models.common import BatchNorm
from brevitas_tpu_torch.nn import QuantAvgPool2d, QuantConv2d, QuantLinear, QuantReLU
from brevitas_tpu_torch.quant.config import QuantConfig, QuantType, ScalingImplType
from brevitas_tpu_torch.quant.presets import Int8WeightPerTensorFloat, IntBias, TruncTo8bit
from brevitas_tpu_torch.utils import resolve_device

FIRST_LAYER_BIT_WIDTH = 8


def common_int_weight_per_tensor_quant(bit_width) -> QuantConfig:
    """CommonIntWeightPerTensorQuant; None disables quantization."""
    if bit_width is None:
        return QuantConfig(quant_type=QuantType.NONE)
    return Int8WeightPerTensorFloat.let(bit_width=float(bit_width), scaling_min_val=2e-16)


def common_int_weight_per_channel_quant(bit_width) -> QuantConfig:
    """CommonIntWeightPerChannelQuant."""
    if bit_width is None:
        return QuantConfig(quant_type=QuantType.NONE)
    return common_int_weight_per_tensor_quant(bit_width).let(scaling_per_output_channel=True)


def common_uint_act_quant(bit_width, per_channel: bool = False) -> QuantConfig:
    """CommonUintActQuant: unsigned, a learned log-domain threshold from 6.0."""
    if bit_width is None:
        return QuantConfig(quant_type=QuantType.NONE)
    return QuantConfig(
        bit_width=float(bit_width), signed=False, narrow_range=False,
        scaling_impl=ScalingImplType.PARAMETER, scaling_const=6.0,
        restrict_scaling=RestrictType.LOG_FP, scaling_min_val=2e-16,
        scaling_per_output_channel=per_channel)


class ConvBlock(nn.Module):
    """QuantConv2d -> BatchNorm -> QuantReLU, returning a QuantTensor."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, weight_bit_width,
                 act_bit_width, *, stride=1, padding=0, groups=1, bn_eps=1e-5,
                 act_scaling_per_channel=False, generator: Optional[torch.Generator] = None):
        super().__init__()
        pad = ((padding, padding),) * 2 if padding else "VALID"
        self.conv = QuantConv2d(
            in_ch, out_ch, kernel_size, stride=stride, padding=pad, groups=groups,
            use_bias=False, weight_quant=common_int_weight_per_channel_quant(weight_bit_width),
            generator=generator)
        self.bn = BatchNorm(out_ch, momentum=0.9, eps=bn_eps, channel_axis=1)
        self.activation = QuantReLU(
            common_uint_act_quant(act_bit_width, per_channel=act_scaling_per_channel),
            num_channels=out_ch if act_scaling_per_channel else None,
            return_quant_tensor=True)

    def forward(self, x):
        return self.activation(self.bn(self.conv(x)))


class DwsConvBlock(nn.Module):
    """Depthwise-separable block."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, bit_width,
                 pw_act_per_channel: bool, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dw_conv = ConvBlock(in_ch, in_ch, 3, bit_width, bit_width, stride=stride,
                                 padding=1, groups=in_ch, generator=generator)
        self.pw_conv = ConvBlock(in_ch, out_ch, 1, bit_width, bit_width,
                                 act_scaling_per_channel=pw_act_per_channel,
                                 generator=generator)

    def forward(self, x):
        return self.pw_conv(self.dw_conv(x))


class MobileNetV1(nn.Module):

    def __init__(self, *, channels: Sequence[Sequence[int]] = (
            (32,), (64,), (128, 128), (256, 256), (512,) * 6, (1024, 1024)),
            bit_width: Optional[int] = 4, in_channels: int = 3, num_classes: int = 1000,
            first_stage_stride: bool = False, pool_size: int = 7,
            generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        init_ch = channels[0][0]
        first_bw = None if bit_width is None else FIRST_LAYER_BIT_WIDTH
        blocks = [ConvBlock(in_channels, init_ch, 3, first_bw, bit_width, stride=2, padding=0,
                            act_scaling_per_channel=True, generator=g)]
        in_ch = init_ch
        stages = channels[1:]
        for i, stage_channels in enumerate(stages):
            pw_per_channel = i < len(stages) - 1
            for j, out_ch in enumerate(stage_channels):
                stride = 2 if j == 0 and (i != 0 or first_stage_stride) else 1
                blocks.append(DwsConvBlock(in_ch, out_ch, stride, bit_width, pw_per_channel,
                                           generator=g))
                in_ch = out_ch
        self.features = nn.ModuleList(blocks)
        self.final_pool = QuantAvgPool2d(
            pool_size, stride=1,
            trunc_quant=None if bit_width is None else TruncTo8bit.let(
                bit_width=float(bit_width)),
            return_quant_tensor=bit_width is not None)
        self.output = QuantLinear(
            in_ch, num_classes, use_bias=True,
            weight_quant=common_int_weight_per_tensor_quant(bit_width),
            bias_quant=None if bit_width is None else IntBias, generator=g)
        self.to(device)

    def forward(self, x):
        for blk in self.features:
            x = blk(x)
        x = self.final_pool(x)
        # the pool ends at 1 x 1, so (N, C, 1, 1) flattens to the same order
        # as the JAX package's (N, 1, 1, C)
        x = x.reshape(x.shape[0], -1)
        return self.output(x)


def quant_mobilenet_v1(bit_width: Optional[int] = 4, width_scale: float = 1.0,
                       num_classes: int = 1000, pool_size: int = 7, **kw) -> MobileNetV1:
    """``width_scale`` and ``pool_size`` build reduced twins (224 px pools
    7 x 7 at the end; 64 px reaches the pool at 2 x 2)."""
    channels = [[32], [64], [128, 128], [256, 256], [512] * 6, [1024, 1024]]
    if width_scale != 1.0:
        channels = [[int(c * width_scale) for c in stage] for stage in channels]
    return MobileNetV1(channels=channels, bit_width=bit_width, num_classes=num_classes,
                       pool_size=pool_size, **kw)
