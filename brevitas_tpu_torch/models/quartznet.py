"""Quantized QuartzNet 15x5 for speech-to-text (port of
``brevitas_tpu/models/quartznet.py``).

The NeMo-derived Jasper encoder: a k 33 / stride 2 separable prologue, 15
residual groups of 5 separable blocks (kernels 33, 39, 51, 63, 75 at 256
and 512 filters), an epilogue of k 87 at dilation 2 and a 1 x 1 to 1024
filters, and a 1 x 1 CTC decoder with a bias. Separable = a depthwise
QuantConv1d, a QuantHardTanh at +-1 and a pointwise QuantConv1d. Weights
are scaled per output channel; activations are unsigned after each ReLU,
with a learned LOG_FP threshold from 1.0. A residual group's output and its
1 x 1 residual branch pass through ONE shared QuantHardTanh, so the two
operands of the add share a grid, and the sum goes through the block's
last QuantReLU. The first and the last two topology entries and the decoder
take ``outer_bit_width``.

Inputs are (B, features, T) and logits (B, vocab, T'); the JAX package's
are (B, T, C). Module and parameter names and list indices follow the JAX
package, so ``interop.jax_state`` maps its state across by path.
"""

from typing import Optional, Sequence

import torch
from torch import nn

from brevitas_tpu_torch.core.restrict import RestrictType
from brevitas_tpu_torch.models.common import BatchNorm
from brevitas_tpu_torch.models.mobilenetv1 import common_int_weight_per_channel_quant
from brevitas_tpu_torch.nn import QuantConv1d, QuantHardTanh, QuantReLU
from brevitas_tpu_torch.quant.config import QuantConfig, QuantType, ScalingImplType
from brevitas_tpu_torch.utils import resolve_device

ABS_ACT_VAL = 1.0


def _act_quant(bit_width, max_val=ABS_ACT_VAL) -> QuantConfig:
    """The ReLU's quantizer: unsigned, a learned LOG_FP threshold from 1.0."""
    if bit_width is None:
        return QuantConfig(quant_type=QuantType.NONE)
    return QuantConfig(
        bit_width=float(bit_width), signed=False, narrow_range=False,
        scaling_impl=ScalingImplType.PARAMETER, scaling_const=float(max_val),
        restrict_scaling=RestrictType.LOG_FP, scaling_min_val=2e-16)


def _norm_scale_quant(bit_width, abs_val=ABS_ACT_VAL) -> QuantConfig:
    """The QuantHardTanh's quantizer: signed, clamped to +-abs_val, a learned
    LOG_FP threshold."""
    if bit_width is None:
        return QuantConfig(quant_type=QuantType.NONE)
    return QuantConfig(
        bit_width=float(bit_width), signed=True, narrow_range=False,
        scaling_impl=ScalingImplType.PARAMETER, scaling_const=float(abs_val),
        restrict_scaling=RestrictType.LOG_FP, scaling_min_val=2e-16)


# (filters, repeat, kernel, stride, dilation, residual, separable)
QUARTZNET_15x5 = (
    (256, 1, 33, 2, 1, False, True),   # prologue
    (256, 5, 33, 1, 1, True, True),
    (256, 5, 33, 1, 1, True, True),
    (256, 5, 33, 1, 1, True, True),
    (256, 5, 39, 1, 1, True, True),
    (256, 5, 39, 1, 1, True, True),
    (256, 5, 39, 1, 1, True, True),
    (512, 5, 51, 1, 1, True, True),
    (512, 5, 51, 1, 1, True, True),
    (512, 5, 51, 1, 1, True, True),
    (512, 5, 63, 1, 1, True, True),
    (512, 5, 63, 1, 1, True, True),
    (512, 5, 63, 1, 1, True, True),
    (512, 5, 75, 1, 1, True, True),
    (512, 5, 75, 1, 1, True, True),
    (512, 5, 75, 1, 1, True, True),
    (512, 1, 87, 1, 2, False, True),   # epilogue 1
    (1024, 1, 1, 1, 1, False, False),  # epilogue 2
)


class SeparableConv1d(nn.Module):
    """Depthwise k-tap conv, QuantHardTanh, pointwise 1 x 1 conv."""

    def __init__(self, in_ch, out_ch, kernel, stride, dilation, bit_width,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        pad = (kernel // 2) * dilation
        wq = common_int_weight_per_channel_quant(bit_width)
        self.dw = QuantConv1d(in_ch, in_ch, kernel, stride=stride, padding=((pad, pad),),
                              dilation=dilation, groups=in_ch, use_bias=False, weight_quant=wq,
                              generator=generator)
        self.pw = QuantConv1d(in_ch, out_ch, 1, use_bias=False, weight_quant=wq,
                              generator=generator)
        self.norm = QuantHardTanh(_norm_scale_quant(bit_width), max_val=ABS_ACT_VAL,
                                  min_val=-ABS_ACT_VAL, return_quant_tensor=True)

    def forward(self, x):
        return self.pw(self.norm(self.dw(x)))


class QuartzBlock(nn.Module):
    """``repeat`` x (conv -> BatchNorm -> QuantReLU), with an optional
    quantized residual around the whole block."""

    def __init__(self, in_ch, filters, repeat, kernel, stride, dilation, residual, separable,
                 bit_width, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.residual = residual
        convs, bns, acts = [], [], []
        ch = in_ch
        wq = common_int_weight_per_channel_quant(bit_width)
        for r in range(repeat):
            s = stride if r == 0 else 1
            if separable:
                convs.append(SeparableConv1d(ch, filters, kernel, s, dilation, bit_width,
                                             generator=generator))
            else:
                pad = (kernel // 2) * dilation
                convs.append(QuantConv1d(ch, filters, kernel, stride=s, padding=((pad, pad),),
                                         dilation=dilation, use_bias=False, weight_quant=wq,
                                         generator=generator))
            bns.append(BatchNorm(filters, momentum=0.9, eps=1e-3, channel_axis=1))
            # the carried grid lets the integer serving twins take exact codes
            acts.append(QuantReLU(_act_quant(bit_width), return_quant_tensor=True))
            ch = filters
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(bns)
        self.acts = nn.ModuleList(acts)
        if residual:
            self.res_conv = QuantConv1d(in_ch, filters, 1, use_bias=False, weight_quant=wq,
                                        generator=generator)
            self.res_bn = BatchNorm(filters, momentum=0.9, eps=1e-3, channel_axis=1)
            self.res_quant = QuantHardTanh(_norm_scale_quant(bit_width), max_val=ABS_ACT_VAL,
                                           min_val=-ABS_ACT_VAL, return_quant_tensor=True)

    def forward(self, x):
        inp = x
        n = len(self.convs)
        for i in range(n):
            x = self.bns[i](self.convs[i](x))
            if i < n - 1 or not self.residual:
                x = self.acts[i](x)
        if self.residual:
            res = self.res_bn(self.res_conv(inp))
            x = self.res_quant(x) + self.res_quant(res)
            x = self.acts[-1](x)
        return x


class QuartzNet(nn.Module):

    def __init__(self, *, num_features: int = 64, vocab_size: int = 29,
                 bit_width: Optional[int] = 8, outer_bit_width: Optional[int] = None,
                 topology: Sequence = QUARTZNET_15x5,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        outer_bw = outer_bit_width or bit_width
        blocks = []
        in_ch = num_features
        for i, (filters, repeat, kernel, stride, dilation, residual,
                separable) in enumerate(topology):
            bw = outer_bw if i == 0 or i >= len(topology) - 2 else bit_width
            blocks.append(QuartzBlock(in_ch, filters, repeat, kernel, stride, dilation,
                                      residual, separable, bw, generator=g))
            in_ch = filters
        self.encoder = nn.ModuleList(blocks)
        self.decoder = QuantConv1d(in_ch, vocab_size, 1, use_bias=True,
                                   weight_quant=common_int_weight_per_channel_quant(outer_bw),
                                   generator=g)
        self.to(device)

    def forward(self, x):
        """x: (B, num_features, T) features -> (B, vocab, T') logits."""
        for blk in self.encoder:
            x = blk(x)
        return self.decoder(x)


def quartznet_15x5(bit_width: int = 8, **kw) -> QuartzNet:
    """8-bit, weights per output channel."""
    return QuartzNet(bit_width=bit_width, **kw)


def quartznet_15x5_4b(**kw) -> QuartzNet:
    """4-bit inner and 8-bit outer layers."""
    return QuartzNet(bit_width=4, outer_bit_width=8, **kw)
