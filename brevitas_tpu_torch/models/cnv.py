"""CNV: the VGG-like quantized ConvNet of the bnn_pynq examples, for CIFAR-10
(port of ``brevitas_tpu/models/cnv.py``).

Input QuantIdentity (8-bit, Q1.7: a power-of-two scale of 2^-7) -> six
[QuantConv2d 3x3 VALID (no bias) -> BatchNorm over channels -> QuantIdentity
(act)] of 64, 64, 128, 128, 256, 256 channels, a 2x2 QuantMaxPool2d after
the second and the fourth -> QuantLinear 256 -> 512 -> 512 -> classes, each
but the last followed by BatchNorm and QuantIdentity -> TensorNorm, with
inputs mapped from [0, 1] to [-1, 1]. Inputs are (N, 3, 32, 32).

Every QuantIdentity and the max-pools return QuantTensors, so each conv and
linear sees its input's scale and bit width and takes the code-domain branch
under ``utils.set_compute_dtype``. Module and parameter names and list
indices follow the JAX package, so ``interop.jax_state`` maps its state
across by path.
"""

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from brevitas_tpu_torch.core.restrict import RestrictType
from brevitas_tpu_torch.models.common import (
    BatchNorm,
    TensorNorm,
    common_act_quant,
    common_weight_quant,
)
from brevitas_tpu_torch.nn import QuantConv2d, QuantIdentity, QuantLinear, QuantMaxPool2d
from brevitas_tpu_torch.quant import presets
from brevitas_tpu_torch.utils import resolve_device

CNV_OUT_CH_POOL: Sequence[Tuple[int, bool]] = (
    (64, False), (64, True), (128, False), (128, True), (256, False), (256, False))
INTERMEDIATE_FC_FEATURES = ((256, 512), (512, 512))
LAST_FC_IN_FEATURES = 512
KERNEL_SIZE = 3
BN_EPS = 1e-4


class CNV(nn.Module):

    def __init__(self, *, num_classes: int = 10, weight_bit_width: Optional[int] = 1,
                 act_bit_width: Optional[int] = 1, in_bit_width: Optional[int] = 8,
                 in_channels: int = 3, per_channel_weights: bool = False,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)

        def wq(bits):
            # per_channel_weights: stats-scaled INT weights, one scale per
            # output channel, instead of the reference's const scale
            if per_channel_weights and bits is not None:
                return presets.Int8WeightPerChannelFloat.let(bit_width=float(bits))
            return common_weight_quant(bits)

        # Q1.7 input: 8 bits over [-1, 1 - 2^-7]; the threshold's power of
        # two (CEIL) is 1, so the scale is 1 / 128
        self.input_quant = QuantIdentity(common_act_quant(
            in_bit_width, max_val=1.0 - 2.0 ** (-7), narrow_range=False,
            restrict=RestrictType.POWER_OF_TWO), return_quant_tensor=True)
        convs = []
        in_ch = in_channels
        for out_ch, pool in CNV_OUT_CH_POOL:
            convs.append(QuantConv2d(in_ch, out_ch, KERNEL_SIZE, padding="VALID",
                                     use_bias=False, weight_quant=wq(weight_bit_width),
                                     generator=g))
            convs.append(BatchNorm(out_ch, momentum=0.9, eps=BN_EPS, channel_axis=1))
            convs.append(QuantIdentity(common_act_quant(act_bit_width),
                                       return_quant_tensor=True))
            if pool:
                convs.append(QuantMaxPool2d(2, return_quant_tensor=True))
            in_ch = out_ch
        self.conv_features = nn.ModuleList(convs)
        fcs = []
        for feat_in, feat_out in INTERMEDIATE_FC_FEATURES:
            fcs.append(QuantLinear(feat_in, feat_out, use_bias=False,
                                   weight_quant=wq(weight_bit_width), generator=g))
            fcs.append(BatchNorm(feat_out, momentum=0.9, eps=BN_EPS))
            fcs.append(QuantIdentity(common_act_quant(act_bit_width),
                                     return_quant_tensor=True))
        fcs.append(QuantLinear(LAST_FC_IN_FEATURES, num_classes, use_bias=False,
                               weight_quant=wq(weight_bit_width), generator=g))
        self.linear_features = nn.ModuleList(fcs)
        self.norm = TensorNorm()
        # weights start uniform(-1, 1), as in the reference's CNV.py
        with torch.no_grad():
            for lyr in self._weighted():
                lyr.weight.copy_(torch.rand(lyr.weight.shape, generator=g) * 2.0 - 1.0)
        self.to(device)

    def _weighted(self):
        return [lyr for lyr in [*self.conv_features, *self.linear_features]
                if isinstance(lyr, (QuantConv2d, QuantLinear))]

    def clip_weights(self, min_val: float = -1.0, max_val: float = 1.0) -> None:
        """Post-step weight clipping, in place (reference trainer.py:245)."""
        with torch.no_grad():
            for lyr in self._weighted():
                lyr.weight.clamp_(min_val, max_val)

    def forward(self, x):
        x = 2.0 * x - 1.0
        x = self.input_quant(x)
        for lyr in self.conv_features:
            x = lyr(x)
        # the VALID convs end at 1 x 1, so (N, C, 1, 1) flattens to the same
        # order as the JAX package's (N, 1, 1, C)
        x = dataclasses.replace(x, value=x.value.reshape(x.value.shape[0], -1))
        for lyr in self.linear_features:
            x = lyr(x)
        return self.norm(x)


def cnv(weight_bit_width=1, act_bit_width=1, in_bit_width=8, **kw) -> CNV:
    return CNV(weight_bit_width=weight_bit_width, act_bit_width=act_bit_width,
               in_bit_width=in_bit_width, **kw)
