"""Quant layer base: the weight/bias/input/output (WBIOL) forward law (port
of ``brevitas_tpu/nn/quant_layer.py``).

    input_quant(x) -> weight_quant(w) -> accumulator scale/bit-width
    propagation -> bias_quant(b | acc_scale, acc_bit_width) -> inner forward
    -> output_quant -> pack.

Left out: the ``compute_dtype`` code-domain branch (off by default), the
cached inference weight, accumulator-aware (A2Q) weights and the PTQ hooks.
"""

from typing import Optional, Union

import torch
from torch import nn

from brevitas_tpu_torch.ops import max_int
from brevitas_tpu_torch.quant.config import QuantConfig, QuantType
from brevitas_tpu_torch.quant.presets import NoneActQuant, NoneBiasQuant, NoneWeightQuant
from brevitas_tpu_torch.quant.quantizers import (
    ActQuantizer,
    BiasQuantizer,
    ParameterQuantizer,
)
from brevitas_tpu_torch.quant_tensor import QuantTensor, pack

TensorOrQuant = Union[torch.Tensor, QuantTensor]


def _cfg(q: Optional[QuantConfig], default: QuantConfig) -> QuantConfig:
    return default if q is None else q


class QuantLayerMixin:
    """Input/output packing shared by all quant layers."""

    return_quant_tensor: bool = False

    def unpack_input(self, x: TensorOrQuant) -> QuantTensor:
        return pack(x)

    def pack_output(self, qt: QuantTensor) -> TensorOrQuant:
        return qt if self.return_quant_tensor else qt.value


class QuantWBIOL(QuantLayerMixin, nn.Module):
    """Base for layers with quantized Weight, Bias, Input, Output."""

    def init_quant(self, weight_quant: Optional[QuantConfig],
                   bias_quant: Optional[QuantConfig],
                   input_quant: Optional[QuantConfig],
                   output_quant: Optional[QuantConfig],
                   weight_init: torch.Tensor, return_quant_tensor: bool,
                   channel_axis: int = 0) -> None:
        self.weight_quant = ParameterQuantizer(
            _cfg(weight_quant, NoneWeightQuant), weight_init, channel_axis)
        self.input_quant = ActQuantizer(_cfg(input_quant, NoneActQuant))
        self.output_quant = ActQuantizer(_cfg(output_quant, NoneActQuant))
        self.bias_quant = BiasQuantizer(_cfg(bias_quant, NoneBiasQuant))
        self.return_quant_tensor = return_quant_tensor

    @property
    def reduce_size(self) -> int:
        """Number of elements summed per output element (fan-in)."""
        raise NotImplementedError

    def max_acc_bit_width(self, input_bit_width: float, weight_bit_width: float) -> float:
        """Accumulator bit-width law: ceil(log2(max_in * max_w * fan_in)),
        evaluated in float32 as the JAX package does."""
        max_input = max_int(False, False, input_bit_width)
        max_weight = max_int(False, self.weight_quant.cfg.narrow_range, weight_bit_width)
        max_output = torch.tensor(max_input * max_weight * self.reduce_size,
                                  dtype=torch.float32)
        return float(torch.ceil(torch.log2(max_output)))

    def quant_weight(self) -> QuantTensor:
        return self.weight_quant(self.weight)

    def forward_quant(self, inp: TensorOrQuant, inner_forward) -> TensorOrQuant:
        qt_in = self.unpack_input(inp)
        if self.input_quant.quant_type != QuantType.NONE:
            quant_input = self.input_quant(qt_in.value)
        else:
            quant_input = qt_in  # an already-quantized input passes through
        quant_weight = self.quant_weight()

        output_scale = output_bit_width = output_zero_point = output_signed = None
        if quant_input.bit_width is not None and quant_weight.bit_width is not None:
            output_bit_width = self.max_acc_bit_width(quant_input.bit_width,
                                                      quant_weight.bit_width)
        if quant_input.scale is not None and quant_weight.scale is not None:
            # a per-channel weight scale (out, 1) becomes (out,), which
            # broadcasts against the (..., out) output
            w_scale = quant_weight.scale
            if w_scale.ndim > 1:
                w_scale = w_scale.reshape(-1)
            output_scale = w_scale * quant_input.scale
        if quant_input.signed is not None:
            output_signed = quant_input.signed or quant_weight.signed

        x_in, w_in = quant_input.value, quant_weight.value
        bias = getattr(self, "bias", None)
        if bias is not None:
            quant_bias = self.bias_quant(bias, input_scale=output_scale,
                                         input_bit_width=output_bit_width)
            out = inner_forward(x_in, w_in, quant_bias.value)
            if quant_bias.bit_width is not None and output_bit_width is not None:
                output_bit_width = max(quant_bias.bit_width, output_bit_width) + 1
        else:
            out = inner_forward(x_in, w_in, None)

        if (self.return_quant_tensor
                and self.output_quant.quant_type == QuantType.NONE
                and quant_input.zero_point is not None):
            output_zero_point = quant_input.zero_point

        qt_out = QuantTensor(out, output_scale, output_zero_point, output_bit_width,
                             signed=output_signed, training=self.input_quant.training)
        if self.output_quant.quant_type != QuantType.NONE:
            qt_out = self.output_quant(qt_out.value)
        return self.pack_output(qt_out)
