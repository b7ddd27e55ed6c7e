"""Quant layer base: the weight/bias/input/output (WBIOL) forward law (port
of ``brevitas_tpu/nn/quant_layer.py``).

    input_quant(x) -> weight_quant(w) -> accumulator scale/bit-width
    propagation -> bias_quant(b | acc_scale, acc_bit_width) -> inner forward
    -> output_quant -> pack.

With ``compute_dtype`` set (``utils.set_compute_dtype``) and INT input
and weight grids of at most 9 bits with integral zero points, the layer
feeds the integer codes ``value / scale`` (exact small integers, lossless in
bf16) to its product and rescales the float32 result by the output scale:
the code-domain branch. A per-channel input scale arrives as (C, 1, ...)
against the input's channel axis and reaches depthwise convs only. BINARY
and TERNARY weights never take the branch (it needs INT weights, as in
JAX): under bf16 their +-scale values are cast to bf16 like any float
operand.

With ``_capture_input`` set on a layer, its forward keeps the input it was
given in ``_bc_last_input``: the PTQ passes (SmoothQuant, GPTQ, AdaRound,
bias correction) read a layer's calibration inputs so. A per-token input
scale (..., 1) broadcasts over the output's last axis like a per-tensor
one. A ``_pre_output_hook(layer, qt_out)`` set on a layer sees the output
before the output quantizer and may replace it (bias correction's seam).
``cache_quant_weight`` keeps the fake-quant weight for eval serving.

Left out: accumulator-aware (A2Q) weights.
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


def _static_leq(v, lim: float) -> bool:
    """True when ``v`` is a known number <= ``lim`` (the port's bit widths
    are constant Python floats)."""
    return v is not None and not torch.is_tensor(v) and float(v) <= lim


def _static_integer_zp(zp) -> bool:
    """True when the zero point is a known integer (the port's are Python
    numbers): then ``value / scale`` is an exact small integer."""
    return zp is None or (not torch.is_tensor(zp) and float(zp).is_integer())


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
        evaluated in float32 as the JAX package does. A 1-bit narrow weight
        (binary) has max_w = 0, so the law gives -inf, as in JAX."""
        max_input = max_int(False, False, input_bit_width)
        max_weight = max_int(False, self.weight_quant.cfg.narrow_range, weight_bit_width)
        max_output = torch.tensor(max_input * max_weight * self.reduce_size,
                                  dtype=torch.float32)
        return float(torch.ceil(torch.log2(max_output)))

    # the product's operand dtype (torch.bfloat16) or None for float32:
    # see utils.set_compute_dtype
    compute_dtype: Optional[torch.dtype] = None

    # True where output channel c is formed from input channel c alone (a
    # depthwise conv), so a per-channel input scale is per output channel
    keeps_channels: bool = False

    def output_channel_view(self, v: torch.Tensor) -> torch.Tensor:
        """A per-output-channel value in the shape that broadcasts against
        the output's channel axis: (O,) for the last axis (a linear's, an
        LSTM's gates); convs put it on axis 1."""
        return v.reshape(-1)

    def quant_weight(self) -> QuantTensor:
        cached = getattr(self, "_cached_quant_weight", None)
        if cached is not None and not self.weight_quant.disable_quant and not self.training:
            return cached
        return self.weight_quant(self.weight)

    def cache_quant_weight(self) -> None:
        """Keep the fake-quant weight for eval serving, so forwards skip the
        quantizer. The cache is not read in training mode or while
        quantization is bypassed, and ``train()`` drops it."""
        with torch.no_grad():
            self._cached_quant_weight = self.weight_quant(self.weight)

    def clear_quant_weight_cache(self) -> None:
        self._cached_quant_weight = None

    def train(self, mode: bool = True):
        if mode:
            self.clear_quant_weight_cache()
        return super().train(mode)

    def forward_quant(self, inp: TensorOrQuant, inner_forward) -> TensorOrQuant:
        if getattr(self, "_capture_input", False):
            self._bc_last_input = inp
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
        if (quant_input.scale is not None and quant_weight.scale is not None
                and self.weight_quant.cfg.scaling_per_group is None):
            # groupwise (MX) weights have no one scale an output channel:
            # the output carries no scale, as in the JAX package.
            # A per-channel weight scale (out, 1, ...) takes the shape of the
            # output's channel axis: (out,) against a linear's (..., out)
            # output, (out, 1, 1) against a 2-D conv's (N, out, H, W)
            w_scale = quant_weight.scale
            if w_scale.ndim > 1:
                w_scale = self.output_channel_view(w_scale)
            if (quant_input.scale.numel() > 1 and not self.keeps_channels
                    and not self.input_quant.per_token):
                # a per-channel input grid (C, 1, ...) is a per-output-channel
                # grid only where output channel c sums input channel c alone
                raise ValueError(f"{type(self).__name__}: a per-channel input grid needs a "
                                 "depthwise layer")
            output_scale = w_scale * quant_input.scale
        if quant_input.signed is not None:
            output_signed = quant_input.signed or quant_weight.signed

        # code domain: exact integer codes through the bf16 product, its
        # float32 result rescaled by the output scale (the same values as
        # the float32 product of the fake-quant values, up to its rounding)
        code_domain = (
            self.compute_dtype is not None
            and output_scale is not None
            and self.weight_quant.quant_type == QuantType.INT
            and _static_leq(quant_input.bit_width, 9.0)
            and _static_leq(quant_weight.bit_width, 9.0)
            and _static_integer_zp(quant_input.zero_point)
            and _static_integer_zp(quant_weight.zero_point))
        if code_domain:
            x_in = quant_input.value / quant_input.scale
            w_in = quant_weight.value / quant_weight.scale
        else:
            x_in, w_in = quant_input.value, quant_weight.value
        bias = getattr(self, "bias", None)
        if bias is not None:
            quant_bias = self.bias_quant(bias, input_scale=output_scale,
                                         input_bit_width=output_bit_width)
            if code_domain:
                out = (inner_forward(x_in, w_in, None) * output_scale
                       + self.output_channel_view(quant_bias.value))
            else:
                out = inner_forward(x_in, w_in, quant_bias.value)
            if quant_bias.bit_width is not None and output_bit_width is not None:
                output_bit_width = max(quant_bias.bit_width, output_bit_width) + 1
        else:
            out = inner_forward(x_in, w_in, None)
            if code_domain:
                out = out * output_scale

        if (self.return_quant_tensor
                and self.output_quant.quant_type == QuantType.NONE
                and quant_input.zero_point is not None):
            output_zero_point = quant_input.zero_point

        qt_out = QuantTensor(out, output_scale, output_zero_point, output_bit_width,
                             signed=output_signed, training=self.input_quant.training)
        hook = getattr(self, "_pre_output_hook", None)
        if hook is not None:
            maybe = hook(self, qt_out)
            if maybe is not None:
                qt_out = maybe
        if self.output_quant.quant_type != QuantType.NONE:
            qt_out = self.output_quant(qt_out.value)
        return self.pack_output(qt_out)
