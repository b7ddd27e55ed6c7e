"""Functional fake-quant primitives (port of ``brevitas_tpu/core/quant.py``).

``int_quant_to_int`` divides by the scale (``x / scale``), as the JAX model
path does: a multiply by the reciprocal can move a value across a rounding
tie.
"""

from typing import Callable, Tuple

import torch

from brevitas_tpu_torch.ops import (
    binary_sign_ste,
    max_int,
    min_int,
    round_ste,
    tensor_clamp,
    ternary_sign_ste,
)

FloatToInt = Callable[[torch.Tensor], torch.Tensor]


def int_quant_to_int(x: torch.Tensor, scale, zero_point, bit_width, *,
                     signed: bool, narrow_range: bool,
                     float_to_int: FloatToInt = round_ste,
                     clamp_fn=tensor_clamp) -> torch.Tensor:
    """Map ``x`` to (float-valued) integers in the representable range."""
    y = x / scale + zero_point
    y = float_to_int(y)
    return clamp_fn(y, min_int(signed, narrow_range, bit_width),
                    max_int(signed, narrow_range, bit_width))


def int_quant(x: torch.Tensor, scale, zero_point, bit_width, *,
              signed: bool, narrow_range: bool,
              float_to_int: FloatToInt = round_ste,
              clamp_fn=tensor_clamp) -> torch.Tensor:
    """Uniform affine fake-quantization (quantize, then dequantize)."""
    y_int = int_quant_to_int(x, scale, zero_point, bit_width, signed=signed,
                             narrow_range=narrow_range,
                             float_to_int=float_to_int, clamp_fn=clamp_fn)
    return (y_int - zero_point) * scale


def int_scaling(bit_width, *, signed: bool, narrow_range: bool):
    """Integer-range threshold: signed ranges use |min_int| so that
    -threshold maps exactly to min_int."""
    if signed:
        return -min_int(signed, narrow_range, bit_width)
    return max_int(signed, narrow_range, bit_width)


def po2_int_scaling(bit_width, *, signed: bool):
    """Power-of-two integer threshold, 2 ** bits (signed: 2 ** (bits - 1)),
    which keeps a power-of-two scale a power of two."""
    return max_int(signed, False, bit_width) + 1.0


def rescaling_scale(threshold: torch.Tensor, bit_width, *, signed: bool,
                    narrow_range: bool, po2_int_scale: bool = False) -> torch.Tensor:
    """scale = float threshold / integer threshold (``po2_int_scaling``
    for power-of-two restricted scales). The integer threshold
    divides as a tensor filled on the threshold's device: PyTorch on CUDA
    multiplies by the reciprocal of a Python-number divisor, which differs
    from the division by an ulp about half the time (for 7 or 127), so the
    card and a CPU copy would compute different scales. A fill, unlike a
    tensor made from the Python number, copies nothing from the host and so
    does not wait for the card. A learned bit width gives a tensor divisor,
    through which its gradient flows."""
    divisor = (po2_int_scaling(bit_width, signed=signed) if po2_int_scale
               else int_scaling(bit_width, signed=signed, narrow_range=narrow_range))
    if torch.is_tensor(divisor):
        return threshold / divisor
    return threshold / torch.full_like(threshold, divisor)


def binary_quant(x: torch.Tensor, scale) -> Tuple[torch.Tensor, float]:
    """``binary_sign(x) * scale`` (+scale at 0), the gradient straight
    through everywhere. Returns (value, bit width 1)."""
    return binary_sign_ste(x) * scale, 1.0


def clamped_binary_quant(x: torch.Tensor, scale) -> Tuple[torch.Tensor, float]:
    """Binarization of ``x`` clamped to [-scale, scale] first (the
    activation side): the ``where`` clamp zeroes the gradient outside that
    range and passes it at exactly +-scale, as in JAX."""
    y = tensor_clamp(x, -scale, scale)
    return binary_sign_ste(y) * scale, 1.0


def ternary_quant(x: torch.Tensor, scale, threshold: float) -> Tuple[torch.Tensor, float]:
    """0 where ``|x| <= threshold * scale`` (a strict ``>`` keeps the rest),
    else ``sign(x) * scale``. Returns (value, bit width 2)."""
    mask = torch.abs(x) > (threshold * scale)
    return mask.to(x.dtype) * ternary_sign_ste(x) * scale, 2.0


def trunc_int_quant(x: torch.Tensor, scale, zero_point, input_bit_width, output_bit_width, *,
                    float_to_int: FloatToInt = round_ste) -> torch.Tensor:
    """Accumulator truncation: drop the low bits that take ``input_bit_width``
    down to ``output_bit_width`` (QuantAvgPool2d's renormalisation of its
    window sum). The first rounding cleans the float error of the value's
    codes; the division by ``2 ** (input - output)`` is exact."""
    y = round_ste(x / scale + zero_point)
    y = y / 2.0 ** (input_bit_width - output_bit_width)
    y = float_to_int(y)
    return (y - zero_point) * scale
