"""QuantTensor: a tensor with its quantization metadata (port of
``brevitas_tpu/quant_tensor.py``; ported: the fields, ``int()``, the shape
views and the sum, as QuartzNet's residual adds and MobileNet's head use
them).

The sum follows the JAX package: the two scales must agree (checked outside
training); the sum's scale is their mean and its bit width ``ceil(log2(max
- min))`` over the two operands' integer ranges.

Bit widths are Python numbers in the port, as its quantizers give them.
"""

import dataclasses
from typing import Any, Optional, Union

import torch

from brevitas_tpu_torch.ops import max_int, min_int, round_ste


def _ceil_log2(v: float) -> float:
    """ceil(log2(v)) in float32, as the JAX package evaluates it."""
    return float(torch.ceil(torch.log2(torch.tensor(v, dtype=torch.float32))))


@dataclasses.dataclass
class QuantTensor:
    value: torch.Tensor
    scale: Optional[torch.Tensor] = None
    zero_point: Optional[Union[torch.Tensor, float]] = None
    bit_width: Optional[Union[torch.Tensor, float]] = None
    signed: Optional[bool] = None
    training: bool = False

    @property
    def shape(self):
        return self.value.shape

    @property
    def is_not_none(self) -> bool:
        return (self.scale is not None and self.zero_point is not None
                and self.bit_width is not None and self.signed is not None)

    def int(self, float_datatype: bool = False) -> torch.Tensor:
        """Integer codes ``round(value / scale + zero_point)``: int8/uint8 up
        to 8 bits, int32 above; ``float_datatype=True`` keeps the float
        dtype (STE-differentiable)."""
        int_value = round_ste(self.value / self.scale + self.zero_point)
        if float_datatype:
            return int_value
        bw = float(torch.as_tensor(self.bit_width).max()) \
            if self.bit_width is not None else 32.0
        if bw <= 8 and self.signed:
            return int_value.to(torch.int8)
        if bw <= 8 and not self.signed:
            return int_value.to(torch.uint8)
        return int_value.to(torch.int32)

    def reshape(self, *shape) -> "QuantTensor":
        """The value reshaped; the metadata stays as it is."""
        return dataclasses.replace(self, value=self.value.reshape(*shape))

    def flatten(self) -> "QuantTensor":
        return dataclasses.replace(self, value=self.value.reshape(-1))

    def check_scaling_factors_same(self, other: "QuantTensor") -> None:
        """Raise unless the two scales have one shape and close values; not
        checked while either operand is training, as in the JAX package."""
        if self.training or other.training:
            return
        if tuple(self.scale.shape) != tuple(other.scale.shape):
            raise ValueError("Scaling factor shapes differ")
        if not torch.allclose(self.scale, other.scale):
            raise ValueError("Scaling factors are different")

    def __add__(self, other: Any) -> "QuantTensor":
        if isinstance(other, QuantTensor) and self.is_not_none and other.is_not_none:
            self.check_scaling_factors_same(other)
            max_val = (max_int(self.signed, False, self.bit_width)
                       + max_int(other.signed, False, other.bit_width))
            min_val = (min_int(self.signed, False, self.bit_width)
                       + min_int(other.signed, False, other.bit_width))
            return QuantTensor(
                self.value + other.value, (self.scale + other.scale) / 2,
                self.zero_point + other.zero_point,
                _ceil_log2(max_val - min_val),
                signed=self.signed or other.signed,
                training=self.training or other.training)
        if isinstance(other, QuantTensor):
            return QuantTensor(self.value + other.value)
        return QuantTensor(self.value + other)


def pack(x: Union[QuantTensor, torch.Tensor]) -> QuantTensor:
    return x if isinstance(x, QuantTensor) else QuantTensor(x)
