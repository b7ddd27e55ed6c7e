"""QuantTensor: a tensor with its quantization metadata (port of
``brevitas_tpu/quant_tensor.py``; ported: the fields and ``int()``)."""

import dataclasses
from typing import Optional, Union

import torch

from brevitas_tpu_torch.ops import round_ste


@dataclasses.dataclass
class QuantTensor:
    value: torch.Tensor
    scale: Optional[torch.Tensor] = None
    zero_point: Optional[Union[torch.Tensor, float]] = None
    bit_width: Optional[Union[torch.Tensor, float]] = None
    signed: Optional[bool] = None
    training: bool = False

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


def pack(x: Union[QuantTensor, torch.Tensor]) -> QuantTensor:
    return x if isinstance(x, QuantTensor) else QuantTensor(x)
