"""Numeric primitives (port of ``brevitas_tpu/ops/numeric.py``).

Bit-widths are Python floats in the port (only constant bit-widths are
ported), so ``max_int``/``min_int`` return floats.
"""

from typing import Union

import torch

Number = Union[torch.Tensor, float, int]


def tensor_clamp(x: torch.Tensor, min_val: Number, max_val: Number) -> torch.Tensor:
    """Clamp with tensor-valued (broadcastable) bounds."""
    out = torch.where(x > max_val, max_val, x)
    return torch.where(out < min_val, min_val, out)


def max_int(signed: bool, narrow_range: bool, bit_width: Number) -> Number:
    """Largest representable integer: max_int(True, *, 8) == 127,
    max_int(False, False, 8) == 255, max_int(False, True, 8) == 254."""
    if not signed and not narrow_range:
        return 2.0**bit_width - 1.0
    if not signed and narrow_range:
        return 2.0**bit_width - 2.0
    return 2.0 ** (bit_width - 1.0) - 1.0


def min_int(signed: bool, narrow_range: bool, bit_width: Number) -> Number:
    """Smallest representable integer: min_int(True, True, 8) == -127,
    min_int(True, False, 8) == -128, unsigned == 0."""
    if signed and narrow_range:
        return -(2.0 ** (bit_width - 1.0)) + 1.0
    if signed and not narrow_range:
        return -(2.0 ** (bit_width - 1.0))
    return 0.0
