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


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis as ``jax.nn.softmax`` forms it:
    ``exp(x - max) / sum``, a division; torch's own softmax multiplies by
    the reciprocal of the sum, which moves the last bit."""
    e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


# finfo(float32).min / 2: the score of a masked attention position; an
# all-masked row softmaxes to uniform instead of NaN
MASKED_SCORE = torch.finfo(torch.float32).min / 2


def causal_mask(tq: int, tk: int, device) -> torch.Tensor:
    """Rectangular causal mask: query row i sees keys up to i + (tk - tq)."""
    return torch.ones((tq, tk), dtype=torch.bool, device=device).tril(tk - tq)
