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


def binary_sign(x: torch.Tensor) -> torch.Tensor:
    """Two-valued sign: +1 for x >= 0, -1 for x < 0 (``torch.sign(0)`` is
    0, so it is not used)."""
    return torch.where(x >= 0, torch.ones_like(x), -torch.ones_like(x))


def round_to_zero(x: torch.Tensor) -> torch.Tensor:
    """Round towards zero. ``torch.trunc`` gives what the JAX package's
    ``sign(x) * floor(|x|)`` gives, signed zeros included (-0.5 and -0.0
    give -0.0); torch's own ``sign(-0.0)`` is +0.0, so that form would not."""
    return torch.trunc(x)


def dpu_round(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, except that a negative .5 tie rounds up (ceil):
    ``dpu_round([-1.5, -0.5, 0.5, 1.5]) == [-1, -0, 0, 2]``."""
    frac = x - torch.floor(x)
    return torch.where((x < 0.0) & (frac == 0.5), torch.ceil(x), torch.round(x))


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


def sigmoid_f64(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))`` formed in float64 and rounded once to ``x``'s
    type. float32 sigmoids differ in the last bit between torch on the CPU,
    torch on the card and XLA; the float64 form rounded once is the same on
    the CPU and the card except where a value lies within a float64 ulp of a
    float32 rounding boundary, and a CUDA kernel that forms it the same way
    (``csrc/quant_lstm_cell.cu``) agrees with it bit for bit on the card."""
    x64 = x.double()
    return torch.reciprocal(1.0 + torch.exp(-x64)).to(x.dtype)


def tanh_f64(x: torch.Tensor) -> torch.Tensor:
    """tanh formed in float64 and rounded once, as :func:`sigmoid_f64`."""
    return torch.tanh(x.double()).to(x.dtype)


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
