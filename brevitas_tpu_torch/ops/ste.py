"""Straight-through-estimator ops as ``torch.autograd.Function``s (port of
``brevitas_tpu/ops/ste.py``): the forward is a rounding or clamping
primitive, the backward passes the gradient straight through.

``torch.round`` rounds half to even, like ``jnp.round``. Stochastic rounding
takes its noise as an input, drawn by the caller (the quantizer holds the
generator), as JAX's ``_stochastic_round(x, noise)`` does.
"""

import torch


class _RoundSte(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _CeilSte(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.ceil(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _FloorSte(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.floor(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _UnarySte(torch.autograd.Function):
    """``fn(x)`` forward, the gradient straight through."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _StochasticRound(torch.autograd.Function):
    """``floor(x + noise)``; the gradient passes straight through to ``x``
    and none reaches the noise, as JAX's ``_stochastic_round`` takes its
    noise as an input with a zero cotangent."""

    @staticmethod
    def forward(ctx, x, noise):
        return torch.floor(x + noise)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TensorClampSte(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, min_val, max_val):
        from brevitas_tpu_torch.ops.numeric import tensor_clamp

        return tensor_clamp(x, min_val, max_val)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ScalarClampMinSte(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, min_val):
        return torch.clamp_min(x, min_val)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AbsBinarySignGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.where(x >= 0, 1.0, -1.0).to(g.dtype)


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """Round half to even; straight-through gradient."""
    return _RoundSte.apply(x)


def ceil_ste(x: torch.Tensor) -> torch.Tensor:
    """Ceil; straight-through gradient."""
    return _CeilSte.apply(x)


def floor_ste(x: torch.Tensor) -> torch.Tensor:
    """Floor; straight-through gradient."""
    return _FloorSte.apply(x)


def round_to_zero_ste(x: torch.Tensor) -> torch.Tensor:
    """Truncation towards zero; straight-through gradient."""
    from brevitas_tpu_torch.ops.numeric import round_to_zero

    return _UnarySte.apply(x, round_to_zero)


def dpu_round_ste(x: torch.Tensor) -> torch.Tensor:
    """DPU rounding (negative .5 ties up); straight-through gradient."""
    from brevitas_tpu_torch.ops.numeric import dpu_round

    return _UnarySte.apply(x, dpu_round)


def binary_sign_ste(x: torch.Tensor) -> torch.Tensor:
    """Two-valued sign (+1 at 0); straight-through gradient."""
    from brevitas_tpu_torch.ops.numeric import binary_sign

    return _UnarySte.apply(x, binary_sign)


def ternary_sign_ste(x: torch.Tensor) -> torch.Tensor:
    """Three-valued sign (``torch.sign``, 0 at 0); straight-through
    gradient."""
    return _UnarySte.apply(x, torch.sign)


def stochastic_round_ste(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Stochastic rounding ``floor(x + noise)`` for uniform [0, 1) ``noise``
    of ``x``'s shape, drawn by the caller: it rounds up with probability
    equal to the fractional part. Straight-through gradient to ``x``."""
    return _StochasticRound.apply(x, noise)


def tensor_clamp_ste(x: torch.Tensor, min_val, max_val) -> torch.Tensor:
    """Clamp with tensor bounds; the gradient passes straight through to
    ``x`` and none reaches the bounds."""
    return _TensorClampSte.apply(x, min_val, max_val)


def scalar_clamp_min_ste(x: torch.Tensor, min_val: float) -> torch.Tensor:
    """Lower-bound clamp with a static scalar bound; straight-through
    gradient."""
    return _ScalarClampMinSte.apply(x, min_val)


def abs_binary_sign_grad(x: torch.Tensor) -> torch.Tensor:
    """``abs`` whose subgradient at 0 is +1: the backward multiplies the
    gradient by binary_sign(x), so learned scales never stick at 0."""
    return _AbsBinarySignGrad.apply(x)
