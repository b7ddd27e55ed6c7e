"""Straight-through-estimator ops as ``torch.autograd.Function``s (port of
``brevitas_tpu/ops/ste.py``): the forward is a rounding or clamping
primitive, the backward passes the gradient straight through.

``torch.round`` rounds half to even, like ``jnp.round``.
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
