"""Shared model components for the bnn_pynq family (port of
``brevitas_tpu/models/common.py``), plus the norms with flax nnx's
semantics that the models use: BatchNorm for ``FC`` and ``CNV``, RMSNorm for
``QuantLlama``, LayerNorm for ``QuantTransformer``.
"""

from typing import Optional

import torch
from torch import nn

from brevitas_tpu_torch.core.restrict import FloatToIntImpl, RestrictType
from brevitas_tpu_torch.quant.config import QuantConfig, QuantType, ScalingImplType


def common_weight_quant(bit_width: Optional[int]) -> QuantConfig:
    """CommonWeightQuant: const scale 1.0, narrow signed; BINARY at 1 bit;
    no quantization when bit_width is None."""
    if bit_width is None:
        return QuantConfig(quant_type=QuantType.NONE)
    return QuantConfig(
        quant_type=QuantType.BINARY if bit_width == 1 else QuantType.INT,
        bit_width=float(bit_width), signed=True, narrow_range=True,
        scaling_impl=ScalingImplType.CONST, scaling_const=1.0)


def common_act_quant(bit_width: Optional[int], min_val: float = -1.0,
                     max_val: float = 1.0, narrow_range: bool = True,
                     restrict: RestrictType = RestrictType.FP) -> QuantConfig:
    """CommonActQuant: const scale max_val, clamped binary at 1 bit."""
    if bit_width is None:
        return QuantConfig(quant_type=QuantType.NONE)
    return QuantConfig(
        quant_type=QuantType.BINARY if bit_width == 1 else QuantType.INT,
        bit_width=float(bit_width), signed=True, narrow_range=narrow_range,
        scaling_impl=ScalingImplType.CONST, scaling_const=max_val,
        restrict_scaling=restrict,
        restrict_scaling_float_to_int=FloatToIntImpl.CEIL)


def _rsqrt(v: torch.Tensor) -> torch.Tensor:
    """float32 rsqrt formed in float64 and rounded once. torch's float32
    rsqrt gives different last bits on the CPU and the card; this rounds to
    the same float32 on both, so a CPU copy of a served model reproduces the
    card's output exactly."""
    return torch.rsqrt(v.double()).to(v.dtype)


class BatchNorm(nn.Module):
    """Batch norm with flax nnx's semantics (``nnx.BatchNorm`` as ``FC`` and
    ``CNV`` build it), which ``nn.BatchNorm1d``/``2d`` do not have: the batch
    variance is ``E[x^2] - E[x]^2`` clamped at 0, the running statistics move
    as ``ra = momentum * ra + (1 - momentum) * batch`` with the *biased*
    variance, and the output is ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias``.

    ``channel_axis=None`` (``FC``'s features) reduces over the leading axis
    in float32. ``channel_axis=1`` (a conv's (N, C, ...) output) reduces over
    every other axis, with the statistics formed in float64 and each rounded
    once to float32: the card and a CPU copy then agree bit for bit (their
    float32 sums over N, H and W run in different orders)."""

    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5,
                 channel_axis=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.channel_axis = channel_axis
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def _batch_stats(self, x: torch.Tensor):
        if self.channel_axis is None:
            mean = x.mean(0)
            return mean, torch.clamp_min((x * x).mean(0) - mean * mean, 0.0)
        dims = [d for d in range(x.ndim) if d != self.channel_axis]
        x64 = x.double()
        mean = x64.mean(dims)
        var = torch.clamp_min((x64 * x64).mean(dims) - mean * mean, 0.0)
        return mean.to(x.dtype), var.to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = self._batch_stats(x)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        mul = _rsqrt(var + self.eps) * self.scale
        if self.channel_axis is not None:
            view = [1] * x.ndim
            view[self.channel_axis] = -1
            mean, mul, bias = mean.reshape(view), mul.reshape(view), self.bias.reshape(view)
        else:
            bias = self.bias
        return (x - mean) * mul + bias


class TensorNorm(nn.Module):
    """Whole-tensor batch norm with a scalar learned affine; the running
    variance is the unbiased one."""

    def __init__(self, eps: float = 1e-4, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(()))
        self.bias = nn.Parameter(torch.zeros(()))
        self.register_buffer("running_mean", torch.zeros(()))
        self.register_buffer("running_var", torch.ones(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = torch.mean(x)
            biased_var = torch.var(x, correction=0)
            n = x.numel()
            unbiased_var = biased_var * n / max(n - 1, 1)
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * unbiased_var)
            return (x - mean) * _rsqrt(biased_var + self.eps) * self.weight + self.bias
        return ((x - self.running_mean) * _rsqrt(self.running_var + self.eps)
                * self.weight + self.bias)


class RMSNorm(nn.Module):
    """Root-mean-square norm over the last axis with flax nnx's semantics
    (``nnx.RMSNorm`` as ``QuantLlama`` builds it): ``x * (rsqrt(mean(x^2) +
    eps) * scale)``, epsilon 1e-6. The mean and rsqrt are formed in float64
    and rounded once, so the card and a CPU copy agree (the order of a
    float32 sum differs between them)."""

    def __init__(self, num_features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = torch.mean(torch.square(x.double()), dim=-1, keepdim=True)
        return x * (torch.rsqrt(var + self.eps).to(x.dtype) * self.scale)


class LayerNorm(nn.Module):
    """Layer norm over the last axis with flax nnx's semantics
    (``nnx.LayerNorm`` as ``QuantTransformer`` builds it): the variance is
    ``E[x^2] - E[x]^2`` clamped at 0, the output ``(x - mean) * (rsqrt(var +
    eps) * scale) + bias``, epsilon 1e-6. The mean, variance and rsqrt are
    formed in float64 and each rounded once, so the card and a CPU copy
    agree (the order of a float32 sum differs between them)."""

    def __init__(self, num_features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x64 = x.double()
        mean = x64.mean(-1, keepdim=True)
        var = torch.clamp_min(torch.square(x64).mean(-1, keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps).to(x.dtype)
        return (x - mean.to(x.dtype)) * (mul * self.scale) + self.bias
