"""Quantizer modules — the stateful resolution of a QuantConfig (port of
``brevitas_tpu/quant/quantizers.py``).

Ported: CONST bit-width; CONST scaling, learned PARAMETER scaling
(``ParameterScaling``), STATS scaling of weights (``StatsScaling``) and
two-phase PARAMETER_FROM_STATS scaling of activations
(``ParameterFromRuntimeStatsScaling``) with its migration to a learned
parameter (``convert_runtime_stats_to_parameter``); ZERO zero-point; quant
delay; the INT/NONE weight quantizer, per-tensor or per output channel, and
activation quantizer, per-tensor, signed or unsigned, with its static grid
(``ActQuantizer.static_int_params``); the NONE bias quantizer; and the
``disable_quant`` switch that calibration mode sets. Configs that need
anything else raise ``NotImplementedError``. On the card a per-tensor
quantizer's fake-quant is the ``fake_quant`` CUDA kernel
(``int_fake_quant``).

The JAX package selects the two-phase scaler's branch with ``lax.cond`` on
a carried counter so it stays inside one jitted step; PyTorch runs eagerly,
so the port branches in Python on the same counter, with the same buffer,
value and handoff semantics. Train/eval is ``nn.Module.training``.
"""

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from brevitas_tpu_torch.core import quant as Qf
from brevitas_tpu_torch.core import restrict as R
from brevitas_tpu_torch.core import stats as S
from brevitas_tpu_torch.kernels.fake_quant import fake_quant
from brevitas_tpu_torch.ops import (
    abs_binary_sign_grad,
    max_int,
    min_int,
    round_ste,
    scalar_clamp_min_ste,
    tensor_clamp,
    tensor_clamp_ste,
)
from brevitas_tpu_torch.quant.config import (
    BitWidthImplType,
    QuantConfig,
    QuantType,
    ScalingImplType,
    ZeroPointImplType,
)
from brevitas_tpu_torch.quant_tensor import QuantTensor


def stats_view(x: torch.Tensor, per_channel: bool = False,
               channel_axis: int = 0) -> torch.Tensor:
    """View ``x`` as (groups, elems) for the stats ops: one group per output
    channel, or a single group for per-tensor scaling."""
    if per_channel:
        x = torch.movedim(x, channel_axis, 0)
        return x.reshape(x.shape[0], -1)
    return x.reshape(1, -1)


def scaling_broadcast_shape(shape: Sequence[int], per_channel: bool,
                            channel_axis: int = 0) -> Tuple[int, ...]:
    """Broadcastable scale shape: the channel dimension kept, all others 1."""
    if not per_channel:
        return ()
    return tuple(d if i == channel_axis % len(shape) else 1
                 for i, d in enumerate(shape))


def _expand(stat: torch.Tensor, bshape: Tuple[int, ...]) -> torch.Tensor:
    """A (groups,) stat in the broadcastable scale shape."""
    return stat.reshape(bshape)


class BitWidth(nn.Module):
    """CONST bit-width (a Python float)."""

    def __init__(self, cfg: QuantConfig):
        super().__init__()
        if BitWidthImplType(cfg.bit_width_impl) != BitWidthImplType.CONST:
            raise NotImplementedError("learned bit-widths are not ported yet")
        self.const = float(cfg.bit_width)

    def forward(self) -> float:
        return self.const


class _RestrictClamp:
    """restrict.forward, then the STE min-clamp."""

    def __init__(self, cfg: QuantConfig):
        self.restrict = R.RestrictType(cfg.restrict_scaling)
        self.f2i = cfg.restrict_scaling_float_to_int
        self.min_val = cfg.scaling_min_val

    def preprocess(self, v):
        return R.preprocess(self.restrict, v)

    def preprocess_runtime(self, v: torch.Tensor) -> torch.Tensor:
        return R.preprocess(self.restrict, v)

    def forward(self, stored: torch.Tensor) -> torch.Tensor:
        return self.clamp_only(R.forward(self.restrict, stored, self.f2i))

    def clamp_only(self, v: torch.Tensor) -> torch.Tensor:
        if self.min_val is not None and self.min_val != 0:
            v = scalar_clamp_min_ste(v, self.min_val)
        return v


class ConstScaling(nn.Module):
    def __init__(self, cfg: QuantConfig, init: float, bshape: Tuple[int, ...] = ()):
        super().__init__()
        self.rc = _RestrictClamp(cfg)
        self.register_buffer("stored", torch.full(bshape, self.rc.preprocess(float(init))))

    def forward(self, stats_input: Optional[torch.Tensor]) -> torch.Tensor:
        return self.rc.forward(self.stored)


class ParameterScaling(nn.Module):
    """Learned scale, stored as a parameter in the restricted domain."""

    def __init__(self, cfg: QuantConfig, init, bshape: Tuple[int, ...] = ()):
        super().__init__()
        self.rc = _RestrictClamp(cfg)
        init = torch.as_tensor(self.rc.preprocess(init), dtype=torch.float32).detach()
        if tuple(init.shape) != tuple(bshape):
            init = (init.reshape(bshape) if init.numel() == math.prod(bshape)
                    else init.reshape(()).expand(bshape))
        self.value = nn.Parameter(init.clone())

    def forward(self, stats_input: Optional[torch.Tensor]) -> torch.Tensor:
        return abs_binary_sign_grad(self.rc.forward(self.value))


class StatsScaling(nn.Module):
    """Stateless scale from the current statistics of the weight: the
    default weight path, whose gradients flow through the stats op."""

    def __init__(self, cfg: QuantConfig, stats_fn, bshape: Tuple[int, ...] = ()):
        super().__init__()
        self.rc = _RestrictClamp(cfg)
        self.stats_fn = stats_fn
        self.bshape = bshape

    def forward(self, stats_input: torch.Tensor) -> torch.Tensor:
        stats = _expand(self.stats_fn(stats_input), self.bshape)
        return self.rc.forward(self.rc.preprocess_runtime(stats))


def _momentum_update(buf: torch.Tensor, update: torch.Tensor,
                     momentum: Optional[float], counter: int) -> torch.Tensor:
    """EMA, or the cumulative running mean when ``momentum`` is None."""
    update = update.detach()
    if momentum is None:
        return buf * (counter / (counter + 1)) + update / (counter + 1)
    return buf * (1 - momentum) + momentum * update


class ParameterFromRuntimeStatsScaling(nn.Module):
    """Two-phase scale: collect running stats for ``collect_stats_steps``
    training steps, then hand the buffer off into a learned parameter.

    Counter ``c`` (training): ``c < steps`` collects into the buffer and
    returns the batch stat; ``c == steps`` copies the buffer into ``value``
    and returns it; afterwards ``value`` is returned. Eval reads the buffer
    while ``c <= steps`` and ``value`` after — so a quantizer calibrated for
    one step with ``steps=1`` serves from its buffer.
    """

    def __init__(self, cfg: QuantConfig, stats_fn, bshape: Tuple[int, ...] = ()):
        super().__init__()
        if cfg.collect_stats_steps <= 0:
            raise ValueError("collect_stats_steps must be positive")
        self.rc = _RestrictClamp(cfg)
        self.stats_fn = stats_fn
        self.bshape = bshape
        self.steps = int(cfg.collect_stats_steps)
        self.momentum = cfg.scaling_stats_momentum
        self.register_buffer("buffer", torch.ones(bshape))
        self.value = nn.Parameter(torch.ones(bshape))
        self.register_buffer("counter", torch.zeros((), dtype=torch.int32))

    def _from_param(self) -> torch.Tensor:
        return abs_binary_sign_grad(self.rc.forward(self.value))

    def forward(self, stats_input: Optional[torch.Tensor]) -> torch.Tensor:
        if not self.training:
            # the branch stays on the device: reading the counter on the host
            # would wait for the card at every call of a served model
            from_buffer = abs_binary_sign_grad(
                self.rc.forward(self.rc.preprocess_runtime(self.buffer)))
            return torch.where(self.counter <= self.steps, from_buffer, self._from_param())
        c = int(self.counter)
        if c > self.steps:
            return self._from_param()
        stats = _expand(self.stats_fn(stats_input), self.bshape)
        clamped = self.rc.clamp_only(stats).to(self.buffer.dtype)
        with torch.no_grad():
            if c < self.steps:
                self.buffer.copy_(clamped if c == 0 else _momentum_update(
                    self.buffer, clamped, self.momentum, c))
            else:
                self.value.copy_(self.rc.preprocess_runtime(self.buffer))
            self.counter += 1
        if c < self.steps:
            return abs_binary_sign_grad(clamped)
        return self._from_param()


def build_scaling(cfg: QuantConfig, bshape: Tuple[int, ...],
                  init_stats_input: Optional[torch.Tensor] = None) -> nn.Module:
    """Resolve ScalingImplType into a scaling module. Ported: CONST,
    PARAMETER, STATS of a parameter (``init_stats_input`` given) and
    PARAMETER_FROM_STATS collected at run time."""
    impl = ScalingImplType(cfg.scaling_impl)
    if impl == ScalingImplType.CONST:
        if cfg.scaling_const is None:
            raise ValueError("CONST scaling requires scaling_const")
        return ConstScaling(cfg, cfg.scaling_const, bshape)
    stats_fn = S.stats_fn(cfg.scaling_stats_op,
                          high_percentile_q=cfg.high_percentile_q)
    if impl == ScalingImplType.PARAMETER:
        if cfg.scaling_const is not None:
            init = torch.full(bshape, float(cfg.scaling_const))
        elif init_stats_input is not None:
            init = _expand(stats_fn(init_stats_input), bshape)
        else:
            init = torch.ones(bshape)
        return ParameterScaling(cfg, init, bshape)
    if impl == ScalingImplType.STATS and init_stats_input is not None:
        return StatsScaling(cfg, stats_fn, bshape)
    if impl == ScalingImplType.PARAMETER_FROM_STATS and init_stats_input is None:
        return ParameterFromRuntimeStatsScaling(cfg, stats_fn, bshape)
    raise NotImplementedError(f"scaling {impl.value} is not ported yet")


class ZeroPoint(nn.Module):
    """ZERO zero-point."""

    def __init__(self, cfg: QuantConfig):
        super().__init__()
        if ZeroPointImplType(cfg.zero_point_impl) != ZeroPointImplType.ZERO:
            raise NotImplementedError("only the ZERO zero-point is ported yet")

    def forward(self, stats_input, scale, bit_width) -> float:
        return 0.0


class QuantDelay(nn.Module):
    """Return the float value for the first ``steps`` training steps."""

    def __init__(self, steps: int):
        super().__init__()
        self.steps = int(steps)
        if self.steps > 0:
            self.register_buffer("counter", torch.zeros((), dtype=torch.int32))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.steps <= 0:
            return y
        c = int(self.counter)
        if self.training:
            self.counter += 1
        return x if c < self.steps else y


def _one_value(v, x: torch.Tensor) -> bool:
    """A number, or a one-element float32 tensor on ``x``'s device that
    broadcasts to no more dimensions than ``x`` has."""
    if not torch.is_tensor(v):
        return True
    return (v.numel() == 1 and v.dtype == torch.float32 and v.device == x.device
            and v.ndim <= x.ndim)


def int_fake_quant(x: torch.Tensor, scale, zero_point, bit_width: float, cfg: QuantConfig,
                   float_to_int) -> torch.Tensor:
    """INT fake-quant of ``x`` under ``cfg``. A per-tensor quantizer that
    rounds half to even, on a float32 CUDA tensor, launches the fused
    ``kernels.fake_quant`` (bit for bit the chain); per-channel scales, other
    roundings and CPU tensors run ``core/quant.py``'s chain, as the JAX
    package computes every quantizer."""
    lo = min_int(cfg.signed, cfg.narrow_range, bit_width)
    hi = max_int(cfg.signed, cfg.narrow_range, bit_width)
    if (x.is_cuda and x.dtype == torch.float32 and float_to_int is round_ste
            and _one_value(scale, x) and _one_value(zero_point, x)):
        return fake_quant(x, scale, zero_point, lo, hi, ste_clamp=cfg.clamp_ste)
    return Qf.int_quant(x, scale, zero_point, bit_width, signed=cfg.signed,
                        narrow_range=cfg.narrow_range, float_to_int=float_to_int,
                        clamp_fn=tensor_clamp_ste if cfg.clamp_ste else tensor_clamp)


def _check_int(quant_type: QuantType) -> None:
    if quant_type != QuantType.INT:
        raise NotImplementedError(f"{quant_type.value} quantization is not ported yet")


class ParameterQuantizer(nn.Module):
    """Weight-side quantizer: INT with per-tensor or per-output-channel
    scaling, or NONE. ``channel_axis`` is the weight's output-channel axis:
    0 for the port's (out, in) linear weight and for an embedding table's
    rows (the JAX package's (in, out) linear weight has it at 1)."""

    def __init__(self, cfg: QuantConfig, weight_init: torch.Tensor,
                 channel_axis: int = 0):
        super().__init__()
        self.cfg = cfg
        self.quant_type = QuantType(cfg.quant_type)
        self.disable_quant = False  # calibration mode: the float weight passes
        self.channel_axis = channel_axis
        self.per_channel = bool(cfg.scaling_per_output_channel)
        if self.quant_type == QuantType.NONE:
            return
        _check_int(self.quant_type)
        self._float_to_int = R.float_to_int_fn(cfg.float_to_int)
        self.bit_width_impl = BitWidth(cfg)
        bshape = scaling_broadcast_shape(weight_init.shape, self.per_channel, channel_axis)
        self.scaling = build_scaling(cfg, bshape, init_stats_input=stats_view(
            weight_init, self.per_channel, channel_axis))
        self.zero_point = ZeroPoint(cfg)
        self.delay = QuantDelay(cfg.quant_delay_steps)

    def forward(self, w: torch.Tensor) -> QuantTensor:
        cfg = self.cfg
        if self.quant_type == QuantType.NONE or self.disable_quant:
            return QuantTensor(w)
        view = stats_view(w, self.per_channel, self.channel_axis)
        bit_width = self.bit_width_impl()
        scale = Qf.rescaling_scale(self.scaling(view), bit_width, signed=cfg.signed,
                                   narrow_range=cfg.narrow_range)
        zp = self.zero_point(view, scale, bit_width)
        y = int_fake_quant(w, scale, zp, bit_width, cfg, self._float_to_int)
        return QuantTensor(self.delay(w, y), scale, zp, bit_width, signed=cfg.signed)


class ActQuantizer(nn.Module):
    """Activation-side quantizer: INT with per-tensor scaling, or NONE."""

    def __init__(self, cfg: QuantConfig):
        super().__init__()
        self.cfg = cfg
        self.quant_type = QuantType(cfg.quant_type)
        self.disable_quant = False  # calibration mode: collect, pass the float value
        if self.quant_type == QuantType.NONE:
            return
        _check_int(self.quant_type)
        if cfg.scaling_per_output_channel:
            raise NotImplementedError("per-channel activation scaling is not ported yet")
        self._float_to_int = R.float_to_int_fn(cfg.float_to_int)
        self.bit_width_impl = BitWidth(cfg)
        self.scaling = build_scaling(cfg, ())
        self.zero_point = ZeroPoint(cfg)
        self.delay = QuantDelay(cfg.quant_delay_steps)

    def static_int_params(self):
        """``(scale, bit_width)`` when this INT quantizer's grid does not
        depend on the data (CONST or learned PARAMETER scale, zero
        zero-point, no delay); gradients flow through the scale into the
        learned parameter. ``"identity"`` for a NONE quantizer, and None when
        the quantizer carries per-call state (runtime statistics, the
        two-phase collection, calibration mode): the caller must then call
        the quantizer. Lets QuantLSTM fuse its per-step quantizer chain."""
        if self.quant_type == QuantType.NONE:
            return "identity"
        cfg = self.cfg
        if self.disable_quant or cfg.quant_delay_steps > 0:
            return None
        if not isinstance(self.scaling, (ConstScaling, ParameterScaling)):
            return None
        bit_width = self.bit_width_impl()
        scale = Qf.rescaling_scale(self.scaling(None), bit_width, signed=cfg.signed,
                                   narrow_range=cfg.narrow_range)
        return scale, bit_width

    def forward(self, x: torch.Tensor) -> QuantTensor:
        cfg = self.cfg
        if self.quant_type == QuantType.NONE:
            return QuantTensor(x, training=self.training)
        view = stats_view(x)
        if self.disable_quant:
            # calibration mode: the scaling statistics advance, the float
            # value passes unchanged
            self.scaling(view)
            return QuantTensor(x, training=self.training)
        bit_width = self.bit_width_impl()
        scale = Qf.rescaling_scale(self.scaling(view), bit_width, signed=cfg.signed,
                                   narrow_range=cfg.narrow_range)
        zp = self.zero_point(view, scale, bit_width)
        y = int_fake_quant(x, scale, zp, bit_width, cfg, self._float_to_int)
        return QuantTensor(self.delay(x, y), scale, zp, bit_width,
                           signed=cfg.signed, training=self.training)


class BiasQuantizer(nn.Module):
    """Bias quantizer: NONE only (the bnn_pynq models have no bias)."""

    def __init__(self, cfg: QuantConfig):
        super().__init__()
        self.cfg = cfg
        self.quant_type = QuantType(cfg.quant_type)
        if self.quant_type != QuantType.NONE:
            raise NotImplementedError("bias quantization is not ported yet")

    def forward(self, b: torch.Tensor, input_scale=None,
                input_bit_width=None) -> QuantTensor:
        return QuantTensor(b)


def convert_runtime_stats_to_parameter(root: nn.Module) -> int:
    """Replace every two-phase scaler in the tree by a learned
    ``ParameterScaling`` seeded from what it collected: its learned value
    once the handoff happened (counter past ``collect_stats_steps``), its
    statistics buffer before. The owning quantizer's config switches to
    PARAMETER scaling. Returns the count converted; a quantizer shared by
    several layers is converted once."""
    count = 0
    for mod in root.modules():
        scaling = getattr(mod, "scaling", None)
        cfg = getattr(mod, "cfg", None)
        if cfg is None or not isinstance(scaling, ParameterFromRuntimeStatsScaling):
            continue
        post = int(scaling.counter) > scaling.steps
        with torch.no_grad():
            seed = scaling.rc.forward(scaling.value) if post else scaling.buffer
            new_cfg = cfg.let(scaling_impl=ScalingImplType.PARAMETER)
            mod.cfg = new_cfg
            mod.scaling = ParameterScaling(new_cfg, seed, scaling.bshape)
        count += 1
    return count
