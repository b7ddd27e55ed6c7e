"""Quantizer modules — the stateful resolution of a QuantConfig (port of
``brevitas_tpu/quant/quantizers.py``).

Ported: CONST and learned PARAMETER bit widths (``BitWidth``); CONST
scaling, learned PARAMETER scaling (``ParameterScaling``), STATS scaling of
weights (``StatsScaling``) and two-phase PARAMETER_FROM_STATS scaling of
activations (``ParameterFromRuntimeStatsScaling``) with its migration to a
learned parameter (``convert_runtime_stats_to_parameter``), and DYNAMIC
scaling (``StatsScaling`` of each call's input, per tensor or, with
``scaling_per_token``, one scale per token); the ZERO,
learned PARAMETER, STATS (of the weight) and two-phase PARAMETER_FROM_STATS
zero points, quantized onto the grid or not (``ZeroPoint``); every
float-to-int rounding, STOCHASTIC_ROUND from a generator the quantizer
holds; quant delay; the INT, BINARY, TERNARY and NONE weight quantizers,
INT per-tensor, per output channel or groupwise (``scaling_per_group``,
the MX INT presets: one scale per run of reduction-axis elements of an
output channel, expanded to the weight's shape), and activation quantizers, INT
per-tensor or per channel, signed or unsigned, with the static grid of an
INT one (``ActQuantizer.static_int_params``); the NONE bias quantizer and
the INT one on the accumulator's scale, its bit width the accumulator's
(``IntBias``) or a constant (``Int8Bias`` .. ``Int32Bias``); the truncating
quantizer of QuantAvgPool2d; and the ``disable_quant`` switch that
calibration mode sets. Configs that need anything else raise
``NotImplementedError``. On the card a per-tensor INT quantizer's
fake-quant is the ``fake_quant`` CUDA kernel where ``int_fake_quant``'s
rule sends it there; BINARY and TERNARY quantizers run the plain torch ops
(the JAX package has no kernel for them).

A per-channel activation quantizer holds one scale per channel, (C,) as
in the JAX package, whose channels-last activations broadcast it as they
are; the port's activations carry their channels on axis 1, so the scale
and the zero point are applied, and carried in the output, as (C, 1, ...,
1).

The JAX package selects a two-phase scaler's or zero point's branch with
``lax.cond``/``where`` on a carried counter so it stays inside one jitted
step; PyTorch runs eagerly, so the port branches in Python on the same
counter, with the same buffer, value and handoff semantics. Train/eval is
``nn.Module.training``.
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
    stochastic_round_ste,
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
    """CONST bit width (a Python float), or a learned PARAMETER one:
    ``round_ste(abs_binary_sign_grad(offset) + min_bit_width)``, a
    one-element tensor whose gradient reaches ``offset``."""

    def __init__(self, cfg: QuantConfig):
        super().__init__()
        self.impl = BitWidthImplType(cfg.bit_width_impl)
        self.const = float(cfg.bit_width)
        if self.impl == BitWidthImplType.PARAMETER:
            if cfg.bit_width < cfg.min_bit_width or cfg.min_bit_width < 2:
                raise ValueError("learned bit-width requires bit_width >= min_bit_width >= 2")
            self.base = float(cfg.min_bit_width)
            self.offset = nn.Parameter(torch.tensor(float(cfg.bit_width - cfg.min_bit_width)))

    @property
    def learned(self) -> bool:
        return self.impl == BitWidthImplType.PARAMETER

    def forward(self):
        if not self.learned:
            return self.const
        return round_ste(abs_binary_sign_grad(self.offset) + self.base)


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
    PARAMETER, STATS of a parameter (``init_stats_input`` given),
    PARAMETER_FROM_STATS collected at run time and DYNAMIC (stateless
    statistics of every call's input)."""
    impl = ScalingImplType(cfg.scaling_impl)
    if impl == ScalingImplType.CONST:
        if cfg.scaling_const is None:
            raise ValueError("CONST scaling requires scaling_const")
        return ConstScaling(cfg, cfg.scaling_const, bshape)
    stats_fn = S.stats_fn(cfg.scaling_stats_op, high_percentile_q=cfg.high_percentile_q,
                          low_percentile_q=cfg.low_percentile_q)
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
    if impl == ScalingImplType.DYNAMIC:
        # nothing to collect, train or checkpoint: the LLM dynamic-quant pattern
        return StatsScaling(cfg, stats_fn, bshape)
    raise NotImplementedError(f"scaling {impl.value} is not ported yet")


class ZeroPoint(nn.Module):
    """The integer-domain zero point for (stats input, scale, bit width):
    ZERO gives 0.0; the others form a linear-domain value ``zp`` and shift
    it to ``zp / scale + min_int`` (``quantize_zero_point`` puts that on
    the grid: rounded and clamped, straight through). PARAMETER learns
    ``zp`` (``abs_binary_sign_grad`` of a parameter, so it never sticks at
    0); STATS takes ``-stats`` of the weight at each call (a negative
    minimum becomes a positive shift); PARAMETER_FROM_STATS collects
    running stats of the activation for ``collect_stats_steps`` training
    steps and then hands the buffer off to the learned ``value``, with the
    counter, buffer and handoff semantics of the two-phase scaler: while
    ``c < steps`` the batch stat is used and folded into the buffer, at
    ``c == steps`` the buffer is copied to ``value``, and eval reads the
    buffer while ``c <= steps`` and ``value`` after."""

    def __init__(self, cfg: QuantConfig, bshape: Tuple[int, ...] = (),
                 runtime: bool = False):
        super().__init__()
        self.impl = ZeroPointImplType(cfg.zero_point_impl)
        self.cfg = cfg
        self.bshape = bshape
        if self.impl == ZeroPointImplType.ZERO:
            return
        self.stats_fn = S.stats_fn(cfg.zero_point_stats_op,
                                   low_percentile_q=cfg.low_percentile_q)
        if self.impl == ZeroPointImplType.PARAMETER:
            self.value = nn.Parameter(torch.zeros(bshape))
        elif self.impl == ZeroPointImplType.PARAMETER_FROM_STATS:
            if not runtime:
                raise ValueError("the two-phase zero point is an activation feature")
            self.steps = int(cfg.collect_stats_steps)
            self.momentum = cfg.scaling_stats_momentum
            self.register_buffer("buffer", torch.zeros(bshape))
            self.value = nn.Parameter(torch.zeros(bshape))
            self.register_buffer("counter", torch.zeros((), dtype=torch.int32))

    def _scale_shift(self, zp_linear: torch.Tensor, scale, bit_width) -> torch.Tensor:
        cfg = self.cfg
        mi = min_int(cfg.signed, cfg.narrow_range, bit_width)
        if cfg.quantize_zero_point:
            return Qf.int_quant_to_int(
                zp_linear, scale, mi, bit_width, signed=cfg.signed,
                narrow_range=cfg.narrow_range,
                clamp_fn=tensor_clamp_ste if cfg.clamp_ste else tensor_clamp)
        return zp_linear / scale + mi

    def _two_phase(self, stats_input: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return torch.where(self.counter <= self.steps, self.buffer, self.value)
        c = int(self.counter)
        if c > self.steps:
            return self.value
        stats = _expand(self.stats_fn(stats_input), self.bshape)
        with torch.no_grad():
            if c < self.steps:
                self.buffer.copy_(stats if c == 0 else _momentum_update(
                    self.buffer, stats, self.momentum, c))
            else:
                self.value.copy_(self.buffer)
            self.counter += 1
        return stats if c < self.steps else self.value

    def forward(self, stats_input, scale, bit_width):
        if self.impl == ZeroPointImplType.ZERO:
            return 0.0
        if self.impl == ZeroPointImplType.PARAMETER:
            zp = abs_binary_sign_grad(self.value)
        elif self.impl == ZeroPointImplType.STATS:
            return self._scale_shift(-_expand(self.stats_fn(stats_input), self.bshape),
                                     scale, bit_width)
        else:
            zp = abs_binary_sign_grad(self._two_phase(stats_input))
        return self._scale_shift(zp, scale, bit_width)


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


def kernel_rule(x: torch.Tensor, scale, zero_point, bit_width, float_to_int) -> bool:
    """``int_fake_quant``'s rule, but for the device: float32, round half to
    even, one-element scale and zero point, a constant bit width."""
    return (x.dtype == torch.float32 and float_to_int is round_ste
            and not torch.is_tensor(bit_width)
            and _one_value(scale, x) and _one_value(zero_point, x))


def int_fake_quant(x: torch.Tensor, scale, zero_point, bit_width, cfg: QuantConfig,
                   float_to_int) -> torch.Tensor:
    """INT fake-quant of ``x`` under ``cfg``. The rule that sends it to the
    fused ``kernels.fake_quant`` (bit for bit the chain, forward and
    gradients): a float32 CUDA tensor, round half to even, a one-element
    scale and zero point (a learned or quantized zero point included: the
    backward kernel sums its gradient), and a constant bit width (the
    kernel's clamp bounds are static numbers; a learned bit width is a
    tensor whose gradient the chain's clamp bounds carry, which the kernel
    would drop). Everything else runs ``core/quant.py``'s chain: per-channel
    scales or zero points, a learned bit width, the other roundings
    (stochastic included), and every CPU tensor, as the JAX package
    computes every quantizer."""
    lo = min_int(cfg.signed, cfg.narrow_range, bit_width)
    hi = max_int(cfg.signed, cfg.narrow_range, bit_width)
    if x.is_cuda and kernel_rule(x, scale, zero_point, bit_width, float_to_int):
        return fake_quant(x, scale, zero_point, lo, hi, ste_clamp=cfg.clamp_ste)
    return Qf.int_quant(x, scale, zero_point, bit_width, signed=cfg.signed,
                        narrow_range=cfg.narrow_range, float_to_int=float_to_int,
                        clamp_fn=tensor_clamp_ste if cfg.clamp_ste else tensor_clamp)


_PORTED_TYPES = (QuantType.INT, QuantType.BINARY, QuantType.TERNARY)


def _check_ported(quant_type: QuantType) -> None:
    if quant_type not in _PORTED_TYPES:
        raise NotImplementedError(f"{quant_type.value} quantization is not ported yet")


class FloatToInt(nn.Module):
    """The float-to-int map of a config. A static one (round, floor, ceil,
    round to zero, DPU round) is a straight-through function; stochastic
    rounding draws uniform [0, 1) noise of the input's shape from a
    ``torch.Generator`` on the input's device, seeded with 0 (as the JAX
    package's default ``nnx.Rngs(stochastic_round=0)``; the two streams
    differ), and rounds ``floor(x + noise)``."""

    def __init__(self, impl: R.FloatToIntImpl):
        super().__init__()
        self.stochastic = R.FloatToIntImpl(impl) == R.FloatToIntImpl.STOCHASTIC_ROUND
        self.fn = None if self.stochastic else R.float_to_int_fn(impl)
        self.generator: Optional[torch.Generator] = None

    def noise(self, x: torch.Tensor) -> torch.Tensor:
        if self.generator is None or self.generator.device != x.device:
            self.generator = torch.Generator(x.device).manual_seed(0)
        return torch.rand(x.shape, generator=self.generator, device=x.device, dtype=x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stochastic:
            return stochastic_round_ste(x, self.noise(x))
        return self.fn(x)


class _FloatToIntMixin:
    @property
    def _float_to_int(self):
        """What ``int_fake_quant`` compares with ``round_ste``: the static
        map itself, or the module that draws the noise."""
        return self.float_to_int if self.float_to_int.stochastic else self.float_to_int.fn


class ParameterQuantizer(_FloatToIntMixin, nn.Module):
    """Weight-side quantizer: INT with per-tensor, per-output-channel or
    groupwise (``scaling_per_group``, MX) scaling, BINARY (``binary_sign(w)
    * scale``), TERNARY, or NONE.
    ``channel_axis`` is the weight's output-channel axis: 0 for the port's
    (out, in) linear weight and for an embedding table's rows (the JAX
    package's (in, out) linear weight has it at 1)."""

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
        _check_ported(self.quant_type)
        self.float_to_int = FloatToInt(cfg.float_to_int)
        self.bit_width_impl = BitWidth(cfg)
        bshape = scaling_broadcast_shape(weight_init.shape, self.per_channel, channel_axis)
        self.scaling = build_scaling(cfg, bshape, init_stats_input=stats_view(
            weight_init, self.per_channel, channel_axis))
        self.zero_point = ZeroPoint(cfg, bshape)
        self.delay = QuantDelay(cfg.quant_delay_steps)
        self.group_scaling = None
        if cfg.scaling_per_group is not None:
            self.group_scaling = self._build_group_scaling(weight_init)

    def _build_group_scaling(self, w: torch.Tensor) -> "StatsScaling":
        """Groupwise (MX) scaling: one statistic per ``scaling_per_group``
        consecutive elements of each output channel's reduction axis."""
        cfg = self.cfg
        if self.quant_type != QuantType.INT:
            raise ValueError("groupwise quant supports INT elements (FLOAT ones wait for "
                             "the FLOAT quantizer)")
        if self.per_channel:
            raise ValueError("scaling_per_group already implies per-output-channel grouping")
        if ZeroPointImplType(cfg.zero_point_impl) != ZeroPointImplType.ZERO:
            raise ValueError("groupwise quant is symmetric-only")
        if ScalingImplType(cfg.scaling_impl) != ScalingImplType.STATS:
            raise ValueError("groupwise scales are weight statistics: use scaling_impl=STATS")
        if self.channel_axis % w.ndim != 0:
            raise ValueError("groupwise quant expects the output channel axis first "
                             "(the port's (out, in, *kernel) weights)")
        size = int(cfg.scaling_per_group)
        red = w.numel() // w.shape[0]
        if red % size != 0:
            raise ValueError(f"reduction size {red} is not divisible by the group size {size}")
        stats_fn = S.stats_fn(cfg.scaling_stats_op, high_percentile_q=cfg.high_percentile_q)
        return StatsScaling(cfg, stats_fn, (w.shape[0], red // size, 1))

    def _groupwise_quant(self, w: torch.Tensor) -> QuantTensor:
        """The groups are runs of ``scaling_per_group`` elements along each
        output channel's reduction axis in the JAX package's element order:
        its HWIO conv kernel reduces over (kh, kw, I), so the port's
        (O, I, kh, kw) weight moves I last first (a linear's (out, in) is
        already in that order). The scale comes back expanded to the
        weight's shape, as in the JAX package."""
        cfg = self.cfg
        size = int(cfg.scaling_per_group)
        wr = torch.movedim(w, 1, -1)
        moved = wr.shape
        blocks = wr.reshape(w.shape[0], -1, size)  # (O, red / G, G)
        bit_width = self.bit_width_impl()
        # a power-of-two scale is 2 to an integer power: exact in float32
        scale = Qf.rescaling_scale(self.group_scaling(blocks.reshape(-1, size)), bit_width,
                                   signed=cfg.signed, narrow_range=cfg.narrow_range,
                                   po2_int_scale=cfg.po2_int_scale)
        y = Qf.int_quant(blocks, scale, 0.0, bit_width, signed=cfg.signed,
                         narrow_range=cfg.narrow_range, float_to_int=self._float_to_int,
                         clamp_fn=tensor_clamp_ste if cfg.clamp_ste else tensor_clamp)
        y = torch.movedim(y.reshape(moved), -1, 1)
        full_scale = torch.movedim(scale.expand(blocks.shape).reshape(moved), -1, 1)
        return QuantTensor(self.delay(w, y), full_scale, 0.0, bit_width, signed=True)

    def forward(self, w: torch.Tensor) -> QuantTensor:
        cfg = self.cfg
        if self.quant_type == QuantType.NONE or self.disable_quant:
            return QuantTensor(w)
        if self.group_scaling is not None:
            return self._groupwise_quant(w)
        view = stats_view(w, self.per_channel, self.channel_axis)
        if self.quant_type == QuantType.BINARY:
            scale = self.scaling(view)
            y, bit_width = Qf.binary_quant(w, scale)
            return QuantTensor(self.delay(w, y), scale, 0.0, bit_width, signed=True)
        if self.quant_type == QuantType.TERNARY:
            scale = self.scaling(view)
            y, bit_width = Qf.ternary_quant(w, scale, cfg.ternary_threshold)
            return QuantTensor(self.delay(w, y), scale, 0.0, bit_width, signed=True)
        bit_width = self.bit_width_impl()
        scale = Qf.rescaling_scale(self.scaling(view), bit_width, signed=cfg.signed,
                                   narrow_range=cfg.narrow_range, po2_int_scale=cfg.po2_int_scale)
        zp = self.zero_point(view, scale, bit_width)
        y = int_fake_quant(w, scale, zp, bit_width, cfg, self._float_to_int)
        return QuantTensor(self.delay(w, y), scale, zp, bit_width, signed=cfg.signed)


class ActQuantizer(_FloatToIntMixin, nn.Module):
    """Activation-side quantizer: INT with per-tensor or per-channel scaling
    (``num_channels`` scales over axis 1 of the input) or, DYNAMIC and
    symmetric, one scale per token (``scaling_per_token``: each position's
    statistic over the last axis, a scale of shape ``x.shape[:-1] + (1,)``),
    BINARY (the input clamped to [-scale, scale], then its sign times the
    scale), TERNARY, or NONE."""

    def __init__(self, cfg: QuantConfig, num_channels: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.quant_type = QuantType(cfg.quant_type)
        self.disable_quant = False  # calibration mode: collect, pass the float value
        self.per_channel = self.per_token = self.dynamic = False
        if self.quant_type == QuantType.NONE:
            return
        _check_ported(self.quant_type)
        self.per_channel = bool(cfg.scaling_per_output_channel)
        if self.per_channel and num_channels is None:
            raise ValueError("per-channel act quant requires num_channels")
        self.dynamic = ScalingImplType(cfg.scaling_impl) == ScalingImplType.DYNAMIC
        self.per_token = bool(cfg.scaling_per_token)
        if self.per_token:
            if not self.dynamic:
                raise ValueError("per-token activation scaling requires scaling_impl=DYNAMIC")
            if self.per_channel:
                raise ValueError("per-token and per-channel scaling are exclusive")
            if ZeroPointImplType(cfg.zero_point_impl) != ZeroPointImplType.ZERO:
                raise ValueError("per-token scaling is symmetric-only")
            self._token_rc = _RestrictClamp(cfg)
            self._token_stats = S.stats_fn(cfg.scaling_stats_op,
                                           high_percentile_q=cfg.high_percentile_q,
                                           low_percentile_q=cfg.low_percentile_q)
        self.float_to_int = FloatToInt(cfg.float_to_int)
        self.bit_width_impl = BitWidth(cfg)
        bshape = (num_channels,) if self.per_channel else ()
        self.scaling = build_scaling(cfg, bshape)
        self.zero_point = ZeroPoint(cfg, bshape, runtime=True)
        self.delay = QuantDelay(cfg.quant_delay_steps)

    def _stats_view(self, x: torch.Tensor) -> torch.Tensor:
        return stats_view(x, self.per_channel, channel_axis=1)

    def _token_threshold(self, x: torch.Tensor) -> torch.Tensor:
        """One threshold per token, (..., 1) against ``x``."""
        t = self._token_stats(x.reshape(-1, x.shape[-1]))
        t = self._token_rc.forward(self._token_rc.preprocess_runtime(t))
        return t.reshape(*x.shape[:-1], 1)

    def _channel_view(self, v, x: torch.Tensor):
        """A per-channel (C,) scale or zero point as (C, 1, ..., 1) against
        ``x``'s axis 1."""
        if not self.per_channel or not torch.is_tensor(v) or v.numel() == 1:
            return v
        return v.reshape(-1, *(1,) * (x.ndim - 2))

    def static_int_params(self):
        """``(scale, bit_width)`` when this INT quantizer's grid does not
        depend on the data (CONST or learned PARAMETER scale, zero
        zero-point, a constant bit width, no delay); gradients flow through
        the scale into the learned parameter. ``"identity"`` for a NONE
        quantizer, and None otherwise: BINARY and TERNARY, per-call state
        (runtime statistics, the two-phase collection, calibration mode), a
        zero point other than ZERO, or a learned bit width (QuantLSTM's
        fused cell takes its bounds from the config's constant width). The
        caller must then call the quantizer. Lets QuantLSTM fuse its
        per-step quantizer chain."""
        if self.quant_type == QuantType.NONE:
            return "identity"
        cfg = self.cfg
        if (self.quant_type != QuantType.INT or self.disable_quant or self.per_channel
                or cfg.quant_delay_steps > 0 or self.bit_width_impl.learned
                or ZeroPointImplType(cfg.zero_point_impl) != ZeroPointImplType.ZERO):
            return None
        if not isinstance(self.scaling, (ConstScaling, ParameterScaling)):
            return None
        bit_width = self.bit_width_impl()
        scale = Qf.rescaling_scale(self.scaling(None), bit_width, signed=cfg.signed,
                                   narrow_range=cfg.narrow_range, po2_int_scale=cfg.po2_int_scale)
        return scale, bit_width

    def _int_scale(self, view: torch.Tensor, bit_width):
        cfg = self.cfg
        return Qf.rescaling_scale(self.scaling(view), bit_width, signed=cfg.signed,
                                  narrow_range=cfg.narrow_range, po2_int_scale=cfg.po2_int_scale)

    def _int_scale_of(self, x: torch.Tensor, view: torch.Tensor, bit_width):
        if not self.per_token:
            return self._int_scale(view, bit_width)
        cfg = self.cfg
        return Qf.rescaling_scale(self._token_threshold(x), bit_width, signed=cfg.signed,
                                  narrow_range=cfg.narrow_range, po2_int_scale=cfg.po2_int_scale)

    def forward(self, x: torch.Tensor) -> QuantTensor:
        cfg = self.cfg
        if self.quant_type == QuantType.NONE:
            return QuantTensor(x, training=self.training)
        if self.disable_quant and self.dynamic:
            return QuantTensor(x, training=self.training)  # stateless: nothing to collect
        view = self._stats_view(x)
        if self.disable_quant:
            # calibration mode: the scaling and zero-point statistics
            # advance, the float value passes unchanged
            if self.quant_type == QuantType.INT:
                bit_width = self.bit_width_impl()
                self.zero_point(view, self._int_scale(view, bit_width), bit_width)
            else:
                self.scaling(view)
            return QuantTensor(x, training=self.training)
        if self.quant_type in (QuantType.BINARY, QuantType.TERNARY):
            scale = self._channel_view(self.scaling(view), x)
            if self.quant_type == QuantType.BINARY:
                y, bit_width = Qf.clamped_binary_quant(x, scale)
            else:
                y, bit_width = Qf.ternary_quant(x, scale, cfg.ternary_threshold)
            return QuantTensor(self.delay(x, y), scale, 0.0, bit_width, signed=True,
                               training=self.training)
        bit_width = self.bit_width_impl()
        scale = self._int_scale_of(x, view, bit_width)
        zp = self.zero_point(view, scale, bit_width)
        scale, zp = self._channel_view(scale, x), self._channel_view(zp, x)
        y = int_fake_quant(x, scale, zp, bit_width, cfg, self._float_to_int)
        return QuantTensor(self.delay(x, y), scale, zp, bit_width,
                           signed=cfg.signed, training=self.training)


class BiasQuantizer(nn.Module):
    """Bias quantizer: NONE, or INT on the accumulator's scale, the layer's
    input scale times its weight scale (``requires_input_scale``), its bit
    width the accumulator's (``requires_input_bit_width``) or the config's
    constant one (``Int32Bias``: a 32-bit grid, the clamp bounds -2^31 and
    2^31 in float32). A per-tensor scale goes to ``fake_quant`` on the card
    by ``int_fake_quant``'s rule, the bit width being a number either way;
    a per-channel one takes the chain. A scale of the bias's own statistics
    is not ported."""

    def __init__(self, cfg: QuantConfig):
        super().__init__()
        self.cfg = cfg
        self.quant_type = QuantType(cfg.quant_type)
        self.disable_quant = False
        if self.quant_type == QuantType.NONE:
            return
        if self.quant_type != QuantType.INT:
            raise NotImplementedError(f"{self.quant_type.value} bias quantization is not "
                                      "ported yet")
        if not cfg.requires_input_scale:
            raise NotImplementedError("a bias scale from the bias's own statistics is not "
                                      "ported yet")
        self.bit_width_impl = None if cfg.requires_input_bit_width else BitWidth(cfg)
        self._float_to_int = R.float_to_int_fn(cfg.float_to_int)

    def forward(self, b: torch.Tensor, input_scale=None,
                input_bit_width=None) -> QuantTensor:
        cfg = self.cfg
        if self.quant_type == QuantType.NONE or self.disable_quant:
            return QuantTensor(b)
        if self.bit_width_impl is not None:
            input_bit_width = self.bit_width_impl()
        elif input_bit_width is None:
            raise ValueError("the bias quantizer needs the accumulator bit width")
        if input_scale is None:
            raise ValueError("the bias quantizer needs the accumulator scale "
                             "(input scale x weight scale)")
        # a 1-D bias takes a per-channel accumulator scale flattened
        scale = input_scale.reshape(-1) if b.ndim == 1 and input_scale.ndim > 1 \
            else input_scale
        y = int_fake_quant(b, scale, 0.0, input_bit_width, cfg, self._float_to_int)
        return QuantTensor(y, scale, 0.0, input_bit_width, signed=cfg.signed)


class TruncQuantizer(nn.Module):
    """Accumulator truncation (QuantAvgPool2d after its window sum): the
    input's codes lose the low bits that take its bit width down to the
    configured one; the scale stays."""

    def __init__(self, cfg: QuantConfig):
        super().__init__()
        self.cfg = cfg
        self._float_to_int = R.float_to_int_fn(cfg.float_to_int)
        self.bit_width_impl = BitWidth(cfg)

    def forward(self, qt: QuantTensor) -> QuantTensor:
        out_bw = self.bit_width_impl()
        y = Qf.trunc_int_quant(qt.value, qt.scale, qt.zero_point, qt.bit_width, out_bw,
                               float_to_int=self._float_to_int)
        return QuantTensor(y, qt.scale, qt.zero_point, out_bw, signed=qt.signed,
                           training=qt.training)


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
