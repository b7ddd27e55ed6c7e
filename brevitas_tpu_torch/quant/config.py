"""Declarative quantizer configuration (port of
``brevitas_tpu/quant/config.py``).

A quantizer is a frozen dataclass of hyperparameters, resolved once at layer
construction into a module (:mod:`brevitas_tpu_torch.quant.quantizers`).
Only the fields the ported quantizers read are carried; the enums keep every
member of the JAX package so configs name the same choices.
"""

import dataclasses
import enum
from typing import Optional

from brevitas_tpu_torch.core.restrict import FloatToIntImpl, RestrictType
from brevitas_tpu_torch.core.stats import DEFAULT_MOMENTUM, StatsOp


class QuantType(str, enum.Enum):
    NONE = "none"
    BINARY = "binary"
    TERNARY = "ternary"
    INT = "int"
    FLOAT = "float"


class BitWidthImplType(str, enum.Enum):
    CONST = "const"
    PARAMETER = "parameter"


class ScalingImplType(str, enum.Enum):
    CONST = "const"
    PARAMETER = "parameter"
    PARAMETER_FROM_STATS = "parameter_from_stats"
    STATS = "stats"
    AFFINE_STATS = "affine_stats"
    HE = "he"
    DYNAMIC = "dynamic"


class ZeroPointImplType(str, enum.Enum):
    ZERO = "zero"
    STATS = "stats"
    PARAMETER_FROM_STATS = "parameter_from_stats"
    PARAMETER = "parameter"


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """One declarative quantizer."""

    quant_type: QuantType = QuantType.INT
    bit_width: float = 8.0
    signed: bool = True
    narrow_range: bool = False
    bit_width_impl: BitWidthImplType = BitWidthImplType.CONST
    min_bit_width: float = 2.0  # the lower bound of a learned bit width
    float_to_int: FloatToIntImpl = FloatToIntImpl.ROUND
    clamp_ste: bool = False  # True: straight-through grads at the clip boundary
    scaling_impl: ScalingImplType = ScalingImplType.STATS
    scaling_stats_op: StatsOp = StatsOp.MAX
    scaling_per_output_channel: bool = False
    # per-token activation scaling: one scale per leading position, reduced
    # over the channel (last) axis; requires scaling_impl=DYNAMIC
    scaling_per_token: bool = False
    # groupwise (microscaling, MX) weights: one scale per
    # ``scaling_per_group`` consecutive reduction-axis elements of each
    # output channel (OCP MX: groups of 32 with a power-of-two scale)
    scaling_per_group: Optional[int] = None
    restrict_scaling: RestrictType = RestrictType.FP
    restrict_scaling_float_to_int: FloatToIntImpl = FloatToIntImpl.ROUND
    scaling_min_val: Optional[float] = None
    scaling_const: Optional[float] = None
    scaling_stats_momentum: Optional[float] = DEFAULT_MOMENTUM
    collect_stats_steps: int = 300
    high_percentile_q: Optional[float] = None
    low_percentile_q: Optional[float] = None
    zero_point_impl: ZeroPointImplType = ZeroPointImplType.ZERO
    quantize_zero_point: bool = False
    zero_point_stats_op: StatsOp = StatsOp.MIN
    ternary_threshold: float = 0.5
    quant_delay_steps: int = 0
    # bias quantizers: the scale (input scale x weight scale) and the bit
    # width (the accumulator's) come from the layer at each call
    requires_input_scale: bool = False
    requires_input_bit_width: bool = False

    def let(self, **overrides) -> "QuantConfig":
        """Functional update (``dataclasses.replace``)."""
        return dataclasses.replace(self, **overrides)

    @property
    def po2_int_scale(self) -> bool:
        """A power-of-two restricted scale divides by 2 ** bits, so that it
        stays a power of two."""
        return RestrictType(self.restrict_scaling) == RestrictType.POWER_OF_TWO
