"""Predefined quantizer configs (port of ``brevitas_tpu/quant/presets.py``).

Ported: the ones the port's models use, the binary and ternary constants,
the shifted (asymmetric, zero-point) unsigned ones, the learned bit-width
variants, the dynamic int8 activation quantizers, the groupwise INT
weights (MX and float-scaled), the 8-bit fixed-point (power-of-two scale)
weights and activations of the flexml flow, and the biases of a constant
bit width on the accumulator's scale. Compose variants with ``.let(...)``.
"""

from brevitas_tpu_torch.core.restrict import FloatToIntImpl, RestrictType
from brevitas_tpu_torch.core.stats import StatsOp
from brevitas_tpu_torch.quant.config import (
    BitWidthImplType,
    QuantConfig,
    QuantType,
    ScalingImplType,
    ZeroPointImplType,
)

_INT = QuantConfig(quant_type=QuantType.INT, signed=True, narrow_range=False)
_NARROW_INT = _INT.let(narrow_range=True)
_UINT = _INT.let(signed=False)

_MAX_STATS = dict(scaling_impl=ScalingImplType.STATS,
                  scaling_stats_op=StatsOp.MAX, scaling_min_val=1e-10)
_MIN_MAX_STATS = dict(scaling_impl=ScalingImplType.STATS,
                      scaling_stats_op=StatsOp.MIN_MAX, scaling_min_val=1e-10)
_PARAM_FROM_PERCENTILE = dict(
    scaling_impl=ScalingImplType.PARAMETER_FROM_STATS,
    scaling_stats_op=StatsOp.PERCENTILE, high_percentile_q=99.999,
    collect_stats_steps=300, scaling_min_val=1e-10)
_PARAM_FROM_PERCENTILE_INTERVAL = dict(
    scaling_impl=ScalingImplType.PARAMETER_FROM_STATS,
    scaling_stats_op=StatsOp.PERCENTILE_INTERVAL,
    high_percentile_q=99.999, low_percentile_q=0.001,
    collect_stats_steps=300, scaling_min_val=1e-10)

_PO2 = dict(restrict_scaling=RestrictType.POWER_OF_TWO,
            restrict_scaling_float_to_int=FloatToIntImpl.CEIL)

Int8WeightPerTensorFloat = _INT.let(narrow_range=True, bit_width=8, **_MAX_STATS)
Int8WeightPerChannelFloat = Int8WeightPerTensorFloat.let(scaling_per_output_channel=True)
Int4WeightPerTensorFloat = Int8WeightPerTensorFloat.let(bit_width=4)
Int4WeightPerChannelFloat = Int8WeightPerChannelFloat.let(bit_width=4)

# fixed point: the scale is 2 to the ceiling of its log2
Int8WeightPerTensorFixedPoint = Int8WeightPerTensorFloat.let(**_PO2)
Int8WeightPerChannelFixedPoint = Int8WeightPerChannelFloat.let(**_PO2)

# asymmetric unsigned weights: the range from min to max, a zero point from
# the negative minimum, put on the grid
ShiftedUint8WeightPerTensorFloat = _UINT.let(
    bit_width=8, **_MIN_MAX_STATS,
    zero_point_impl=ZeroPointImplType.STATS,
    zero_point_stats_op=StatsOp.MIN, quantize_zero_point=True)
ShiftedUint8WeightPerChannelFloat = ShiftedUint8WeightPerTensorFloat.let(
    scaling_per_output_channel=True)

Int8ActPerTensorFloat = _INT.let(bit_width=8, **_PARAM_FROM_PERCENTILE)
Uint8ActPerTensorFloat = _UINT.let(bit_width=8, **_PARAM_FROM_PERCENTILE)
Int8ActPerTensorFixedPoint = Int8ActPerTensorFloat.let(**_PO2)
Uint8ActPerTensorFixedPoint = Uint8ActPerTensorFloat.let(**_PO2)

# asymmetric unsigned activations: a two-phase scale of the percentile
# interval and a two-phase zero point of the low percentile
ShiftedUint8ActPerTensorFloat = _UINT.let(
    bit_width=8, **_PARAM_FROM_PERCENTILE_INTERVAL,
    zero_point_impl=ZeroPointImplType.PARAMETER_FROM_STATS,
    zero_point_stats_op=StatsOp.PERCENTILE_LOW, quantize_zero_point=True)

# a bias on the accumulator's grid: its scale and bit width come from the
# layer (input scale x weight scale, the accumulator bit width)
IntBias = _INT.let(requires_input_scale=True, requires_input_bit_width=True)
# the accumulator's scale, a constant bit width (quantize()'s default bias)
Int8Bias = IntBias.let(bit_width=8, requires_input_bit_width=False)
Int16Bias = IntBias.let(bit_width=16, requires_input_bit_width=False)
Int32Bias = IntBias.let(bit_width=32, requires_input_bit_width=False)

# accumulator truncation (QuantAvgPool2d): drop low bits by flooring
TruncTo8bit = QuantConfig(quant_type=QuantType.INT, bit_width=8,
                          float_to_int=FloatToIntImpl.FLOOR)

NoneWeightQuant = QuantConfig(quant_type=QuantType.NONE)
NoneActQuant = QuantConfig(quant_type=QuantType.NONE)
NoneBiasQuant = QuantConfig(quant_type=QuantType.NONE)

# binary and ternary, each with a constant scale of 0.1
SignedBinaryWeightPerTensorConst = QuantConfig(
    quant_type=QuantType.BINARY, signed=True, narrow_range=True,
    scaling_impl=ScalingImplType.CONST, scaling_const=0.1)
SignedBinaryActPerTensorConst = SignedBinaryWeightPerTensorConst
SignedTernaryWeightPerTensorConst = QuantConfig(
    quant_type=QuantType.TERNARY, signed=True, narrow_range=True,
    scaling_impl=ScalingImplType.CONST, scaling_const=0.1,
    ternary_threshold=0.5)
SignedTernaryActPerTensorConst = SignedTernaryWeightPerTensorConst

# learned bit widths: 8 bits to start, learned down to min_bit_width (2)
Int8WeightPerTensorFloatLearnedBitWidth = Int8WeightPerTensorFloat.let(
    bit_width_impl=BitWidthImplType.PARAMETER)
Int8ActPerTensorFloatLearnedBitWidth = Int8ActPerTensorFloat.let(
    bit_width_impl=BitWidthImplType.PARAMETER)

# dynamic activation quantizers: stateless scales from each call's input
# (the LLM serving pattern), per tensor or one per token
Int8DynamicActPerTensorFloat = _INT.let(
    bit_width=8, scaling_impl=ScalingImplType.DYNAMIC,
    scaling_stats_op=StatsOp.MAX, scaling_min_val=1e-10)
Int8DynamicActPerTokenFloat = Int8DynamicActPerTensorFloat.let(scaling_per_token=True)

# groupwise weights: one scale per 32 consecutive reduction-axis elements of
# an output channel; OCP MX's INT elements take a power-of-two scale (the
# MX float elements wait for the FLOAT quantizer)
MXInt8Weight = _NARROW_INT.let(bit_width=8, scaling_per_group=32, **_MAX_STATS, **_PO2)
MXInt4Weight = MXInt8Weight.let(bit_width=4)
Int8WeightPerGroupFloat = _NARROW_INT.let(bit_width=8, scaling_per_group=32, **_MAX_STATS)
Int4WeightPerGroupFloat = Int8WeightPerGroupFloat.let(bit_width=4)
