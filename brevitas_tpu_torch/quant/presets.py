"""Predefined quantizer configs (port of ``brevitas_tpu/quant/presets.py``).

Ported: the ones the port's models use. Compose variants with
``.let(...)``.
"""

from brevitas_tpu_torch.core.restrict import FloatToIntImpl
from brevitas_tpu_torch.core.stats import StatsOp
from brevitas_tpu_torch.quant.config import QuantConfig, QuantType, ScalingImplType

_INT = QuantConfig(quant_type=QuantType.INT, signed=True, narrow_range=False)
_UINT = _INT.let(signed=False)

_MAX_STATS = dict(scaling_impl=ScalingImplType.STATS,
                  scaling_stats_op=StatsOp.MAX, scaling_min_val=1e-10)
_PARAM_FROM_PERCENTILE = dict(
    scaling_impl=ScalingImplType.PARAMETER_FROM_STATS,
    scaling_stats_op=StatsOp.PERCENTILE, high_percentile_q=99.999,
    collect_stats_steps=300, scaling_min_val=1e-10)

Int8WeightPerTensorFloat = _INT.let(narrow_range=True, bit_width=8, **_MAX_STATS)
Int8WeightPerChannelFloat = Int8WeightPerTensorFloat.let(scaling_per_output_channel=True)
Int4WeightPerTensorFloat = Int8WeightPerTensorFloat.let(bit_width=4)
Int4WeightPerChannelFloat = Int8WeightPerChannelFloat.let(bit_width=4)

Int8ActPerTensorFloat = _INT.let(bit_width=8, **_PARAM_FROM_PERCENTILE)
Uint8ActPerTensorFloat = _UINT.let(bit_width=8, **_PARAM_FROM_PERCENTILE)

# a bias on the accumulator's grid: its scale and bit width come from the
# layer (input scale x weight scale, the accumulator bit width)
IntBias = _INT.let(requires_input_scale=True, requires_input_bit_width=True)

# accumulator truncation (QuantAvgPool2d): drop low bits by flooring
TruncTo8bit = QuantConfig(quant_type=QuantType.INT, bit_width=8,
                          float_to_int=FloatToIntImpl.FLOOR)

NoneWeightQuant = QuantConfig(quant_type=QuantType.NONE)
NoneActQuant = QuantConfig(quant_type=QuantType.NONE)
NoneBiasQuant = QuantConfig(quant_type=QuantType.NONE)
