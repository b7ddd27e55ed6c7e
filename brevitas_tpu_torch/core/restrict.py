"""Scale-domain restrictions (port of ``brevitas_tpu/core/restrict.py``).

A restriction is a pair of maps: ``preprocess`` moves a raw (linear-domain)
init value into the stored domain once, ``forward`` maps the stored value to
its effective value at every call. FP stores the value itself; LOG_FP and
POWER_OF_TWO store its log2 and give ``2 ** value`` and ``2 ** f2i(value)``,
so a learned power-of-two scale trains in log2 space through the
float-to-int map's straight-through gradient. INT stores the value itself
and gives ``f2i(value)``.

Every restriction is ported, with the ROUND, CEIL, FLOOR, ROUND_TO_ZERO and
DPU_ROUND float-to-int maps. STOCHASTIC_ROUND draws noise, so it is no
static map: a quantizer resolves it itself (``quant.quantizers``), and
``float_to_int_fn`` refuses it.
"""

import enum
import math

import torch

from brevitas_tpu_torch.ops import ceil_ste, dpu_round_ste, floor_ste, round_ste, round_to_zero_ste


class RestrictType(str, enum.Enum):
    FP = "fp"
    LOG_FP = "log_fp"
    INT = "int"
    POWER_OF_TWO = "power_of_two"


class FloatToIntImpl(str, enum.Enum):
    ROUND = "round"
    FLOOR = "floor"
    CEIL = "ceil"
    ROUND_TO_ZERO = "round_to_zero"
    DPU_ROUND = "dpu_round"
    STOCHASTIC_ROUND = "stochastic_round"


_STATIC_MAPS = {
    FloatToIntImpl.ROUND: round_ste,
    FloatToIntImpl.FLOOR: floor_ste,
    FloatToIntImpl.CEIL: ceil_ste,
    FloatToIntImpl.ROUND_TO_ZERO: round_to_zero_ste,
    FloatToIntImpl.DPU_ROUND: dpu_round_ste,
}


def float_to_int_fn(impl: FloatToIntImpl):
    """The straight-through map of a static float-to-int choice."""
    impl = FloatToIntImpl(impl)
    if impl not in _STATIC_MAPS:
        raise ValueError(f"float_to_int {impl.value} draws noise: the quantizer resolves it")
    return _STATIC_MAPS[impl]


def preprocess(restrict: RestrictType, value):
    """Move a raw (linear-domain) init value into the stored domain: log2
    for LOG_FP and POWER_OF_TWO (``math.log2`` of a number, ``torch.log2``
    of a tensor, which is differentiable); FP and INT store it as it is."""
    if RestrictType(restrict) in (RestrictType.FP, RestrictType.INT):
        return value
    if isinstance(value, (float, int)):
        return math.log2(value)
    return torch.log2(value)


def forward(restrict: RestrictType, value: torch.Tensor,
            float_to_int: FloatToIntImpl = FloatToIntImpl.ROUND) -> torch.Tensor:
    """Map a stored value to its effective (linear-domain) value."""
    restrict = RestrictType(restrict)
    if restrict == RestrictType.FP:
        return value
    if restrict == RestrictType.INT:
        return float_to_int_fn(float_to_int)(value)
    if restrict == RestrictType.LOG_FP:
        # formed in float64 and rounded once: torch's float32 pow gives other
        # last bits on the card than on the CPU
        return torch.exp2(value.double()).to(value.dtype)
    return 2.0 ** float_to_int_fn(float_to_int)(value)
