"""Scale-domain restrictions (port of ``brevitas_tpu/core/restrict.py``).

A restriction is a pair of maps: ``preprocess`` moves a raw (linear-domain)
init value into the stored domain once, ``forward`` maps the stored value to
its effective value at every call. FP stores the value itself; LOG_FP and
POWER_OF_TWO store its log2 and give ``2 ** value`` and ``2 ** f2i(value)``,
so a learned power-of-two scale trains in log2 space through the
float-to-int map's straight-through gradient.

Ported: FP, LOG_FP and POWER_OF_TWO, and the ROUND/CEIL/FLOOR float-to-int
maps.
The INT restriction and the other maps raise until a later slice ports them.
"""

import enum
import math

import torch

from brevitas_tpu_torch.ops import ceil_ste, floor_ste, round_ste


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


def float_to_int_fn(impl: FloatToIntImpl):
    impl = FloatToIntImpl(impl)
    if impl == FloatToIntImpl.ROUND:
        return round_ste
    if impl == FloatToIntImpl.CEIL:
        return ceil_ste
    if impl == FloatToIntImpl.FLOOR:
        return floor_ste
    raise NotImplementedError(f"float_to_int {impl.value} is not ported yet")


def _check_ported(restrict: RestrictType) -> RestrictType:
    restrict = RestrictType(restrict)
    if restrict == RestrictType.INT:
        raise NotImplementedError("the INT restriction is not ported yet")
    return restrict


def preprocess(restrict: RestrictType, value):
    """Move a raw (linear-domain) init value into the stored domain: log2
    for LOG_FP and POWER_OF_TWO (``math.log2`` of a number, ``torch.log2``
    of a tensor, which is differentiable)."""
    if _check_ported(restrict) == RestrictType.FP:
        return value
    if isinstance(value, (float, int)):
        return math.log2(value)
    return torch.log2(value)


def forward(restrict: RestrictType, value: torch.Tensor,
            float_to_int: FloatToIntImpl = FloatToIntImpl.ROUND) -> torch.Tensor:
    """Map a stored value to its effective (linear-domain) value."""
    restrict = _check_ported(restrict)
    if restrict == RestrictType.FP:
        return value
    if restrict == RestrictType.LOG_FP:
        # formed in float64 and rounded once: torch's float32 pow gives other
        # last bits on the card than on the CPU
        return torch.exp2(value.double()).to(value.dtype)
    return 2.0 ** float_to_int_fn(float_to_int)(value)
