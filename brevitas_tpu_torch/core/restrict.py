"""Scale-domain restrictions (port of ``brevitas_tpu/core/restrict.py``).

Ported: the FP restriction and the ROUND/CEIL float-to-int maps. The other
members of the enums name what the JAX package supports and raise here until
a later slice ports them.
"""

import enum

import torch

from brevitas_tpu_torch.ops import ceil_ste, round_ste


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
    raise NotImplementedError(f"float_to_int {impl.value} is not ported yet")


def preprocess(restrict: RestrictType, value):
    """Move a raw (linear-domain) init value into the stored domain."""
    if RestrictType(restrict) != RestrictType.FP:
        raise NotImplementedError(f"restriction {restrict} is not ported yet")
    return value


def forward(restrict: RestrictType, value: torch.Tensor,
            float_to_int: FloatToIntImpl = FloatToIntImpl.ROUND) -> torch.Tensor:
    """Map a stored value to its effective (linear-domain) value."""
    if RestrictType(restrict) != RestrictType.FP:
        raise NotImplementedError(f"restriction {restrict} is not ported yet")
    return value
