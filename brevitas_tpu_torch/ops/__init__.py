"""Numeric and straight-through-estimator primitives (port of
``brevitas_tpu/ops``)."""

from brevitas_tpu_torch.ops.numeric import (
    MASKED_SCORE,
    binary_sign,
    causal_mask,
    dpu_round,
    max_int,
    min_int,
    round_to_zero,
    sigmoid_f64,
    softmax,
    tanh_f64,
    tensor_clamp,
)
from brevitas_tpu_torch.ops.ste import (
    abs_binary_sign_grad,
    binary_sign_ste,
    ceil_ste,
    dpu_round_ste,
    floor_ste,
    round_ste,
    round_to_zero_ste,
    scalar_clamp_min_ste,
    stochastic_round_ste,
    tensor_clamp_ste,
    ternary_sign_ste,
)

__all__ = ["MASKED_SCORE", "binary_sign", "causal_mask", "dpu_round", "max_int", "min_int",
           "round_to_zero", "sigmoid_f64", "softmax", "tanh_f64", "tensor_clamp", "round_ste",
           "ceil_ste", "floor_ste", "round_to_zero_ste", "dpu_round_ste", "binary_sign_ste",
           "ternary_sign_ste", "stochastic_round_ste", "tensor_clamp_ste",
           "scalar_clamp_min_ste", "abs_binary_sign_grad"]
