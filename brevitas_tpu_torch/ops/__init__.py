"""Numeric and straight-through-estimator primitives (port of
``brevitas_tpu/ops``)."""

from brevitas_tpu_torch.ops.numeric import (
    MASKED_SCORE,
    causal_mask,
    max_int,
    min_int,
    sigmoid_f64,
    softmax,
    tanh_f64,
    tensor_clamp,
)
from brevitas_tpu_torch.ops.ste import (
    abs_binary_sign_grad,
    ceil_ste,
    round_ste,
    scalar_clamp_min_ste,
    tensor_clamp_ste,
)

__all__ = ["MASKED_SCORE", "causal_mask", "max_int", "min_int", "sigmoid_f64", "softmax", "tanh_f64",
           "tensor_clamp", "round_ste", "ceil_ste", "tensor_clamp_ste",
           "scalar_clamp_min_ste", "abs_binary_sign_grad"]
