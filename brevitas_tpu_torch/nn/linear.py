"""QuantLinear (port of ``brevitas_tpu/nn/linear.py``).

The weight is stored the torch way, (out_features, in_features); the JAX
package stores (in, out). ``interop.jax_state`` transposes across. With
``compute_dtype`` set, the product takes bf16-rounded operands and returns
float32 (``compute_dtype_matmul``).
"""

from typing import Optional

import torch

from brevitas_tpu_torch.nn.quant_layer import QuantWBIOL
from brevitas_tpu_torch.quant.config import QuantConfig
from brevitas_tpu_torch.quant.presets import Int8WeightPerTensorFloat


class _ComputeDtypeMatmul(torch.autograd.Function):
    """``a @ b`` of the operands rounded to ``dtype``, with a float32 result,
    as ``jnp.dot(a.astype(dtype), b.astype(dtype),
    preferred_element_type=float32)`` computes it. The product of two bf16
    values is exact in float32, so the forward is a float32 product of the
    rounded operands (exact for integer codes while the sums stay below
    2^24). The backward is JAX's transpose of that dot: each operand's
    gradient is the float32 product of the unrounded upstream gradient with
    the other rounded operand, rounded to ``dtype`` and back to the
    operand's own dtype. Autograd of a bf16 ``torch.matmul`` would round the
    upstream gradient first and return a bf16 product instead."""

    @staticmethod
    def forward(ctx, a, b, dtype):
        ar = a.to(dtype).to(torch.float32)
        br = b.to(dtype).to(torch.float32)
        ctx.save_for_backward(ar, br)
        ctx.dtype = dtype
        ctx.dtypes = (a.dtype, b.dtype)
        return torch.matmul(ar, br)

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.matmul(g, br.t()).to(ctx.dtype).to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            k, n = br.shape
            db = torch.matmul(ar.reshape(-1, k).t(), g.reshape(-1, n))
            db = db.to(ctx.dtype).to(ctx.dtypes[1])
        return da, db, None


def compute_dtype_matmul(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` for ``a`` (..., K) and a matrix ``b`` (K, N), with ``dtype``
    (bf16) operands and a float32 result; see ``_ComputeDtypeMatmul``."""
    if b.ndim != 2:
        raise ValueError(f"compute_dtype_matmul takes a matrix b, got {b.ndim}-D")
    return _ComputeDtypeMatmul.apply(a, b, dtype)


class QuantLinear(QuantWBIOL):

    def __init__(self, in_features: int, out_features: int, *,
                 use_bias: bool = True,
                 weight_quant: Optional[QuantConfig] = Int8WeightPerTensorFloat,
                 bias_quant: Optional[QuantConfig] = None,
                 input_quant: Optional[QuantConfig] = None,
                 output_quant: Optional[QuantConfig] = None,
                 return_quant_tensor: bool = False,
                 dtype: torch.dtype = torch.float32,
                 device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        k = 1.0 / in_features ** 0.5
        # uniform(-k, k), drawn on the CPU so a seed gives the same weights
        # on every device
        w = torch.rand((out_features, in_features), generator=generator,
                       dtype=dtype) * (2 * k) - k
        self.weight = torch.nn.Parameter(w)
        self.bias = (torch.nn.Parameter(torch.zeros(out_features, dtype=dtype))
                     if use_bias else None)
        # the output channel is axis 0 of the (out, in) weight
        self.init_quant(weight_quant, bias_quant, input_quant, output_quant,
                        weight_init=w, return_quant_tensor=return_quant_tensor,
                        channel_axis=0)
        if device is not None:
            self.to(device)

    @property
    def reduce_size(self) -> int:
        return self.in_features

    def forward(self, x):
        def inner(xv, wv, bv):
            if self.compute_dtype is not None:
                y = compute_dtype_matmul(xv, wv.t(), self.compute_dtype)
            else:
                y = torch.matmul(xv, wv.t())
            if bv is not None:
                y = y + bv
            return y.to(xv.dtype)

        return self.forward_quant(x, inner)
