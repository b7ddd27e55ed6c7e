"""QuantLinear (port of ``brevitas_tpu/nn/linear.py``).

The weight is stored the torch way, (out_features, in_features); the JAX
package stores (in, out). ``interop.jax_state`` transposes across.
"""

from typing import Optional

import torch

from brevitas_tpu_torch.nn.quant_layer import QuantWBIOL
from brevitas_tpu_torch.quant.config import QuantConfig
from brevitas_tpu_torch.quant.presets import Int8WeightPerTensorFloat


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
            y = torch.matmul(xv, wv.t())
            if bv is not None:
                y = y + bv
            return y.to(xv.dtype)

        return self.forward_quant(x, inner)
