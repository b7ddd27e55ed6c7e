"""Quant pooling (port of ``brevitas_tpu/nn/pool.py``; ported: the max
pools and the truncating average pool).

Max pooling is monotone in each element, so a quantized input's grid passes
through: with ``return_quant_tensor`` the output carries the input's scale,
zero point and bit width, and the next layer sees them. Padding is
``'VALID'``, ``'SAME'`` (XLA's: the high side takes the odd unit) or explicit
``(lo, hi)`` pairs, and pads with -inf as ``lax.reduce_window`` does; the
padding goes to ``F.pad`` first (``max_pool`` limits its own to half the
window).

``QuantAvgPool2d`` keeps integer semantics: the window sum is an accumulator
whose bit width grows by ``ceil(log2(window))``, and a truncating quantizer
floors it back to the output width. The truncation's scale, ``2 ** (acc_bw
- out_bw)``, stands in for the division by the window: a 7 x 7 window
divides by 64, not 49, as in the JAX package. The sum is formed in float64
and rounded once, so the card and a CPU copy agree; the truncation's first
rounding recovers the exact integer sum of the codes. Without a grid (or a
truncating quantizer) the pool returns the plain mean.

Left out: the adaptive average pool (slice 11).
"""

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from brevitas_tpu_torch.nn.conv import _tuple, padding_spec, resolve_pads
from brevitas_tpu_torch.nn.quant_layer import QuantLayerMixin
from brevitas_tpu_torch.quant.config import QuantConfig
from brevitas_tpu_torch.quant.presets import TruncTo8bit
from brevitas_tpu_torch.quant.quantizers import TruncQuantizer
from brevitas_tpu_torch.quant_tensor import QuantTensor


class QuantAvgPool2d(QuantLayerMixin, nn.Module):
    """(N, C, H, W) average pool, VALID, with truncating re-quantization."""

    def __init__(self, kernel_size, stride=None,
                 trunc_quant: Optional[QuantConfig] = TruncTo8bit,
                 return_quant_tensor: bool = False):
        super().__init__()
        self.kernel_size = _tuple(kernel_size, 2)
        self.stride = _tuple(stride, 2) if stride is not None else self.kernel_size
        self.trunc_quant = TruncQuantizer(trunc_quant) if trunc_quant else None
        self.return_quant_tensor = return_quant_tensor
        # whether the last call truncated (a grid reached it): the exporters
        # mirror it, so an exported graph truncates where the model does
        self.last_call_truncated: Optional[bool] = None

    @property
    def _kernel_elems(self) -> int:
        return math.prod(self.kernel_size)

    def forward(self, x):
        qt = self.unpack_input(x)
        v = qt.value
        summed = F.avg_pool2d(v.double(), self.kernel_size, self.stride,
                              divisor_override=1).to(v.dtype)
        elems = self._kernel_elems
        self.last_call_truncated = (qt.scale is not None and qt.bit_width is not None
                                    and self.trunc_quant is not None)
        if self.last_call_truncated:
            acc_bw = qt.bit_width + math.ceil(math.log2(elems))
            acc = QuantTensor(summed, qt.scale, qt.zero_point, acc_bw, signed=qt.signed,
                              training=qt.training)
            return self.pack_output(self.trunc_quant(acc))
        # a divisor on the device: CUDA multiplies by the reciprocal of a
        # Python number
        return self.pack_output(QuantTensor(summed / torch.full_like(summed, elems),
                                            training=qt.training))


class _QuantMaxPoolNd(QuantLayerMixin, nn.Module):

    def __init__(self, spatial_dims: int, kernel_size, stride=None, padding="VALID",
                 return_quant_tensor: bool = False):
        super().__init__()
        n = spatial_dims
        self.spatial_dims = n
        self.kernel_size = _tuple(kernel_size, n)
        self.stride = _tuple(stride, n) if stride is not None else self.kernel_size
        self.padding = padding_spec(padding, n)
        self.return_quant_tensor = return_quant_tensor

    def forward(self, x):
        qt = self.unpack_input(x)
        v = qt.value
        pads = resolve_pads(self.padding, v.shape[2:], self.kernel_size, self.stride,
                            (1,) * self.spatial_dims)
        if any(p != (0, 0) for p in pads):
            v = F.pad(v, [p for lo_hi in reversed(pads) for p in lo_hi], value=float("-inf"))
        pool = F.max_pool1d if self.spatial_dims == 1 else F.max_pool2d
        out = pool(v, self.kernel_size, self.stride)
        return self.pack_output(dataclasses.replace(qt, value=out))


class QuantMaxPool1d(_QuantMaxPoolNd):
    """(N, C, L) inputs."""

    def __init__(self, kernel_size, stride=None, **kw):
        super().__init__(1, kernel_size, stride, **kw)


class QuantMaxPool2d(_QuantMaxPoolNd):
    """(N, C, H, W) inputs."""

    def __init__(self, kernel_size, stride=None, **kw):
        super().__init__(2, kernel_size, stride, **kw)
