"""Quant pooling (port of ``brevitas_tpu/nn/pool.py``; ported: the max
pools).

Max pooling is monotone in each element, so a quantized input's grid passes
through: with ``return_quant_tensor`` the output carries the input's scale,
zero point and bit width, and the next layer sees them. Padding is
``'VALID'``, ``'SAME'`` (XLA's: the high side takes the odd unit) or explicit
``(lo, hi)`` pairs, and pads with -inf as ``lax.reduce_window`` does; the
padding goes to ``F.pad`` first (``max_pool`` limits its own to half the
window).

Left out: the truncating ``QuantAvgPool2d`` and its adaptive form (slice 7).
"""

import dataclasses

import torch.nn.functional as F
from torch import nn

from brevitas_tpu_torch.nn.conv import _tuple, padding_spec, resolve_pads
from brevitas_tpu_torch.nn.quant_layer import QuantLayerMixin


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
