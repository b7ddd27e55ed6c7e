"""Quant convolutions (port of ``brevitas_tpu/nn/conv.py``).

torch's layout: (N, C, L) and (N, C, H, W) activations, (O, I, K) and (O,
I, KH, KW) weights; the JAX package is channels-last (NHWC activations,
HWIO weights) and ``interop.jax_state`` permutes the carried weights.
Per-channel weight scales group over the output channel, axis 0 here, and
the layer's output scale is (O, 1, ...) so that it broadcasts against the
channel axis of the output.

Padding is ``'SAME'``, ``'VALID'`` or explicit ``(lo, hi)`` pairs, with
XLA's meaning: ``'SAME'`` gives ``ceil(size / stride)`` outputs and puts the
odd unit of padding on the high side.

Every conv is an explicit patch matrix (one strided copy of the input)
times the weight matrix, in float32 at the highest matmul precision (no TF32, whatever the
process-wide setting says; restored after), forward and backward, so each
output is a plain float32 sum of products. cuDNN's algorithms for these
shapes include Winograd and FFT transforms, which on an H100 miss integer
sums by up to 1e-3 in float32: the code-domain branch below needs them
exact, as does the comparison with a CPU copy.

With ``compute_dtype`` set, the conv follows the JAX package's custom VJP
(``_partial_vjp_conv``): the forward is a float32 conv of the operands
rounded to that dtype (exact for products of bf16 values, the sum in
float32); the backward rounds the upstream gradient to the dtype first and
forms both backward convs from the rounded operands, each result rounded
to the dtype once (a bf16 conv with float32 accumulation) and upcast to its
operand's dtype. This is not the linear's rule (``nn.linear``), whose
backward takes the unrounded gradient.

``FloatConv1d`` / ``FloatConv2d`` are float convs (``torch.nn.Conv1d`` /
``Conv2d`` with the JAX package's ``nnx.Conv`` padding rule and the same
patch-matrix conv): the layers of a float model that ``graph.quantize``
turns into quant convs, keeping their padding.

Left out: the transposed convs (slice 11).
"""

import contextlib
import itertools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from brevitas_tpu_torch.nn.quant_layer import QuantWBIOL
from brevitas_tpu_torch.quant.config import QuantConfig
from brevitas_tpu_torch.quant.presets import Int8WeightPerTensorFloat


def _tuple(v, n):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


@contextlib.contextmanager
def full_float32_matmuls():
    """Float32 matmuls at the highest precision (no TF32) inside, the
    caller's setting restored after."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def padding_spec(padding, spatial_dims: int):
    """``'SAME'``, ``'VALID'``, or explicit (lo, hi) pairs, one a spatial
    axis (a number pads both sides)."""
    if isinstance(padding, str):
        if padding.upper() not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r}")
        return padding.upper()
    return tuple((int(p[0]), int(p[1])) if isinstance(p, (tuple, list)) else (int(p), int(p))
                 for p in _tuple(padding, spatial_dims))


def resolve_pads(padding, sizes, kernel_size, stride, dilation):
    """(lo, hi) of each spatial axis for an input of ``sizes``, with XLA's
    meaning: 'SAME' gives ceil(size / stride) outputs, the high side taking
    the odd unit."""
    if padding == "VALID":
        return ((0, 0),) * len(sizes)
    if padding != "SAME":
        return padding
    pads = []
    for n, k, s, d in zip(sizes, kernel_size, stride, dilation):
        out = -(-n // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def _patches(x: torch.Tensor, k, stride, dilation) -> torch.Tensor:
    """The (N, C * prod(k), prod(out)) patch matrix of an (N, C, *spatial)
    input, in ``F.unfold``'s order, by one strided copy."""
    x = x.contiguous()
    spatial = x.shape[2:]
    out = [(n - d * (kk - 1) - 1) // s + 1 for n, kk, s, d in zip(spatial, k, stride, dilation)]
    st = x.stride()
    view = x.as_strided(
        (*x.shape[:2], *k, *out),
        (*st[:2], *(st[2 + i] * dilation[i] for i in range(len(k))),
         *(st[2 + i] * stride[i] for i in range(len(k)))),
        x.storage_offset())
    return view.reshape(x.shape[0], x.shape[1] * math.prod(k), math.prod(out)), out


def _fold(cols: torch.Tensor, shape, k, out, stride, dilation) -> torch.Tensor:
    """The adjoint of ``_patches``: each patch entry added back to the
    input element it came from, one kernel offset at a time (a fixed
    order)."""
    x = cols.new_zeros(shape)
    cols = cols.reshape(*shape[:2], *k, *out)
    for offset in itertools.product(*(range(kk) for kk in k)):
        index = tuple(slice(o * d, o * d + s * (n - 1) + 1, s)
                      for o, d, s, n in zip(offset, dilation, stride, out))
        x[(slice(None), slice(None)) + index] += cols[(slice(None), slice(None)) + offset]
    return x


class _Conv(torch.autograd.Function):
    """A conv of an already padded input as a patch matrix times the
    weight matrix under ``full_float32_matmuls``, forward and backward; with
    ``dtype`` set, the JAX package's mixed-precision rule (see the module
    docstring)."""

    @staticmethod
    def forward(ctx, x, w, stride, dilation, groups, dtype):
        if dtype is not None:
            x_in = x.to(dtype).to(torch.float32)
            w_in = w.to(dtype).to(torch.float32)
        else:
            x_in, w_in = x, w
        n, o, g = x.shape[0], w.shape[0], groups
        k = tuple(w.shape[2:])
        cols, out = _patches(x_in, k, stride, dilation)
        cols = cols.reshape(n, g, cols.shape[1] // g, cols.shape[2])
        w_mat = w_in.reshape(g, o // g, -1)
        with full_float32_matmuls():
            y = torch.matmul(w_mat, cols).reshape(n, o, *out)
        ctx.save_for_backward(cols, w_mat)
        ctx.conf = (k, out, stride, dilation, dtype, x.shape, w.shape, (x.dtype, w.dtype))
        return y

    @staticmethod
    def backward(ctx, gy):
        cols, w_mat = ctx.saved_tensors
        k, out, stride, dilation, dtype, x_shape, w_shape, dtypes = ctx.conf
        n, g = cols.shape[:2]
        if dtype is not None:
            gy = gy.to(dtype).to(torch.float32)
        gy = gy.reshape(n, g, w_mat.shape[1], -1)
        dx = dw = None
        with full_float32_matmuls():
            if ctx.needs_input_grad[0]:
                dx = _fold(torch.matmul(w_mat.transpose(1, 2), gy), x_shape, k, out, stride,
                           dilation)
            if ctx.needs_input_grad[1]:
                dw = torch.matmul(gy, cols.transpose(2, 3)).sum(0).reshape(w_shape)
        # each result rounded to the compute dtype once, then to its operand's
        dx, dw = (None if v is None else v.to(dtype or t).to(t)
                  for v, t in zip((dx, dw), dtypes))
        return dx, dw, None, None, None, None


def conv_nd(x: torch.Tensor, w: torch.Tensor, stride, padding, dilation, groups: int = 1,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A conv of (N, C, *spatial) ``x`` with (O, C / groups, *kernel) ``w``
    in full float32, ``padding`` as (lo, hi) pairs (XLA's explicit padding,
    negative pads included, by ``F.pad``), ``dtype`` the operand dtype (None:
    float32)."""
    if any(p != (0, 0) for p in padding):
        x = F.pad(x, [p for lo_hi in reversed(padding) for p in lo_hi])
    return _Conv.apply(x, w, tuple(stride), tuple(dilation), groups, dtype)


class _QuantConvNd(QuantWBIOL):
    """Shared N-d conv machinery."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int, kernel_size, *,
                 stride=1, padding="SAME", dilation=1, groups: int = 1,
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
        if in_channels % groups or out_channels % groups:
            raise ValueError(f"groups {groups} must divide {in_channels} and {out_channels}")
        self.spatial_dims = spatial_dims
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _tuple(kernel_size, spatial_dims)
        self.stride = _tuple(stride, spatial_dims)
        self.dilation = _tuple(dilation, spatial_dims)
        self.groups = groups
        self.padding = padding_spec(padding, spatial_dims)
        fan_in = math.prod(self.kernel_size) * in_channels // groups
        k = 1.0 / fan_in ** 0.5
        # uniform(-k, k), drawn on the CPU so a seed gives the same weights
        # on every device
        wshape = (out_channels, in_channels // groups, *self.kernel_size)
        w = torch.rand(wshape, generator=generator, dtype=dtype) * (2 * k) - k
        self.weight = torch.nn.Parameter(w)
        self.bias = (torch.nn.Parameter(torch.zeros(out_channels, dtype=dtype))
                     if use_bias else None)
        self._fan_in = fan_in
        # per-channel scaling groups over the output channel: axis 0 of OI...
        self.init_quant(weight_quant, bias_quant, input_quant, output_quant,
                        weight_init=w, return_quant_tensor=return_quant_tensor,
                        channel_axis=0)
        if device is not None:
            self.to(device)

    @property
    def reduce_size(self) -> int:
        return self._fan_in

    @property
    def keeps_channels(self) -> bool:
        return self.groups == self.in_channels == self.out_channels

    def output_channel_view(self, v: torch.Tensor) -> torch.Tensor:
        """A per-output-channel value as (O, 1, ...): the channel axis of
        the (N, O, *spatial) output."""
        return v.reshape(-1, *(1,) * self.spatial_dims)

    def pads(self, sizes):
        """(lo, hi) padding of each spatial axis for an input of ``sizes``."""
        return resolve_pads(self.padding, sizes, self.kernel_size, self.stride, self.dilation)

    def forward(self, x):
        def inner(xv, wv, bv):
            y = conv_nd(xv, wv, self.stride, self.pads(xv.shape[2:]), self.dilation,
                        self.groups, self.compute_dtype)
            if bv is not None:
                y = y + self.output_channel_view(bv)
            return y.to(xv.dtype)

        return self.forward_quant(x, inner)


class QuantConv1d(_QuantConvNd):
    """(N, C, L) inputs."""

    def __init__(self, in_channels, out_channels, kernel_size, **kw):
        super().__init__(1, in_channels, out_channels, kernel_size, **kw)


class QuantConv2d(_QuantConvNd):
    """(N, C, H, W) inputs."""

    def __init__(self, in_channels, out_channels, kernel_size, **kw):
        super().__init__(2, in_channels, out_channels, kernel_size, **kw)


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator] = None):
    """flax's default kernel init: a normal truncated at two standard
    deviations, scaled to variance ``1 / fan_in``."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                           generator=generator)


class _FloatConvMixin:
    """A float conv with XLA's padding ('SAME', 'VALID' or (lo, hi) pairs)
    through ``conv_nd``; flax's init (``lecun_normal_`` kernel, zero
    bias)."""

    def _setup(self, spatial_dims, padding, generator):
        self.spatial_dims = spatial_dims
        self.xla_padding = padding_spec(padding, spatial_dims)
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def pads(self, sizes):
        return resolve_pads(self.xla_padding, sizes, self.kernel_size, self.stride,
                            self.dilation)

    def forward(self, x):
        y = conv_nd(x, self.weight, self.stride, self.pads(x.shape[2:]), self.dilation,
                    self.groups)
        if self.bias is not None:
            y = y + self.bias.reshape(-1, *(1,) * self.spatial_dims)
        return y


class FloatConv1d(_FloatConvMixin, torch.nn.Conv1d):
    """(N, C, L) inputs."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding="SAME",
                 dilation=1, groups=1, bias=True, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         dilation=dilation, groups=groups, bias=bias)
        self._setup(1, padding, generator)


class FloatConv2d(_FloatConvMixin, torch.nn.Conv2d):
    """(N, C, H, W) inputs."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding="SAME",
                 dilation=1, groups=1, bias=True, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         dilation=dilation, groups=groups, bias=bias)
        self._setup(2, padding, generator)


class QuantConvTranspose1d:
    def __init__(self, *args, **kw):
        raise NotImplementedError("transposed convs are not ported yet (slice 11)")


class QuantConvTranspose2d(QuantConvTranspose1d):
    pass
