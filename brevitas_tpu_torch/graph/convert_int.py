"""QAT -> integer-domain serving conversion (port of
``brevitas_tpu/graph/convert_int.py``; ported: the QuantLinear twins, the
dynamic int8 twin, the QuantConv twin, the QuantMultiheadAttention twin and
``convert_integer_inference`` restricted to those layers).

Freeze the trained quantizer state, cache the integer weights and scales,
and serve with the integer GEMM kernels, dequant in the epilogue. With
x_q = x/s_x + zp_x, y = s_x s_w (x_q @ w_q - zp_x * colsum(w_q)), so the
zero-point correction folds into the bias.

The JAX package sends small shapes to XLA's plain path (``_prefer_pallas_gemm``,
the M >= 16 gate and the attention gate, measured on a TPU v5e) and packs
only int4 weights that tile its Pallas kernel (``int4_block_shapes_ok``).
No such gate carries over: on the card every serving call launches the
hand-written kernel.

Convs: torch has no int8 conv on CUDA, and cuDNN's float32 convs miss
integer sums on the H100 (Winograd/FFT). A pointwise conv (kernel 1,
ungrouped, no padding; at stride s it reads every s-th position, so the
input is subsampled first, as ResNet's downsampling shortcuts need) is a
GEMM and runs on ``int8_matmul``; every other conv sums its codes through the port's
patch-matrix conv (``nn.conv.conv_nd``), in float32 where the worst case
``K * 128 * max|w code|`` stays below 2^24 (every partial sum an exact
integer), else in float64 (exact below 2^53). The rule is decided when the
twin is built, from the shapes and the weight bit width.
"""

import itertools
from typing import Optional

import torch
from torch import nn

from brevitas_tpu_torch import config
from brevitas_tpu_torch.graph.base import named_modules, set_module
from brevitas_tpu_torch.kernels import (
    int4_matmul,
    int4_weight_only_matmul,
    int4kv_decode_attention,
    int8_attention_dispatch,
    int8_decode_attention,
    int8_matmul,
    pack_int4_rows,
    unpack_int4_rows,
    update_kv_packed,
)
from brevitas_tpu_torch.nn.attention import QuantMultiheadAttention, apply_rope
from brevitas_tpu_torch.nn.conv import _QuantConvNd, conv_nd, resolve_pads
from brevitas_tpu_torch.nn.linear import QuantLinear
from brevitas_tpu_torch.ops import max_int, min_int
from brevitas_tpu_torch.quant.config import QuantType
from brevitas_tpu_torch.quant_tensor import QuantTensor


def _freeze_act_quant(act_quantizer):
    """(scale, zero_point, lo, hi) of a trained INT activation quantizer —
    after training they no longer depend on the input."""
    if act_quantizer.quant_type != QuantType.INT:
        raise ValueError(f"integer serving supports INT input quantizers, got "
                         f"{act_quantizer.quant_type}")
    if act_quantizer.dynamic:
        raise ValueError("dynamic act quant has no static scale to freeze: use "
                         "DynamicInt8InferenceLinear")
    act_quantizer.eval()
    scaling = act_quantizer.scaling
    # a learned scale is a parameter, a constant or collected one a buffer
    device = next(itertools.chain(scaling.parameters(), scaling.buffers())).device
    qt = act_quantizer(torch.zeros((1, 1), device=device))
    cfg = act_quantizer.cfg
    lo = float(min_int(cfg.signed, cfg.narrow_range, qt.bit_width))
    hi = float(max_int(cfg.signed, cfg.narrow_range, qt.bit_width))
    return qt.scale.detach(), qt.zero_point, lo, hi


def _freeze_output_quant(act_quantizer):
    """Frozen output requant params as floats, or None when no output
    quantizer is set."""
    if act_quantizer is None or act_quantizer.quant_type == QuantType.NONE:
        return None
    s, zp, lo, hi = _freeze_act_quant(act_quantizer)
    return float(s), float(zp), lo, hi


def _apply_output_quant(y: torch.Tensor, frozen) -> torch.Tensor:
    if frozen is None:
        return y
    s, zp, lo, hi = frozen
    q = torch.clamp(torch.round(y / s + zp), lo, hi)
    return (q - zp) * s


def _weight_scale(qw: QuantTensor, out_features: int) -> torch.Tensor:
    """A weight's scale as a float32 vector: one value, or one an output
    channel. Any other scale (groupwise MX weights: one a group, expanded
    to the weight's shape) has no integer twin: ``ValueError``, and
    ``convert_integer_inference`` leaves the layer on its fake-quant path."""
    s = qw.scale.reshape(-1).to(torch.float32)
    if s.numel() not in (1, out_features):
        raise ValueError(f"integer serving needs a per-tensor or per-output-channel weight "
                         f"scale, got {s.numel()} values for {out_features} channels")
    return s


def _val(x):
    """Serving twins consume plain tensors; an upstream quant layer may hand
    over a QuantTensor — take its value."""
    return x.value if isinstance(x, QuantTensor) else x


def _carried_codes(x):
    """(codes_int8, scale, shift) from a CARRIED input grid, or None.

    bnn_pynq-style models give their linears no ``input_quant``: the grid
    arrives as QuantTensor metadata from the preceding activation quantizer.
    The values are exact multiples of the carried scale, so
    ``round(value/scale)`` recovers the codes; unsigned grids re-centre by
    128 into int8 and the shift folds into the bias through the weight
    column sums. Symmetric grids only."""
    if not isinstance(x, QuantTensor) or x.scale is None:
        return None
    signed = bool(x.signed) if x.signed is not None else True
    shift = 0.0 if signed else 128.0
    codes = torch.round(x.value / x.scale) - shift
    codes = torch.clamp(codes, -128.0, 127.0).to(torch.int8)
    return codes, x.scale.to(torch.float32).reshape(()), shift


class Int8InferenceLinear(nn.Module):
    """Serving twin of a trained QuantLinear: cached integer weight (K, N)
    and the integer GEMM kernel.

    Weights of 8 bits go through ``int8_matmul``. Weights of 4 bits or fewer
    (W4A8) are stored packed two per byte (``w_packed``, (K/2, N), and no
    ``w_int``) and go through ``int4_matmul`` when ``config.INT4_PACKED_SERVING``
    is on and K is even. The JAX package packs only shapes that tile its
    Pallas kernel (``int4_block_shapes_ok``) and sends the others to its
    plain int8 GEMM, whose exact int32 accumulator and epilogue order are
    ``int4_matmul``'s; so packing every such weight here gives the same
    output."""

    def __init__(self, qlinear: QuantLinear, act: Optional[str] = None):
        super().__init__()
        with torch.no_grad():
            qw = qlinear.quant_weight()
            bit_width = float(qw.bit_width)
            if bit_width > 8.0:
                raise ValueError("the int8 path needs bit_width <= 8")
            w_scale = _weight_scale(qw, qw.value.shape[0])
            w_int = qw.int().t().contiguous()  # (in, out) int8
            # the column sums come from the codes, before any packing
            colsum = w_int.to(torch.int32).sum(0).to(torch.float32)
            bias = (qlinear.bias.detach().to(torch.float32) if qlinear.bias is not None
                    else torch.zeros(w_int.shape[1], device=w_int.device))
            if (config.INT4_PACKED_SERVING and bit_width <= 4.0
                    and w_int.shape[0] % 2 == 0):
                # the packed bytes are the only weight copy
                self.register_buffer("w_packed", pack_int4_rows(w_int).contiguous())
                self.register_buffer("w_int", None)
            else:
                self.register_buffer("w_packed", None)
                self.register_buffer("w_int", w_int)
            self.register_buffer("w_scale", w_scale)
            self.register_buffer("colsum", colsum)
            if qlinear.input_quant.quant_type == QuantType.NONE:
                # carried-grid mode: the grid arrives with the input
                self.x_scale = None
            else:
                x_scale, x_zp, self.x_lo, self.x_hi = _freeze_act_quant(
                    qlinear.input_quant)
                self.register_buffer("x_scale", x_scale.reshape(()))
                self.x_zp = float(x_zp)
                self.x_signed = qlinear.input_quant.cfg.signed
                # unsigned (uint8) inputs re-centre into int8 by -128; with
                # the zero point this folds into the bias through
                # (x_q - zp) = (x_q - shift) + (shift - zp)
                self.x_shift = 0.0 if self.x_signed else 128.0
                bias = bias + (self.x_shift - self.x_zp) * colsum \
                    * self.x_scale * w_scale
            self.register_buffer("bias", bias)
        self.act = act
        self.output_quant = _freeze_output_quant(getattr(qlinear, "output_quant", None))
        self.out_features = w_int.shape[1]

    def forward(self, x) -> torch.Tensor:
        if self.x_scale is None:
            carried = _carried_codes(x)
            if carried is None:
                # no grid for this input: the dequantized-weight float path
                # keeps the function right
                w = self.w_int if self.w_packed is None else unpack_int4_rows(self.w_packed)
                y = _val(x) @ (w.to(torch.float32) * self.w_scale) + self.bias
                y = torch.clamp_min(y, 0.0) if self.act == "relu" else y
                return _apply_output_quant(y, self.output_quant)
            x_int, x_scale, shift = carried
            bias = self.bias + shift * self.colsum * x_scale * self.w_scale
            x = _val(x)
        else:
            x = _val(x)
            x_scale, bias = self.x_scale, self.bias
            x_int = torch.clamp(torch.round(x / x_scale + self.x_zp), self.x_lo, self.x_hi)
            x_int = (x_int - self.x_shift).to(torch.int8)
        flat = x_int.reshape(-1, x_int.shape[-1])
        if self.w_packed is not None:
            y = int4_matmul(flat, self.w_packed, x_scale, self.w_scale, bias, act=self.act)
        else:
            y = int8_matmul(flat, self.w_int, x_scale, self.w_scale, bias, act=self.act)
        y = y.reshape(*x.shape[:-1], self.out_features)
        return _apply_output_quant(y, self.output_quant)


class WeightOnlyInt4InferenceLinear(nn.Module):
    """w4a16 serving twin: activations stay float, weights are stored as
    split-halves packed int4 and unpacked inside the GEMM kernel."""

    def __init__(self, qlinear: QuantLinear):
        super().__init__()
        if qlinear.input_quant.quant_type != QuantType.NONE:
            raise ValueError("weight-only serving wants NO input quantizer")
        with torch.no_grad():
            qw = qlinear.quant_weight()
            if float(qw.bit_width) > 4.0:
                raise ValueError("the weight-only int4 path needs bit_width <= 4")
            w_scale = _weight_scale(qw, qw.value.shape[0])
            w_int = qw.int().t()  # (in, out)
            k, n = w_int.shape
            if k % 2:
                raise ValueError("in_features must be even to pack int4")
            self.register_buffer("w_packed", pack_int4_rows(w_int).contiguous())
            self.register_buffer("w_scale", w_scale)
            self.register_buffer("bias", qlinear.bias.detach().to(torch.float32)
                                 if qlinear.bias is not None else None)
        self.out_features = n
        self.in_features = k
        self.output_quant = _freeze_output_quant(getattr(qlinear, "output_quant", None))

    def forward(self, x) -> torch.Tensor:
        x = _val(x)
        flat = x.reshape(-1, self.in_features)
        y = int4_weight_only_matmul(flat, self.w_packed, self.w_scale, self.bias)
        y = y.reshape(*x.shape[:-1], self.out_features).to(x.dtype)
        return _apply_output_quant(y, self.output_quant)


class DynamicInt8InferenceLinear(nn.Module):
    """Serving twin of a QuantLinear with a dynamic (per-token or per-tensor)
    INT input quantizer: the layer's own stateless quantizer forms each
    request's scale, the codes ``round(value / scale)`` go through
    ``int8_matmul`` with unit scales and no bias (the float32 of the exact
    int32 accumulator), and the epilogue runs in torch in the JAX package's
    order, ``((acc * x_scale) * w_scale) + bias``, each step rounded: the
    kernel's fused ``acc * (x_scale * w_scale)`` would round differently. A
    dynamic output quantizer is re-applied at every call, any other frozen.
    Signed-symmetric input grids only."""

    def __init__(self, qlinear: QuantLinear):
        super().__init__()
        xq = qlinear.input_quant
        if xq.quant_type != QuantType.INT or not xq.dynamic:
            raise ValueError("DynamicInt8InferenceLinear needs a DYNAMIC INT input quantizer")
        if not xq.cfg.signed:
            raise ValueError("dynamic int8 serving is signed-symmetric only")
        with torch.no_grad():
            qw = qlinear.quant_weight()
            if float(qw.bit_width) > 8.0:
                raise ValueError("the int8 path needs bit_width <= 8")
            w_scale = _weight_scale(qw, qw.value.shape[0])
            w_int = qw.int().t().contiguous()  # (in, out) int8
            self.register_buffer("w_int", w_int)
            self.register_buffer("w_scale", w_scale)
            self.register_buffer("bias", qlinear.bias.detach().to(torch.float32)
                                 if qlinear.bias is not None else None)
            self.register_buffer("unit", torch.ones((), device=w_int.device))
        self.input_quant = xq.eval()
        self.out_features = w_int.shape[1]
        oq = getattr(qlinear, "output_quant", None)
        if oq is not None and oq.quant_type != QuantType.NONE and oq.dynamic:
            self.output_quant = None
            self.dynamic_output_quant = oq.eval()  # stateless, applied at every call
        else:
            self.output_quant = _freeze_output_quant(oq)
            self.dynamic_output_quant = None

    def forward(self, x) -> torch.Tensor:
        x = _val(x)
        qt = self.input_quant(x)
        x_int = torch.round(qt.value / qt.scale).to(torch.int8)
        acc = int8_matmul(x_int.reshape(-1, x_int.shape[-1]), self.w_int, self.unit, self.unit)
        y = acc.reshape(*x.shape[:-1], self.out_features) * qt.scale * self.w_scale
        if self.bias is not None:
            y = y + self.bias
        if self.dynamic_output_quant is not None:
            return self.dynamic_output_quant(y).value
        return _apply_output_quant(y, self.output_quant)


# sums of integers in float32 are exact while every partial sum stays below
# 2^24; an int8 input code is at most 128 in size
FLOAT32_EXACT = 2.0 ** 24
MAX_X_CODE = 128


def conv_acc_dtype(fan_in: int, weight_bit_width: float, narrow_range: bool) -> torch.dtype:
    """The dtype in which a conv's integer codes sum exactly: float32 where
    ``fan_in * 128 * max|w code|`` stays below 2^24, else float64."""
    w_max = max(abs(min_int(True, narrow_range, weight_bit_width)),
                max_int(True, narrow_range, weight_bit_width))
    return torch.float32 if fan_in * MAX_X_CODE * w_max < FLOAT32_EXACT else torch.float64


class Int8InferenceConv(nn.Module):
    """Serving twin of a trained QuantConv1d/2d: cached integer weight
    codes, the conv of the input's codes summed exactly, and the dequant in
    the epilogue, ``(acc + shift * correction) * (x_scale * w_scale) +
    bias`` in the JAX package's order. Pointwise convs run on
    ``int8_matmul`` with unit scales and no bias (its float32 accumulator is
    exact below 2^24), so the epilogue stays the JAX package's; the others
    on the exact conv route (module docstring). Unsigned inputs re-centre
    by 128 into int8; the shift comes back through the weight column sums
    (pointwise) or a batch-1 conv of ones with the input-channel sums of
    the kernel (zero padding changes the sum at the borders). With no
    input quantizer the grid comes with the input (``_carried_codes``); an
    input without one takes the float conv of the dequantized weights."""

    def __init__(self, qconv: _QuantConvNd):
        super().__init__()
        with torch.no_grad():
            qw = qconv.quant_weight()
            bit_width = float(qw.bit_width)
            if bit_width > 8.0:
                raise ValueError("the int8 path needs bit_width <= 8")
            w_int = qw.int()  # (O, C / groups, *kernel) int8
            out_ch = w_int.shape[0]
            self.register_buffer("w_scale", _weight_scale(qw, out_ch))
            self.register_buffer("w_int", w_int)
            self.register_buffer("bias", qconv.bias.detach().to(torch.float32)
                                 if qconv.bias is not None else None)
            if qconv.input_quant.quant_type == QuantType.NONE:
                self.x_scale = None
            else:
                x_scale, x_zp, self.x_lo, self.x_hi = _freeze_act_quant(qconv.input_quant)
                self.register_buffer("x_scale", x_scale.reshape(()))
                self.x_zp = float(x_zp)
                self.x_signed = qconv.input_quant.cfg.signed
                self.x_shift = 0.0 if self.x_signed else 128.0
            self.spatial_dims = qconv.spatial_dims
            self.kernel_size = qconv.kernel_size
            self.stride = qconv.stride
            self.dilation = qconv.dilation
            self.groups = qconv.groups
            self.padding = qconv.padding
            self.pointwise = (all(k == 1 for k in qconv.kernel_size)
                              and qconv.groups == 1
                              and (isinstance(qconv.padding, str)
                                   or all(p == (0, 0) for p in qconv.padding)))
            if self.pointwise:
                w_mat = w_int.reshape(out_ch, -1).t().contiguous()  # (C, O)
                self.register_buffer("w_mat", w_mat)
                self.register_buffer("colsum", w_mat.to(torch.int32).sum(0).to(torch.float32))
                self.register_buffer("unit", torch.ones((), device=w_int.device))
                self.acc_dtype = torch.float32
            else:
                self.acc_dtype = conv_acc_dtype(qconv.reduce_size, bit_width,
                                                qconv.weight_quant.cfg.narrow_range)
                self.register_buffer("w_codes", w_int.to(self.acc_dtype))
                # the kernel summed over its input channels: one channel a group
                self.register_buffer("w_ksum", w_int.to(torch.int32).sum(1, keepdim=True)
                                     .to(torch.float32))
        self.output_quant = _freeze_output_quant(getattr(qconv, "output_quant", None))

    def _channels(self, v: torch.Tensor) -> torch.Tensor:
        """A per-output-channel (O,) value against the (N, O, *spatial) output."""
        return v.reshape(-1, *(1,) * self.spatial_dims)

    def _pads(self, sizes):
        return resolve_pads(self.padding, sizes, self.kernel_size, self.stride, self.dilation)

    def _conv(self, x_int: torch.Tensor) -> torch.Tensor:
        """The float32 accumulator of the conv of int8 codes, exact."""
        if self.pointwise:
            if any(v != 1 for v in self.stride):
                x_int = x_int[(slice(None), slice(None))
                              + tuple(slice(None, None, v) for v in self.stride)]
            n, c = x_int.shape[:2]
            flat = x_int.movedim(1, -1).reshape(-1, c)
            acc = int8_matmul(flat, self.w_mat, self.unit, self.unit)
            return acc.reshape(n, *x_int.shape[2:], -1).movedim(-1, 1)
        acc = conv_nd(x_int.to(self.acc_dtype), self.w_codes, self.stride,
                      self._pads(x_int.shape[2:]), self.dilation, self.groups)
        return acc.to(torch.float32)

    def forward(self, x) -> torch.Tensor:
        if self.x_scale is None:
            carried = _carried_codes(x)
            if carried is None:
                # no grid for this input: the float conv of the dequantized weights
                v = _val(x)
                w = self.w_int.to(torch.float32) * self.w_scale.reshape(
                    -1, *(1,) * (self.w_int.ndim - 1))
                y = conv_nd(v, w, self.stride, self._pads(v.shape[2:]), self.dilation,
                            self.groups)
                if self.bias is not None:
                    y = y + self._channels(self.bias)
                return _apply_output_quant(y, self.output_quant)
            x_int, x_scale, shift = carried
            x = _val(x)
        else:
            x = _val(x)
            x_scale = self.x_scale
            shift = self.x_shift - self.x_zp
            x_int = torch.clamp(torch.round(x / x_scale + self.x_zp), self.x_lo, self.x_hi)
            x_int = (x_int - self.x_shift).to(torch.int8)
        acc = self._conv(x_int)
        if shift != 0.0:
            if self.pointwise:
                # kernel 1: no borders, the correction is one value a channel
                acc = acc + shift * self._channels(self.colsum)
            else:
                ones = torch.ones((1, self.groups, *x.shape[2:]), device=x.device)
                ksum = conv_nd(ones, self.w_ksum, self.stride, self._pads(x.shape[2:]),
                               self.dilation, self.groups)
                acc = acc + shift * ksum
        y = acc * self._channels(x_scale * self.w_scale)
        if self.bias is not None:
            y = y + self._channels(self.bias)
        return _apply_output_quant(y, self.output_quant)


class Int8InferenceAttention(nn.Module):
    """Serving twin of a trained QuantMultiheadAttention: int8 projection
    GEMMs around the int8 attention core (``kernels.int8_attention``), with
    RoPE and grouped-query attention, and decoding against an int8 or an
    int4-packed KV cache. Needs symmetric signed q/k/v quantizers and an
    unsigned probability quantizer with zero zero-point (the layer's
    defaults)."""

    def __init__(self, mha: QuantMultiheadAttention):
        super().__init__()
        self.num_heads = mha.num_heads
        self.head_dim = mha.head_dim
        self.embed_dim = mha.embed_dim
        self.use_rope = mha.use_rope
        self.rope_theta = mha.rope_theta
        # GQA: the caches hold only the KV heads; each kernel reads KV head
        # h // groups for query head h
        self.num_kv_heads = mha.num_kv_heads
        self.kv_groups = self.num_heads // self.num_kv_heads
        self.q_proj = Int8InferenceLinear(mha.q_proj)
        self.k_proj = Int8InferenceLinear(mha.k_proj)
        self.v_proj = Int8InferenceLinear(mha.v_proj)
        self.out_proj = Int8InferenceLinear(mha.out_proj)
        with torch.no_grad():
            for name in ("q", "k", "v"):
                qz = getattr(mha, f"{name}_quant")
                s, zp, lo, hi = _freeze_act_quant(qz)
                if float(zp) != 0.0 or not qz.cfg.signed:
                    raise ValueError("the int8 attention core needs symmetric signed "
                                     "q/k/v quantizers")
                self.register_buffer(f"{name}_scale", s.reshape(()).to(torch.float32))
                setattr(self, f"{name}_lo", lo)
                setattr(self, f"{name}_hi", hi)
            p_s, p_zp, p_lo, p_hi = _freeze_act_quant(mha.probs_quant)
            if p_lo != 0.0 or float(p_zp) != 0.0:
                raise ValueError("the probability quantizer must be unsigned with "
                                 "zero zero-point (softmax output is [0, 1])")
            self.register_buffer("p_scale", p_s.reshape(()).to(torch.float32))
        self.p_levels = int(p_hi)
        # K/V codes of 4 bits or fewer fit a nibble: the decode cache packs
        # two positions per byte under the policy of config.py
        fits_nibble = (self.k_lo >= -8.0 and self.k_hi <= 7.0
                       and self.v_lo >= -8.0 and self.v_hi <= 7.0)
        policy = str(config.INT4_KV_CACHE).lower()
        if policy in ("0", "false", "off"):
            self.kv_int4 = False
        elif policy in ("1", "true", "on"):
            self.kv_int4 = fits_nibble
        else:
            self.kv_int4 = fits_nibble and (
                mha.kv_pack_requested or self.head_dim >= config.INT4_KV_MIN_HEAD_DIM)

    def _to_int8(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """Straight to the integer codes, without the fake-quant round trip."""
        q = torch.round(x / getattr(self, f"{name}_scale"))
        return torch.clamp(q, getattr(self, f"{name}_lo"),
                           getattr(self, f"{name}_hi")).to(torch.int8)

    def _rope(self, y: torch.Tensor, n_heads: int, positions: torch.Tensor) -> torch.Tensor:
        b, t = y.shape[0], y.shape[1]
        return apply_rope(y.reshape(b, t, n_heads, self.head_dim), positions,
                          self.rope_theta).reshape(b, t, n_heads * self.head_dim)

    def _heads(self, y: torch.Tensor, n_heads: int) -> torch.Tensor:
        """(B, T, n*D) -> (B*n, T, D)."""
        b, t = y.shape[0], y.shape[1]
        return y.reshape(b, t, n_heads, self.head_dim).transpose(1, 2) \
            .reshape(b * n_heads, t, self.head_dim)

    def _merge_heads(self, out: torch.Tensor, b: int, t: int) -> torch.Tensor:
        return out.reshape(b, self.num_heads, t, self.head_dim).transpose(1, 2) \
            .reshape(b, t, self.embed_dim)

    def forward(self, x, causal: bool = False) -> torch.Tensor:
        x = _val(x)
        b, t, _ = x.shape
        q_f, k_f = self.q_proj(x), self.k_proj(x)
        if self.use_rope:
            # the codes are codes of the rotated values, as in the fake-quant model
            positions = torch.arange(t, device=x.device)
            q_f = self._rope(q_f, self.num_heads, positions)
            k_f = self._rope(k_f, self.num_kv_heads, positions)
        q = self._heads(self._to_int8(q_f, "q"), self.num_heads)
        k = self._heads(self._to_int8(k_f, "k"), self.num_kv_heads)
        v = self._heads(self._to_int8(self.v_proj(x), "v"), self.num_kv_heads)
        out = int8_attention_dispatch(q, k, v, self.q_scale, self.k_scale, self.v_scale,
                                      self.p_scale, head_dim=self.head_dim,
                                      p_levels=self.p_levels, causal=causal,
                                      kv_groups=self.kv_groups)
        return self.out_proj(self._merge_heads(out, b, t).to(x.dtype))

    # -- incremental decoding ------------------------------------------------
    # The K/V quantizers are frozen per-tensor grids, so caching their codes
    # is exact.

    def init_decode_cache(self, batch: int, max_len: int, dtype=None):
        """(k_cache, v_cache) int8 of shape (B*KVH, max_len, D), or packed
        (B*KVH, l_half, D) with l_half = ceil(max_len / 2), rounded up to a
        multiple of 128 from max_len 256 on: the JAX package's layout, kept
        position for position. ``dtype`` is accepted and ignored."""
        rows = batch * self.num_kv_heads
        if self.kv_int4:
            l_half = -(-max_len // 2)
            if max_len >= 256:
                l_half += (-l_half) % 128
            shape = (rows, l_half, self.head_dim)
        else:
            shape = (rows, max_len, self.head_dim)
        device = self.q_scale.device
        return (torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape, dtype=torch.int8, device=device))

    def decode_step(self, x_t, k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int):
        """One token (B, 1, E) against the cache; writes this step's K/V codes
        at ``pos`` IN PLACE (the JAX package returns new caches; a copy per
        step would cost more than the step). Returns (y_t, k_cache, v_cache)."""
        x_t = _val(x_t)
        b = x_t.shape[0]
        q_f, k_f = self.q_proj(x_t), self.k_proj(x_t)
        if self.use_rope:
            positions = torch.full((1,), pos, device=x_t.device)
            q_f = self._rope(q_f, self.num_heads, positions)
            k_f = self._rope(k_f, self.num_kv_heads, positions)
        q = self._heads(self._to_int8(q_f, "q"), self.num_heads)
        k_t = self._heads(self._to_int8(k_f, "k"), self.num_kv_heads)
        v_t = self._heads(self._to_int8(self.v_proj(x_t), "v"), self.num_kv_heads)
        scales = (self.q_scale, self.k_scale, self.v_scale, self.p_scale)
        if self.kv_int4:
            update_kv_packed(k_cache, k_t, pos)
            update_kv_packed(v_cache, v_t, pos)
            attend = int4kv_decode_attention
        else:
            k_cache[:, pos:pos + 1] = k_t
            v_cache[:, pos:pos + 1] = v_t
            attend = int8_decode_attention
        out = attend(q, k_cache, v_cache, pos, *scales, head_dim=self.head_dim,
                     p_levels=self.p_levels, kv_groups=self.kv_groups)
        return self.out_proj(self._merge_heads(out, b, 1).to(x_t.dtype)), k_cache, v_cache


def convert_integer_inference(model: nn.Module) -> nn.Module:
    """Swap every eligible trained layer for its integer serving twin, in
    place: QuantMultiheadAttention for ``Int8InferenceAttention`` (whose
    projections become integer twins with it); a QuantLinear with a dynamic
    INT input quantizer for ``DynamicInt8InferenceLinear``, for weight-only
    int4 when it has no input quantizer and weights of 4 bits or fewer, else
    ``Int8InferenceLinear`` (frozen input grid, or the carried grid when it
    has no input quantizer; packed weights for W4A8); a QuantConv1d/2d with
    INT weights for ``Int8InferenceConv``. Other layers stay on the
    fake-quant path, and so does a layer whose twin refuses it
    (``ValueError``: groupwise MX weights, a dynamic or missing grid where a
    frozen one is needed, ...). The JAX package's linear twin flattens an
    MX weight's expanded scale and fails on a shape (``TypeError``), which
    its ``except`` does not catch; here the twin refuses it."""
    converted = []
    for path, mod in list(named_modules(model)):
        if any(path.startswith(p + ".") for p in converted):
            continue  # its parent already became a serving twin
        try:
            if isinstance(mod, QuantMultiheadAttention):
                set_module(model, path, Int8InferenceAttention(mod))
                converted.append(path)
            elif (isinstance(mod, _QuantConvNd)
                  and mod.weight_quant.quant_type == QuantType.INT):
                set_module(model, path, Int8InferenceConv(mod))
            elif not (isinstance(mod, QuantLinear)
                      and mod.weight_quant.quant_type == QuantType.INT):
                continue
            elif mod.input_quant.quant_type == QuantType.INT and mod.input_quant.dynamic:
                set_module(model, path, DynamicInt8InferenceLinear(mod))
            elif (mod.input_quant.quant_type == QuantType.NONE
                    and float(mod.quant_weight().bit_width) <= 4.0):
                set_module(model, path, WeightOnlyInt4InferenceLinear(mod))
            else:
                set_module(model, path, Int8InferenceLinear(mod))
        except (ValueError, NotImplementedError):
            continue
    return model
