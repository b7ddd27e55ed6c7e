"""QCDQ / QONNX / QOp ONNX export (port of ``brevitas_tpu/export/qcdq.py``).

A handler registry maps the port's quant layers to ONNX nodes, and the
model is serialized with the port's protobuf emitter (``onnx_proto``). The
walk is ``model.export_layers()`` where a model declares one, else the
items ``export/derive.py`` derives from one traced forward, else the
children in order, checked against the model by the interpreter.

The bytes are the JAX package's for the same state: the same node order,
initializer names and float32 bits. The port's activations are NCHW, as
the ONNX graph is, so none of JAX's transposes go in: a linear's weight is
stored (out, in) and goes out as JAX's (in, out), a conv's is OIHW already,
and the graph's input shape is the example's. Every number is read from the
live model's quantizers on its own device: on the card each per-tensor
activation quantizer's probe runs the ``fake_quant`` kernel.

Where the port departs from the JAX package (ROADMAP S5):

- a conv with XLA 'SAME' padding exports its pads resolved against the
  size its input had in the export forward (JAX raises; the graph's input
  shape is fixed by the example anyway);
- the truncating average pool's floor epsilon is ``min(1/(2T), 0.5)``:
  JAX's ``1/(2T)`` crosses an integer when ``T < 1``;
- QOp export of a linear or conv without an output quantizer (every layer
  of ``ptq_calibrate``'s models) emits ONNX's integer ops
  (``MatMulInteger``/``ConvInteger``) and a dequantizing Mul; JAX raises;
- only activation quantizers record the grid a truncating pool reads
  (``GraphBuilder.last_qt``); a linear, conv, scale-bias, BatchNorm or
  TensorNorm without an output quantizer clears it, and a truncating pool
  with no activation grid before it raises. JAX records weight grids too.

``QuantConvTranspose1d/2d`` and ``QuantUpsample`` have no layer in the port
yet (slice 11); any layer without a handler raises ``ValueError``.
"""

import itertools
import math
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from brevitas_tpu_torch.export import onnx_proto as P
from brevitas_tpu_torch.models.common import BatchNorm, TensorNorm
from brevitas_tpu_torch.nn.activation import (
    QuantHardTanh,
    QuantIdentity,
    QuantNonLinearActLayer,
    QuantReLU,
)
from brevitas_tpu_torch.nn.conv import QuantConv1d, QuantConv2d, _QuantConvNd, resolve_pads
from brevitas_tpu_torch.nn.linear import QuantLinear
from brevitas_tpu_torch.nn.misc import FoldedBatchNorm, QuantScaleBias
from brevitas_tpu_torch.nn.pool import QuantAvgPool2d, _QuantMaxPoolNd
from brevitas_tpu_torch.nn.rnn import QuantLSTM
from brevitas_tpu_torch.quant.config import QuantType


def _np(v, dtype=None) -> np.ndarray:
    """A tensor (on any device) or a number as a numpy array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype)


def grid(qt, scale=None) -> SimpleNamespace:
    """A quant tensor's metadata as numpy: ``scale`` and ``zero_point``
    arrays, ``bit_width`` a float, ``signed`` a bool (``scale`` replaces
    the scale)."""
    return SimpleNamespace(
        scale=_np(qt.scale if scale is None else scale, np.float32),
        zero_point=_np(qt.zero_point, np.float32),
        bit_width=None if qt.bit_width is None else float(_np(qt.bit_width)),
        signed=bool(qt.signed))


def _device(module) -> torch.device:
    t = next(itertools.chain(module.parameters(), module.buffers()), None)
    return t.device if t is not None else torch.device("cpu")


def _probe(quantizer, shape, module=None):
    """The quantizer's output grid, read by calling it on zeros of
    ``shape`` on its module's device (the grid of an eval-mode quantizer
    does not depend on the data)."""
    return quantizer(torch.zeros(shape, device=_device(module or quantizer)))


class GraphBuilder:
    def __init__(self, style: str):
        assert style in ("qcdq", "qonnx", "qop", "finn")
        self.style = style
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self.counter = 0
        # FINN bookkeeping: the channel count of the current tensor
        # (threshold expansion), and the activation grid on it (the
        # truncating pool's input scale and bit width)
        self.channels: Optional[int] = None
        self.last_qt = None
        # each conv's input spatial size in the export forward ('SAME' pads)
        self.in_sizes: Dict[int, tuple] = {}

    def fresh(self, hint: str) -> str:
        self.counter += 1
        return f"{hint}_{self.counter}"

    def init_tensor(self, hint: str, array: np.ndarray) -> str:
        name = self.fresh(hint)
        self.initializers.append(P.tensor_proto(name, np.asarray(array)))
        return name

    def add(self, op: str, inputs, outputs=None, domain: str = "", **attrs) -> str:
        out = outputs or [self.fresh(op.lower())]
        self.nodes.append(P.node(op, inputs, out, domain=domain, **attrs))
        return out[0]

    # -- quantize-dequantize emission ---------------------------------------

    def qdq(self, x_name: str, qt, hint: str, narrow: bool = False,
            quant_type: QuantType = QuantType.INT, act: bool = True) -> str:
        """Emit the fake-quant of ``qt``'s grid applied to ``x_name``;
        ``act`` records it as the activation grid of the current tensor."""
        if not isinstance(qt, SimpleNamespace):
            qt = grid(qt)
        if quant_type == QuantType.BINARY:
            # QONNX BipolarQuant: y = sign(x) * scale
            if self.style != "qonnx":
                raise ValueError("binary quantizers export via QONNX only "
                                 "(reference FINN flow)")
            s_name = self.init_tensor(hint + "_scale", qt.scale)
            if act:
                self.last_qt = qt
            return self.add("BipolarQuant", [x_name, s_name], domain="onnx.brevitas")
        if act:
            self.last_qt = qt  # the truncating pool reads the live grid
        scale = qt.scale
        if scale.size == 1:
            scale = scale.reshape(())
        elif scale.ndim <= 1:
            scale = scale.reshape(-1)
        zp_f = qt.zero_point
        bw = qt.bit_width
        signed = qt.signed
        if self.style == "qonnx":
            # a multi-dim scale keeps its broadcast shape (per-channel
            # weights: (1, O, 1, 1) and the like)
            s_name = self.init_tensor(hint + "_scale", scale)
            z_name = self.init_tensor(hint + "_zp", zp_f.reshape(scale.shape)
                                      if zp_f.size == scale.size else zp_f)
            b_name = self.init_tensor(hint + "_bw", np.asarray(bw, np.float32))
            return self.add(
                "Quant", [x_name, s_name, z_name, b_name],
                domain="onnx.brevitas", narrow=int(narrow), signed=int(signed),
                rounding_mode="ROUND")
        # QCDQ: QuantizeLinear -> (Clip) -> DequantizeLinear, int8/uint8 storage
        assert bw <= 8.0, "QCDQ export targets <=8-bit quantizers"
        np_dt = np.int8 if signed else np.uint8
        s_name = self.init_tensor(hint + "_scale", scale)
        zp = np.asarray(np.round(zp_f), np_dt)
        zp = zp.reshape(scale.shape) if zp.size == scale.size else \
            np.broadcast_to(zp, scale.shape).astype(np_dt)
        z_name = self.init_tensor(hint + "_zp", zp)
        axis_kw = {}
        if scale.ndim == 1:
            axis_kw["axis"] = 1  # per-output-channel of an (in, out) weight
        q = self.add("QuantizeLinear", [x_name, s_name, z_name], **axis_kw)
        if bw < 8.0 or narrow:
            lo = float(-(2 ** (bw - 1)) + (1 if narrow else 0)) if signed else 0.0
            hi = float(2 ** (bw - 1) - 1) if signed else float(2**bw - 1 - (1 if narrow else 0))
            lo_n = self.init_tensor(hint + "_lo", np.asarray(lo, np_dt))
            hi_n = self.init_tensor(hint + "_hi", np.asarray(hi, np_dt))
            q = self.add("Clip", [q, lo_n, hi_n])
        return self.add("DequantizeLinear", [q, s_name, z_name], **axis_kw)


Handler = Callable[[GraphBuilder, object, str], str]
_HANDLERS: Dict[type, Handler] = {}


def handles(*classes):
    def deco(fn):
        for c in classes:
            _HANDLERS[c] = fn
        return fn

    return deco


def _act_probe_shape(layer, features: int):
    """The probe of a layer's input or output quantizer: (1, features) for a
    linear, (1, C, 8, ...) for a conv or a scale-bias over channels."""
    if isinstance(layer, _QuantConvNd):
        return (1, features) + (8,) * layer.spatial_dims
    if isinstance(layer, QuantScaleBias):
        return (1, features, 8, 8)
    return (1, features)


def _io_qt(layer, quantizer, features: int):
    return _probe(quantizer, _act_probe_shape(layer, features), layer)


def _weight_qt(qw):
    """The weight grid with its scale flat: one value, or one an output
    channel."""
    scale = _np(qw.scale)
    return grid(qw, scale.reshape(-1) if scale.size > 1 else scale.reshape(()))


# -- QOp (QLinearConv / QLinearMatMul) emission ------------------------------
# Each WBIOL layer becomes QuantizeLinear -> QLinear{Conv,MatMul} (integer
# product, int32 bias) -> DequantizeLinear, or, without an output
# quantizer, QuantizeLinear -> {MatMul,Conv}Integer -> dequantizing Mul
# (_qop_integer); other layers keep their QCDQ form. A linear with a bias
# runs as a kernel-1 QLinearConv, because QLinearMatMul carries no bias.


def _qop_validate(layer, name: str) -> None:
    if layer.input_quant.quant_type != QuantType.INT or \
            layer.output_quant.quant_type not in (QuantType.INT, QuantType.NONE):
        raise ValueError(
            f"QOp export of {name} requires an INT input quantizer and an INT or no "
            "output quantizer (reference StdQOpONNXQuantWBIOLHandler.validate)")
    if layer.weight_quant.quant_type != QuantType.INT:
        raise ValueError(f"QOp export of {name} requires INT weight quant")
    for q, what in ((layer.input_quant, "input"), (layer.output_quant, "output")):
        if q.cfg.narrow_range:
            raise ValueError(f"narrow {what} quant not supported by QOp export")


def _qop_int_range(qt, what: str):
    """(lo, hi, bw) of a grid; a grid above 8 bits, which int8/uint8
    storage would saturate, raises."""
    from brevitas_tpu_torch.ops import max_int, min_int

    bw = qt.bit_width
    if bw > 8.0:
        raise ValueError(f"QOp export stores {what} as int8/uint8; "
                         f"{bw:g}-bit quantizers cannot be represented")
    lo = float(min_int(qt.signed, False, bw))
    hi = float(max_int(qt.signed, False, bw))
    return lo, hi, bw


def _qop_quantize_io(b: GraphBuilder, x: str, qt, hint: str):
    """QuantizeLinear (+Clip below 8 bits) of a float tensor; the quantized
    name and the (scale, zero point) initializer names."""
    np_dt = np.int8 if qt.signed else np.uint8
    lo, hi, bw = _qop_int_range(qt, f"{hint} activations")
    s_name = b.init_tensor(hint + "_scale", qt.scale.reshape(()))
    z_name = b.init_tensor(hint + "_zp", np.asarray(np.round(qt.zero_point), np_dt).reshape(()))
    q = b.add("QuantizeLinear", [x, s_name, z_name])
    if bw < 8.0:
        q = b.add("Clip", [q, b.init_tensor(hint + "_lo", np.asarray(lo, np_dt)),
                           b.init_tensor(hint + "_hi", np.asarray(hi, np_dt))])
    return q, s_name, z_name


def _qop_weight_inits(b: GraphBuilder, qw, w_int: np.ndarray):
    """Initializers of the integer weight (output channel on axis 0) and its
    per-tensor or per-channel scale and zero point."""
    _qop_int_range(qw, "weights")
    np_dt = np.int8 if qw.signed else np.uint8
    w_name = b.init_tensor("w_int", w_int.astype(np_dt))
    scale = qw.scale.reshape(-1)
    per_channel = scale.size > 1
    s_name = b.init_tensor("w_scale", scale if per_channel else scale.reshape(()))
    zp = np.asarray(np.round(qw.zero_point), np_dt)
    zp = (np.broadcast_to(zp.reshape(-1), scale.shape).astype(np_dt)
          if per_channel else zp.reshape(()))
    z_name = b.init_tensor("w_zp", zp)
    return w_name, s_name, z_name, scale


def _qop_int_bias(b: GraphBuilder, bias: np.ndarray, in_scale: np.ndarray,
                  w_scale: np.ndarray) -> str:
    """The int32 bias on the scale input_scale * weight_scale."""
    bias_scale = np.asarray(in_scale, np.float64).reshape(()) * \
        np.asarray(w_scale, np.float64).reshape(-1)
    return b.init_tensor(
        "b_int", np.round(np.asarray(bias, np.float64) / bias_scale).astype(np.int32))


def _qop_finish(b: GraphBuilder, y_q: str, out_qt, y_s: str, y_z: str) -> str:
    lo, hi, bw = _qop_int_range(out_qt, "outputs")
    if bw < 8.0:
        np_dt = np.int8 if out_qt.signed else np.uint8
        y_q = b.add("Clip", [y_q, b.init_tensor("y_lo", np.asarray(lo, np_dt)),
                             b.init_tensor("y_hi", np.asarray(hi, np_dt))])
    return b.add("DequantizeLinear", [y_q, y_s, y_z])


def _qop_out_inits(b: GraphBuilder, out_qt):
    y_s = b.init_tensor("y_scale", out_qt.scale.reshape(()))
    y_np_dt = np.int8 if out_qt.signed else np.uint8
    y_z = b.init_tensor("y_zp", np.asarray(np.round(out_qt.zero_point), y_np_dt).reshape(()))
    return y_s, y_z


def _qop_integer(b: GraphBuilder, layer, x: str, w_int: np.ndarray, in_qt, qw_t,
                 conv: bool) -> str:
    """A WBIOL layer without an output quantizer: QuantizeLinear, then ONNX's
    integer product (``MatMulInteger``/``ConvInteger``, an int32
    accumulator), a Cast, the Mul by in_scale * w_scale and the float bias
    on the accumulator grid. The reference's QOp handler refuses such a
    layer (it needs an output grid for QLinear*), and every layer of
    ``ptq_calibrate``'s models is one."""
    qw = grid(qw_t)
    x_q, x_s, x_z = _qop_quantize_io(b, x, grid(in_qt), "x")
    w_name, w_s, w_z, w_scale = _qop_weight_inits(b, qw, w_int)
    if conv:
        acc = b.add("ConvInteger", [x_q, w_name, x_z, w_z],
                    kernel_shape=list(layer.kernel_size), strides=list(layer.stride),
                    dilations=list(layer.dilation), group=layer.groups,
                    pads=_onnx_pads(layer, b))
    else:
        acc = b.add("MatMulInteger", [x_q, w_name, x_z, w_z])
    y = b.add("Cast", [acc], to=P.FLOAT)
    acc_scale = (grid(in_qt).scale.reshape(()) * w_scale).astype(np.float32)
    if acc_scale.size == 1:
        acc_scale = acc_scale.reshape(())
    elif conv:
        acc_scale = acc_scale.reshape((1, -1) + (1,) * layer.spatial_dims)
    y = b.add("Mul", [y, b.init_tensor("acc_scale", acc_scale)])
    if layer.bias is not None:
        bias = _exported_bias(layer, in_qt, qw_t)
        if conv:
            bias = bias.reshape((1, -1) + (1,) * layer.spatial_dims)
        y = b.add("Add", [y, b.init_tensor("bias", bias)])
    b.last_qt = None
    return y


def _qop_linear(b: GraphBuilder, layer: QuantLinear, x: str) -> str:
    _qop_validate(layer, "QuantLinear")
    if layer.output_quant.quant_type == QuantType.NONE:
        in_qt = _io_qt(layer, layer.input_quant, layer.in_features)
        qw_t = layer.quant_weight()
        return _qop_integer(b, layer, x, _np(qw_t.int()).T, in_qt, qw_t, conv=False)
    in_qt = grid(_io_qt(layer, layer.input_quant, layer.in_features))
    out_qt = grid(_io_qt(layer, layer.output_quant, layer.out_features))
    qw_t = layer.quant_weight()
    qw = grid(qw_t)
    w_int = _np(qw_t.int())  # (out, in)
    y_s, y_z = _qop_out_inits(b, out_qt)
    if layer.bias is not None:
        # (N, in) -> (N, in, 1): a kernel-1 QLinearConv carries the bias
        x = b.add("Reshape", [x, b.init_tensor(
            "shape", np.asarray([0, layer.in_features, 1], np.int64))])
        x_q, x_s, x_z = _qop_quantize_io(b, x, in_qt, "x")
        w_name, w_s, w_z, w_scale = _qop_weight_inits(b, qw, w_int[:, :, None])
        bias_name = _qop_int_bias(b, _np(layer.bias), in_qt.scale, w_scale)
        y_q = b.add("QLinearConv",
                    [x_q, x_s, x_z, w_name, w_s, w_z, y_s, y_z, bias_name],
                    kernel_shape=[1], strides=[1], dilations=[1], group=1,
                    pads=[0, 0])
        y = _qop_finish(b, y_q, out_qt, y_s, y_z)
        return b.add("Reshape", [y, b.init_tensor(
            "shape", np.asarray([0, layer.out_features], np.int64))])
    x_q, x_s, x_z = _qop_quantize_io(b, x, in_qt, "x")
    # QLinearMatMul takes (in, out); a per-channel scale lies on axis 1
    w_name, w_s, w_z, _ = _qop_weight_inits(b, qw, w_int.T)
    y_q = b.add("QLinearMatMul", [x_q, x_s, x_z, w_name, w_s, w_z, y_s, y_z])
    return _qop_finish(b, y_q, out_qt, y_s, y_z)


def _qop_conv(b: GraphBuilder, layer, x: str) -> str:
    _qop_validate(layer, type(layer).__name__)
    if layer.output_quant.quant_type == QuantType.NONE:
        in_qt = _io_qt(layer, layer.input_quant, layer.in_channels)
        qw_t = layer.quant_weight()
        return _qop_integer(b, layer, x, _np(qw_t.int()), in_qt, qw_t, conv=True)
    in_qt = grid(_io_qt(layer, layer.input_quant, layer.in_channels))
    out_qt = grid(_io_qt(layer, layer.output_quant, layer.out_channels))
    qw_t = layer.quant_weight()
    qw = grid(qw_t)
    w_int = _np(qw_t.int())  # OIHW
    x_q, x_s, x_z = _qop_quantize_io(b, x, in_qt, "x")
    w_name, w_s, w_z, w_scale = _qop_weight_inits(b, qw, w_int)
    y_s, y_z = _qop_out_inits(b, out_qt)
    inputs = [x_q, x_s, x_z, w_name, w_s, w_z, y_s, y_z]
    if layer.bias is not None:
        inputs.append(_qop_int_bias(b, _np(layer.bias), in_qt.scale, w_scale))
    y_q = b.add("QLinearConv", inputs, kernel_shape=list(layer.kernel_size),
                strides=list(layer.stride), dilations=list(layer.dilation),
                group=layer.groups, pads=_onnx_pads(layer, b))
    return _qop_finish(b, y_q, out_qt, y_s, y_z)


def _exported_bias(layer, in_qt, qw) -> np.ndarray:
    """The bias as the layer's forward quantizes it (``bias_quant(b |
    in_scale * w_scale, acc_bit_width)``). The raw float bias would move
    every output by up to half an accumulator step, enough to flip an
    activation code that sits on a boundary. ``in_qt`` and ``qw`` are the
    port's quant tensors."""
    bias = layer.bias.detach()
    output_scale = None
    output_bit_width = None
    if (in_qt is not None and in_qt.bit_width is not None
            and qw is not None and qw.bit_width is not None):
        output_bit_width = layer.max_acc_bit_width(in_qt.bit_width, qw.bit_width)
    if (in_qt is not None and in_qt.scale is not None
            and qw is not None and qw.scale is not None
            and layer.weight_quant.cfg.scaling_per_group is None):
        w_scale = qw.scale
        if w_scale.ndim > 1:
            w_scale = w_scale.reshape(-1)
        output_scale = w_scale * in_qt.scale
    cfg = layer.bias_quant.cfg
    if cfg.requires_input_scale and output_scale is None:
        return _np(bias, np.float32)  # the forward adds the raw bias then
    qb = layer.bias_quant(bias, input_scale=output_scale, input_bit_width=output_bit_width)
    return _np(qb.value, np.float32)


def _in_quant(b: GraphBuilder, layer, x: str, features: int):
    """The layer's input QDQ: (the port's input quant tensor or None, the
    new tensor name)."""
    if layer.input_quant.quant_type == QuantType.NONE:
        return None, x
    in_qt = _io_qt(layer, layer.input_quant, features)
    x = b.qdq(x, in_qt, "act", narrow=layer.input_quant.cfg.narrow_range,
              quant_type=layer.input_quant.quant_type)
    return in_qt, x


def _out_quant(b: GraphBuilder, layer, y: str, features: int) -> str:
    if layer.output_quant.quant_type == QuantType.NONE:
        b.last_qt = None  # the output is on no activation grid
        return y
    return b.qdq(y, _io_qt(layer, layer.output_quant, features), "act",
                 narrow=layer.output_quant.cfg.narrow_range,
                 quant_type=layer.output_quant.quant_type)


@handles(QuantLinear)
def _export_linear(b: GraphBuilder, layer: QuantLinear, x: str) -> str:
    if b.style == "qop":
        return _qop_linear(b, layer, x)
    in_qt, x = _in_quant(b, layer, x, layer.in_features)
    qw = layer.quant_weight()
    w_name = b.init_tensor("weight", _np(qw.value).T)  # (in, out), as JAX stores it
    if qw.scale is not None and layer.weight_quant.quant_type == QuantType.INT:
        w_name = b.qdq(w_name, _weight_qt(qw), "weight",
                       narrow=layer.weight_quant.cfg.narrow_range, act=False)
    y = b.add("MatMul", [x, w_name])
    if layer.bias is not None:
        b_name = b.init_tensor("bias", _exported_bias(layer, in_qt, qw))
        y = b.add("Add", [y, b_name])
    return _out_quant(b, layer, y, layer.out_features)


@handles(QuantConv1d, QuantConv2d)
def _export_conv(b: GraphBuilder, layer, x: str) -> str:
    if b.style == "qop":
        return _qop_conv(b, layer, x)
    in_qt, x = _in_quant(b, layer, x, layer.in_channels)
    qw = layer.quant_weight()
    w_name = b.init_tensor("weight", _np(qw.value))  # OIHW
    if qw.scale is not None and layer.weight_quant.quant_type == QuantType.INT:
        w_name = _qdq_axis0(b, w_name, _weight_qt(qw), layer.weight_quant.cfg.narrow_range,
                            ndim=qw.value.ndim)
    pads = _onnx_pads(layer, b)
    y = b.add("Conv", [x, w_name] + (
        [b.init_tensor("bias", _exported_bias(layer, in_qt, qw))]
        if layer.bias is not None else []),
        kernel_shape=list(layer.kernel_size), strides=list(layer.stride),
        dilations=list(layer.dilation), group=layer.groups, pads=pads)
    return _out_quant(b, layer, y, layer.out_channels)


def _qdq_axis0(b: GraphBuilder, x_name: str, qt, narrow: bool, axis: int = 0,
               ndim: int = 4) -> str:
    """Weight QDQ with a per-channel axis (0 for OIHW conv kernels, 1 for
    (in, H) LSTM gate blocks); ``ndim`` is the weight's rank."""
    scale = qt.scale.reshape(-1)
    per_channel = scale.size > 1
    if b.style == "qonnx":
        if per_channel:
            # the Quant op's scale broadcasts over ``axis``
            shape = [1] * ndim
            shape[axis] = -1
            qt = SimpleNamespace(**{**vars(qt), "scale": scale.reshape(shape)})
        return b.qdq(x_name, qt, "weight", narrow, act=False)
    np_dt = np.int8 if qt.signed else np.uint8
    s_name = b.init_tensor("w_scale", scale if per_channel else scale.reshape(()))
    zp_f = np.asarray(np.round(qt.zero_point), np_dt)
    zp = (np.broadcast_to(zp_f.reshape(-1), scale.shape).astype(np_dt)
          if per_channel else zp_f.reshape(()))
    z_name = b.init_tensor("w_zp", zp)
    kw = {"axis": axis} if per_channel else {}
    q = b.add("QuantizeLinear", [x_name, s_name, z_name], **kw)
    bw = qt.bit_width
    if bw < 8.0 or narrow:
        if qt.signed:
            lo = -(2 ** (bw - 1)) + (1 if narrow else 0)
            hi = 2 ** (bw - 1) - 1
        else:
            lo = 0
            hi = 2 ** bw - 1 - (1 if narrow else 0)
        q = b.add("Clip", [q, b.init_tensor("lo", np.asarray(lo, np_dt)),
                           b.init_tensor("hi", np.asarray(hi, np_dt))])
    return b.add("DequantizeLinear", [q, s_name, z_name], **kw)


def resolved_padding(layer, in_sizes: Optional[Dict[int, tuple]] = None):
    """The conv's explicit (lo, hi) pairs: 'VALID' as zeros, 'SAME' against
    the input size the layer saw in the export forward (``in_sizes``, by
    ``id`` of the layer)."""
    if layer.padding == "VALID":
        return ((0, 0),) * layer.spatial_dims
    if layer.padding == "SAME":
        sizes = (in_sizes or {}).get(id(layer))
        if sizes is None:
            raise ValueError("SAME padding export needs the layer's input size: export "
                             "runs a forward of the example first")
        return resolve_pads("SAME", sizes, layer.kernel_size, layer.stride, layer.dilation)
    return layer.padding


def _onnx_pads(layer, b: Optional[GraphBuilder] = None) -> List[int]:
    pads = resolved_padding(layer, None if b is None else b.in_sizes)
    return [p[0] for p in pads] + [p[1] for p in pads]


@handles(QuantReLU, QuantIdentity, QuantHardTanh)
def _export_act(b: GraphBuilder, layer: QuantNonLinearActLayer, x: str) -> str:
    if isinstance(layer, QuantReLU):
        x = b.add("Relu", [x])
    if layer.act_quant.quant_type != QuantType.NONE:
        x = b.qdq(x, _probe(layer.act_quant, (1, 8), layer), "act",
                  narrow=layer.act_quant.cfg.narrow_range,
                  quant_type=layer.act_quant.quant_type)
    return x


@handles(_QuantMaxPoolNd)
def _export_maxpool(b: GraphBuilder, layer, x: str) -> str:
    attrs: Dict[str, object] = dict(kernel_shape=list(layer.kernel_size),
                                    strides=list(layer.stride))
    if layer.padding == "SAME":
        attrs["auto_pad"] = "SAME_UPPER"
    elif layer.padding != "VALID" and any(p != (0, 0) for p in layer.padding):
        attrs["pads"] = [p[0] for p in layer.padding] + [p[1] for p in layer.padding]
    return b.add("MaxPool", [x], **attrs)


@handles(QuantAvgPool2d)
def _export_avgpool(b: GraphBuilder, layer, x: str) -> str:
    """Average pool with the layer's truncation: ``(floor(round(sum/s +
    zp) / T) - zp) * s`` with ``T = 2^(acc_bw - out_bw)``, ``acc_bw = in_bw
    + ceil(log2 k)``, the output at the input's scale.

    - QONNX: the ``Trunc`` custom op (domain onnx.brevitas) on the window
      sum, integer-domain in the interpreter.
    - QCDQ: Mul/Add/Floor/Clip spelled out (QuantizeLinear rounds half to
      even where truncation floors). An epsilon before Floor absorbs float
      round-off: the values before it lie on a 1/T grid, so ``min(1/(2T),
      0.5)`` cannot carry one across an integer (JAX's ``1/(2T)`` does when
      T < 1).

    Where the model did not truncate (no grid reached it) a plain
    AveragePool is exact."""
    y = b.add("AveragePool", [x], kernel_shape=list(layer.kernel_size),
              strides=list(layer.stride))
    qt = b.last_qt
    truncated = layer.last_call_truncated
    if truncated is None:  # never called: infer it from the walk
        truncated = layer.trunc_quant is not None and qt is not None
    if not truncated:
        return y
    if qt is None or qt.bit_width is None:
        raise ValueError(
            "QuantAvgPool2d truncates at runtime but the export walk has no activation "
            "grid before it to truncate against")
    k = layer._kernel_elems
    in_bw = qt.bit_width
    out_bw = float(_np(layer.trunc_quant.bit_width_impl()))
    acc_bw = in_bw + math.ceil(math.log2(k))
    T = 2.0 ** (acc_bw - out_bw)
    s = qt.scale.reshape(())
    zp = float(qt.zero_point.reshape(()))
    if b.style == "qonnx":
        # the accumulator s*(n - k*zp) from the mean, then Trunc's floor
        acc = b.add("Mul", [y, b.init_tensor("trunc_k", np.asarray(float(k), np.float32))])
        out = b.add(
            "Trunc",
            [acc,
             b.init_tensor("trunc_scale", s),
             b.init_tensor("trunc_zp", np.asarray(zp, np.float32)),
             b.init_tensor("trunc_ibw", np.asarray(acc_bw, np.float32)),
             b.init_tensor("trunc_obw", np.asarray(out_bw, np.float32))],
            domain="onnx.brevitas", rounding_mode="FLOOR")
    else:
        # y_int = k*avg/s + zp ; q = floor(y_int/T + eps) ; v = (q - zp)*s
        t = b.add("Mul", [y, b.init_tensor(
            "trunc_to_int", np.asarray(float(k) / float(s), np.float32))])
        if zp:
            t = b.add("Add", [t, b.init_tensor("trunc_zp_in", np.asarray(zp, np.float32))])
        t = b.add("Mul", [t, b.init_tensor("trunc_inv_T", np.asarray(1.0 / T, np.float32))])
        t = b.add("Add", [t, b.init_tensor(
            "trunc_eps", np.asarray(min(1.0 / (2.0 * T), 0.5), np.float32))])
        t = b.add("Floor", [t])
        if zp == 0.0:
            # the clip at the output width is a no-op for zp = 0 inputs
            # (|sum_int| <= k*2^(in_bw-1) and k <= 2^ceil(log2 k)); with zp
            # != 0 the model's floor may undershoot the grid, so no clip
            lo = -(2.0 ** (out_bw - 1)) if qt.signed else 0.0
            hi = 2.0 ** (out_bw - 1) - 1 if qt.signed else 2.0 ** out_bw - 1
            t = b.add("Clip", [t, b.init_tensor("trunc_lo", np.asarray(lo, np.float32)),
                               b.init_tensor("trunc_hi", np.asarray(hi, np.float32))])
        if zp:
            t = b.add("Sub", [t, b.init_tensor("trunc_zp_out", np.asarray(zp, np.float32))])
        out = b.add("Mul", [t, b.init_tensor("trunc_s", s)])
    b.last_qt = SimpleNamespace(scale=qt.scale, zero_point=qt.zero_point, bit_width=out_bw,
                                signed=qt.signed)
    return out


# -- QuantLSTM (QONNX custom op) ---------------------------------------------
# One ``QuantLSTMLayer`` node (domain onnx.brevitas) a direction, with the
# quantized gate weights as inputs and every activation quantizer's scale,
# zero point, bit width, sign and range as attributes; the directions of a
# bidirectional layer are concatenated.

_LSTM_ACT_QUANTIZERS = (
    "gate_acc", "forget_acc", "cell_acc", "out_acc",
    "in_sigmoid", "forget_sigmoid", "out_sigmoid",
    "cell_tanh", "hidden_tanh", "cell_state", "hidden_state")


def _act_quant_attrs(prefix: str, qz, probe_features: int, module) -> Dict[str, object]:
    """scale/zp/bw/signed/narrow attributes of one quantizer; bw 0 is off."""
    if qz.quant_type == QuantType.NONE:
        return {f"{prefix}_bw": 0}
    qt = grid(_probe(qz, (1, probe_features), module))
    return {
        f"{prefix}_scale": float(qt.scale.reshape(())),
        f"{prefix}_zp": float(qt.zero_point.reshape(())),
        f"{prefix}_bw": int(qt.bit_width),
        f"{prefix}_signed": int(qt.signed),
        f"{prefix}_narrow": int(qz.cfg.narrow_range),
    }


def _emit_lstm_layer(b: GraphBuilder, lay, x: str) -> str:
    hs = lay.hidden_size
    if lay.input_quant.quant_type != QuantType.NONE:
        in_features = int(lay.w_ih.shape[0])
        x = b.qdq(x, _probe(lay.input_quant, (1, 1, in_features), lay), "lstm_in",
                  narrow=lay.input_quant.cfg.narrow_range,
                  quant_type=lay.input_quant.quant_type)

    def one_gate(raw_block, quantizer, hint):
        name = b.init_tensor(hint, _np(raw_block, np.float32))
        if quantizer.quant_type == QuantType.INT:
            qw = quantizer(raw_block)
            # (in, H) gate blocks: a per-channel scale lies on axis 1
            name = _qdq_axis0(b, name, _weight_qt(qw), quantizer.cfg.narrow_range, axis=1,
                              ndim=2)
        return name

    def weight_name(param, quants, hint):
        """One chain a gate over the packed (in, G*H) matrix, joined by a
        Concat (one chain where the layer shares a single quantizer)."""
        raw = param.detach()
        if len(quants) == 1:
            return one_gate(raw, quants[0], hint)
        parts = [one_gate(raw[:, g * hs:(g + 1) * hs], quants[g], f"{hint}_g{g}")
                 for g in range(len(quants))]
        return b.add("Concat", parts, axis=1)

    inputs = [x,
              weight_name(lay.w_ih, lay.w_ih_quants, "w_ih"),
              weight_name(lay.w_hh, lay.w_hh_quants, "w_hh")]
    if lay.bias is not None:
        inputs.append(b.init_tensor("lstm_bias",
                                    _np(lay.bias_quant(lay.bias.detach()).value, np.float32)))
    attrs: Dict[str, object] = {"hidden_size": hs, "reverse": int(lay.reverse), "cifg": 0}
    q = lay.quants
    acc_feats = 4 * hs
    for prefix in _LSTM_ACT_QUANTIZERS:
        feats = acc_feats if prefix.endswith("acc") else hs
        attrs.update(_act_quant_attrs(prefix, getattr(q, prefix), feats, lay))
    return b.add("QuantLSTMLayer", inputs, domain="onnx.brevitas", **attrs)


@handles(QuantLSTM)
def _export_lstm(b: GraphBuilder, layer, x: str) -> str:
    if b.style != "qonnx":
        raise ValueError("QuantLSTM exports via QONNX only (reference "
                         "BrevitasQuantLSTMCellFn is a QONNX custom op)")
    step = 2 if layer.bidirectional else 1
    for i in range(0, len(layer.layers), step):
        y_f = _emit_lstm_layer(b, layer.layers[i], x)
        if layer.bidirectional:
            y_b = _emit_lstm_layer(b, layer.layers[i + 1], x)
            x = b.add("Concat", [y_f, y_b], axis=2)
        else:
            x = y_f
    return x


@handles(BatchNorm)
def _export_bn(b: GraphBuilder, layer: BatchNorm, x: str) -> str:
    b.last_qt = None
    return b.add(
        "BatchNormalization",
        [x, b.init_tensor("bn_scale", _np(layer.scale, np.float32)),
         b.init_tensor("bn_bias", _np(layer.bias, np.float32)),
         b.init_tensor("bn_mean", _np(layer.mean, np.float32)),
         b.init_tensor("bn_var", _np(layer.var, np.float32))],
        epsilon=float(layer.eps))


def tensor_norm_affine(layer: TensorNorm):
    """TensorNorm's eval affine (mul, add) in Python floats, as JAX forms
    it: ``1 / sqrt(var + eps)`` in double precision."""
    inv_std = 1.0 / np.sqrt(float(_np(layer.running_var)) + layer.eps)
    mul = float(_np(layer.weight)) * inv_std
    add = float(_np(layer.bias)) - float(_np(layer.running_mean)) * mul
    return mul, add


@handles(TensorNorm)
def _export_tensor_norm(b: GraphBuilder, layer: TensorNorm, x: str) -> str:
    mul, add = tensor_norm_affine(layer)
    b.last_qt = None
    y = b.add("Mul", [x, b.init_tensor("tn_mul", np.asarray(mul, np.float32))])
    return b.add("Add", [y, b.init_tensor("tn_add", np.asarray(add, np.float32))])


@handles(nn.Dropout, FoldedBatchNorm)
def _export_identity(b: GraphBuilder, layer, x: str) -> str:
    return x  # eval-mode dropout; a BatchNorm folded into the layer before


@handles(QuantScaleBias)
def _export_scale_bias(b: GraphBuilder, layer: QuantScaleBias, x: str) -> str:
    """Per-channel Mul/Add with the QDQ'd weight (a BatchNorm converted by
    ``quantize(bn_to_scale_bias=True)``), on an NCHW tensor: the (C,)
    weight and bias broadcast as (C, 1, 1)."""
    in_qt, x = _in_quant(b, layer, x, layer.num_features)
    qw = layer.quant_weight()
    w = _np(qw.value, np.float32).reshape(-1, 1, 1)
    w_name = b.init_tensor("sb_weight", w)
    if qw.scale is not None and layer.weight_quant.quant_type == QuantType.INT:
        w_name = _qdq_axis0(b, w_name, _weight_qt(qw), layer.weight_quant.cfg.narrow_range,
                            ndim=3)
    y = b.add("Mul", [x, w_name])
    if layer.bias is not None:
        y = b.add("Add", [y, b.init_tensor(
            "sb_bias", _exported_bias(layer, in_qt, qw).reshape(-1, 1, 1))])
    return _out_quant(b, layer, y, layer.num_features)


def _record_conv_inputs(model, example) -> Dict[int, tuple]:
    """Each conv's input spatial size in one forward of ``example``."""
    sizes: Dict[int, tuple] = {}

    def hook(mod, args):
        v = args[0].value if hasattr(args[0], "value") else args[0]
        sizes[id(mod)] = tuple(v.shape[2:])

    handles_ = [m.register_forward_pre_hook(hook) for m in model.modules()
                if isinstance(m, _QuantConvNd)]
    try:
        with torch.no_grad():
            y = model(example)
    finally:
        for h in handles_:
            h.remove()
    return sizes, y


def export_items(model, example, y_ref):
    """The export walk: ``model.export_layers()``, else the derived items;
    the reason derivation failed (the walk is then the children in order)."""
    if hasattr(model, "export_layers"):
        return model.export_layers(), None
    from brevitas_tpu_torch.export.derive import DeriveError, derive_export_items

    try:
        return derive_export_items(model, example, output_rank=y_ref.ndim), None
    except DeriveError as e:
        return _sequential_children(model), e


def _sequential_children(model) -> list:
    """The model's children in order, a ``ModuleList``'s items in its place."""
    out = []
    for _, child in model.named_children():
        out.extend(child if isinstance(child, nn.ModuleList) else [child])
    return out


def example_tensor(model, example_input) -> torch.Tensor:
    """The example as a float32 tensor on the model's device."""
    return torch.as_tensor(np.asarray(example_input, np.float32)
                           if not isinstance(example_input, torch.Tensor)
                           else example_input).to(_device(model), torch.float32)


def export_model(model, example_input, path: Optional[str] = None,
                 style: str = "qcdq", input_name: str = "input",
                 output_name: str = "output", debug: bool = False) -> bytes:
    """Export a quant model to ONNX bytes (written to ``path`` if given).
    The example is (N, C, ...) like the model's input; the graph's input has
    its shape with a dynamic batch.

    ``debug=True`` gives every quant layer's output a named probe (an
    Identity node ``debug_<i>_<Class>``): list them with
    :func:`debug_probe_names`, read them with ``run_onnx(blob, inputs,
    extra_outputs=names)``."""
    model.eval()
    example = example_tensor(model, example_input)
    # one eval forward: the conv input sizes, the pools' runtime decisions
    in_sizes, y_ref = _record_conv_inputs(model, example)
    items, fallback_reason = export_items(model, example, y_ref)
    b = GraphBuilder(style)
    b.in_sizes = in_sizes
    in_shape = tuple(example.shape)
    if len(in_shape) >= 2:
        b.channels = int(in_shape[1])
    x = input_name
    saved: Dict[str, str] = {}
    for item in items:
        if isinstance(item, tuple):  # glue
            x = _emit_glue(b, item, x, saved)
            continue
        handler = None
        if style == "finn":
            from brevitas_tpu_torch.export.finn import _FINN_HANDLERS

            handler = _lookup(_FINN_HANDLERS, item)
        if handler is None:
            handler = _lookup(_HANDLERS, item)
        if handler is None:
            raise ValueError(f"no export handler for {type(item).__name__}")
        x = handler(b, item, x)
        if debug:
            x = b.add("Identity", [x], outputs=[f"debug_{len(b.nodes)}_{type(item).__name__}"])
    b.nodes.append(P.node("Identity", [x], [output_name]))

    inputs = [P.value_info(input_name, P.FLOAT, [None] + list(in_shape[1:]))]
    outputs = [P.value_info(output_name, P.FLOAT, [None])]
    graph_msg = P.graph(b.nodes, "brevitas_tpu_export", inputs, outputs, b.initializers)
    custom = [("onnx.brevitas", 1)] if style == "qonnx" else []
    if style == "finn":
        custom = [("finn.custom_op.general", 1)]
    blob = P.model(graph_msg, opset=13, custom_domains=custom)
    if fallback_reason is not None:
        _validate_fallback_export(blob, example, y_ref, input_name, fallback_reason)
    if style == "finn":
        from brevitas_tpu_torch.export.finn import (
            move_quant_attributes_into_annotations,
            restore_domain,
        )

        blob = restore_domain(move_quant_attributes_into_annotations(blob))
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def _lookup(table: Dict[type, Callable], item):
    for cls in type(item).__mro__:
        if cls in table:
            return table[cls]
    return None


def _emit_glue(b: GraphBuilder, item: tuple, x: str, saved: Dict[str, str]) -> str:
    op = item[0]
    if op == "flatten":
        return b.add("Flatten", [x], axis=1)
    if op == "affine":
        _, mul, add = item
        x = b.add("Mul", [x, b.init_tensor("mul", np.asarray(mul, np.float32))])
        return b.add("Add", [x, b.init_tensor("add", np.asarray(add, np.float32))])
    if op == "debug":
        # a named probe: an Identity whose output name is stable
        return b.add("Identity", [x], outputs=[item[1]])
    # residual topology: remember a tensor, branch back to it, join branches
    if op == "save":
        saved[item[1]] = x
        return x
    if op == "load":
        return saved[item[1]]
    if op == "add_saved":
        return b.add("Add", [x, saved[item[1]]])
    if op == "relu":
        return b.add("Relu", [x])
    if op == "relu6":
        return b.add("Clip", [x, b.init_tensor("relu6_lo", np.asarray(0.0, np.float32)),
                              b.init_tensor("relu6_hi", np.asarray(6.0, np.float32))])
    if op == "concat":  # join "@" (the current tensor) and saved ones on channels
        return b.add("Concat", [x if n == "@" else saved[n] for n in item[1]], axis=1)
    if op == "maxpool":
        _, k, s, pad = item
        attrs: Dict[str, object] = dict(kernel_shape=[k, k], strides=[s, s])
        if pad == "SAME":
            attrs["auto_pad"] = "SAME_UPPER"
        return b.add("MaxPool", [x], **attrs)
    if op == "avgpool":
        _, k, s = item
        return b.add("AveragePool", [x], kernel_shape=[k, k], strides=[s, s])
    if op == "gap":
        return b.add("GlobalAveragePool", [x])
    if op == "flatten_hwc":  # flatten in (H, W, C) order
        x = b.add("Transpose", [x], perm=[0, 2, 3, 1])
        return b.add("Flatten", [x], axis=1)
    if op == "resize_scale":  # bilinear upsample by a static factor
        _, sh, sw = item
        scales = b.init_tensor("resize_scales", np.asarray([1.0, 1.0, sh, sw], np.float32))
        return b.add("Resize", [x, "", scales], mode="linear",
                     coordinate_transformation_mode="half_pixel")
    if op == "expand_like":  # broadcast (B, C, 1, 1) to a saved tensor's H, W
        shp = b.add("Shape", [saved[item[1]]])
        return b.add("Expand", [x, shp])
    if op == "expand_hw":  # broadcast (B, C, 1, 1) to static H, W
        _, h, w = item
        return b.add("Expand", [x, b.init_tensor(
            "expand_shape", np.asarray([1, 1, h, w], np.int64))])
    if op == "unflatten2d":  # (B, C) -> (B, C, 1, 1)
        return b.add("Reshape", [x, b.init_tensor(
            "unflatten_shape", np.asarray([0, -1, 1, 1], np.int64))])
    raise ValueError(f"unknown glue spec {item}")


class ExportValidationError(ValueError):
    """The walk could not be derived, and the children in order give a
    graph that does not reproduce the model: export refuses rather than
    return a wrong graph."""


def _validate_fallback_export(blob, example, y_ref, input_name, reason):
    """Run the fallback bytes in the interpreter against the model's
    output."""
    from brevitas_tpu_torch.export.interp import run_onnx

    want = _np(y_ref)
    try:
        (got,) = run_onnx(blob, {input_name: _np(example, np.float32)})
        span = float(np.max(np.abs(want))) + 1e-6
        ok = got.shape == want.shape and np.allclose(got, want, atol=5e-2 * span + 1e-3)
    except Exception:
        ok = False
    if not ok:
        raise ExportValidationError(
            f"export walk could not be derived ({reason}) and the child-order fallback "
            "does not reproduce the model; provide export_layers() for this "
            "architecture") from reason


def debug_probe_names(model_bytes: bytes) -> List[str]:
    """Probe names emitted by ``export_model(..., debug=True)``."""
    g = P.parse_model(model_bytes)
    return [n.outputs[0] for n in g.nodes
            if n.op_type == "Identity" and n.outputs and n.outputs[0].startswith("debug_")]
