"""FINN-dialect ONNX export (port of ``brevitas_tpu/export/finn.py``).

Reference: ``src/brevitas/export/onnx/finn/``: FINNManager (manager.py:75),
the MultiThreshold activation lowering (function/act.py:16-39, the
threshold synthesis of handler/act.py:26-138), the integer-weight
MatMul/Conv functions (function/parameter.py), the QuantAvgPool2d
accumulator node (function/acc.py), the ``finn_datatype`` annotations and
the attribute-to-annotation and domain-restoring model transforms
(transform.py, utils.py).

The FINN dataflow compiler reads a dialect where:

- every quantized activation is a ``MultiThreshold(x, thresholds)`` node
  (domain ``finn.custom_op.general``): ``y[c] = sum_t [x[c] >= T[c,t]]``, an
  integer count, then a plain ``Add`` (the most negative integer) and
  ``Mul`` (the scale) give the fake-quant value back. A 1-bit signed grid
  takes the BIPOLAR form: ``out_scale/out_bias`` attributes fold
  ``2*[x>=0]-1``.
- every weight is an INTEGER-valued float initializer on a standard
  ``MatMul``/``Conv`` whose FINN datatype rides first as a ``weight_qnt``
  string attribute and then, after ``move_quant_attributes_into_annotations``,
  as a ``finn_datatype`` entry of ``graph.quantization_annotation``; the
  weight scale follows as a plain ``Mul``.
- a truncating average pool is a ``QuantAvgPool2d`` node on the integer
  domain (``Div`` by the scale, pool and shift, ``Mul`` by the scale).

Numerics: MultiThreshold counts round half UP on a midpoint exactly, where
the fake-quant law rounds half to even; a measure-zero difference the
reference's FINN flow has too, which the chip script counts.

The port's linear weights are (out, in) and go out as JAX's (in, out); its
conv weights are OIHW already. A linear or conv clears the activation grid
a truncating pool reads (``GraphBuilder.last_qt``), as ``export/qcdq.py``'s
layers do.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np

from brevitas_tpu_torch.export import onnx_proto as P
from brevitas_tpu_torch.export.qcdq import (
    GraphBuilder,
    Handler,
    _np,
    _onnx_pads,
    _probe,
    export_model,
    grid,
)
from brevitas_tpu_torch.nn.activation import QuantHardTanh, QuantIdentity, QuantReLU
from brevitas_tpu_torch.nn.conv import QuantConv1d, QuantConv2d
from brevitas_tpu_torch.nn.linear import QuantLinear
from brevitas_tpu_torch.nn.pool import QuantAvgPool2d
from brevitas_tpu_torch.quant.config import QuantType

DOMAIN_STRING = "finn.custom_op.general"

_FINN_HANDLERS: Dict[type, Handler] = {}


def _finn_handles(*classes):
    def deco(fn):
        for c in classes:
            _FINN_HANDLERS[c] = fn
        return fn

    return deco


def finn_datatype(bit_width: float, signed: bool,
                  supported_int_bit_width_range: Tuple[int, int] = (2, 33),
                  ) -> str:
    """FINN datatype string (reference export/onnx/finn/utils.py:5)."""
    bw = int(round(float(bit_width)))
    if bw == 1 and signed:
        return "BIPOLAR"
    if bw == 1:
        return "BINARY"
    if bw in range(*supported_int_bit_width_range):
        return f"INT{bw}" if signed else f"UINT{bw}"
    raise ValueError(f"Unsupported bit width {bw} for FINN export")


# ---------------------------------------------------------------------------
# threshold synthesis (reference handler/act.py:26-138)
# ---------------------------------------------------------------------------


def relu_thresholds(scale: np.ndarray, bit_width: int,
                    channels: Optional[int] = None) -> np.ndarray:
    """(C, 2^bw - 1) thresholds realizing the unsigned ReLU grid:
    ``T[c,t] = |s_c|/2 + |s_c|·t`` (reference FINNQuantReLUHandler)."""
    flat = np.abs(np.asarray(scale, np.float64).reshape(-1))
    num_thresholds = 2 ** bit_width - 1
    t = np.arange(num_thresholds, dtype=np.float64)
    thr = flat[:, None] / 2.0 + flat[:, None] * t[None, :]
    if channels is not None and thr.shape[0] == 1 and channels > 1:
        thr = np.broadcast_to(thr, (channels, num_thresholds)).copy()
    return thr.astype(np.float32)


def hardtanh_thresholds(scale: np.ndarray, bit_width: int, narrow: bool,
                        channels: Optional[int] = None) -> np.ndarray:
    """(C, N-1) thresholds for a signed symmetric grid (reference
    FINNQuantHardTanhHandler.thresholds): count + most-negative-int bias
    reproduces ``clip(round(x/s), lo, hi)``."""
    if bit_width == 1:
        return np.zeros((1, 1), np.float32)
    num_distinct = 2 ** bit_width - 1 if narrow else 2 ** bit_width
    num_thresholds = num_distinct - 1
    step = np.abs(np.asarray(scale, np.float64).reshape(-1))
    half_step = step / 2.0
    min_threshold = -half_step - step * ((num_thresholds // 2) - 1)
    if not narrow:
        min_threshold = min_threshold - step
    t = np.arange(num_thresholds, dtype=np.float64)
    thr = min_threshold[:, None] + step[:, None] * t[None, :]
    if channels is not None and thr.shape[0] == 1 and channels > 1:
        thr = np.broadcast_to(thr, (channels, num_thresholds)).copy()
    return thr.astype(np.float32)


def hardtanh_bias(bit_width: int, narrow: bool) -> float:
    """Most-negative integer of the grid (reference quant_act_bias)."""
    if bit_width == 1:
        return -0.5
    return float(-(2 ** (bit_width - 1) - 1) if narrow
                 else -(2 ** (bit_width - 1)))


# ---------------------------------------------------------------------------
# activation handlers
# ---------------------------------------------------------------------------


def _act_meta(layer, channels=None):
    # a per-channel quantizer needs a probe at its true channel count
    ch = getattr(layer, "num_channels", None) or channels or 8
    qt = grid(_probe(layer.act_quant, (1, int(ch)), layer))
    bw = int(round(qt.bit_width))
    return qt, qt.scale, bw, qt.signed, layer.act_quant.cfg.narrow_range


@_finn_handles(QuantReLU)
def _finn_relu(b: GraphBuilder, layer: QuantReLU, x: str) -> str:
    if layer.act_quant.quant_type == QuantType.NONE:
        return b.add("Relu", [x])
    qt, scale, bw, signed, narrow = _act_meta(layer, b.channels)
    thr = relu_thresholds(scale, bw, b.channels)
    t_name = b.init_tensor("thres", thr)
    y = b.add("MultiThreshold", [x, t_name], domain=DOMAIN_STRING,
              out_dtype=finn_datatype(bw, False),
              activation_qnt=finn_datatype(bw, False))
    s = scale.reshape(-1)
    s_init = s.reshape(()) if s.size == 1 else _channel_shaped(s, b)
    y = b.add("Mul", [y, b.init_tensor("act_scale",
                                       np.asarray(s_init, np.float32))])
    b.last_qt = qt
    return y


@_finn_handles(QuantIdentity, QuantHardTanh)
def _finn_identity(b: GraphBuilder, layer, x: str) -> str:
    aq = layer.act_quant
    if aq.quant_type == QuantType.NONE:
        return x
    qt, scale, bw, signed, narrow = _act_meta(layer, b.channels)
    if aq.quant_type == QuantType.BINARY or bw == 1:
        # BIPOLAR: y = out_scale·[x >= 0] + out_bias = sign(x)·scale
        # (reference emits out_scale=2, out_bias=-1 and asserts scale == 1;
        # folding the actual scale generalizes to scale != 1)
        flat = float(np.asarray(scale).reshape(-1)[0])
        t_name = b.init_tensor("thres", np.zeros((1, 1), np.float32))
        y = b.add("MultiThreshold", [x, t_name], domain=DOMAIN_STRING,
                  out_dtype="BIPOLAR", activation_qnt="BIPOLAR",
                  out_scale=2.0 * flat, out_bias=-1.0 * flat)
        b.last_qt = qt
        return y
    if not signed:
        # unsigned identity grid == the ReLU grid
        return _finn_relu(b, layer, x)
    thr = hardtanh_thresholds(scale, bw, narrow, b.channels)
    t_name = b.init_tensor("thres", thr)
    y = b.add("MultiThreshold", [x, t_name], domain=DOMAIN_STRING,
              out_dtype=finn_datatype(bw, signed),
              activation_qnt=finn_datatype(bw, signed))
    y = b.add("Add", [y, b.init_tensor(
        "act_bias", np.asarray(hardtanh_bias(bw, narrow), np.float32))])
    s = scale.reshape(-1)
    s_init = s.reshape(()) if s.size == 1 else _channel_shaped(s, b)
    y = b.add("Mul", [y, b.init_tensor("act_scale",
                                       np.asarray(s_init, np.float32))])
    b.last_qt = qt
    return y


def _channel_shaped(s: np.ndarray, b: GraphBuilder) -> np.ndarray:
    """Per-channel activation constants broadcast over NCHW axis 1."""
    return s.reshape(1, -1, 1, 1)


# ---------------------------------------------------------------------------
# WBIOL handlers (reference handler/parameter.py)
# ---------------------------------------------------------------------------


def _finn_validate(layer, name: str):
    """FINN WBIOL contract (reference FINNQuantWBIOLHandler.validate):
    weights quantized, activations handled by separate MultiThreshold
    layers — input/output quant on the layer itself is unsupported."""
    if layer.weight_quant.quant_type not in (QuantType.INT, QuantType.BINARY):
        raise ValueError(f"FINN export of {name} requires INT or BINARY "
                         "weight quant")
    if layer.input_quant.quant_type != QuantType.NONE or \
            layer.output_quant.quant_type != QuantType.NONE:
        raise ValueError(
            f"FINN export of {name}: input/output quantizers must live in "
            "standalone activation layers (reference FINNQuantWBIOLHandler"
            ".validate asserts no input/output quant)")


def _finn_weight(layer):
    """(integer codes in the port's layout, the scale as float64, the
    datatype)."""
    qw = layer.quant_weight()
    scale = _np(qw.scale, np.float64)
    if layer.weight_quant.quant_type == QuantType.BINARY:
        codes = _np(qw.value, np.float64) / scale
        return codes.astype(np.float32), scale, "BIPOLAR"
    codes = _np(qw.int(), np.float32)
    bw = float(_np(qw.bit_width))
    return codes, scale, finn_datatype(bw, bool(qw.signed))


def _finn_bias(b: GraphBuilder, layer, y: str, conv: bool) -> str:
    """The bias as a plain Add of its float value. The port's INT bias
    quantizers all take the accumulator's scale (``requires_input_scale``),
    which a FINN layer (no input quantizer) does not have; the JAX
    package exports those as their float value too."""
    if layer.bias is None:
        return y
    bias = _np(layer.bias, np.float32)
    # conv output is (N, C, *spatial): the bias broadcasts over the layer's
    # own spatial rank
    shape = (1, -1) + (1,) * layer.spatial_dims if conv else (-1,)
    return b.add("Add", [y, b.init_tensor("bias", bias.reshape(shape))])


@_finn_handles(QuantLinear)
def _finn_linear(b: GraphBuilder, layer: QuantLinear, x: str) -> str:
    _finn_validate(layer, "QuantLinear")
    codes, scale, dtype = _finn_weight(layer)
    w_name = b.init_tensor("Wt_int", codes.T)  # (in, out)
    y = b.add("MatMul", [x, w_name], domain=DOMAIN_STRING, weight_qnt=dtype)
    flat = scale.reshape(-1).astype(np.float32)
    s_arr = flat.reshape(()) if flat.size == 1 else flat.reshape(1, -1)
    y = b.add("Mul", [y, b.init_tensor("w_scale", s_arr)])
    y = _finn_bias(b, layer, y, conv=False)
    b.channels = layer.out_features
    b.last_qt = None  # the output is on no activation grid
    return y


@_finn_handles(QuantConv1d, QuantConv2d)
def _finn_conv(b: GraphBuilder, layer, x: str) -> str:
    _finn_validate(layer, type(layer).__name__)
    spatial = layer.spatial_dims
    codes, scale, dtype = _finn_weight(layer)
    w = codes  # OIHW
    pads = _onnx_pads(layer, b)
    y = b.add("Conv", [x, b.init_tensor("W_int", w)], domain=DOMAIN_STRING,
              weight_qnt=dtype, kernel_shape=list(layer.kernel_size),
              pads=pads, strides=list(layer.stride), group=layer.groups,
              dilations=list(layer.dilation))
    flat = scale.reshape(-1).astype(np.float32)
    s_arr = (flat.reshape(()) if flat.size == 1
             else flat.reshape((1, -1) + (1,) * spatial))
    y = b.add("Mul", [y, b.init_tensor("w_scale", s_arr)])
    y = _finn_bias(b, layer, y, conv=True)
    b.channels = layer.out_channels
    b.last_qt = None
    return y


@_finn_handles(QuantAvgPool2d)
def _finn_avgpool(b: GraphBuilder, layer: QuantAvgPool2d, x: str) -> str:
    if layer.trunc_quant is None or layer.last_call_truncated is False:
        # mirror the model: no trunc quantizer, or the layer saw a plain
        # array at runtime and computed a plain mean (nn/pool.py)
        return b.add("AveragePool", [x], kernel_shape=list(layer.kernel_size),
                     strides=list(layer.stride))
    if b.last_qt is None:
        raise ValueError("FINN QuantAvgPool2d export needs a preceding "
                         "quantized activation (input scale/bit-width; "
                         "reference caches them via _cache_inp_out)")
    qt = b.last_qt
    ibits = int(round(qt.bit_width))
    obits = int(round(float(_np(layer.trunc_quant.bit_width_impl()))))
    scale = qt.scale.reshape(())
    dtype = finn_datatype(ibits, qt.signed)
    s_name = b.init_tensor("pool_scale", scale)
    y = b.add("Div", [x, s_name], domain=DOMAIN_STRING, activation_qnt=dtype)
    y = b.add("QuantAvgPool2d", [y], domain=DOMAIN_STRING,
              kernel=layer.kernel_size[0], stride=layer.stride[0],
              signed=int(bool(qt.signed)), ibits=ibits, obits=obits)
    return b.add("Mul", [y, s_name])


# ---------------------------------------------------------------------------
# model transforms (reference transform.py)
# ---------------------------------------------------------------------------

_QNT_ATTRS = ("weight_qnt", "bias_qnt", "activation_qnt")


def _reserialize(field: int, wire: int, val) -> bytes:
    """Re-emit one parsed field verbatim (P._read_fields unpacks wire-5/1
    payloads to python floats, so they must be re-packed, not .to_bytes)."""
    import struct

    if wire == 2:
        return P.f_bytes(field, bytes(val))
    if wire == 5:
        return P._tag(field, 5) + struct.pack("<f", val)
    if wire == 1:
        return P._tag(field, 1) + struct.pack("<d", val)
    return P.f_varint(field, val)


def _walk_nodes(model_bytes: bytes, node_fn, graph_suffix_fn=None) -> bytes:
    """Rewrite every NodeProto in a serialized ModelProto via ``node_fn``
    (bytes → bytes), passing all other fields through verbatim; optionally
    append extra GraphProto fields produced by ``graph_suffix_fn()``."""
    out = b""
    for field, wire, val in P._read_fields(model_bytes):
        if field == 7:  # ModelProto.graph
            g_out = b""
            for f2, w2, v2 in P._read_fields(val):
                if f2 == 1:  # GraphProto.node
                    g_out += P.f_bytes(1, node_fn(v2))
                else:
                    g_out += _reserialize(f2, w2, v2)
            if graph_suffix_fn is not None:
                g_out += graph_suffix_fn()
            out += P.f_bytes(7, g_out)
        else:
            out += _reserialize(field, wire, val)
    return out


def _tensor_annotation(tensor_name: str, datatype: str) -> bytes:
    """GraphProto.quantization_annotation (field 14): TensorAnnotation
    {tensor_name=1, quant_parameter_tensor_names=2} with a
    StringStringEntryProto{key='finn_datatype', value=datatype}."""
    entry = P.f_string(1, "finn_datatype") + P.f_string(2, datatype)
    ta = P.f_string(1, tensor_name) + P.f_bytes(2, entry)
    return P.f_bytes(14, ta)


def move_quant_attributes_into_annotations(model_bytes: bytes) -> bytes:
    """Move ``weight_qnt``/``bias_qnt``/``activation_qnt`` node attributes
    into ``graph.quantization_annotation`` entries keyed ``finn_datatype``
    (reference transform.py:12-49): weight/bias datatypes annotate the
    second node input, activation datatypes the node output."""
    annotations: List[Tuple[str, str]] = []

    def rewrite(node_bytes: bytes) -> bytes:
        fields = list(P._read_fields(node_bytes))
        inputs = [v.decode() for f, w, v in fields if f == 1]
        outputs = [v.decode() for f, w, v in fields if f == 2]
        out = b""
        for f, w, v in fields:
            if f == 5:  # attribute
                name, value = P.parse_attribute(v)
                if name in _QNT_ATTRS and isinstance(value, str):
                    if value != "FLOAT32":
                        target = (outputs[0] if name == "activation_qnt"
                                  else inputs[1])
                        annotations.append((target, value))
                    continue  # drop the attribute
            out += _reserialize(f, w, v)
        return out

    def suffix() -> bytes:
        return b"".join(_tensor_annotation(t, d) for t, d in annotations)

    return _walk_nodes(model_bytes, rewrite, suffix)


def restore_domain(model_bytes: bytes) -> bytes:
    """Return MatMul/Conv/Add/Div nodes to the default ONNX domain
    (reference transform.py:52-59): the FINN domain was only needed while
    quant attributes rode on them."""

    def rewrite(node_bytes: bytes) -> bytes:
        fields = list(P._read_fields(node_bytes))
        op_type = next((v.decode() for f, w, v in fields if f == 4), "")
        out = b""
        for f, w, v in fields:
            if f == 7 and op_type in ("MatMul", "Conv", "Add", "Div"):
                continue  # drop domain
            out += _reserialize(f, w, v)
        return out

    return _walk_nodes(model_bytes, rewrite)


def read_finn_annotations(model_bytes: bytes) -> Dict[str, str]:
    """tensor name → finn_datatype from ``graph.quantization_annotation``."""
    out: Dict[str, str] = {}
    for field, wire, val in P._read_fields(model_bytes):
        if field != 7:
            continue
        for f2, w2, v2 in P._read_fields(val):
            if f2 != 14:
                continue
            tensor = dtype = None
            for f3, w3, v3 in P._read_fields(v2):
                if f3 == 1:
                    tensor = v3.decode()
                elif f3 == 2:
                    key = value = None
                    for f4, w4, v4 in P._read_fields(v3):
                        if f4 == 1:
                            key = v4.decode()
                        elif f4 == 2:
                            value = v4.decode()
                    if key == "finn_datatype":
                        dtype = value
            if tensor is not None and dtype is not None:
                out[tensor] = dtype
    return out


def export_finn_onnx(model, example_input, path: Optional[str] = None,
                     **kw) -> bytes:
    """FINN-dialect export (reference export_finn_onnx → FINNManager)."""
    return export_model(model, example_input, path, style="finn", **kw)
