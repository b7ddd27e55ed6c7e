"""TorchScript export: QCDQ and QOp (port of
``brevitas_tpu/export/torch_backend.py``).

Reference: ``src/brevitas/export/torch/qcdq/`` (TorchQCDQManager,
manager.py:22: fake-quantize chains traced to TorchScript) and
``export/torch/qoperator/`` (TorchQOpManager, manager.py:24: the WBIOL
layers on ``torch.nn.quantized`` modules).

The artifact is built from the same walk as the ONNX exporters
(``export/qcdq.py``): each quant layer becomes a closure of plain torch ops
over frozen constants (scale, zero point, bit width, the fake-quant weight
and the accumulator-grid bias), the closures compose into a
``torch.nn.Module``, and ``torch.jit.trace`` makes the TorchScript program.
The closures are the JAX package's, op for op, so both packages' modules
give the same bits on the same input. They never call the port's CUDA
kernels: a ctypes call does not trace, and the artifact is meant for other
runtimes.

- QCDQ: the constants live on the model's device and the program is traced
  there. The activation law ``(clamp(round(x/s + zp), lo, hi) - zp) * s``
  rounds half to even as the model does; the weights and biases are the
  values the model's forward consumes.
- QOp: ``torch.ao.nn.quantized`` modules (quint8 activations, qint8
  weights, an int32 bias at in_scale * w_scale). Those modules have CUDA
  kernels in no PyTorch build, so this artifact is built and traced on the
  host whatever the model's device: that is the artifact's nature, as in the
  reference, not a fallback of the port's path. Their fused requantization
  can differ from the fake-quant model by an output step (the reference
  allows the same against ONNX Runtime, tests/brevitas_ort/common.py:25).
  The reference caps QOp weights at 7 bits for fbgemm's int16 accumulation
  on x86 CPUs without VNNI; this exporter allows 8 bits.

The truncating average pool is the JAX package's rescaled mean (``sum /
2^ceil(log2 k)``, no floor), so it can sit an output step off the model.
"""

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from brevitas_tpu_torch.export.qcdq import (
    _exported_bias,
    _np,
    _probe,
    _record_conv_inputs,
    example_tensor,
    export_items,
    grid,
    resolved_padding,
    tensor_norm_affine,
)
from brevitas_tpu_torch.models.common import BatchNorm, TensorNorm
from brevitas_tpu_torch.nn.activation import (
    QuantHardTanh,
    QuantIdentity,
    QuantNonLinearActLayer,
    QuantReLU,
)
from brevitas_tpu_torch.nn.conv import QuantConv1d, QuantConv2d
from brevitas_tpu_torch.nn.linear import QuantLinear
from brevitas_tpu_torch.nn.misc import FoldedBatchNorm, QuantScaleBias
from brevitas_tpu_torch.nn.pool import QuantAvgPool2d, _QuantMaxPoolNd
from brevitas_tpu_torch.quant.config import QuantType

TorchFn = Callable  # (torch.Tensor) -> torch.Tensor

_T_HANDLERS: Dict[type, Callable] = {}


def _t_handles(*classes):
    def deco(fn):
        for c in classes:
            _T_HANDLERS[c] = fn
        return fn

    return deco


def _const(array, device) -> torch.Tensor:
    return torch.from_numpy(np.array(array, copy=True)).to(device)


def _int_range(bw: float, signed: bool, narrow: bool):
    if signed:
        lo = -(2.0 ** (bw - 1)) + (1.0 if narrow else 0.0)
        hi = 2.0 ** (bw - 1) - 1.0
    else:
        lo = 0.0
        hi = 2.0**bw - 1.0 - (1.0 if narrow else 0.0)
    return lo, hi


def _act_fq_fn(quantizer, probe_shape, module, device) -> Optional[TorchFn]:
    """Fake-quant closure of an activation quantizer over its frozen grid; a
    per-channel scale broadcasts over the NCHW channel axis."""
    if quantizer.quant_type == QuantType.NONE:
        return None
    if quantizer.quant_type != QuantType.INT:
        raise ValueError(
            "torch QCDQ export supports INT activation quantizers only "
            "(binary/ternary export via QONNX, reference FINN flow)")
    qt = grid(_probe(quantizer, probe_shape, module))
    scale = qt.scale.reshape(-1)
    zp = qt.zero_point.reshape(-1)
    lo, hi = _int_range(qt.bit_width, qt.signed, quantizer.cfg.narrow_range)
    per_channel = scale.size > 1
    s_t = _const(scale, device)
    z_t = _const(np.broadcast_to(zp, scale.shape).astype(np.float32), device)

    def fq(x):
        s, z = s_t, z_t
        if per_channel and x.dim() > 2:
            shape = [1] * x.dim()
            shape[1] = -1  # NCHW channel axis
            s = s_t.view(shape)
            z = z_t.view(shape)
        y = torch.clamp(torch.round(x / s + z), lo, hi)
        return (y - z) * s

    return fq


def _chain(*fns) -> TorchFn:
    fns = [f for f in fns if f is not None]

    def run(x):
        for f in fns:
            x = f(x)
        return x

    return run


def _probe_in(layer):
    return (1, layer.in_channels) + (8,) * layer.spatial_dims


def _probe_out(layer):
    return (1, layer.out_channels) + (8,) * layer.spatial_dims


def _torch_pad(layer, in_sizes) -> Optional[List[int]]:
    """The conv's padding as an ``F.pad`` spec (last spatial axis first),
    or None where it pads nothing."""
    pads = resolved_padding(layer, in_sizes)
    if all(p == (0, 0) for p in pads):
        return None
    pad: List[int] = []
    for lo, hi in reversed(pads):
        pad.extend([lo, hi])
    return pad


def _in_fq(layer, features_probe, device):
    if layer.input_quant.quant_type == QuantType.NONE:
        return None, None
    in_qt = _probe(layer.input_quant, features_probe, layer)
    return in_qt, _act_fq_fn(layer.input_quant, features_probe, layer, device)


@_t_handles(QuantLinear)
def _t_linear(layer: QuantLinear, style: str, ctx) -> TorchFn:
    device = ctx["device"]
    in_qt, in_fq = _in_fq(layer, (1, layer.in_features), device)
    qw = layer.quant_weight()
    w = _const(_np(qw.value, np.float32), device)  # (out, in)
    bias = None
    if layer.bias is not None:
        bias = _const(_exported_bias(layer, in_qt, qw), device)
    out_fq = _act_fq_fn(layer.output_quant, (1, layer.out_features), layer, device)
    if style == "qop":
        return _t_qop_linear(layer, in_qt, in_fq, qw, bias, out_fq)

    def run(x):
        return F.linear(x, w, bias)

    return _chain(in_fq, run, out_fq)


@_t_handles(QuantConv1d, QuantConv2d)
def _t_conv(layer, style: str, ctx) -> TorchFn:
    device = ctx["device"]
    spatial = layer.spatial_dims
    in_qt, in_fq = _in_fq(layer, _probe_in(layer), device)
    qw = layer.quant_weight()
    w = _const(_np(qw.value, np.float32), device)  # OIHW
    bias = None
    if layer.bias is not None:
        bias = _const(_exported_bias(layer, in_qt, qw), device)
    out_fq = _act_fq_fn(layer.output_quant, _probe_out(layer), layer, device)
    if style == "qop":
        return _t_qop_conv(layer, in_qt, in_fq, qw, w, bias, out_fq, ctx)

    pad = _torch_pad(layer, ctx["in_sizes"])
    conv = F.conv1d if spatial == 1 else F.conv2d

    def run(x):
        if pad is not None:
            x = F.pad(x, pad)
        return conv(x, w, bias, stride=layer.stride, dilation=layer.dilation,
                    groups=layer.groups)

    return _chain(in_fq, run, out_fq)


@_t_handles(QuantReLU, QuantIdentity, QuantHardTanh)
def _t_act(layer: QuantNonLinearActLayer, style: str, ctx) -> TorchFn:
    act = torch.relu if isinstance(layer, QuantReLU) else None
    fq = _act_fq_fn(layer.act_quant, (1, 8), layer, ctx["device"])
    return _chain(act, fq)


@_t_handles(_QuantMaxPoolNd)
def _t_maxpool(layer, style: str, ctx) -> TorchFn:
    same = layer.padding == "SAME"
    k, s = layer.kernel_size, layer.stride
    if layer.spatial_dims != 2:
        raise ValueError("torch export supports 2-D max pools")
    if not same and layer.padding != "VALID" and any(p != (0, 0) for p in layer.padding):
        raise ValueError("torch export of a max pool with explicit padding")

    def run(x):
        if same:
            # SAME_UPPER padding resolved against the traced input's shape
            pads = []
            for dim, (kk, ss) in zip((3, 2), zip(reversed(k), reversed(s))):
                size = x.shape[dim]
                out = -(-size // ss)
                total = max(0, (out - 1) * ss + kk - size)
                pads.extend([total // 2, total - total // 2])
            x = F.pad(x, pads, value=float("-inf"))
        return F.max_pool2d(x, k, s)

    return run


@_t_handles(QuantAvgPool2d)
def _t_avgpool(layer, style: str, ctx) -> TorchFn:
    k, s = layer.kernel_size, layer.stride
    factor = 1.0
    if layer.trunc_quant is not None:
        # the JAX package's rescale: the layer emits trunc(sum /
        # 2^ceil(log2 k)) at the input scale, AveragePool gives sum / k
        kk = layer._kernel_elems
        factor = kk / (2.0 ** math.ceil(math.log2(kk)))

    def run(x):
        y = F.avg_pool2d(x, k, s)
        return y * factor if factor != 1.0 else y

    return run


@_t_handles(TensorNorm)
def _t_tensor_norm(layer: TensorNorm, style: str, ctx) -> TorchFn:
    mul, add = tensor_norm_affine(layer)

    def run(x):
        return x * mul + add

    return run


@_t_handles(QuantScaleBias)
def _t_scale_bias(layer: QuantScaleBias, style: str, ctx) -> TorchFn:
    device = ctx["device"]
    probe = (1, layer.num_features, 8, 8)
    in_qt, in_fq = _in_fq(layer, probe, device)
    qw = layer.quant_weight()
    w = _const(_np(qw.value, np.float32).reshape(-1, 1, 1), device)
    b = None
    if layer.bias is not None:
        b = _const(_exported_bias(layer, in_qt, qw).reshape(-1, 1, 1), device)
    out_fq = _act_fq_fn(layer.output_quant, probe, layer, device)

    def run(x):
        y = x * w
        return y + b if b is not None else y

    return _chain(in_fq, run, out_fq)


@_t_handles(nn.Dropout, FoldedBatchNorm)
def _t_identity(layer, style: str, ctx) -> TorchFn:
    return lambda x: x


@_t_handles(BatchNorm)
def _t_batchnorm(layer: BatchNorm, style: str, ctx) -> TorchFn:
    device = ctx["device"]
    weight = _const(_np(layer.scale, np.float32), device)
    bias = _const(_np(layer.bias, np.float32), device)
    mean = _const(_np(layer.mean, np.float32), device)
    var = _const(_np(layer.var, np.float32), device)
    eps = float(layer.eps)

    def run(x):
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)

    return run


# -- QOp: torch.ao.nn.quantized execution ------------------------------------


def _quint8_params(qt, narrow: bool, what: str):
    """(scale, quint8 zero point) storing an INT activation grid of at most
    8 bits. A signed grid shifts onto quint8 by +128 (exact). A narrow grid
    raises: quint8 storage could give the code -2^(bw-1) it excludes."""
    if narrow:
        raise ValueError(f"narrow quant not supported by QOp export ({what})")
    bw = qt.bit_width
    if bw > 8.0:
        raise ValueError(f"QOp export stores {what} as quint8; {bw:g}-bit "
                         "quantizers cannot be represented")
    scale = float(qt.scale.reshape(()))
    zp = float(qt.zero_point.reshape(()))
    if zp != round(zp):
        raise ValueError(f"QOp export needs integer zero-points ({what})")
    zp = int(round(zp)) + (128 if qt.signed else 0)
    return scale, zp


def _qop_weight_zp_check(qw):
    """torch's qint8 weights are symmetric: an asymmetric weight quantizer
    raises rather than export wrongly."""
    if np.any(np.round(qw.zero_point.reshape(-1).astype(np.float64)) != 0):
        raise ValueError("torch QOp export requires symmetric (zero "
                         "zero-point) weight quantizers")


def _sub8_input_guard(in_fq, in_qt):
    """``quantize_per_tensor`` clamps to quint8's [0, 255]; a grid below 8
    bits clamps tighter, so the model's own input fake-quant goes first."""
    return in_fq if in_qt.bit_width < 8.0 else None


def _t_qop_linear(layer, in_qt, in_fq, qw_t, bias, out_fq) -> TorchFn:
    if in_qt is None or layer.output_quant.quant_type == QuantType.NONE:
        raise ValueError("QOp export requires INT input and output "
                         "quantizers (reference StdQOpONNXQuantWBIOLHandler)")
    in_qt = grid(in_qt)
    x_scale, x_zp = _quint8_params(in_qt, layer.input_quant.cfg.narrow_range, "inputs")
    out_qt = grid(_probe(layer.output_quant, (1, layer.out_features), layer))
    y_scale, y_zp = _quint8_params(out_qt, layer.output_quant.cfg.narrow_range, "outputs")
    sub8_fq = _sub8_input_guard(in_fq, in_qt)
    qw = grid(qw_t)
    _qop_weight_zp_check(qw)
    w_int = _np(qw_t.int(), np.float32)  # (out, in)
    w_scale = qw.scale.reshape(-1)
    if w_scale.size > 1:
        wq = torch.quantize_per_channel(
            torch.from_numpy((w_int * w_scale[:, None]).copy()),
            torch.from_numpy(w_scale.astype(np.float64).copy()),
            torch.zeros(w_scale.size, dtype=torch.int64), 0, torch.qint8)
    else:
        wq = torch.quantize_per_tensor(torch.from_numpy((w_int * w_scale).copy()),
                                       float(w_scale[0]), 0, torch.qint8)
    mod = torch.ao.nn.quantized.Linear(layer.in_features, layer.out_features,
                                       bias_=bias is not None)
    mod.set_weight_bias(wq, None if bias is None else bias.cpu())
    mod.scale = y_scale
    mod.zero_point = y_zp

    def run(x):
        xq = torch.quantize_per_tensor(x, x_scale, x_zp, torch.quint8)
        return mod(xq).dequantize()

    # below 8 bits the quantized module clamps to the full uint8 range: the
    # model's own (narrower) fake-quant goes around it
    fn = _chain(sub8_fq, run, out_fq)
    fn._torch_mod = mod  # packed params must be a registered module to trace
    return fn


def _t_qop_conv(layer, in_qt, in_fq, qw_t, w_oihw, bias, out_fq, ctx) -> TorchFn:
    if in_qt is None or layer.output_quant.quant_type == QuantType.NONE:
        raise ValueError("QOp export requires INT input and output "
                         "quantizers (reference StdQOpONNXQuantWBIOLHandler)")
    if layer.spatial_dims != 2:
        raise ValueError("torch QOp conv export supports Conv2d")
    in_qt = grid(in_qt)
    x_scale, x_zp = _quint8_params(in_qt, layer.input_quant.cfg.narrow_range, "inputs")
    out_qt = grid(_probe(layer.output_quant, _probe_out(layer), layer))
    y_scale, y_zp = _quint8_params(out_qt, layer.output_quant.cfg.narrow_range, "outputs")
    sub8_fq = _sub8_input_guard(in_fq, in_qt)
    qw = grid(qw_t)
    _qop_weight_zp_check(qw)
    w_scale = qw.scale.reshape(-1)
    if w_scale.size > 1:
        wq = torch.quantize_per_channel(
            w_oihw, torch.from_numpy(w_scale.astype(np.float64).copy()),
            torch.zeros(w_scale.size, dtype=torch.int64), 0, torch.qint8)
    else:
        wq = torch.quantize_per_tensor(w_oihw, float(w_scale[0]), 0, torch.qint8)
    pads = resolved_padding(layer, ctx["in_sizes"])
    if any(p[0] != p[1] for p in pads):
        raise ValueError("asymmetric conv padding not supported by torch QOp")
    mod = torch.ao.nn.quantized.Conv2d(
        layer.in_channels, layer.out_channels, layer.kernel_size,
        stride=layer.stride, padding=[p[0] for p in pads],
        dilation=layer.dilation, groups=layer.groups, bias=bias is not None)
    mod.set_weight_bias(wq, None if bias is None else bias.cpu())
    mod.scale = y_scale
    mod.zero_point = y_zp

    def run(x):
        xq = torch.quantize_per_tensor(x, x_scale, x_zp, torch.quint8)
        return mod(xq).dequantize()

    fn = _chain(sub8_fq, run, out_fq)
    fn._torch_mod = mod
    return fn


# -- module assembly ----------------------------------------------------------


def _glue_fn(item, saved: Dict[str, object]) -> TorchFn:
    op = item[0]
    if op == "flatten":
        return lambda x: torch.flatten(x, 1)
    if op == "affine":
        _, mul, add = item
        return lambda x: x * float(mul) + float(add)
    if op == "debug":
        name = item[1]

        def probe(x):
            saved["__debug_" + name] = x
            return x

        return probe
    if op == "save":
        name = item[1]

        def save(x):
            saved[name] = x
            return x

        return save
    if op == "load":
        name = item[1]
        return lambda x: saved[name]
    if op == "add_saved":
        name = item[1]
        return lambda x: x + saved[name]
    if op == "relu":
        return torch.relu
    if op == "relu6":
        return lambda x: torch.clamp(x, 0.0, 6.0)
    if op == "concat":
        names = item[1]
        return lambda x: torch.cat([x if n == "@" else saved[n] for n in names], dim=1)
    if op == "maxpool":
        _, k, s, pad = item

        def mp(x):
            if pad == "SAME":
                size_h, size_w = x.shape[2], x.shape[3]
                pads = []
                for size in (size_w, size_h):
                    out = -(-size // s)
                    total = max(0, (out - 1) * s + k - size)
                    pads.extend([total // 2, total - total // 2])
                x = F.pad(x, pads, value=float("-inf"))
            return F.max_pool2d(x, k, s)

        return mp
    if op == "avgpool":
        _, k, s = item
        return lambda x: F.avg_pool2d(x, k, s)
    if op == "gap":
        return lambda x: torch.mean(x, dim=(2, 3), keepdim=True)
    if op == "flatten_hwc":
        return lambda x: torch.flatten(x.permute(0, 2, 3, 1), 1)
    if op == "resize_scale":
        _, sh, sw = item
        return lambda x: F.interpolate(x, scale_factor=(sh, sw), mode="bilinear",
                                       align_corners=False)
    if op == "expand_like":
        name = item[1]
        return lambda x: x.expand(-1, -1, saved[name].shape[2], saved[name].shape[3])
    if op == "expand_hw":
        _, h, w = item
        return lambda x: x.expand(-1, -1, h, w)
    if op == "unflatten2d":
        return lambda x: x.reshape(x.shape[0], -1, 1, 1)
    raise ValueError(f"unknown glue spec {item}")


def build_torch_module(model, example_input, style: str = "qcdq"):
    """The model's torch twin as an eager ``torch.nn.Module`` with its
    constants baked in: on the model's device for QCDQ, on the host for
    QOp."""
    assert style in ("qcdq", "qop")
    model.eval()
    example = example_tensor(model, example_input)
    in_sizes, y_ref = _record_conv_inputs(model, example)
    items, _ = export_items(model, example, y_ref)
    device = example.device if style == "qcdq" else torch.device("cpu")
    ctx = {"device": device, "in_sizes": in_sizes}
    saved: Dict[str, object] = {}
    fns: List[TorchFn] = []
    for item in items:
        if isinstance(item, tuple):
            fns.append(_glue_fn(item, saved))
            continue
        handler = None
        for cls in type(item).__mro__:
            if cls in _T_HANDLERS:
                handler = _T_HANDLERS[cls]
                break
        if handler is None:
            raise ValueError(f"no torch export handler for {type(item).__name__}")
        fns.append(handler(item, style, ctx))

    class _Exported(nn.Module):
        def __init__(self):
            super().__init__()
            # quantized modules carry TorchBind packed params and must be
            # registered submodules for torch.jit.trace to capture them
            self.qmods = nn.ModuleList([f._torch_mod for f in fns if hasattr(f, "_torch_mod")])

        def forward(self, x):
            saved.clear()
            for f in fns:
                x = f(x)
            return x

    return _Exported()


def export_torch_qcdq(model, example_input, path: Optional[str] = None):
    """Trace the QCDQ torch twin to TorchScript on the model's device
    (reference export_torch_qcdq). Returns the ScriptModule; saves it with
    ``torch.jit.save`` when ``path`` is given."""
    mod = build_torch_module(model, example_input, style="qcdq")
    example = example_tensor(model, example_input)
    with torch.no_grad():
        traced = torch.jit.trace(mod, example)
    if path:
        torch.jit.save(traced, path)
    return traced


def export_torch_qop(model, example_input, path: Optional[str] = None):
    """Trace the quantized-op torch twin on the host (reference
    export_torch_qop): the WBIOL layers run as ``torch.ao.nn.quantized``
    modules. Returns the ScriptModule; saves it when ``path`` is given."""
    if torch.backends.quantized.engine == "none":  # pragma: no cover
        for eng in ("fbgemm", "x86", "qnnpack"):
            if eng in torch.backends.quantized.supported_engines:
                torch.backends.quantized.engine = eng
                break
    mod = build_torch_module(model, example_input, style="qop")
    example = example_tensor(model, example_input).cpu()
    with torch.no_grad():
        traced = torch.jit.trace(mod, example)
    if path:
        torch.jit.save(traced, path)
    return traced
