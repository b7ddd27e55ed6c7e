"""Numpy interpreter for exported ONNX graphs, the test oracle (the port's
own copy of ``brevitas_tpu/export/interp.py``).

The reference validates exports against onnxruntime
(``tests/brevitas_ort/common.py:37``); the port does not depend on onnxruntime, so this
module executes the exact op subset the exporter emits, with ONNX-faithful
semantics (QuantizeLinear round-half-to-even + saturate, per-axis support,
NCHW convolutions). Also interprets the QONNX custom ``Quant`` op. The
port's copy adds ``MatMulInteger`` and ``ConvInteger`` (exact int32
accumulators), which its QOp export emits for a layer without an output
quantizer.
"""

from typing import Callable, Dict, List, Optional

import numpy as np

from brevitas_tpu_torch.export.onnx_proto import _ONNX_TO_NP, OnnxGraph, parse_model


def _quantize_linear(x, scale, zp, axis: Optional[int]):
    if scale.ndim == 1 and axis is not None:
        shape = [1] * x.ndim
        shape[axis] = scale.size
        scale = scale.reshape(shape)
        zp_r = zp.reshape(shape)
    else:
        zp_r = zp
    q = np.round(x / scale).astype(np.int64) + zp_r.astype(np.int64)
    info = np.iinfo(zp.dtype)
    return np.clip(q, info.min, info.max).astype(zp.dtype)


def _dequantize_linear(q, scale, zp, axis: Optional[int]):
    if scale.ndim == 1 and axis is not None:
        shape = [1] * q.ndim
        shape[axis] = scale.size
        scale = scale.reshape(shape)
        zp = zp.reshape(shape)
    return (q.astype(np.float32) - zp.astype(np.float32)) * scale


def _conv(x, w, b, strides, pads, dilations, group):
    n, cin, *ish = x.shape
    cout, cin_g, *ksh = w.shape
    spatial = len(ksh)
    pad_width = [(0, 0), (0, 0)] + [
        (pads[i], pads[i + spatial]) for i in range(spatial)]
    xp = np.pad(x, pad_width)
    osh = [
        (xp.shape[2 + i] - dilations[i] * (ksh[i] - 1) - 1) // strides[i] + 1
        for i in range(spatial)]
    out = np.zeros((n, cout, *osh), np.result_type(x.dtype, w.dtype, np.float32))
    cig = cin // group
    cog = cout // group
    for g in range(group):
        xs = xp[:, g * cig:(g + 1) * cig]
        ws = w[g * cog:(g + 1) * cog]
        # im2col-free direct loop over kernel positions (test-scale sizes)
        for idx in np.ndindex(*ksh):
            slices = tuple(
                slice(idx[i] * dilations[i],
                      idx[i] * dilations[i] + strides[i] * osh[i], strides[i])
                for i in range(spatial))
            patch = xs[(slice(None), slice(None)) + slices]
            out[:, g * cog:(g + 1) * cog] += np.einsum(
                "nc...,oc->no...", patch, ws[(slice(None), slice(None)) + idx])
    if b is not None:
        out += b.reshape(1, -1, *([1] * spatial))
    return out


def _conv_transpose(x, w, b, strides, pads, dilations):
    """ONNX ConvTranspose (group=1): scatter-add each kernel tap; ``pads``
    crop the output (torch semantics)."""
    n, cin, *ish = x.shape
    cin_w, cout, *ksh = w.shape
    spatial = len(ksh)
    full = [(ish[i] - 1) * strides[i] + dilations[i] * (ksh[i] - 1) + 1
            for i in range(spatial)]
    out = np.zeros((n, cout, *full), np.result_type(x.dtype, w.dtype, np.float32))
    for idx in np.ndindex(*ksh):
        slices = tuple(
            slice(idx[i] * dilations[i],
                  idx[i] * dilations[i] + strides[i] * ish[i], strides[i])
            for i in range(spatial))
        out[(slice(None), slice(None)) + slices] += np.einsum(
            "nc...,co->no...", x, w[(slice(None), slice(None)) + idx])
    crop = tuple(slice(pads[i], full[i] - pads[i + spatial])
                 for i in range(spatial))
    out = out[(slice(None), slice(None)) + crop]
    if b is not None:
        out = out + b.reshape(1, -1, *([1] * spatial))
    return out


def _pool(x, kernel, strides, op, auto_pad=None):
    n, c, h, w = x.shape
    kh, kw = kernel
    sh, sw = strides
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        # SAME_UPPER places the extra pad at the end (lax 'SAME' convention);
        # max pooling pads with -inf so padding never wins
        def pad_amounts(size, k, s):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            lo = total // 2 if auto_pad == "SAME_UPPER" else -(-total // 2)
            return lo, total - lo
        ph = pad_amounts(h, kh, sh)
        pw = pad_amounts(w, kw, sw)
        fill = -np.inf if op == "max" else 0.0
        x = np.pad(x, [(0, 0), (0, 0), ph, pw], constant_values=fill)
        n, c, h, w = x.shape
    oh = (h - kh) // sh + 1
    ow = (w - kw) // sw + 1
    out = np.empty((n, c, oh, ow), x.dtype)
    for i in range(oh):
        for j in range(ow):
            win = x[:, :, i * sh:i * sh + kh, j * sw:j * sw + kw]
            out[:, :, i, j] = win.max((2, 3)) if op == "max" else win.mean((2, 3))
    return out


def _resize_linear_axis(x, axis, scale):
    """1-D linear interpolation along ``axis`` with ONNX half_pixel
    coordinates (matches jax.image.resize bilinear for upsampling)."""
    n_in = x.shape[axis]
    n_out = int(round(n_in * scale))
    src = (np.arange(n_out) + 0.5) / scale - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = (src - lo).astype(np.float32)
    lo0 = np.clip(lo, 0, n_in - 1)
    lo1 = np.clip(lo + 1, 0, n_in - 1)
    a = np.take(x, lo0, axis=axis)
    b = np.take(x, lo1, axis=axis)
    shape = [1] * x.ndim
    shape[axis] = n_out
    frac = frac.reshape(shape)
    return a * (1.0 - frac) + b * frac


def _quant_lstm_layer(x, w_ih, w_hh, bias, a):
    """QONNX custom QuantLSTMLayer: the quantized recurrence with per-act
    fake-quant from the node's attrs (exporter counterpart of the reference
    BrevitasQuantLSTMCellFn)."""

    def q(v, p):
        bw = a.get(p + "_bw", 0)
        if not bw:
            return v
        scale, zp = a[p + "_scale"], a[p + "_zp"]
        signed, narrow = bool(a[p + "_signed"]), bool(a[p + "_narrow"])
        lo = (-(2 ** (bw - 1)) + (1 if narrow else 0)) if signed else 0.0
        hi = (2 ** (bw - 1) - 1) if signed else (2 ** bw - 1 - (1 if narrow else 0))
        qv = np.clip(np.round(v / scale + zp), lo, hi)
        return ((qv - zp) * scale).astype(np.float32)

    xp = x @ w_ih
    if bias is not None:
        xp = xp + bias
    if a.get("reverse"):
        xp = xp[:, ::-1]
    n, t, _ = xp.shape
    hs = a["hidden_size"]
    h = np.zeros((n, hs), np.float32)
    c = np.zeros((n, hs), np.float32)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    cifg = bool(a.get("cifg", 0))

    def acc_q(v, prefix):
        # per-gate accumulator attrs (forget_acc/cell_acc/out_acc) with
        # fallback to the shared/legacy gate_acc attrs
        return q(v, prefix if (prefix + "_bw") in a else "gate_acc")

    ys = []
    for step in range(t):
        gates = xp[:, step] + h @ w_hh
        if cifg:
            i_g, g_g, o_g = np.split(gates, 3, axis=-1)
        else:
            i_g, f_g, g_g, o_g = np.split(gates, 4, axis=-1)
        i_t = q(sig(acc_q(i_g, "gate_acc")), "in_sigmoid")
        if cifg:
            # forget = quantized(1) - input gate (ONNXRuntime CIFG law)
            f_t = q(np.ones_like(i_t), "in_sigmoid") - i_t
        else:
            f_t = q(sig(acc_q(f_g, "forget_acc")), "forget_sigmoid")
        g_t = q(np.tanh(acc_q(g_g, "cell_acc")), "cell_tanh")
        o_t = q(sig(acc_q(o_g, "out_acc")), "out_sigmoid")
        c = q(f_t * c + i_t * g_t, "cell_state")
        h = q(o_t * q(np.tanh(c), "hidden_tanh"), "hidden_state")
        ys.append(h)
    y = np.stack(ys, axis=1)
    if a.get("reverse"):
        y = y[:, ::-1]
    return y


def _qlinear_out(acc, x_s, w_s, y_s, y_zp, channel_axis: int):
    """Requantize an integer accumulator: acc * (x_s*w_s) / y_s + y_zp,
    rounded half-to-even and saturated to the zero-point dtype."""
    w_s = np.asarray(w_s, np.float64).reshape(-1)
    if w_s.size > 1:
        shape = [1] * acc.ndim
        shape[channel_axis] = w_s.size
        w_s = w_s.reshape(shape)
    scale = np.asarray(x_s, np.float64).reshape(()) * w_s / \
        np.asarray(y_s, np.float64).reshape(())
    y = np.round(acc * scale) + np.asarray(y_zp, np.float64).reshape(())
    info = np.iinfo(y_zp.dtype)
    return np.clip(y, info.min, info.max).astype(y_zp.dtype)


def run_onnx(model_bytes: bytes, inputs: Dict[str, np.ndarray],
             extra_outputs: Optional[List[str]] = None,
             on_output: Optional[Callable] = None) -> List[np.ndarray]:
    """Execute the graph; returns the declared outputs, then any
    ``extra_outputs`` (debug-marker probe names). ``on_output(node, value,
    env)``, where given, sees each node's output (``env`` maps every tensor
    computed so far by name) and returns the value the rest of the graph
    reads: a check can hold the graph's activations against a model's, node
    by node, and go on from the model's."""
    g: OnnxGraph = parse_model(model_bytes)
    env: Dict[str, np.ndarray] = dict(g.initializers)
    env.update({k: np.asarray(v) for k, v in inputs.items()})

    for n in g.nodes:
        i = [env[name] for name in n.inputs if name]
        a = n.attrs
        if n.op_type == "QuantizeLinear":
            out = _quantize_linear(i[0], i[1], i[2], a.get("axis"))
        elif n.op_type == "DequantizeLinear":
            out = _dequantize_linear(i[0], i[1], i[2], a.get("axis"))
        elif n.op_type == "Clip":
            out = np.clip(i[0], i[1], i[2])
        elif n.op_type == "BipolarQuant":  # QONNX custom op: sign(x)*scale
            x, scale = i
            out = np.where(x >= 0, 1.0, -1.0).astype(np.float32) * scale
        elif n.op_type == "Quant":  # QONNX custom op
            x, scale, zp, bw = i
            signed, narrow = bool(a["signed"]), bool(a["narrow"])
            bw = float(np.asarray(bw).reshape(-1)[0])
            lo = (-(2 ** (bw - 1)) + (1 if narrow else 0)) if signed else 0.0
            hi = (2 ** (bw - 1) - 1) if signed else (2**bw - 1 - (1 if narrow else 0))
            q = np.clip(np.round(x / scale + zp), lo, hi)
            out = ((q - zp) * scale).astype(np.float32)
        elif n.op_type == "Trunc":  # QONNX custom op (reference
            # BrevitasTruncFn, export/onnx/qonnx/function.py:54-72):
            # integer-domain LSB drop — y_int = round(x/s + zp), then
            # floor(y_int / 2^(ibw-obw)), output at the INPUT scale
            # (matches core/quant.py trunc_int_quant with FLOOR)
            x, scale, zp, ibw, obw = i
            mode = a.get("rounding_mode", "FLOOR")
            mode = mode.decode() if isinstance(mode, bytes) else mode
            shift = 2.0 ** (float(np.asarray(ibw).reshape(-1)[0])
                            - float(np.asarray(obw).reshape(-1)[0]))
            y = np.round(x / scale + zp) / shift
            y = np.floor(y) if mode == "FLOOR" else np.round(y)
            out = ((y - zp) * scale).astype(np.float32)
        elif n.op_type == "Floor":
            out = np.floor(i[0])
        elif n.op_type == "MultiThreshold":
            # FINN custom op (finn.custom_op.general): per-channel threshold
            # counting — y[.., c, ..] = Σ_t [x >= T[c, t]] — optionally
            # affine-mapped by out_scale/out_bias attrs (BIPOLAR form)
            x, thr = i
            if x.ndim >= 2:
                # channel axis 1 (NCHW / NC); thresholds (C, T) or (1, T)
                tshape = (1, thr.shape[0]) + (1,) * (x.ndim - 2) + \
                    (thr.shape[1],)
                cnt = (x[..., None] >= thr.reshape(tshape)).sum(-1)
            else:
                cnt = (x[..., None] >= thr.reshape(-1)).sum(-1)
            out = cnt.astype(np.float32)
            if "out_scale" in a or "out_bias" in a:
                out = out * np.float32(a.get("out_scale", 1.0)) + \
                    np.float32(a.get("out_bias", 0.0))
        elif n.op_type == "QuantAvgPool2d":
            # FINN custom op: integer-domain average pool as a truncated
            # accumulator — sum over the window, drop LSBs down to obits
            # (matches nn/pool.py QuantAvgPool2d with FLOOR trunc)
            x = i[0]
            k, s = int(a["kernel"]), int(a["stride"])
            summed = _pool(x, (k, k), (s, s), "avg") * (k * k)
            acc_bits = int(a["ibits"]) + int(np.ceil(np.log2(k * k)))
            shift = 2.0 ** (acc_bits - int(a["obits"]))
            out = np.floor(np.round(summed) / shift).astype(np.float32)
        elif n.op_type == "MatMul":
            out = i[0] @ i[1]
        elif n.op_type == "Add":
            out = i[0] + i[1]
        elif n.op_type == "Mul":
            out = i[0] * i[1]
        elif n.op_type == "Div":
            out = i[0] / i[1]
        elif n.op_type == "Relu":
            out = np.maximum(i[0], 0)
        elif n.op_type == "Sigmoid":
            out = 1.0 / (1.0 + np.exp(-i[0]))
        elif n.op_type == "Tanh":
            out = np.tanh(i[0])
        elif n.op_type == "Conv":
            out = _conv(i[0], i[1], i[2] if len(i) > 2 else None,
                        a.get("strides", [1, 1]), a.get("pads", [0, 0, 0, 0]),
                        a.get("dilations", [1, 1]), a.get("group", 1))
        elif n.op_type == "ConvTranspose":
            spatial = i[0].ndim - 2
            out = _conv_transpose(
                i[0], i[1], i[2] if len(i) > 2 else None,
                a.get("strides", [1] * spatial),
                a.get("pads", [0] * (2 * spatial)),
                a.get("dilations", [1] * spatial))
        elif n.op_type == "MaxPool":
            out = _pool(i[0], a["kernel_shape"], a["strides"], "max",
                        auto_pad=a.get("auto_pad"))
        elif n.op_type == "AveragePool":
            out = _pool(i[0], a["kernel_shape"], a["strides"], "avg",
                        auto_pad=a.get("auto_pad"))
        elif n.op_type == "GlobalAveragePool":
            out = i[0].mean(axis=tuple(range(2, i[0].ndim)), keepdims=True)
        elif n.op_type == "Transpose":
            out = np.transpose(i[0], a["perm"])
        elif n.op_type == "Resize":
            x_r, scales = i[0], np.asarray(i[1], np.float64).reshape(-1)
            mode = a.get("mode", "nearest")
            out = x_r
            if mode == "linear":
                for ax, s in enumerate(scales):
                    if s != 1.0:
                        out = _resize_linear_axis(out, ax, float(s))
            elif mode == "nearest":
                # integer-factor asymmetric nearest = repeat along the axis
                for ax, s in enumerate(scales):
                    if s != 1.0:
                        assert s == int(s) and s > 0, (ax, s)
                        out = np.repeat(out, int(s), axis=ax)
            else:
                raise AssertionError(f"unsupported Resize mode {mode}")
        elif n.op_type == "Shape":
            out = np.asarray(i[0].shape, np.int64)
        elif n.op_type == "Expand":
            target = tuple(int(v) for v in i[1].tolist())
            out = np.broadcast_to(
                i[0], np.broadcast_shapes(i[0].shape, target)).copy()
        elif n.op_type == "BatchNormalization":
            x, scale, bias, mean, var = i
            shape = [1, -1] + [1] * (x.ndim - 2)
            out = ((x - mean.reshape(shape))
                   / np.sqrt(var.reshape(shape) + a.get("epsilon", 1e-5))
                   * scale.reshape(shape) + bias.reshape(shape))
        elif n.op_type == "Flatten":
            out = i[0].reshape(i[0].shape[0], -1)
        elif n.op_type == "Reshape":
            out = i[0].reshape([i[0].shape[d] if s == 0 else s
                                for d, s in enumerate(i[1].tolist())])
        elif n.op_type == "QLinearConv":
            x_q, x_s, x_z, w_q, w_s, w_z, y_s, y_z = i[:8]
            bias = i[8] if len(i) > 8 else None
            x_c = x_q.astype(np.int64) - np.asarray(x_z, np.int64).reshape(())
            w_c = w_q.astype(np.int64) - (
                np.asarray(w_z, np.int64).reshape(-1).reshape(
                    (-1,) + (1,) * (w_q.ndim - 1))
                if np.asarray(w_z).size > 1
                else np.asarray(w_z, np.int64).reshape(()))
            spatial = x_q.ndim - 2
            acc = _conv(x_c.astype(np.float64), w_c.astype(np.float64), None,
                        a.get("strides", [1] * spatial),
                        a.get("pads", [0] * (2 * spatial)),
                        a.get("dilations", [1] * spatial), a.get("group", 1))
            if bias is not None:
                acc = acc + bias.astype(np.float64).reshape(
                    (1, -1) + (1,) * spatial)
            out = _qlinear_out(acc, x_s, w_s, y_s, y_z, channel_axis=1)
        elif n.op_type == "QLinearMatMul":
            x_q, x_s, x_z, w_q, w_s, w_z, y_s, y_z = i
            x_c = x_q.astype(np.int64) - np.asarray(x_z, np.int64).reshape(())
            w_c = w_q.astype(np.int64) - (
                np.asarray(w_z, np.int64).reshape(1, -1)
                if np.asarray(w_z).size > 1
                else np.asarray(w_z, np.int64).reshape(()))
            out = _qlinear_out(x_c @ w_c, x_s, w_s, y_s, y_z,
                               channel_axis=x_q.ndim - 1)
        elif n.op_type == "MatMulInteger":
            a_q, b_q = i[0], i[1]
            a_z = np.asarray(i[2], np.int64) if len(i) > 2 else np.int64(0)
            b_z = np.asarray(i[3], np.int64) if len(i) > 3 else np.int64(0)
            out = ((a_q.astype(np.int64) - a_z) @ (b_q.astype(np.int64) - b_z)).astype(np.int32)
        elif n.op_type == "ConvInteger":
            x_q, w_q = i[0], i[1]
            x_z = np.asarray(i[2], np.int64).reshape(()) if len(i) > 2 else np.int64(0)
            w_z = (np.asarray(i[3], np.int64).reshape((-1,) + (1,) * (w_q.ndim - 1))
                   if len(i) > 3 and np.asarray(i[3]).size > 1
                   else (np.asarray(i[3], np.int64).reshape(()) if len(i) > 3
                         else np.int64(0)))
            spatial = x_q.ndim - 2
            acc = _conv((x_q.astype(np.int64) - x_z).astype(np.float64),
                        (w_q.astype(np.int64) - w_z).astype(np.float64), None,
                        a.get("strides", [1] * spatial), a.get("pads", [0] * (2 * spatial)),
                        a.get("dilations", [1] * spatial), a.get("group", 1))
            out = acc.astype(np.int32)
        elif n.op_type == "Concat":
            out = np.concatenate(i, axis=a["axis"])
        elif n.op_type == "QuantLSTMLayer":
            out = _quant_lstm_layer(i[0], i[1], i[2],
                                    i[3] if len(i) > 3 else None, a)
        elif n.op_type == "Identity":
            out = i[0]
        # ---- ops emitted by EXTERNAL producers (torch.onnx.export of the
        # reference, consumed as the independent-producer oracle) ----------
        elif n.op_type == "Constant":
            out = np.asarray(a["value"])
        elif n.op_type == "Gemm":
            x, w = i[0], i[1]
            if int(a.get("transA", 0)):
                x = x.T
            if int(a.get("transB", 0)):
                w = w.T
            out = float(a.get("alpha", 1.0)) * (x @ w)
            if len(i) > 2:
                out = out + float(a.get("beta", 1.0)) * i[2]
        elif n.op_type == "Cast":
            out = i[0].astype(_ONNX_TO_NP[int(a["to"])])
        elif n.op_type == "Unsqueeze":
            axes = (np.asarray(i[1], np.int64).reshape(-1).tolist()
                    if len(i) > 1 else list(a.get("axes", [])))
            out = i[0]
            for ax in sorted(axes):
                out = np.expand_dims(out, int(ax))
        elif n.op_type == "Squeeze":
            axes = (np.asarray(i[1], np.int64).reshape(-1).tolist()
                    if len(i) > 1 else list(a.get("axes", [])))
            out = np.squeeze(i[0], axis=tuple(int(ax) for ax in axes)) \
                if axes else np.squeeze(i[0])
        elif n.op_type == "Sub":
            out = i[0] - i[1]
        elif n.op_type == "Pow":
            out = np.power(i[0], i[1])
        elif n.op_type == "Sqrt":
            out = np.sqrt(i[0])
        elif n.op_type == "Neg":
            out = -i[0]
        elif n.op_type == "Exp":
            out = np.exp(i[0])
        elif n.op_type in ("ReduceMean", "ReduceSum"):
            axes = (tuple(np.asarray(i[1], np.int64).reshape(-1).tolist())
                    if len(i) > 1 else tuple(a.get("axes", ())) or None)
            fn = np.mean if n.op_type == "ReduceMean" else np.sum
            out = fn(i[0], axis=axes, keepdims=bool(a.get("keepdims", 1)))
        else:
            raise NotImplementedError(f"op {n.op_type}")
        env[n.outputs[0]] = np.asarray(out, dtype=np.float32) \
            if n.op_type not in ("QuantizeLinear", "Clip", "Reshape", "Shape",
                                 "Constant", "Cast", "Unsqueeze", "Squeeze",
                                 "QLinearConv", "QLinearMatMul", "MatMulInteger",
                                 "ConvInteger") else out
        if on_output is not None:
            env[n.outputs[0]] = on_output(n, env[n.outputs[0]], env)

    return [env[name] for name in g.outputs] + \
        [env[name] for name in (extra_outputs or [])]
