"""The port's exporters (``brevitas_tpu_torch/export/``) against the JAX
package's, byte for byte.

Each model is built in both packages with the same module names; the JAX
models are built under one ``nnx.jit`` (their initializers compile as one
program), calibrated (FC: one training forward) eagerly, and their state
carried into the port's twins with ``load_jax_state``. Then both packages export the
same numbers, and the bytes must be equal: the same node order, the same
initializer names and the same float32 bits in every scale, weight and
bias. The models: LFC's FC with one hidden layer (4 bits), a CNV-like net
(two convs, a max pool, BatchNorm, TensorNorm), ``ptq_calibrate``'s conv
net after the flexml flow (its head flattens in (H, W, C) order), a net of
linears and a conv with input and output quantizers (the QOp dialect's
layers), a ``QuantScaleBias``, and a one-layer ``QuantLSTM`` (QONNX). The
residual, concatenation, average-pool and derivation tests, the three
corrected reference defects and the CLI are in
``tests/test_torch_port_export_derive.py``.

Tolerances, each with its reason:
- ONNX bytes (QCDQ, QONNX, QOp, FINN): equal. Where the JAX package raises
  (QOp of a layer without input or output quantizers, QuantLSTM outside
  QONNX), the port raises the same exception class. ``ptq_calibrate``'s
  conv net has XLA 'SAME' convs, which the JAX exporter refuses; the JAX
  side here exports it with the same pads written out ((0, 1) on each
  spatial axis), which the port resolves from the example (ROADMAP S5);
- the port's interpreter on the JAX package's bytes: JAX's interpreter's
  outputs bit for bit (the same numpy code);
- TorchScript (``export_torch_qcdq`` / ``export_torch_qop``): the port's
  module and the JAX package's give the same bits on the same input; both
  are the same torch ops over the same constants;
- the native artifact: every array equal to JAX's (values, shapes and
  dtypes) and the manifest's entries equal, compared key by key (a model
  built under ``nnx.jit`` lists its modules by name, so JAX's order here is
  alphabetical); the port's ``load_native`` reads JAX's artifact, its
  integer weights the port model's codes;
- the exported graph against the port's own model under the interpreter:
  within 1e-5 of the output's largest magnitude (float32 sums in other
  orders), the QOp graph within one output step.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import brevitas_tpu.export as JE
import brevitas_tpu.graph as JG
import brevitas_tpu.nn as jqnn
from brevitas_tpu.examples.ptq_calibrate import FloatConvNet as JaxConvNet
from brevitas_tpu.export.derive import derive_export_items as jax_derive
from brevitas_tpu.export.interp import run_onnx as jax_run_onnx
from brevitas_tpu.graph.flexml import quantize_flexml as jax_quantize_flexml
from brevitas_tpu.models.common import TensorNorm as JaxTensorNorm
from brevitas_tpu.models.fc import FC as JaxFC
from brevitas_tpu.quant import presets as jp
from brevitas_tpu.utils import eval_mode as jax_eval_mode
from brevitas_tpu_torch import export as PE
from brevitas_tpu_torch import graph as PG
from brevitas_tpu_torch import nn as qnn
from brevitas_tpu_torch.examples.bnn_pynq import load_digits_upscaled
from brevitas_tpu_torch.examples.ptq_calibrate import FloatConvNet
from brevitas_tpu_torch.export.derive import derive_export_items as port_derive
from brevitas_tpu_torch.export.onnx_proto import parse_model
from brevitas_tpu_torch.interop import load_jax_state
from brevitas_tpu_torch.models.common import BatchNorm, TensorNorm
from brevitas_tpu_torch.models.fc import FC
from brevitas_tpu_torch.quant import presets

torch.set_num_threads(1)

OUT_RTOL = 1e-5
ONNX_STYLES = ("qcdq", "qonnx", "qop", "finn")
SAME_PADS = ((0, 1), (0, 1))  # XLA's 'SAME' at stride 2, kernel 3, even input


def jax_state_arrays(model) -> dict:
    return {".".join(map(str, path)): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model)) if path[0] != "rngs"}


def nchw(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2))


def nhwc(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x).transpose(0, 2, 3, 1))


def _randomize_bns(model, rng) -> None:
    for _, bn in JG.find_modules(model, nnx.BatchNorm):
        c = bn.mean[...].shape[0]
        bn.mean[...] = jnp.asarray(rng.normal(0.0, 0.1, c).astype(np.float32))
        bn.var[...] = jnp.asarray(rng.uniform(0.5, 1.5, c).astype(np.float32))
        bn.scale[...] = jnp.asarray(rng.uniform(0.5, 1.5, c).astype(np.float32))
        bn.bias[...] = jnp.asarray(rng.normal(0.0, 0.1, c).astype(np.float32))


def _randomize_tensor_norm(model, rng) -> None:
    for _, tn in JG.find_modules(model, JaxTensorNorm):
        tn.running_mean[...] = jnp.asarray(np.float32(rng.normal(0.0, 0.1)))
        tn.running_var[...] = jnp.asarray(np.float32(rng.uniform(0.5, 1.5)))
        tn.weight[...] = jnp.asarray(np.float32(rng.uniform(0.5, 1.5)))
        tn.bias[...] = jnp.asarray(np.float32(rng.normal(0.0, 0.1)))


def _calibrate(model, xs) -> None:
    with JG.calibration_mode(model):
        for x in xs:
            model(jnp.asarray(x))
    jax_eval_mode(model)


def item_names(items, model, torch_side: bool) -> list:
    """An item list with each module as its path in ``model``."""
    named = (model.named_modules(remove_duplicate=False) if torch_side
             else JG.named_modules(model))
    path = {}
    for p, m in named:
        path.setdefault(id(m), p)
    return [it if isinstance(it, tuple) else path[id(it)] for it in items]


# -- the models, each in both packages ----------------------------------------

W4 = dict(bit_width=4.0)
A4 = dict(bit_width=4.0, collect_stats_steps=2)
A8 = dict(collect_stats_steps=2)


class JaxCnvLike(nnx.Module):
    """Two VALID convs (the second ends at 1 x 1), BatchNorms, 4-bit
    activations, a max pool, a linear head and TensorNorm: CNV's layers."""

    def __init__(self):
        r = nnx.Rngs(0)
        w4 = jp.Int8WeightPerTensorFloat.let(**W4)
        self.inp = jqnn.QuantIdentity(jp.Int8ActPerTensorFloat.let(**A8))
        self.conv1 = jqnn.QuantConv2d(3, 8, 3, padding="VALID", use_bias=False,
                                      weight_quant=w4, rngs=r)
        self.bn1 = nnx.BatchNorm(8, use_running_average=True, rngs=r)
        self.act1 = jqnn.QuantIdentity(jp.Int8ActPerTensorFloat.let(**A4))
        self.pool = jqnn.QuantMaxPool2d(2, 2)
        self.conv2 = jqnn.QuantConv2d(8, 8, 3, padding="VALID", use_bias=False,
                                      weight_quant=w4, rngs=r)
        self.bn2 = nnx.BatchNorm(8, use_running_average=True, rngs=r)
        self.act2 = jqnn.QuantIdentity(jp.Int8ActPerTensorFloat.let(**A4))
        self.fc = jqnn.QuantLinear(8, 4, weight_quant=w4, rngs=r)
        self.norm = JaxTensorNorm()

    def __call__(self, x):
        x = self.act1(self.bn1(self.conv1(self.inp(x))))
        x = self.act2(self.bn2(self.conv2(self.pool(x))))
        return self.norm(self.fc(x.reshape(x.shape[0], -1)))


class CnvLike(torch.nn.Module):
    def __init__(self):
        super().__init__()
        w4 = presets.Int8WeightPerTensorFloat.let(**W4)
        self.inp = qnn.QuantIdentity(presets.Int8ActPerTensorFloat.let(**A8))
        self.conv1 = qnn.QuantConv2d(3, 8, 3, padding="VALID", use_bias=False, weight_quant=w4)
        self.bn1 = BatchNorm(8, channel_axis=1)
        self.act1 = qnn.QuantIdentity(presets.Int8ActPerTensorFloat.let(**A4))
        self.pool = qnn.QuantMaxPool2d(2, 2)
        self.conv2 = qnn.QuantConv2d(8, 8, 3, padding="VALID", use_bias=False, weight_quant=w4)
        self.bn2 = BatchNorm(8, channel_axis=1)
        self.act2 = qnn.QuantIdentity(presets.Int8ActPerTensorFloat.let(**A4))
        self.fc = qnn.QuantLinear(8, 4, weight_quant=w4)
        self.norm = TensorNorm()

    def forward(self, x):
        x = self.act1(self.bn1(self.conv1(self.inp(x))))
        x = self.act2(self.bn2(self.conv2(self.pool(x))))
        return self.norm(self.fc(x.reshape(x.shape[0], -1)))


class JaxQOpNet(nnx.Module):
    """A conv and two linears, each with input and output quantizers (the
    QOp dialect's integer layers), per-channel weights on the conv."""

    def __init__(self):
        r = nnx.Rngs(0)
        a8 = jp.Int8ActPerTensorFloat.let(**A8)
        u8 = jp.Uint8ActPerTensorFloat.let(**A8)
        self.conv = jqnn.QuantConv2d(3, 4, 3, padding=[(1, 1), (1, 1)],
                                     weight_quant=jp.Int8WeightPerChannelFloat,
                                     input_quant=a8, output_quant=a8, rngs=r)
        self.l1 = jqnn.QuantLinear(64, 16, input_quant=a8, output_quant=u8, rngs=r)
        self.l2 = jqnn.QuantLinear(16, 4, use_bias=False, input_quant=u8, output_quant=a8,
                                   rngs=r)

    def export_layers(self):
        return [self.conv, ("flatten_hwc",), self.l1, self.l2]

    def __call__(self, x):
        x = self.conv(x)
        return self.l2(self.l1(x.reshape(x.shape[0], -1)))


class QOpNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        a8 = presets.Int8ActPerTensorFloat.let(**A8)
        u8 = presets.Uint8ActPerTensorFloat.let(**A8)
        self.conv = qnn.QuantConv2d(3, 4, 3, padding=1,
                                    weight_quant=presets.Int8WeightPerChannelFloat,
                                    input_quant=a8, output_quant=a8)
        self.l1 = qnn.QuantLinear(64, 16, input_quant=a8, output_quant=u8)
        self.l2 = qnn.QuantLinear(16, 4, use_bias=False, input_quant=u8, output_quant=a8)

    def export_layers(self):
        return [self.conv, ("flatten_hwc",), self.l1, self.l2]

    def forward(self, x):
        x = self.conv(x)
        return self.l2(self.l1(x.movedim(1, -1).reshape(x.shape[0], -1)))


class JaxScaleBiasNet(nnx.Module):
    """A BatchNorm as ``QuantScaleBias`` (per-channel 8-bit multipliers, an
    Int32 bias on the accumulator scale) between two quantizers."""

    def __init__(self):
        self.inp = jqnn.QuantIdentity(jp.Int8ActPerTensorFloat.let(**A8),
                                      return_quant_tensor=False)
        self.sb = jqnn.QuantScaleBias(4, weight_quant=jp.Int8WeightPerChannelFloat,
                                      bias_quant=jp.Int32Bias,
                                      input_quant=jp.Int8ActPerTensorFloat.let(**A8),
                                      output_quant=jp.Int8ActPerTensorFloat.let(**A8))

    def __call__(self, x):
        return self.sb(self.inp(x))


class ScaleBiasNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.inp = qnn.QuantIdentity(presets.Int8ActPerTensorFloat.let(**A8))
        self.sb = qnn.QuantScaleBias(4, weight_quant=presets.Int8WeightPerChannelFloat,
                                     bias_quant=presets.Int32Bias,
                                     input_quant=presets.Int8ActPerTensorFloat.let(**A8),
                                     output_quant=presets.Int8ActPerTensorFloat.let(**A8),
                                     weight_init=torch.ones(4), channel_axis=1)

    def forward(self, x):
        return self.sb(self.inp(x))


class JaxLstmNet(nnx.Module):
    def __init__(self):
        self.lstm = jqnn.QuantLSTM(4, 6, rngs=nnx.Rngs(0))

    def export_layers(self):
        return [self.lstm]

    def __call__(self, x):
        return self.lstm(x)[0]


class LstmNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lstm = qnn.QuantLSTM(4, 6, device="cpu")

    def export_layers(self):
        return [self.lstm]

    def forward(self, x):
        return self.lstm(x)[0]


def _port_convnet(state: dict):
    m = FloatConvNet()
    PG.merge_batchnorms(m, m.BN_PAIRS)
    PG.quantize_flexml(m, collect_stats_steps=2)
    return load_jax_state(m, state).eval()


def _build_jax(rng) -> dict:
    """Every JAX model, calibrated, with its example input (JAX layout). The
    models are built under one ``nnx.jit``, so that their initializers
    compile as one program (it lists each module's attributes by name)."""
    fc, cnv, conv, qop, sb, lstm = nnx.jit(lambda: (
        JaxFC(weight_bit_width=4, act_bit_width=4, in_bit_width=8, in_features=16,
              out_features=(8,), rngs=nnx.Rngs(0)),
        JaxCnvLike(), JaxConvNet(nnx.Rngs(0)), JaxQOpNet(), JaxScaleBiasNet(),
        JaxLstmNet()))()
    models = {}

    x = rng.uniform(0.0, 1.0, (4, 16)).astype(np.float32)
    fc(jnp.asarray(x))  # one training forward: BatchNorm statistics move
    _randomize_tensor_norm(fc, rng)
    jax_eval_mode(fc)
    models["fc"] = (fc, x)

    _randomize_bns(cnv, rng)
    _randomize_tensor_norm(cnv, rng)
    x = rng.uniform(-1.0, 1.0, (2, 8, 8, 3)).astype(np.float32)
    _calibrate(cnv, [x, x * 0.9])
    models["cnv"] = (cnv, x)

    # the digits as JAX's loader gives them (ROADMAP S19: the same bits)
    x_test = nhwc(load_digits_upscaled("test")[0][:16])
    _randomize_bns(conv, rng)
    JG.preprocess_flexml(conv, x_test[:1], equalize_iterations=2)
    jax_quantize_flexml(conv, collect_stats_steps=2)
    _calibrate(conv, [x_test[:8], x_test[8:16]])
    for layer in (conv.c1, conv.c2):
        layer.padding = SAME_PADS  # JAX's exporter takes no 'SAME'
    models["convnet"] = (conv, x_test[:2])

    x = rng.normal(0.0, 1.0, (2, 4, 4, 3)).astype(np.float32)
    _calibrate(qop, [x, x * 0.9])
    models["qop"] = (qop, x)

    sb.sb.weight[...] = jnp.asarray(rng.uniform(0.5, 1.5, 4).astype(np.float32))
    sb.sb.bias[...] = jnp.asarray(rng.normal(0.0, 0.2, 4).astype(np.float32))
    x = rng.normal(0.0, 1.0, (2, 3, 3, 4)).astype(np.float32)
    _calibrate(sb, [x, x * 0.9])
    models["scale_bias"] = (sb, x)

    x = rng.normal(0.0, 1.0, (2, 3, 4)).astype(np.float32)
    lstm(jnp.asarray(x))  # the activation statistics
    jax_eval_mode(lstm)
    models["lstm"] = (lstm, x)
    return models


PORT_MODELS = {
    "fc": lambda s: load_jax_state(FC(weight_bit_width=4, act_bit_width=4, in_bit_width=8,
                                      in_features=16, out_features=(8,), device="cpu"),
                                   s).eval(),
    "cnv": lambda s: load_jax_state(CnvLike(), s).eval(),
    "convnet": _port_convnet,
    "qop": lambda s: load_jax_state(QOpNet(), s).eval(),
    "scale_bias": lambda s: load_jax_state(ScaleBiasNet(), s).eval(),
    "lstm": lambda s: load_jax_state(LstmNet(), s).eval(),
}
NHWC = {"cnv", "convnet", "qop", "scale_bias"}  # JAX's input is channels-last
DERIVED = ("fc", "cnv", "convnet", "scale_bias")  # no export_layers()


def port_input(name: str, x: np.ndarray) -> np.ndarray:
    return nchw(x) if name in NHWC else x


def _jax_try(fn):
    try:
        return fn()
    except (ValueError, AssertionError, NotImplementedError) as e:
        return e


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    rng = np.random.default_rng(20261019)
    models = _build_jax(rng)
    out = {}
    for name, (m, x) in models.items():
        r = out[name] = {"x": x, "state": jax_state_arrays(m)}
        xj = jnp.asarray(x)
        r["y"] = np.asarray(m(xj))
        for style in ONNX_STYLES:
            r[style] = _jax_try(lambda: JE.export_model(m, xj, style=style))
        if name in DERIVED:
            r["items"] = item_names(jax_derive(m, xj, output_rank=r["y"].ndim), m, False)
        if name in ("fc", "cnv", "qop"):
            r["torch_qcdq"] = JE.export_torch_qcdq(m, xj)
        if name == "qop":
            r["torch_qop"] = JE.export_torch_qop(m, xj)
        if name in ("fc", "cnv", "qop"):
            path = str(tmp_path_factory.mktemp("native") / f"{name}.npz")
            JE.export_native(m, path)
            r["native_path"] = path
            r["native"] = dict(np.load(path))
    return out


@pytest.fixture(scope="module")
def port_models(jax_ref):
    return {name: PORT_MODELS[name](r["state"]) for name, r in jax_ref.items()}


def _diff_report(jb: bytes, pb: bytes) -> str:
    gj, gp = parse_model(jb), parse_model(pb)
    lines = [f"jax ops {[n.op_type for n in gj.nodes]}",
             f"port ops {[n.op_type for n in gp.nodes]}"]
    for k, a in gj.initializers.items():
        b = gp.initializers.get(k)
        if b is None or a.shape != b.shape or a.dtype != b.dtype or not np.array_equal(a, b):
            lines.append(f"{k}: jax {a.shape} {a.dtype} port "
                         f"{None if b is None else (b.shape, b.dtype)}")
    return "\n".join(lines)


# where the JAX package raises: QOp of layers without input quantizers,
# FINN of layers with them, QuantLSTM outside QONNX, and QOp of layers
# without output quantizers (the port exports those, ROADMAP S5)
RAISES = {("fc", "qop"), ("cnv", "qop"), ("convnet", "finn"), ("qop", "finn"),
          ("lstm", "qcdq"), ("lstm", "qop"), ("lstm", "finn")}
PORT_ONLY = {("convnet", "qop")}
CASES = [(name, style) for name in PORT_MODELS for style in ONNX_STYLES
         if (name, style) not in RAISES | PORT_ONLY]


@pytest.mark.parametrize("name,style", CASES)
def test_onnx_bytes_equal_jax(jax_ref, port_models, name, style):
    r = jax_ref[name]
    got = PE.export_model(port_models[name], torch.from_numpy(port_input(name, r["x"])),
                          style=style)
    assert got == r[style], _diff_report(r[style], got)


@pytest.mark.parametrize("name,style", sorted(RAISES))
def test_export_raises_where_jax_raises(jax_ref, port_models, name, style):
    r = jax_ref[name]
    assert isinstance(r[style], ValueError)
    with pytest.raises(ValueError):
        PE.export_model(port_models[name], torch.from_numpy(port_input(name, r["x"])),
                        style=style)


@pytest.mark.parametrize("name", list(PORT_MODELS))
def test_port_model_matches_jax_model(jax_ref, port_models, name):
    """The carried state gives JAX's outputs: the parity the bytes rest on."""
    r = jax_ref[name]
    with torch.no_grad():
        y = port_models[name](torch.from_numpy(port_input(name, r["x"]))).numpy()
    want = r["y"]
    if name in NHWC and want.ndim == 4:
        want = nchw(want)
    np.testing.assert_allclose(y, want, rtol=0, atol=OUT_RTOL * np.abs(want).max())


@pytest.mark.parametrize("name", DERIVED)
def test_derived_items_equal_jax(jax_ref, port_models, name):
    r = jax_ref[name]
    m = port_models[name]
    x = torch.from_numpy(port_input(name, r["x"]))
    items = port_derive(m, x, output_rank=r["y"].ndim)
    assert item_names(items, m, True) == r["items"]


@pytest.mark.parametrize("name,style", [c for c in CASES if c[1] != "finn"]
                         + sorted(PORT_ONLY))
def test_port_graph_reproduces_port_model(jax_ref, port_models, name, style):
    """The exported graph, run by the port's interpreter, gives the port
    model's output: within 1e-5 of its largest magnitude, one output step
    for QOp's requantizing layers. ``ptq_calibrate``'s conv net in QOp (its
    layers have no output quantizer: the JAX package raises) goes through
    ONNX's integer ConvInteger/MatMulInteger."""
    r = jax_ref[name]
    m = port_models[name]
    x = port_input(name, r["x"])
    if (name, style) in PORT_ONLY:
        assert isinstance(r[style], ValueError)
    blob = PE.export_model(m, torch.from_numpy(x), style=style)
    PE.validate_onnx(blob)
    (got,) = PE.run_onnx(blob, {"input": x})
    with torch.no_grad():
        want = m(torch.from_numpy(x)).numpy()
    atol = OUT_RTOL * np.abs(want).max()
    if style == "qop" and name == "qop":
        with torch.no_grad():
            atol = float(m.l2.output_quant(torch.zeros(1, 4)).scale) * 1.0001
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("name,style", CASES)
def test_port_interpreter_runs_jax_bytes(jax_ref, name, style):
    """The port's validator accepts the JAX package's bytes, and its
    interpreter gives JAX's interpreter's outputs on them."""
    r = jax_ref[name]
    blob = r[style]
    PE.validate_onnx(blob)
    feed = {"input": port_input(name, r["x"]).astype(np.float32)}
    (got,) = PE.run_onnx(blob, feed)
    (want,) = jax_run_onnx(blob, feed)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["fc", "cnv", "qop"])
def test_torch_qcdq_equals_jax_module(jax_ref, port_models, name):
    r = jax_ref[name]
    x = torch.from_numpy(port_input(name, r["x"]))
    ts = PE.export_torch_qcdq(port_models[name], x)
    with torch.no_grad():
        got = ts(x)
        want = r["torch_qcdq"](x)
        model_y = port_models[name](x)
    assert torch.equal(got, want)
    # and the artifact is the model (JAX's test_torch_export bound)
    np.testing.assert_allclose(got.numpy(), model_y.numpy(), rtol=1e-5, atol=1e-5)


def test_torch_qop_equals_jax_module(jax_ref, port_models):
    r = jax_ref["qop"]
    x = torch.from_numpy(port_input("qop", r["x"]))
    ts = PE.export_torch_qop(port_models["qop"], x)
    with torch.no_grad():
        assert torch.equal(ts(x), r["torch_qop"](x))


@pytest.mark.parametrize("name", ["fc", "cnv"])
def test_torch_qop_raises_as_jax(port_models, jax_ref, name):
    """Layers without input and output quantizers have no QOp form in
    either package's TorchScript exporter."""
    x = torch.from_numpy(port_input(name, jax_ref[name]["x"]))
    with pytest.raises(ValueError):
        PE.export_torch_qop(port_models[name], x)


@pytest.mark.parametrize("name", ["fc", "cnv", "qop"])
def test_native_artifact_equals_jax(jax_ref, port_models, name, tmp_path):
    r = jax_ref[name]
    path = str(tmp_path / "port.npz")
    info = PE.export_native(port_models[name], path)
    got = dict(np.load(path))
    want = r["native"]
    # the JAX models were built under nnx.jit, which lists their modules by
    # name: the artifacts are compared key by key, the manifests by path
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "__manifest__":
            continue
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    def entries(a):
        return sorted(json.loads(bytes(a).decode()), key=lambda e: e["path"])

    assert entries(got["__manifest__"]) == entries(want["__manifest__"])
    assert info["layers"] == len(PE.load_native(r["native_path"]))


@pytest.mark.parametrize("name", ["fc", "cnv", "qop"])
def test_load_native_reads_jax_artifact(jax_ref, port_models, name):
    """The port reads JAX's artifact; its integer weights are the port
    model's codes in the JAX layout."""
    loaded = PE.load_native(jax_ref[name]["native_path"])
    m = port_models[name]
    assert loaded
    for path, entry in loaded.items():
        layer = m.get_submodule(path)
        codes = layer.quant_weight().int().numpy().astype(np.int64)
        codes = codes.T if codes.ndim == 2 else codes.transpose(2, 3, 1, 0)
        np.testing.assert_array_equal(entry["w_int"].astype(np.int64), codes)
