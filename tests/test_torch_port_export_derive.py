"""The port's export derivation (``export/derive.py`` on
``graph.autograph``'s ``per_call`` trace) against the JAX package's, the
three reference defects the port corrects, and ``ptq_calibrate --export``.

The JAX models are ``tests/test_export_derive.py``'s (a residual block
whose shared quantizer is called three times, a channel concatenation, a
relu6 clip, a scalar affine prologue) and an 8-bit truncating average pool,
each with a port twin of the same module names; all are built under one
``nnx.jit``, calibrated eagerly, and their state carried into the port
with ``load_jax_state``.

Tolerances, each with its reason:
- derived item lists: equal, each module named by its path;
- ONNX bytes: equal to JAX's for the same state;
- the exported graph against the port's model under the interpreter:
  within 1e-5 of the output's largest magnitude (float32 sums in another
  order); a model JAX cannot derive raises in both packages;
- the three defects of the JAX exporter (ROADMAP S5): the port's graph
  gives its model's output within the same 1e-5, or the port refuses with
  an error where JAX writes a wrong graph; JAX's graph misses JAX's model
  by at least one activation step each time;
- the CLI: the written file validates, its interpreted accuracy on the 360
  test digits is the run's ``ptq_acc``, and its outputs are the model's
  within 1e-5 of their largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import brevitas_tpu.export as JE
import brevitas_tpu.graph as JG
import brevitas_tpu.nn as jqnn
from brevitas_tpu.export.derive import DeriveError as JaxDeriveError
from brevitas_tpu.export.derive import derive_export_items as jax_derive
from brevitas_tpu.export.qcdq import ExportValidationError as JaxExportValidationError
from brevitas_tpu.quant import presets as jp
from brevitas_tpu.utils import eval_mode as jax_eval_mode
from brevitas_tpu_torch import export as PE
from brevitas_tpu_torch import nn as qnn
from brevitas_tpu_torch.examples import ptq_calibrate as cli
from brevitas_tpu_torch.export.derive import DeriveError, derive_export_items
from brevitas_tpu_torch.export.qcdq import ExportValidationError
from brevitas_tpu_torch.graph.autograph import trace_module_graph
from brevitas_tpu_torch.interop import load_jax_state
from brevitas_tpu_torch.quant import presets

torch.set_num_threads(1)

OUT_RTOL = 1e-5
PAD1 = [(1, 1), (1, 1)]


def jax_state_arrays(model) -> dict:
    return {".".join(map(str, path)): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model)) if path[0] != "rngs"}


def nchw(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2))


def item_names(items, model, torch_side: bool) -> list:
    named = (model.named_modules(remove_duplicate=False) if torch_side
             else JG.named_modules(model))
    path = {}
    for p, m in named:
        path.setdefault(id(m), p)
    return [it if isinstance(it, tuple) else path[id(it)] for it in items]


def _jw8():
    return jp.Int8WeightPerTensorFloat


def _ja8(**kw):
    return jp.Int8ActPerTensorFloat.let(collect_stats_steps=2, **kw)


def _pa8(**kw):
    return presets.Int8ActPerTensorFloat.let(collect_stats_steps=2, **kw)


# -- the models, each in both packages ----------------------------------------


class JaxResidualNet(nnx.Module):
    """conv -> relu -> conv -> + skip (a shared quantizer called three
    times) -> relu -> mean -> linear (tests/test_export_derive.py)."""

    def __init__(self):
        r = nnx.Rngs(0)
        self.inp = jqnn.QuantIdentity(_ja8())
        self.stem = jqnn.QuantConv2d(3, 8, 3, padding=PAD1, weight_quant=_jw8(), rngs=r)
        self.conv1 = jqnn.QuantConv2d(8, 8, 3, padding=PAD1, weight_quant=_jw8(), rngs=r)
        self.conv2 = jqnn.QuantConv2d(8, 8, 3, padding=PAD1, weight_quant=_jw8(), rngs=r)
        self.shared = jqnn.QuantIdentity(_ja8())
        self.fc = jqnn.QuantLinear(8, 4, weight_quant=_jw8(), rngs=r)

    def __call__(self, x):
        x = self.stem(self.inp(x))
        y = self.conv2(jax.nn.relu(self.conv1(x)))
        out = self.shared(self.shared(y) + self.shared(x))
        return self.fc(jnp.mean(jax.nn.relu(out), axis=(1, 2)))


class ResidualNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        w8 = presets.Int8WeightPerTensorFloat
        self.inp = qnn.QuantIdentity(_pa8())
        self.stem = qnn.QuantConv2d(3, 8, 3, padding=1, weight_quant=w8)
        self.conv1 = qnn.QuantConv2d(8, 8, 3, padding=1, weight_quant=w8)
        self.conv2 = qnn.QuantConv2d(8, 8, 3, padding=1, weight_quant=w8)
        self.shared = qnn.QuantIdentity(_pa8())
        self.fc = qnn.QuantLinear(8, 4, weight_quant=w8)

    def forward(self, x):
        x = self.stem(self.inp(x))
        y = self.conv2(torch.relu(self.conv1(x)))
        out = self.shared(self.shared(y) + self.shared(x))
        return self.fc(torch.relu(out).mean((2, 3)))


class JaxConcatNet(nnx.Module):
    """Two branches joined on channels (tests/test_export_derive.py)."""

    def __init__(self):
        r = nnx.Rngs(0)
        self.inp = jqnn.QuantIdentity(_ja8())
        self.a = jqnn.QuantConv2d(3, 4, 3, padding=PAD1, weight_quant=_jw8(), rngs=r)
        self.b = jqnn.QuantConv2d(3, 6, 1, padding="VALID", weight_quant=_jw8(), rngs=r)
        self.head = jqnn.QuantConv2d(10, 5, 1, padding="VALID", weight_quant=_jw8(), rngs=r)

    def __call__(self, x):
        x = self.inp(x)
        return self.head(jnp.concatenate(
            [jax.nn.relu(self.a(x)), jax.nn.relu(self.b(x))], axis=-1))


class ConcatNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        w8 = presets.Int8WeightPerTensorFloat
        self.inp = qnn.QuantIdentity(_pa8())
        self.a = qnn.QuantConv2d(3, 4, 3, padding=1, weight_quant=w8)
        self.b = qnn.QuantConv2d(3, 6, 1, padding="VALID", weight_quant=w8)
        self.head = qnn.QuantConv2d(10, 5, 1, padding="VALID", weight_quant=w8)

    def forward(self, x):
        x = self.inp(x)
        return self.head(torch.cat([torch.relu(self.a(x)), torch.relu(self.b(x))], 1))


class JaxPoolNet(nnx.Module):
    """An input quantizer's grid into a truncating 2 x 2 average pool
    (``TruncTo8bit``), then a 1 x 1 conv. ``bits`` 8: the pool's
    truncation T = 4; 4: T = 1/4 (the first defect's case)."""

    def __init__(self, bits=8.0):
        self.inp = jqnn.QuantIdentity(_ja8(bit_width=bits), return_quant_tensor=True)
        self.pool = jqnn.QuantAvgPool2d(2)
        self.conv = jqnn.QuantConv2d(3, 4, 1, padding="VALID", weight_quant=_jw8(),
                                     rngs=nnx.Rngs(0))

    def __call__(self, x):
        return self.conv(self.pool(self.inp(x)))


class PoolNet(torch.nn.Module):
    def __init__(self, bits=8.0):
        super().__init__()
        self.inp = qnn.QuantIdentity(_pa8(bit_width=bits), return_quant_tensor=True)
        self.pool = qnn.QuantAvgPool2d(2)
        self.conv = qnn.QuantConv2d(3, 4, 1, padding="VALID",
                                    weight_quant=presets.Int8WeightPerTensorFloat)

    def forward(self, x):
        return self.conv(self.pool(self.inp(x)))


class JaxConvPoolNet(nnx.Module):
    """A conv's output grid straight into a truncating average pool (the
    second defect's case); ``act`` puts an activation quantizer between."""

    def __init__(self, act=False):
        self.inp = jqnn.QuantIdentity(_ja8(), return_quant_tensor=True)
        self.conv = jqnn.QuantConv2d(3, 4, 1, padding="VALID", use_bias=False,
                                     weight_quant=_jw8(), return_quant_tensor=True,
                                     rngs=nnx.Rngs(0))
        self.act = jqnn.QuantIdentity(_ja8(), return_quant_tensor=True) if act else None
        self.pool = jqnn.QuantAvgPool2d(2)

    def __call__(self, x):
        y = self.conv(self.inp(x))
        return self.pool(self.act(y) if self.act is not None else y)


class ConvPoolNet(torch.nn.Module):
    def __init__(self, act=False):
        super().__init__()
        self.inp = qnn.QuantIdentity(_pa8(), return_quant_tensor=True)
        self.conv = qnn.QuantConv2d(3, 4, 1, padding="VALID", use_bias=False,
                                    weight_quant=presets.Int8WeightPerTensorFloat,
                                    return_quant_tensor=True)
        self.act = qnn.QuantIdentity(_pa8(), return_quant_tensor=True) if act else None
        self.pool = qnn.QuantAvgPool2d(2)

    def forward(self, x):
        y = self.conv(self.inp(x))
        return self.pool(self.act(y) if self.act is not None else y)


class JaxScalarNet(nnx.Module):
    """A scalar computed from constants alone, broadcast and rectified on
    the side of the data path (the third defect's case)."""

    def __init__(self):
        self.inp = jqnn.QuantIdentity(_ja8())
        self.c = jqnn.QuantConv2d(3, 4, 1, padding="VALID", weight_quant=_jw8(),
                                  rngs=nnx.Rngs(0))
        self.q = jqnn.QuantIdentity(_ja8())

    def __call__(self, x):
        y = self.q(self.c(self.inp(x)))
        jax.nn.relu(jnp.broadcast_to(jnp.sqrt(jnp.float32(4.0)), (1,)))  # unused
        return y


class ScalarNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.inp = qnn.QuantIdentity(_pa8())
        self.c = qnn.QuantConv2d(3, 4, 1, padding="VALID",
                                 weight_quant=presets.Int8WeightPerTensorFloat)
        self.q = qnn.QuantIdentity(_pa8())

    def forward(self, x):
        y = self.q(self.c(self.inp(x)))
        torch.relu(torch.sqrt(torch.tensor(4.0)).expand(1))  # unused
        return y


class JaxRelu6Net(nnx.Module):
    """x -> 2x - 1 -> conv -> min(relu(.), 6) -> quantizer: the affine
    prologue composes to one item, the clip folds into ("relu6",)."""

    def __init__(self):
        self.c = jqnn.QuantConv2d(3, 4, 1, padding="VALID", weight_quant=_jw8(),
                                  input_quant=_ja8(), rngs=nnx.Rngs(0))
        self.q = jqnn.QuantIdentity(_ja8())

    def __call__(self, x):
        return self.q(jnp.minimum(jax.nn.relu(self.c(2.0 * x - 1.0)), 6.0))


class Relu6Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.c = qnn.QuantConv2d(3, 4, 1, padding="VALID",
                                 weight_quant=presets.Int8WeightPerTensorFloat,
                                 input_quant=_pa8())
        self.q = qnn.QuantIdentity(_pa8())

    def forward(self, x):
        return self.q(torch.clamp(torch.relu(self.c(2.0 * x - 1.0)), max=6.0))


class JaxSineNet(nnx.Module):
    """A sine between two convs: no export mapping, and the child order
    misses it (tests/test_export_derive.py:122,186)."""

    def __init__(self):
        r = nnx.Rngs(0)
        self.c1 = jqnn.QuantConv2d(3, 4, 1, padding="VALID", weight_quant=_jw8(), rngs=r)
        self.c2 = jqnn.QuantConv2d(4, 4, 1, padding="VALID", weight_quant=_jw8(), rngs=r)

    def __call__(self, x):
        return self.c2(jnp.sin(self.c1(x)))


class SineNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        w8 = presets.Int8WeightPerTensorFloat
        self.c1 = qnn.QuantConv2d(3, 4, 1, padding="VALID", weight_quant=w8)
        self.c2 = qnn.QuantConv2d(4, 4, 1, padding="VALID", weight_quant=w8)

    def forward(self, x):
        return self.c2(torch.sin(self.c1(x)))


MODELS = {
    "residual": (JaxResidualNet, ResidualNet, (2, 6, 6, 3)),
    "concat": (JaxConcatNet, ConcatNet, (2, 6, 6, 3)),
    "pool8": (lambda: JaxPoolNet(8.0), lambda: PoolNet(8.0), (2, 4, 4, 3)),
    "pool4": (lambda: JaxPoolNet(4.0), lambda: PoolNet(4.0), (2, 4, 4, 3)),
    "conv_pool": (JaxConvPoolNet, ConvPoolNet, (2, 4, 4, 3)),
    "conv_act_pool": (lambda: JaxConvPoolNet(True), lambda: ConvPoolNet(True), (2, 4, 4, 3)),
    "scalar": (JaxScalarNet, ScalarNet, (2, 4, 4, 3)),
    "relu6": (JaxRelu6Net, Relu6Net, (2, 4, 4, 3)),
    "sine": (JaxSineNet, SineNet, (1, 4, 4, 3)),
}
# the models whose JAX export is right, and their dialects
PARITY = {"residual": ("qcdq", "qonnx"), "concat": ("qcdq", "qonnx"),
          "pool8": ("qcdq", "qonnx", "finn"), "conv_act_pool": ("qcdq", "qonnx"),
          "relu6": ("qcdq", "qonnx")}
DERIVED = ("residual", "concat", "pool8", "conv_act_pool", "relu6")


def _jax_try(fn):
    try:
        return fn()
    except (ValueError, AssertionError) as e:
        return e


@pytest.fixture(scope="module")
def jax_ref():
    rng = np.random.default_rng(181019)
    built = nnx.jit(lambda: tuple(spec[0]() for spec in MODELS.values()))()
    out = {}
    for (name, (_, _, shape)), m in zip(MODELS.items(), built):
        x = rng.normal(0.0, 1.0, shape).astype(np.float32)
        r = out[name] = {"x": x}
        if name != "sine":
            with JG.calibration_mode(m):
                m(jnp.asarray(x))
                m(jnp.asarray(x * 0.9))
            jax_eval_mode(m)
        xj = jnp.asarray(x)
        r["state"] = jax_state_arrays(m)
        y = m(xj)
        r["y"] = np.asarray(y.value if hasattr(y, "value") else y)
        for style in PARITY.get(name, ("qcdq",)):
            r[style] = _jax_try(lambda: JE.export_model(m, xj, style=style))
        r["items"] = _jax_try(lambda: item_names(
            jax_derive(m, xj, output_rank=r["y"].ndim), m, False))
    out["jax_shared_calls"] = sorted(
        n.call_index for n in JG.trace_module_graph(
            built[0], jnp.asarray(out["residual"]["x"]), per_call=True).nodes
        if n.kind == "module" and n.path == "shared")
    return out


def _port(name: str, r: dict):
    return load_jax_state(MODELS[name][1](), r["state"]).eval()


def _run(model, x: np.ndarray, style="qcdq"):
    """(the graph's output, the model's) on the NCHW input."""
    blob = PE.export_model(model, torch.from_numpy(x), style=style)
    PE.validate_onnx(blob)
    (got,) = PE.run_onnx(blob, {"input": x})
    with torch.no_grad():
        want = model(torch.from_numpy(x))
    want = (want.value if hasattr(want, "value") else want).numpy()
    return got, want


def _jax_graph_error(r: dict, style="qcdq") -> float:
    """The largest difference between the JAX package's graph (run by the
    port's interpreter) and the JAX model; inf where the shapes differ."""
    (got,) = PE.run_onnx(r[style], {"input": nchw(r["x"])})
    want = nchw(r["y"]) if r["y"].ndim == 4 else r["y"]
    return float(np.abs(got - want).max()) if got.shape == want.shape else np.inf


def test_shared_module_gets_per_call_nodes(jax_ref):
    m = ResidualNet().eval()
    x = torch.from_numpy(nchw(jax_ref["residual"]["x"]))
    g = trace_module_graph(m, x, per_call=True)
    calls = sorted(n.call_index for n in g.nodes if n.kind == "module" and n.path == "shared")
    assert calls == jax_ref["jax_shared_calls"] == [0, 1, 2]
    merged = trace_module_graph(m, x)  # the default merges a module's calls
    assert len([n for n in merged.nodes if n.kind == "module" and n.path == "shared"]) == 1


@pytest.mark.parametrize("name", DERIVED)
def test_derived_items_equal_jax(jax_ref, name):
    r = jax_ref[name]
    m = _port(name, r)
    items = derive_export_items(m, torch.from_numpy(nchw(r["x"])), output_rank=r["y"].ndim)
    assert item_names(items, m, True) == r["items"]


def test_derived_glue_covers_the_skip_and_the_clip(jax_ref):
    """The residual walk saves, loads and adds; the concat joins two
    branches; the clip folds into one ("relu6",) after the composed affine."""
    res = [it for it in jax_ref["residual"]["items"] if isinstance(it, tuple)]
    assert {"save", "add_saved", "gap", "flatten"} <= {it[0] for it in res}
    cat = [it for it in jax_ref["concat"]["items"] if isinstance(it, tuple)
           and it[0] == "concat"]
    assert len(cat) == 1 and len(cat[0][1]) == 2
    glue = [it for it in jax_ref["relu6"]["items"] if isinstance(it, tuple)]
    assert glue[0] == ("affine", 2.0, -1.0) and ("relu6",) in glue and ("relu",) not in glue


CASES = [(name, style) for name, styles in PARITY.items() for style in styles]


@pytest.mark.parametrize("name,style", CASES)
def test_onnx_bytes_equal_jax(jax_ref, name, style):
    r = jax_ref[name]
    got = PE.export_model(_port(name, r), torch.from_numpy(nchw(r["x"])), style=style)
    assert got == r[style]


@pytest.mark.parametrize("name,style", [c for c in CASES if c[1] != "finn"])
def test_port_graph_reproduces_port_model(jax_ref, name, style):
    got, want = _run(_port(name, jax_ref[name]), nchw(jax_ref[name]["x"]), style)
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_RTOL * np.abs(want).max())


@pytest.mark.parametrize("name,style", CASES)
def test_port_interpreter_runs_jax_bytes(jax_ref, name, style):
    """The port's validator accepts the JAX package's bytes, and its
    interpreter gives JAX's interpreter's outputs on them."""
    from brevitas_tpu.export.interp import run_onnx as jax_run_onnx

    r = jax_ref[name]
    PE.validate_onnx(r[style])
    feed = {"input": nchw(r["x"])}
    np.testing.assert_array_equal(PE.run_onnx(r[style], feed)[0],
                                  jax_run_onnx(r[style], feed)[0])


def test_unmappable_structure_raises_in_both(jax_ref):
    """tests/test_export_derive.py:122: a sine has no export mapping."""
    r = jax_ref["sine"]
    assert isinstance(r["items"], JaxDeriveError)
    with pytest.raises(DeriveError):
        derive_export_items(_port("sine", r), torch.from_numpy(nchw(r["x"])))


def test_underivable_export_refuses_in_both(jax_ref):
    """tests/test_export_derive.py:186: the child-order fallback misses the
    sine, so the checked export refuses rather than return it."""
    r = jax_ref["sine"]
    assert isinstance(r["qcdq"], JaxExportValidationError)
    with pytest.raises(ExportValidationError):
        PE.export_model(_port("sine", r), torch.from_numpy(nchw(r["x"])))


def test_defect_trunc_epsilon_below_one(jax_ref):
    """ADVICE (a), JAX qcdq.py:579: 4-bit activations into TruncTo8bit at a
    2 x 2 window give T = 2^(6 - 8) = 1/4, where JAX's floor epsilon
    1/(2T) = 2 lifts every pooled code by two output steps. The port's
    min(1/(2T), 0.5) reproduces its model."""
    r = jax_ref["pool4"]
    m = _port("pool4", r)
    got, want = _run(m, nchw(r["x"]))
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_RTOL * np.abs(want).max())
    step = float(m.inp.act_quant(torch.zeros(1, 3)).scale)
    assert _jax_graph_error(r) > step


def test_defect_pool_after_conv(jax_ref):
    """ADVICE (b), JAX qcdq.py:86-89,534: a conv's accumulator grid goes
    straight into a truncating pool. JAX truncates against the conv's
    weight grid, which the model never does, and its graph misses its
    model; the port has no activation grid there and refuses. With an
    activation quantizer between them, the port's graph is its model's and
    its bytes JAX's."""
    r = jax_ref["conv_pool"]
    assert not isinstance(r["qcdq"], Exception)
    assert _jax_graph_error(r) > 1e-3 * np.abs(r["y"]).max()
    with pytest.raises(ValueError, match="activation grid"):
        PE.export_model(_port("conv_pool", r), torch.from_numpy(nchw(r["x"])))
    ra = jax_ref["conv_act_pool"]
    got, want = _run(_port("conv_act_pool", ra), nchw(ra["x"]))
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_RTOL * np.abs(want).max())


def test_defect_scalar_constant_threaded_to_input(jax_ref):
    """ADVICE (c), JAX derive.py:160: a scalar computed from constants alone
    is threaded to the model's input, so its broadcast and relu become the
    graph's last step and the graph returns relu(input). The port refuses
    to derive it, and the checked child-order fallback reproduces the
    model."""
    r = jax_ref["scalar"]
    assert not isinstance(r["qcdq"], Exception)
    assert r["items"][-1] == ("relu",)
    assert _jax_graph_error(r) > 1e-3 * np.abs(r["y"]).max()
    m = _port("scalar", r)
    x = nchw(r["x"])
    with pytest.raises(DeriveError, match="scalar"):
        derive_export_items(m, torch.from_numpy(x))
    got, want = _run(m, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_RTOL * np.abs(want).max())


def test_ptq_calibrate_export_cli(tmp_path):
    """``ptq_calibrate --export qcdq`` (mlp, one epoch) writes a file that
    validates and whose interpreted accuracy is the run's ``ptq_acc``."""
    path = str(tmp_path / "ptq.onnx")
    keep = {}
    out = cli.main(["--model", "mlp", "--train-epochs", "1", "--calib-batches", "2",
                    "--bias-correct-batches", "1", "--equalize-iterations", "2",
                    "--export", "qcdq", "--export-path", path, "--device", "cpu"], keep=keep)
    assert out["exported"] == path
    blob = open(path, "rb").read()
    PE.validate_onnx(blob)
    (y,) = PE.run_onnx(blob, {"input": keep["x_test"]})
    with torch.no_grad():
        want = keep["model"](torch.from_numpy(keep["x_test"])).numpy()
    np.testing.assert_allclose(y, want, rtol=0, atol=OUT_RTOL * np.abs(want).max())
    assert float(np.mean(y.argmax(-1) == keep["y_test"])) == out["ptq_acc"]


def test_duplicate_shared_stateless_modules():
    """tests/test_graph.py's case: a shared dropout is copied, a shared
    linear (weight sharing) stays shared."""
    from brevitas_tpu_torch.graph import duplicate_shared_stateless_modules

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.drop = torch.nn.Dropout(0.0)
            self.a = self.drop
            self.l1 = qnn.QuantLinear(4, 4)
            self.l2 = self.l1

        def forward(self, x):
            return self.l2(self.a(self.l1(self.drop(x))))

    m = Net()
    assert duplicate_shared_stateless_modules(m) == 1
    assert m.a is not m.drop and m.l2 is m.l1


def test_disable_last_return_quant_tensor():
    """tests/test_graph.py's case: the last quant layer of export_layers()
    returns a plain tensor, the one before it still a QuantTensor."""
    from brevitas_tpu_torch.graph import disable_last_return_quant_tensor
    from brevitas_tpu_torch.quant_tensor import QuantTensor

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.q1 = qnn.QuantIdentity(_pa8(), return_quant_tensor=True)
            self.q2 = qnn.QuantIdentity(_pa8(), return_quant_tensor=True)

        def export_layers(self):
            return [self.q1, self.q2]

        def forward(self, x):
            return self.q2(self.q1(x))

    m = Net()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 8)).astype(np.float32))
    assert isinstance(m(x), QuantTensor)
    assert disable_last_return_quant_tensor(m) == "q2"
    assert m.q1.return_quant_tensor and not m.q2.return_quant_tensor
    assert isinstance(m(x), torch.Tensor)
