"""The port's PTQ CLI (``examples/ptq_calibrate.py``) against the JAX package's.

Both of the CLI's model families run ``main``'s sequence from one float
model that JAX trains on the digits: the MLP with per-channel weights and
AdaRound, and the conv net with the flexml fixed-point quantizers and
GPTQ, each ending in integer serving. JAX runs each step once for the
module, recording its state between steps (its forwards and AdaRound's
and GPTQ's solves under ``nnx.jit``, its BatchNorm fold, equalization and
bias correction eagerly, as ``main`` runs them); the port repeats each
step from JAX's state before it. The port's ``main`` alone is held to the
JAX tests' own bounds, and the port's flexml flow on a float ResNet-18 at
width 0.125 (BatchNorm fusion through integer serving) to the JAX model
zoo test's bound. The ResNet's passes are held to JAX's one by one in
``tests/test_torch_port_ptq.py``.

Tolerances, each with its reason:
- the preprocessed state (BatchNorm fold, equalization): bit for bit,
  and the regions and pairs equal;
- calibration: per-tensor activation scales within 2 float32 ulps of
  JAX's (float scales from a percentile of activations whose last bits
  differ: XLA's matmul and conv sums against torch's) and equal where
  they are powers of two (fixed point); weight codes and scales equal;
- AdaRound from JAX's calibrated state: weight codes equal except in at
  most 1 % of a layer, by one step (Adam's updates round differently,
  ROADMAP S8; none differs here, the counts are printed); GPTQ from JAX's
  state: codes within two steps of JAX's, at most 10 % of a layer's
  differing, and each layer's GPTQ proxy error (``tr(dW^T H dW)``, which
  ``apply_gptq`` reports) within 5 % of JAX's, its nearest-rounding one
  within 1e-3. The Hessian comes from activations whose last bits differ
  and its Cholesky factor from LAPACK here and XLA there; the recursion
  carries each flip into every later row, so the share that differs grows
  with the rows: 0.6 % of c2's 4,608 codes (K 144) and 5.9 % of the head's
  15,680 (K 1,568), whose inputs also carry c2's flips (its nearest error
  parts from JAX's by 1.4e-4 relative), where JAX's GPTQ moved 14 % of the
  head's codes off nearest rounding;
- bias correction from JAX's state after the weight pass: each corrected
  bias within 2e-6 of JAX's, or 2 % of the layer's largest correction
  where that is more. The corrections are float32 means over the batch
  of outputs whose last bits differ, and XLA sums a conv output's 25,088
  (c1) or 6,272 (c2) elements a channel in sequence where torch sums them
  pairwise: c1's corrections, up to 1.2e-3, part by up to 1.6e-5. The
  MLP's (128 a channel) stay within 1.5e-6. A downstream input code that
  flipped at a .5 tie would move a later layer's correction by far more;
  none does here;
- accuracies from JAX's final state, fake-quant and served: equal, or
  within one test image (1/360) where an argmax sits on a tie of float32
  sums; the serving twins' kinds equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import brevitas_tpu.graph as JG
import brevitas_tpu.nn as jqnn
from brevitas_tpu.examples import ptq_calibrate as jcli
from brevitas_tpu.examples.bnn_pynq import load_digits_upscaled as jax_load_digits
from brevitas_tpu.graph.flexml import quantize_flexml as jax_quantize_flexml
from brevitas_tpu.quant import presets as jp
from brevitas_tpu.utils import eval_mode as jax_eval_mode
from brevitas_tpu_torch import graph as PG
from brevitas_tpu_torch import nn as qnn
from brevitas_tpu_torch.examples import ptq_calibrate as cli
from brevitas_tpu_torch.graph.learned_round import freeze_weight_scale
from brevitas_tpu_torch.interop import load_jax_state
from brevitas_tpu_torch.models import float_resnet
from brevitas_tpu_torch.quant import presets

torch.set_num_threads(1)

EPOCHS = 3
BATCH = 128
CALIB = 2
BIAS_BATCHES = 1
ADAROUND_STEPS = 60
ADAROUND_FLIP_SHARE = 0.01
GPTQ_FLIP_SHARE = 0.1
GPTQ_MAX_STEP = 2
GPTQ_MSE_REL = 0.05
GPTQ_NEAR_REL = 1e-3
BIAS_REL = 0.02
SCALE_ULPS = 2
BIAS_ATOL = 2e-6
ONE_IMAGE = 1 / 360
FLOWS = {"mlp": ["--model", "mlp", "--per-channel", "--learned-round"],
         "convnet": ["--model", "convnet", "--fixed-point", "--gptq"]}


def jax_state_arrays(model) -> dict:
    return {".".join(map(str, path)): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model)) if path[0] != "rngs"}


def _calib(x, n):
    return [x[(i * BATCH) % max(len(x) - BATCH, 1):][:BATCH] for i in range(n)]


def _jax_train(model, x, y, bn_stats):
    """``jcli._train_float``: optax's Adam, the batches in order."""
    jcli._train_float(model, x, y, EPOCHS, 1e-3, BATCH, bn_stats=bn_stats)


def _jax_quant_codes(model) -> dict:
    """Each quant layer's weight codes, weight scale and input scale, eagerly
    (under jit XLA turns a scale's division by a constant into a reciprocal
    multiply, ROADMAP S13)."""
    out = {}
    for path, layer in JG.find_modules(model, jqnn.QuantWBIOL):
        qw = layer.quant_weight()
        qi = layer.input_quant(jnp.zeros((1, 1)))
        out[path] = (np.asarray(qw.value / qw.scale), np.asarray(qw.scale).reshape(-1),
                     np.asarray(qi.scale).reshape(-1))
    return out


@pytest.fixture(scope="module")
def jax_ref():
    x_train, y_train = jax_load_digits("train")
    x_test, y_test = jax_load_digits("test")
    predict = nnx.jit(lambda m, xb: jnp.argmax(m(xb), -1))
    fwd = nnx.jit(lambda m, xb: m(xb))

    def accuracy(m):
        return float(np.mean(np.asarray(predict(m, jnp.asarray(x_test))) == y_test))

    ref = {}
    for name in FLOWS:
        r = ref[name] = {}
        m = jcli.MODELS[name](nnx.Rngs(0))
        _jax_train(m, x_train, y_train, bn_stats=name == "convnet")
        r["float_state"] = jax_state_arrays(m)
        r["float_acc"] = accuracy(m)
        r["pairs"] = JG.find_bn_pairs(m, x_test[:1])
        JG.preprocess_flexml(m, x_test[:1], equalize_iterations=10)
        r["regions"] = JG.extract_regions(m, x_test[:1])
        r["pre_state"] = jax_state_arrays(m)
        r["pre_acc"] = accuracy(m)
        if name == "convnet":
            jax_quantize_flexml(m, collect_stats_steps=CALIB)
        else:
            JG.quantize(m, weight_quant=jp.Int8WeightPerChannelFloat.let(bit_width=8),
                        act_quant=jp.Int8ActPerTensorFloat.let(bit_width=8,
                                                               collect_stats_steps=CALIB))
        with JG.calibration_mode(m):
            for b in _calib(x_train, CALIB):
                fwd(m, jnp.asarray(b))
        jax_eval_mode(m)
        r["calib_state"] = jax_state_arrays(m)
        r["calib_codes"] = _jax_quant_codes(m)
        calib = [jnp.asarray(b) for b in _calib(x_train, CALIB)]
        if name == "convnet":
            r["gptq"] = JG.apply_gptq(m, calib)
        else:
            r["adaround"] = JG.apply_learned_round(m, calib, steps=ADAROUND_STEPS)
        r["weight_state"] = jax_state_arrays(m)
        r["weight_codes"] = _jax_quant_codes(m)
        with JG.bias_correction_mode(m):
            for b in _calib(x_train, BIAS_BATCHES):
                m(jnp.asarray(b))
        r["bias_state"] = jax_state_arrays(m)
        r["ptq_acc"] = accuracy(m)
        JG.convert_integer_inference(m)
        r["twins"] = sorted(type(mod).__name__ for _, mod in JG.named_modules(m)
                            if "Inference" in type(mod).__name__)
        r["int_acc"] = accuracy(m)
    return ref


def _nchw(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2))


def _port_float(name: str, state: dict):
    return load_jax_state(cli.MODELS[name](), state)


def _port_quantized(name: str, pre_state: dict):
    m = _port_float(name, pre_state) if name == "mlp" else _port_folded(pre_state)
    if name == "convnet":
        PG.quantize_flexml(m, collect_stats_steps=CALIB)
    else:
        PG.quantize(m, weight_quant=presets.Int8WeightPerChannelFloat.let(bit_width=8),
                    act_quant=presets.Int8ActPerTensorFloat.let(bit_width=8,
                                                                collect_stats_steps=CALIB))
    return m


def _port_folded(state: dict):
    m = cli.FloatConvNet()
    PG.merge_batchnorms(m, m.BN_PAIRS)
    return load_jax_state(m, state)


def _codes(layer):
    qw = layer.quant_weight()
    got = (qw.value / qw.scale).detach()
    got = got.permute(2, 3, 1, 0) if got.ndim == 4 else got.t()
    return got.numpy(), qw.scale.detach().numpy().reshape(-1)


def _x(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(_nchw(x))


@pytest.mark.parametrize("name", list(FLOWS))
def test_preprocess_matches_jax(jax_ref, name):
    r = jax_ref[name]
    m = _port_float(name, r["float_state"])
    sample = _x(jax_load_digits("test")[0][:1])
    pairs = PG.find_bn_pairs(m, sample)
    assert pairs == r["pairs"]
    PG.preprocess_flexml(m, sample, equalize_iterations=10)
    assert sorted(PG.extract_regions(m, sample)) == sorted(r["regions"])
    want = _port_float(name, r["pre_state"]) if name == "mlp" else _port_folded(r["pre_state"])
    for (path, a), (_, b) in zip(m.state_dict().items(), want.state_dict().items()):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("name", list(FLOWS))
def test_quantize_and_calibration_match_jax(jax_ref, name):
    r = jax_ref[name]
    m = _port_quantized(name, r["pre_state"])
    x_train = jax_load_digits("train")[0]
    with torch.no_grad(), PG.calibration_mode(m):
        for b in _calib(x_train, CALIB):
            m(_x(b))
    m.eval()
    layers = dict(PG.find_modules(m, qnn.QuantWBIOL))
    assert set(layers) == set(r["calib_codes"])
    for path, (codes, w_scale, x_scale) in r["calib_codes"].items():
        got_codes, got_scale = _codes(layers[path])
        np.testing.assert_array_equal(got_codes, codes, err_msg=path)
        np.testing.assert_array_equal(got_scale, w_scale, err_msg=path)
        got_x = layers[path].input_quant(torch.zeros(1, 1)).scale.detach().numpy().reshape(-1)
        ulp = np.spacing(np.abs(x_scale))
        tol = 0 if name == "convnet" else SCALE_ULPS
        assert (np.abs(got_x - x_scale) <= tol * ulp).all(), (path, got_x, x_scale)


def _port_calibrated(name: str, r: dict):
    """The port's quantized model holding JAX's calibrated state."""
    m = _port_quantized(name, r["pre_state"])
    load_jax_state(m, r["calib_state"])
    return m.eval()


@pytest.mark.parametrize("name", list(FLOWS))
def test_weight_pass_matches_jax(jax_ref, name):
    r = jax_ref[name]
    m = _port_calibrated(name, r)
    x_train = jax_load_digits("train")[0]
    calib = [_x(b) for b in _calib(x_train, CALIB)]
    if name == "convnet":
        report = PG.apply_gptq(m, calib)
        for path, (near, mse) in report.items():
            want_near, want_mse = r["gptq"][path]
            print(f"{name} {path}: GPTQ proxy MSE {mse:.4g} (JAX {want_mse:.4g}), nearest "
                  f"{near:.4g} (JAX {want_near:.4g})")
            assert near == pytest.approx(want_near, rel=GPTQ_NEAR_REL)
            assert mse == pytest.approx(want_mse, rel=GPTQ_MSE_REL)
    else:
        report = PG.apply_learned_round(m, calib, steps=ADAROUND_STEPS)
        assert set(report) == set(r["adaround"])
    layers = dict(PG.find_modules(m, qnn.QuantWBIOL))
    for path, (codes, w_scale, _) in r["weight_codes"].items():
        got, got_scale = _codes(layers[path])
        np.testing.assert_array_equal(got_scale, w_scale, err_msg=path)
        differ = got != codes
        share = float(differ.mean())
        step = float(np.abs(got - codes).max())
        moved = float((codes != r["calib_codes"][path][0]).mean())
        print(f"{name} {path}: {int(differ.sum())} of {codes.size} codes differ ({share:.4f}), "
              f"by at most {step}; JAX's pass moved {moved:.4f} of them off nearest")
        if name == "convnet":
            assert step <= GPTQ_MAX_STEP and share <= GPTQ_FLIP_SHARE, path
        else:
            assert step <= 1 and share <= ADAROUND_FLIP_SHARE, path
    # the learned rounding moved codes off nearest, and the port's with it
    if name == "mlp":
        moved = [float((r["weight_codes"][p][0] != r["calib_codes"][p][0]).mean())
                 for p in r["weight_codes"]]
        assert max(moved) > 0.01


def _port_after_weight_pass(name: str, r: dict):
    m = _port_calibrated(name, r)
    for _, layer in PG.find_modules(m, qnn.QuantWBIOL):
        if isinstance(layer, (qnn.QuantLinear, qnn.QuantConv2d)):
            freeze_weight_scale(layer)
    load_jax_state(m, r["weight_state"])
    return m


@pytest.mark.parametrize("name", list(FLOWS))
def test_bias_correction_matches_jax(jax_ref, name):
    r = jax_ref[name]
    m = _port_after_weight_pass(name, r)
    x_train = jax_load_digits("train")[0]
    with torch.no_grad(), PG.bias_correction_mode(m):
        for b in _calib(x_train, BIAS_BATCHES):
            m(_x(b))
    for path, _ in PG.find_modules(m, qnn.QuantWBIOL):
        got = m.get_submodule(path).bias.detach().numpy()
        want = r["bias_state"][f"{path}.bias"]
        before = r["weight_state"].get(f"{path}.bias")
        moved = np.abs(want - before).max() if before is not None else np.abs(want).max()
        print(f"{name} {path}: correction up to {moved:.3g}, port against JAX "
              f"{np.abs(got - want).max():.3g}")
        assert np.abs(got - want).max() <= max(BIAS_ATOL, BIAS_REL * moved), path


@pytest.mark.parametrize("name", list(FLOWS))
def test_accuracies_and_twins_match_jax(jax_ref, name):
    r = jax_ref[name]
    x_test, y_test = jax_load_digits("test")
    m = _port_after_weight_pass(name, r)
    load_jax_state(m, r["bias_state"])
    xt = _nchw(x_test)
    ptq_acc = cli._accuracy(m, xt, y_test)
    PG.convert_integer_inference(m)
    twins = sorted(type(mod).__name__ for mod in m.modules()
                   if "Inference" in type(mod).__name__)
    int_acc = cli._accuracy(m, xt, y_test)
    print(f"{name}: ptq {ptq_acc} (JAX {r['ptq_acc']}), int {int_acc} (JAX {r['int_acc']})")
    assert twins == r["twins"]
    assert abs(ptq_acc - r["ptq_acc"]) <= ONE_IMAGE + 1e-12
    assert abs(int_acc - r["int_acc"]) <= ONE_IMAGE + 1e-12
    # and the float and preprocessed models from JAX's states score as JAX's
    m = _port_float(name, r["float_state"])
    assert cli._accuracy(m, xt, y_test) == pytest.approx(r["float_acc"], abs=ONE_IMAGE)


def test_port_main_mlp_meets_jax_bounds():
    """tests/test_end_to_end.py's bounds for the MLP flow (its ONNX export
    is held in tests/test_torch_port_export_derive.py)."""
    out = cli.main(["--model", "mlp", "--train-epochs", "3", "--calib-batches", "2",
                    "--bias-correct-batches", "1", "--convert-int", "--device", "cpu"])
    assert out["float_acc"] > 0.8
    assert out["ptq_acc"] > out["float_acc"] - 0.05
    assert out["int_acc"] > out["float_acc"] - 0.05
    assert set(out) >= {"model", "float_acc", "preprocessed_acc", "ptq_acc", "bit_width",
                        "fixed_point", "learned_round", "gptq", "gpfq", "int_acc"}


def test_port_main_convnet_fixed_point_meets_jax_bounds():
    out = cli.main(["--model", "convnet", "--train-epochs", "3", "--fixed-point",
                    "--calib-batches", "2", "--bias-correct-batches", "1", "--device", "cpu"])
    assert out["float_acc"] > 0.75
    assert out["preprocessed_acc"] == pytest.approx(out["float_acc"], abs=0.02)
    assert out["ptq_acc"] > out["float_acc"] - 0.06


def test_port_main_export_raises():
    """--export takes the three ONNX dialects of the JAX CLI and raises on
    any other (the export flow itself is held in
    tests/test_torch_port_export_derive.py)."""
    with pytest.raises(SystemExit):
        cli.main(["--export", "finn", "--device", "cpu"])


def test_port_resnet_flexml_flow():
    """Float ResNet-18 (width 0.125) through the whole flexml flow on the
    port: fold, equalize, quantize, calibrate, bias-correct, serve. The
    fake-quant output within the JAX zoo test's bound of the float one
    (tests/test_model_zoo.py), the served one near the fake-quant one."""
    g = torch.Generator().manual_seed(0)
    m = float_resnet(18, num_classes=10, width_mult=0.125, generator=g)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 3, 32, 32)).astype(np.float32))
    m.train()
    with torch.no_grad():
        for _ in range(3):
            m(x)  # BatchNorm statistics away from the identity
    m.eval()
    with torch.no_grad():
        y_float = m(x)
    PG.preprocess_flexml(m, x[:1], equalize_iterations=4)
    assert sum(isinstance(mod, qnn.FoldedBatchNorm) for mod in m.modules()) == 20
    with torch.no_grad():
        assert (m(x) - y_float).abs().max() <= 1e-4 * y_float.abs().max() + 1e-5
    PG.quantize_flexml(m, collect_stats_steps=2)
    with torch.no_grad():
        with PG.calibration_mode(m):
            m(x)
            m(x)
        m.eval()
        with PG.bias_correction_mode(m):
            m(x)
        y_q = m(x)
    err, span = float((y_q - y_float).abs().max()), float(y_float.abs().max())
    assert err < 0.35 * span + 0.1, (err, span)
    PG.convert_integer_inference(m)
    kinds = {type(mod).__name__ for mod in m.modules() if "Inference" in type(mod).__name__}
    assert kinds == {"Int8InferenceConv", "Int8InferenceLinear"}
    with torch.no_grad():
        y_int = m(x)
    gap = float((y_int - y_q).abs().max())
    print(f"resnet flexml: fake-quant vs float {err:.4g} (span {span:.4g}), served vs "
          f"fake-quant {gap:.4g}")
    assert gap <= 0.05 * span
