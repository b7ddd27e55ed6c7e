"""The port's CNN post-training quantization passes against the JAX package's.

What ``examples/ptq_calibrate.py`` reaches, pass by pass: the digits data,
the fixed-point presets and the constant-width INT biases, BatchNorm
folding (``merge_bn``, ``merge_batchnorms``, ``QuantScaleBias``), the
traced BatchNorm pairs and equalization regions (``find_bn_pairs``,
``extract_regions``, ``discover_bn_pairs``), cross-layer equalization,
the flexml quantization and its calibration on a float ResNet-18 at width
0.125, and AdaRound. Each pass starts from the JAX package's own state
before it (``load_jax_state``); every JAX reference is computed once for
the module, its forwards under ``nnx.jit``. The CLI's flows, bias
correction among them, are in ``tests/test_torch_port_ptq_cli.py``.

Tolerances, each with its reason:
- the digits file and its upscaled split, the presets, BatchNorm folding
  and cross-layer equalization: bit for bit. The fold is one float32
  square root, one division and products, each correctly rounded in both
  packages; equalization's factors come from maxima, minima, one division
  and one square root;
- pairs and regions: equal as sorted path lists;
- the flexml quantizers after calibration: every weight code and scale
  equal, every activation scale equal. The scales are powers of two, the
  ceiling of the log2 of a percentile of activations that differ in their
  last bits (XLA's conv sums against the port's patch matrix);
- the calibrated model's output within 1e-5 of JAX's (relative to its
  largest magnitude), argmax equal: the codes are the same but for a
  flip at a .5 tie, which would move an output by a step of the last
  layer's scale, far above 1e-5; none happens here;
- the bias quantizer: bit for bit (one division, a round and a clamp);
- ``QuantScaleBias`` from a BatchNorm: multipliers and shifts bit for
  bit, output within 1e-6;
- AdaRound: v within 2e-4 of JAX's after 2 and 8 steps. Adam's update
  is ``lr * m_hat / (sqrt(v_hat) + eps)`` in both, but torch divides by
  ``sqrt(1 - b2^t)`` after the square root and optax before it, and the
  regularizer's float32 pow differs in XLA by ulps (ROADMAP S8), so each
  step moves v by up to a few ulps of lr = 3e-3 differently. A weight
  already on the grid (w / scale an integer: each channel's largest
  starts so) starts with its rectified sigmoid exactly on the kink at 0,
  where the two logistic functions part by an ulp: on one side its
  gradient is 0, on the other Adam moves it by lr; those weights are held
  within 2 lr a step. ``_bake`` from the same v: bit for bit. After 200 steps the rounding
  decisions equal JAX's except where the rectified sigmoid is within 0.05
  of the 0.5 threshold (none here; the count is printed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import brevitas_tpu.graph as JG
import brevitas_tpu.nn as jqnn
from brevitas_tpu.examples.bnn_pynq import load_digits_upscaled as jax_load_digits
from brevitas_tpu.examples.ptq_calibrate import FloatConvNet as JaxConvNet
from brevitas_tpu.graph import learned_round as jlr
from brevitas_tpu.graph.equalize import cross_layer_equalization as jax_cle
from brevitas_tpu.graph.flexml import quantize_flexml as jax_quantize_flexml
from brevitas_tpu.models.mobilenetv1 import quant_mobilenet_v1 as jax_mobilenet
from brevitas_tpu.models.resnet import float_resnet as jax_float_resnet
from brevitas_tpu.quant import presets as jp
from brevitas_tpu.quant.quantizers import BiasQuantizer as JaxBiasQuantizer
from brevitas_tpu.utils import eval_mode as jax_eval_mode
from brevitas_tpu_torch import graph as PG
from brevitas_tpu_torch import nn as qnn
from brevitas_tpu_torch.examples import bnn_pynq
from brevitas_tpu_torch.examples.ptq_calibrate import FloatConvNet
from brevitas_tpu_torch.graph import learned_round as plr
from brevitas_tpu_torch.graph.equalize import cross_layer_equalization
from brevitas_tpu_torch.interop import load_jax_state
from brevitas_tpu_torch.models import float_resnet, quant_mobilenet_v1
from brevitas_tpu_torch.models.common import BatchNorm
from brevitas_tpu_torch.quant import presets
from brevitas_tpu_torch.quant.quantizers import BiasQuantizer

torch.set_num_threads(1)

RESNET_WIDTH = 0.125
EQUALIZE_ITERATIONS = 2
CALIB_STEPS = 2
OUT_RTOL = 1e-5
SCALE_BIAS_ATOL = 1e-6
ADAROUND_STEPS = (2, 8)
ADAROUND_V_ATOL = 2e-4
ADAROUND_LR = 3e-3
ADAROUND_LONG = 200
ADAROUND_MARGIN = 0.05
PRESETS = ["Int8WeightPerTensorFixedPoint", "Int8WeightPerChannelFixedPoint",
           "Int8ActPerTensorFixedPoint", "Uint8ActPerTensorFixedPoint", "Int8Bias",
           "Int16Bias", "Int32Bias"]


def jax_state_arrays(model) -> dict:
    return {".".join(map(str, path)): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model)) if path[0] != "rngs"}


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _randomize_bns(model, rng) -> None:
    """Running statistics and affine parameters away from the identity, so
    that a fold is no identity."""
    for _, bn in JG.find_modules(model, nnx.BatchNorm):
        c = bn.mean[...].shape[0]
        bn.mean[...] = jnp.asarray(rng.normal(0.0, 0.1, c).astype(np.float32))
        bn.var[...] = jnp.asarray(rng.uniform(0.5, 1.5, c).astype(np.float32))
        bn.scale[...] = jnp.asarray(rng.uniform(0.5, 1.5, c).astype(np.float32))
        bn.bias[...] = jnp.asarray(rng.normal(0.0, 0.1, c).astype(np.float32))


def _sorted(regions):
    return sorted((tuple(s), tuple(k)) for s, k in regions)


class JaxTapNet(nnx.Module):
    """A conv output feeding both a BatchNorm and a residual add."""

    def __init__(self):
        r = nnx.Rngs(0)
        self.conv = nnx.Conv(8, 8, (3, 3), padding="SAME", rngs=r)
        self.bn = nnx.BatchNorm(8, use_running_average=True, rngs=r)

    def __call__(self, x):
        y = self.conv(x)
        return self.bn(y) + y


class TapNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = qnn.FloatConv2d(8, 8, 3)
        self.bn = BatchNorm(8, momentum=0.99, channel_axis=1)
        self.eval()

    def forward(self, x):
        y = self.conv(x)
        return self.bn(y) + y


class JaxConcatNet(nnx.Module):
    """Two convs joined along the channel axis (stops a region) and a
    spatial concatenation (passes one)."""

    def __init__(self):
        r = nnx.Rngs(0)
        self.a = nnx.Conv(3, 4, (3, 3), rngs=r)
        self.b = nnx.Conv(3, 4, (3, 3), rngs=r)
        self.c = nnx.Conv(8, 8, (3, 3), rngs=r)
        self.d = nnx.Conv(8, 8, (1, 1), rngs=r)

    def __call__(self, x):
        y = jnp.concatenate([self.a(x), self.b(x)], axis=-1)
        z = jax.nn.relu(self.c(y))
        z = jnp.concatenate([z, z], axis=1)  # along H
        return self.d(z)


class ConcatNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = qnn.FloatConv2d(3, 4, 3)
        self.b = qnn.FloatConv2d(3, 4, 3)
        self.c = qnn.FloatConv2d(8, 8, 3)
        self.d = qnn.FloatConv2d(8, 8, 1)

    def forward(self, x):
        y = torch.cat([self.a(x), self.b(x)], 1)
        z = torch.relu(self.c(y))
        z = torch.cat([z, z], 2)
        return self.d(z)


@pytest.fixture(scope="module")
def jax_ref():
    rng = np.random.default_rng(0)
    ref = {}
    # the float ResNet, pass by pass; each pass but the fold under nnx.jit
    # (eagerly, the JAX package compiles each new primitive and shape on its
    # own). The fold runs eagerly, as preprocess_flexml runs it: under jit
    # XLA contracts -mean * mul + bias into a fused multiply-add
    m = nnx.jit(lambda: jax_float_resnet(18, num_classes=10, width_mult=RESNET_WIDTH,
                                         rngs=nnx.Rngs(0)))()
    _randomize_bns(m, rng)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    ref["x"] = x
    ref["float_state"] = jax_state_arrays(m)
    ref["pairs"] = JG.find_bn_pairs(m, x[:1])
    ref["regions_before"] = JG.extract_regions(m, x[:1])
    ref["hand_pairs"] = list(m.bn_pairs())
    JG.merge_batchnorms(m, ref["pairs"])
    ref["merged_state"] = jax_state_arrays(m)
    ref["regions"] = JG.extract_regions(m, x[:1])
    srcs, sinks = ref["regions"][1]
    ref["s_first"] = np.asarray(nnx.jit(lambda mm: jax_cle(
        [JG.get_module(mm, p) for p in srcs], [JG.get_module(mm, p) for p in sinks]))(m))
    ref["after_first_state"] = jax_state_arrays(m)
    nnx.jit(lambda mm: JG.equalize(mm, ref["regions"], iterations=EQUALIZE_ITERATIONS))(m)
    ref["equalized_state"] = jax_state_arrays(m)
    nnx.jit(lambda mm: jax_quantize_flexml(mm, collect_stats_steps=CALIB_STEPS))(m)
    fwd = nnx.jit(lambda mm, xx: mm(xx))
    with JG.calibration_mode(m):
        for _ in range(CALIB_STEPS):
            fwd(m, jnp.asarray(x))
    jax_eval_mode(m)
    ref["y_quant"] = np.asarray(fwd(m, jnp.asarray(x)))

    @nnx.jit
    def codes(mm):
        out = {}
        for path, layer in JG.find_modules(mm, jqnn.QuantWBIOL):
            qw = layer.quant_weight()
            qi = layer.input_quant(jnp.zeros((1, 1)))
            out[path] = (qw.value / qw.scale, qw.scale, qi.scale)
        return out

    kinds = {path: type(layer).__name__ for path, layer in JG.find_modules(m, jqnn.QuantWBIOL)}
    layers = {path: (*map(np.asarray, v), kinds[path]) for path, v in codes(m).items()}
    ref["layers"] = layers

    # small models' pairs and regions
    tap = JaxTapNet()
    ref["tap_pairs"] = JG.find_bn_pairs(tap, np.zeros((1, 8, 8, 8), np.float32))
    tap.bn.mean[...] = jnp.asarray(rng.normal(0, 0.1, 8).astype(np.float32))
    tap.bn.var[...] = jnp.asarray(rng.uniform(0.5, 1.5, 8).astype(np.float32))
    tap.bn.scale[...] = jnp.asarray(rng.uniform(0.5, 1.5, 8).astype(np.float32))
    ref["tap_state"] = jax_state_arrays(tap)
    jax_quantize_flexml(tap, collect_stats_steps=1)
    xt = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    ref["tap_x"] = xt
    sb = tap.bn
    ref["tap_scale_bias"] = (type(sb).__name__, np.asarray(sb.weight[...]),
                             np.asarray(sb.bias[...]))
    with JG.calibration_mode(tap):
        tap(jnp.asarray(xt))
    jax_eval_mode(tap)
    ref["tap_y"] = np.asarray(tap(jnp.asarray(xt)))
    cat = JaxConcatNet()
    ref["concat_regions"] = JG.extract_regions(cat, np.zeros((1, 8, 8, 3), np.float32))
    conv = JaxConvNet(nnx.Rngs(0))
    xc = np.zeros((1, 28, 28, 1), np.float32)
    ref["convnet_pairs"] = JG.find_bn_pairs(conv, xc)
    ref["convnet_declared"] = JG.discover_bn_pairs(conv)
    JG.merge_batchnorms(conv, ref["convnet_pairs"])
    ref["convnet_regions"] = JG.extract_regions(conv, xc)
    mn = nnx.jit(lambda: jax_mobilenet(bit_width=None, width_scale=0.25, num_classes=10,
                                       pool_size=2, rngs=nnx.Rngs(0)))()
    xm = np.zeros((1, 64, 64, 3), np.float32)
    ref["mobilenet_pairs"] = JG.find_bn_pairs(mn, xm)
    nnx.jit(lambda mm: JG.merge_batchnorms(mm, ref["mobilenet_pairs"]))(mn)
    ref["mobilenet_regions"] = JG.extract_regions(mn, xm)

    # AdaRound on a linear and a conv layer
    ada = {}
    for kind in ("linear", "conv"):
        if kind == "linear":
            layer = jqnn.QuantLinear(32, 16, weight_quant=jp.Int8WeightPerChannelFloat.let(
                bit_width=4), rngs=nnx.Rngs(1))
            xa = rng.standard_normal((64, 32)).astype(np.float32)
        else:
            layer = jqnn.QuantConv2d(4, 8, 3, padding="SAME", weight_quant=(
                jp.Int8WeightPerTensorFloat.let(bit_width=4)), rngs=nnx.Rngs(2))
            xa = rng.standard_normal((4, 6, 6, 4)).astype(np.float32)
        jax_eval_mode(layer)
        state = jax_state_arrays(layer)
        runs = {}
        for steps in ADAROUND_STEPS + (ADAROUND_LONG,):
            v, near, learned = jlr._optimize_layer(
                layer, jnp.asarray(xa), steps=steps, lr=3e-3, lam=0.01, beta_start=20.0,
                beta_end=2.0, warmup=0.5 if steps < ADAROUND_LONG else 0.2)
            runs[steps] = (np.asarray(v), near, learned)
        v = jnp.asarray(runs[ADAROUND_LONG][0])
        jlr._bake(layer, v)
        ada[kind] = dict(state=state, x=xa, runs=runs, baked=np.asarray(layer.weight[...]))
    ref["adaround"] = ada
    return ref


def test_digits_file_is_sklearns():
    from sklearn.datasets import load_digits

    d = load_digits()
    with np.load(bnn_pynq.DIGITS) as f:
        assert f["images"].dtype == np.uint8 and f["target"].dtype == np.uint8
        np.testing.assert_array_equal(f["images"], d.images)
        np.testing.assert_array_equal(f["target"], d.target)


@pytest.mark.parametrize("split", ["train", "test"])
def test_digits_upscaled_split_matches_jax(split):
    xj, yj = jax_load_digits(split)
    xp, yp = bnn_pynq.load_digits_upscaled(split)
    assert xp.shape == (len(xj), 1, 28, 28) and xp.dtype == np.float32
    np.testing.assert_array_equal(xp[:, 0], xj[..., 0])
    np.testing.assert_array_equal(yp, yj)


def test_bnn_pynq_trains_on_digits(tmp_path):
    acc = bnn_pynq.main(["--network", "TFC_1W1A", "--dataset", "digits", "--epochs", "2",
                         "--batch-size", "64", "--log-every", "1000", "--ckpt-dir",
                         str(tmp_path), "--device", "cpu"])
    assert acc > 0.3  # the JAX package's bound (tests/test_end_to_end.py)


@pytest.mark.parametrize("name", PRESETS)
def test_presets_match_jax(name):
    a, b = getattr(presets, name), getattr(jp, name)
    for field in type(a).__dataclass_fields__:
        assert str(getattr(a, field)) == str(getattr(b, field)), field


@pytest.mark.parametrize("cfg,per_channel", [("Int32Bias", False), ("Int32Bias", True),
                                              ("Int8Bias", False), ("Int16Bias", True)])
def test_constant_width_bias_quantizer_matches_jax(cfg, per_channel):
    rng = np.random.default_rng(3)
    b = rng.normal(0.0, 2.0, 16).astype(np.float32)
    scale = (rng.uniform(1e-4, 1e-2, (16, 1)) if per_channel
             else np.asarray(3e-3)).astype(np.float32)
    # codes past an 8-bit grid's ends, to reach the clamp
    b[:3] = np.asarray([1.0, -1.0, 0.5], np.float32) * 300.0 * scale.reshape(-1)[:3]
    want = JaxBiasQuantizer(getattr(jp, cfg))(jnp.asarray(b), input_scale=jnp.asarray(scale))
    got = BiasQuantizer(getattr(presets, cfg))(torch.from_numpy(b),
                                               input_scale=torch.from_numpy(scale))
    np.testing.assert_array_equal(got.value.numpy(), np.asarray(want.value))
    assert float(got.bit_width) == float(want.bit_width)
    q = BiasQuantizer(presets.Int32Bias)
    q.disable_quant = True
    assert q(torch.from_numpy(b)).bit_width is None


def _port_resnet(state: dict, merged: bool) -> torch.nn.Module:
    m = float_resnet(18, num_classes=10, width_mult=RESNET_WIDTH)
    if merged:
        PG.merge_batchnorms(m, m.bn_pairs())
    return load_jax_state(m, state)


def _assert_state(model, state: dict) -> None:
    for path, want in state.items():
        owner, _, name = path.rpartition(".")
        mod = model.get_submodule(owner)
        if isinstance(mod, (torch.nn.Conv2d, qnn.QuantConv2d)) and name in ("kernel", "weight"):
            got = mod.weight.detach().permute(2, 3, 1, 0)
        elif isinstance(mod, torch.nn.Linear) and name == "kernel":
            got = mod.weight.detach().t()
        else:
            got = getattr(mod, name).detach()
        np.testing.assert_array_equal(got.numpy(), want, err_msg=path)


def test_resnet_bn_pairs_and_regions_match_jax(jax_ref):
    m = _port_resnet(jax_ref["float_state"], merged=False)
    x = nchw(jax_ref["x"][:1])
    pairs = PG.find_bn_pairs(m, x)
    assert sorted(pairs) == sorted(jax_ref["pairs"]) and len(pairs) == 20
    assert sorted(m.bn_pairs()) == sorted(jax_ref["hand_pairs"])
    assert sorted(PG.discover_bn_pairs(m)) == sorted(jax_ref["pairs"])
    assert PG.extract_regions(m, x) == jax_ref["regions_before"] == []
    PG.merge_batchnorms(m, pairs)
    regions = PG.extract_regions(m, x)
    assert _sorted(regions) == _sorted(jax_ref["regions"]) and len(regions) == 12
    # the last region reaches the head through the global mean
    assert any("output" in sinks for _, sinks in regions)
    assert sum(len(s) > 1 for s, _ in regions) == 4


def test_merge_batchnorms_bit_for_bit(jax_ref):
    m = _port_resnet(jax_ref["float_state"], merged=False)
    PG.merge_batchnorms(m, jax_ref["pairs"])
    assert sum(isinstance(mod, qnn.FoldedBatchNorm) for mod in m.modules()) == 20
    _assert_state(m, jax_ref["merged_state"])


def test_merge_bn_into_quant_layers():
    """Output channel first: a QuantLinear's (out, in) and a QuantConv2d's
    (O, I, kh, kw) weights scale along axis 0, a missing bias is made."""
    rng = np.random.default_rng(5)
    for layer in (qnn.QuantLinear(6, 4, use_bias=False), qnn.QuantConv2d(3, 4, 3)):
        w0 = layer.weight.detach().clone()
        s, b, mu, var = (torch.from_numpy(rng.uniform(0.5, 1.5, 4).astype(np.float32))
                         for _ in range(4))
        qnn.merge_bn(layer, s, b, mu, var, 1e-5)
        mul = s / torch.sqrt(var + 1e-5)
        assert torch.equal(layer.weight, w0 * mul.reshape(-1, *(1,) * (w0.ndim - 1)))
        assert layer.bias is not None


def test_cross_layer_equalization_bit_for_bit(jax_ref):
    m = _port_resnet(jax_ref["merged_state"], merged=True)
    srcs, sinks = jax_ref["regions"][1]
    s = cross_layer_equalization([m.get_submodule(p) for p in srcs],
                                 [m.get_submodule(p) for p in sinks])
    np.testing.assert_array_equal(s.numpy(), jax_ref["s_first"])
    _assert_state(m, jax_ref["after_first_state"])
    PG.equalize(m, jax_ref["regions"], iterations=EQUALIZE_ITERATIONS)
    _assert_state(m, jax_ref["equalized_state"])


def test_flexml_quantize_and_calibration_match_jax(jax_ref):
    m = _port_resnet(jax_ref["equalized_state"], merged=True)
    PG.quantize_flexml(m, collect_stats_steps=CALIB_STEPS)
    x = nchw(jax_ref["x"])
    with torch.no_grad(), PG.calibration_mode(m):
        for _ in range(CALIB_STEPS):
            m(x)
    m.eval()
    layers = dict(PG.find_modules(m, qnn.QuantWBIOL))
    assert set(layers) == set(jax_ref["layers"])
    for path, (codes, w_scale, x_scale, kind) in jax_ref["layers"].items():
        layer = layers[path]
        qw = layer.quant_weight()
        got = (qw.value / qw.scale).detach()
        if got.ndim == 4:
            got = got.permute(2, 3, 1, 0)
        elif got.ndim == 2:
            got = got.t()
        assert type(layer).__name__ == kind
        np.testing.assert_array_equal(got.numpy(), codes, err_msg=path)
        np.testing.assert_array_equal(qw.scale.detach().numpy().reshape(-1),
                                      w_scale.reshape(-1), err_msg=path)
        np.testing.assert_array_equal(layer.input_quant(torch.zeros(1, 1)).scale.detach()
                                      .numpy().reshape(-1), x_scale.reshape(-1), err_msg=path)
    with torch.no_grad():
        y = m(x).numpy()
    want = jax_ref["y_quant"]
    assert np.abs(y - want).max() <= OUT_RTOL * np.abs(want).max()
    np.testing.assert_array_equal(y.argmax(1), want.argmax(1))


def test_residual_tap_blocks_bn_fold_and_becomes_quant_scale_bias(jax_ref):
    assert jax_ref["tap_pairs"] == []
    net = load_jax_state(TapNet(), jax_ref["tap_state"])
    assert PG.find_bn_pairs(net, torch.zeros(1, 8, 8, 8)) == []
    PG.quantize_flexml(net, collect_stats_steps=1)
    kind, w, b = jax_ref["tap_scale_bias"]
    assert type(net.bn).__name__ == kind == "QuantScaleBias"
    np.testing.assert_array_equal(net.bn.weight.detach().numpy(), w)
    np.testing.assert_array_equal(net.bn.bias.detach().numpy(), b)
    x = nchw(jax_ref["tap_x"])
    with torch.no_grad():
        with PG.calibration_mode(net):
            net(x)
        net.eval()
        y = net(x).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(y, jax_ref["tap_y"], rtol=0, atol=SCALE_BIAS_ATOL)


def test_channel_concat_stops_and_spatial_concat_passes(jax_ref):
    """JAX's channel axis is the last; the port's is axis 1 of an NCHW
    tensor: the traced layout decides, so the regions agree."""
    regions = PG.extract_regions(ConcatNet(), torch.zeros(1, 3, 8, 8))
    assert _sorted(regions) == _sorted(jax_ref["concat_regions"]) == [(("c",), ("d",))]


def test_convnet_pairs_and_regions_match_jax(jax_ref):
    net = FloatConvNet()
    x = torch.zeros(1, 1, 28, 28)
    pairs = PG.find_bn_pairs(net, x)
    assert pairs == jax_ref["convnet_pairs"] == [("c1", "bn1"), ("c2", "bn2")]
    assert PG.discover_bn_pairs(net) == jax_ref["convnet_declared"]
    PG.merge_batchnorms(net, pairs)
    assert _sorted(PG.extract_regions(net, x)) == _sorted(jax_ref["convnet_regions"])


def test_mobilenet_regions_after_bn_merge_match_jax(jax_ref):
    m = quant_mobilenet_v1(bit_width=None, width_scale=0.25, num_classes=10, pool_size=2,
                           device="cpu")
    m.eval()
    x = torch.zeros(1, 3, 64, 64)
    pairs = PG.find_bn_pairs(m, x)
    assert sorted(pairs) == sorted(jax_ref["mobilenet_pairs"])
    PG.merge_batchnorms(m, pairs)
    regions = PG.extract_regions(m, x)
    assert _sorted(regions) == _sorted(jax_ref["mobilenet_regions"])
    dw = {p for p, mod in m.named_modules() if isinstance(mod, qnn.QuantConv2d)
          and mod.groups > 1}
    assert dw <= {p for _, sinks in regions for p in sinks}
    assert dw <= {p for srcs, _ in regions for p in srcs}


def _port_ada_layer(kind: str, state: dict):
    if kind == "linear":
        layer = qnn.QuantLinear(32, 16, weight_quant=presets.Int8WeightPerChannelFloat.let(
            bit_width=4))
    else:
        layer = qnn.QuantConv2d(4, 8, 3, padding="SAME", weight_quant=(
            presets.Int8WeightPerTensorFloat.let(bit_width=4)))
    load_jax_state(layer, state)
    return layer.eval()


def _ada_x(kind: str, x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x) if kind == "linear" else nchw(x)


def _v_nchw(kind: str, v: np.ndarray) -> np.ndarray:
    return v.T if kind == "linear" else v.transpose(3, 2, 0, 1)


@pytest.mark.parametrize("kind", ["linear", "conv"])
@pytest.mark.parametrize("steps", ADAROUND_STEPS)
def test_adaround_v_tracks_jax(jax_ref, kind, steps):
    ref = jax_ref["adaround"][kind]
    layer = _port_ada_layer(kind, ref["state"])
    w = layer.weight.detach()
    w_s = w / plr._grid(layer, w)[0]
    on_grid = (w_s == torch.floor(w_s)).numpy()
    v, near, learned = plr._optimize_layer(layer, _ada_x(kind, ref["x"]), steps=steps,
                                           lr=ADAROUND_LR, lam=0.01, beta_start=20.0,
                                           beta_end=2.0, warmup=0.5)
    want_v, want_near, _ = ref["runs"][steps]
    diff = np.abs(v.numpy() - _v_nchw(kind, want_v))
    print(f"{kind}, {steps} steps: max |dv| {diff[~on_grid].max():.3g} off the grid, "
          f"{diff[on_grid].max():.3g} on it ({int(on_grid.sum())} weights)")
    assert (diff[~on_grid] <= ADAROUND_V_ATOL).all()
    assert (diff[on_grid] <= 2 * ADAROUND_LR * steps).all()
    assert near == pytest.approx(want_near, rel=1e-4)


@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_adaround_bake_and_decisions_match_jax(jax_ref, kind):
    ref = jax_ref["adaround"][kind]
    want_v = _v_nchw(kind, ref["runs"][ADAROUND_LONG][0])
    layer = _port_ada_layer(kind, ref["state"])
    plr._bake(layer, torch.from_numpy(np.ascontiguousarray(want_v)))
    np.testing.assert_array_equal(layer.weight.detach().numpy(), _v_nchw(kind, ref["baked"]))
    layer = _port_ada_layer(kind, ref["state"])
    v, near, learned = plr._optimize_layer(layer, _ada_x(kind, ref["x"]), steps=ADAROUND_LONG,
                                           lr=3e-3, lam=0.01, beta_start=20.0, beta_end=2.0,
                                           warmup=0.2)
    h, want_h = plr._rectified_sigmoid(v).numpy(), plr._rectified_sigmoid(
        torch.from_numpy(np.ascontiguousarray(want_v))).numpy()
    differ = (h >= 0.5) != (want_h >= 0.5)
    near_threshold = np.abs(want_h - 0.5) <= ADAROUND_MARGIN
    print(f"{kind}: {int(differ.sum())} decisions differ, {int(near_threshold.sum())} of "
          f"{h.size} within {ADAROUND_MARGIN} of the threshold")
    assert not (differ & ~near_threshold).any()
    assert learned <= near * 1.05  # AdaRound does not do worse than nearest here


def test_quant_weight_cache():
    layer = qnn.QuantLinear(8, 4).eval()
    PG.cache_inference_quant_weights(layer)
    cached = layer._cached_quant_weight
    assert layer.quant_weight() is cached
    layer.train()
    assert layer._cached_quant_weight is None
    PG.clip_float_weights(layer, 0.01)
    assert float(layer.weight.abs().max()) <= 0.01


@pytest.mark.parametrize("stride", [2, 3])
def test_strided_pointwise_conv_twin_runs_int8_matmul(monkeypatch, stride):
    """ResNet's downsampling shortcuts: a 1 x 1 conv at stride s serves on
    int8_matmul after subsampling its input, bit for bit the stride-1
    twin's output at every s-th position."""
    from brevitas_tpu_torch.graph import convert_int
    from brevitas_tpu_torch.graph.convert_int import Int8InferenceConv

    g = torch.Generator().manual_seed(7)
    convs = [qnn.QuantConv2d(8, 6, 1, stride=s, padding="VALID", generator=g,
                             weight_quant=presets.Int8WeightPerChannelFloat,
                             input_quant=presets.Uint8ActPerTensorFloat.let(
                                 collect_stats_steps=1)) for s in (1, stride)]
    convs[1].load_state_dict(convs[0].state_dict())
    x = torch.rand((2, 8, 11, 9), generator=g)
    for conv in convs:
        with torch.no_grad(), PG.calibration_mode(conv):
            conv(x)
        conv.eval()
    calls = []
    mm = convert_int.int8_matmul
    monkeypatch.setattr(convert_int, "int8_matmul",
                        lambda *a, **k: (calls.append(a[0].shape), mm(*a, **k))[1])
    twins = [Int8InferenceConv(conv) for conv in convs]
    assert all(t.pointwise for t in twins)
    with torch.no_grad():
        full, strided = (t(x) for t in twins)
        fq = convs[1](x)
    assert len(calls) == 2 and calls[1][0] == 2 * len(range(0, 11, stride)) * len(
        range(0, 9, stride))
    assert torch.equal(strided, full[:, :, ::stride, ::stride])
    assert strided.shape == fq.shape
    assert float((strided - fq).abs().max()) <= 1e-5 * float(fq.abs().max())
