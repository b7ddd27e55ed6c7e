"""The port's QuartzNet integer serving slice against the JAX package's.

A reduced QuartzNet, five topology entries: a k 5 stride-2 separable
prologue at 16 filters, two residual groups (16 filters k 7, 32 filters
k 9, two blocks each), a k 9 dilation-2 epilogue and the 1 x 1 epilogue to
64 filters, then the decoder with its bias; 8 features, T 32, batch 2.
Two bit-width configurations: ``quartznet_15x5`` (8 bits) and
``quartznet_15x5_4b`` (4 bits inside, 8 at the outer layers). Every JAX
model is built once for the module under ``nnx.jit``; each stage (the
train-mode forward that moves the BatchNorm statistics, the eval forward,
``convert_integer_inference`` and the converted forward) runs in JAX first
and the port repeats it from the JAX state of that stage
(``load_jax_state``). Data are made from numpy seeds, (B, T, C) for JAX and
transposed to the port's (B, C, T).

What is held to JAX:
- the train-mode forward, the BatchNorm running statistics after it, the
  eval forward, the twin of every conv after the conversion (type and path)
  and the converted logits;
- ``Int8InferenceConv`` in each mode: a frozen signed and a frozen
  unsigned input grid (border correction on a padded k 5 conv, the column
  sums on a pointwise one), a carried signed (QuantHardTanh) and unsigned
  (QuantReLU) grid, the float path of an input without a grid, and the
  float64 route of a conv whose worst-case sum passes 2^24; the pointwise
  twins go through ``int8_matmul`` and the others do not;
- ``QuantHardTanh`` (its own default config and a config whose threshold
  it sets): values, scale and gradients;
- ``QuantTensor`` sums (a signed 8-bit and an unsigned 4-bit grid, both
  orders): value, mean scale, bit width and sign; unequal scales raise
  outside training and pass in training; reshape and flatten keep the
  metadata.

Tolerances, each with its reason:
- activation codes: a code that differs between the packages is allowed
  only at a certified .5 tie (the two inputs to that quantizer on either
  side of the same half-integer boundary, within 1e-5 of the tensor's
  largest value of each other: float32 convs of fake-quant values and the
  BatchNorm statistics sum in other orders, and the port forms the
  statistics in float64); each such code is then set to JAX's in the port,
  so the rest compares the same codes;
- the train-mode and eval outputs within 1e-5 of the largest logit (the
  float32 conv sums in other orders, float64 BatchNorm statistics);
  running statistics within 1e-5 of their largest element;
- the converted logits within 1e-5 of the largest logit: the first
  depthwise conv takes the float path (its sum in another order), the
  BatchNorms in eval run elementwise float32 that XLA may fuse into FMAs
  (ROADMAP S1); the integer twins are exact, which the mode tests check
  bit for bit against the JAX twins run eagerly (no FMA contraction);
- the float path of a twin within ``(K + 2) 2^-24`` of ``sum |x w|``, K
  the fan-in; QuantHardTanh and the sums exact. The twins' modes run
  without a bias under ``jit`` (no add for XLA to contract into an FMA),
  and one with its bias eagerly: bit for bit.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from brevitas_tpu.graph import convert_integer_inference as jax_convert
from brevitas_tpu.graph.base import named_modules as jax_named_modules
from brevitas_tpu.graph.convert_int import Int8InferenceConv as JaxInt8InferenceConv
from brevitas_tpu.models import quartznet_15x5 as jax_quartznet_15x5
from brevitas_tpu.models import quartznet_15x5_4b as jax_quartznet_15x5_4b
from brevitas_tpu.nn import QuantConv1d as JaxQuantConv1d
from brevitas_tpu.nn import QuantHardTanh as JaxQuantHardTanh
from brevitas_tpu.nn import QuantReLU as JaxQuantReLU
from brevitas_tpu.quant.config import QuantConfig as JaxQuantConfig
from brevitas_tpu.quant.config import QuantType as JaxQuantType
from brevitas_tpu.quant.config import ScalingImplType as JaxScalingImplType
from brevitas_tpu.quant.quantizers import ActQuantizer as JaxActQuantizer
from brevitas_tpu.quant_tensor import QuantTensor as JaxQuantTensor
from brevitas_tpu.utils import eval_mode as jax_eval_mode
from brevitas_tpu_torch import graph as G
from brevitas_tpu_torch.graph import convert_int
from brevitas_tpu_torch.graph.convert_int import Int8InferenceConv, conv_acc_dtype
from brevitas_tpu_torch.interop import load_jax_state
from brevitas_tpu_torch.models import quartznet_15x5, quartznet_15x5_4b
from brevitas_tpu_torch.nn import QuantConv1d, QuantHardTanh, QuantReLU
from brevitas_tpu_torch.nn.conv import conv_nd
from brevitas_tpu_torch.quant.config import QuantConfig, ScalingImplType
from brevitas_tpu_torch.quant.quantizers import ActQuantizer
from brevitas_tpu_torch.quant_tensor import QuantTensor

torch.set_num_threads(1)

# (filters, repeat, kernel, stride, dilation, residual, separable)
TOPOLOGY = ((16, 1, 5, 2, 1, False, True),
            (16, 2, 7, 1, 1, True, True),
            (32, 2, 9, 1, 1, True, True),
            (32, 1, 9, 1, 2, False, True),
            (64, 1, 1, 1, 1, False, False))
FEATURES, FRAMES, BATCH = 8, 32, 2
CONFIGS = {"8b": (jax_quartznet_15x5, quartznet_15x5),
           "4b": (jax_quartznet_15x5_4b, quartznet_15x5_4b)}
TIE_SHARE = 1e-5
STAGES = ("train", "eval", "converted")

# Int8InferenceConv modes: (name, in, out, kernel, padding, groups, input
# grid): "frozen_signed"/"frozen_unsigned" an input quantizer, "carried_*"
# a QuantTensor from a QuantHardTanh (signed) or a QuantReLU (unsigned),
# "float" a plain tensor; weights 8 bits per channel
MODES = [("frozen_signed", 8, 6, 5, 2, 1, "frozen_signed"),
         ("frozen_unsigned_border", 8, 8, 5, 2, 8, "frozen_unsigned"),
         ("frozen_unsigned_pointwise", 8, 6, 1, 0, 1, "frozen_unsigned"),
         ("carried_signed_pointwise", 8, 6, 1, 0, 1, "carried_signed"),
         ("carried_unsigned_border", 8, 8, 7, 3, 8, "carried_unsigned"),
         ("carried_unsigned_pointwise", 8, 6, 1, 0, 1, "carried_unsigned"),
         ("float_no_grid", 8, 8, 5, 2, 8, "float"),
         # 128 x 9 = 1,152 taps of at most 128 x 127: past 2^24
         ("float64_route", 128, 4, 9, 4, 1, "carried_signed")]
MODE_IDS = [m[0] for m in MODES]


def jax_arrays(model) -> dict:
    return {".".join(map(str, path)): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model)) if path[0] != "rngs"}


def to_port(v: np.ndarray) -> np.ndarray:
    """Channels-last (B, ..., C) to the port's (B, C, ...)."""
    v = np.asarray(v)
    return np.ascontiguousarray(np.moveaxis(v, -1, 1)) if v.ndim > 2 else v


def features(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).random((BATCH, FRAMES, FEATURES), dtype=np.float32)


@contextlib.contextmanager
def jax_act_records(store: list):
    """Record each INT activation quantizer call of the JAX package, in call
    order: (input, output value, scale)."""
    orig = JaxActQuantizer.__call__

    def call(self, x):
        out = orig(self, x)
        if self.quant_type != JaxQuantType.NONE:
            store.append((x, out.value, out.scale))
        return out

    JaxActQuantizer.__call__ = call
    try:
        yield
    finally:
        JaxActQuantizer.__call__ = orig


class ForceJaxCodes:
    """Forward hooks on the port's INT activation quantizers: the i-th call
    meets JAX's i-th record; each output that differs from JAX's must be a
    certified .5 tie (module docstring) and then takes JAX's value,
    unchanged in its gradient."""

    def __init__(self, model, records):
        self.records, self.calls, self.flips = records, 0, 0
        self.handles = [m.register_forward_hook(self.hook) for m in model.modules()
                        if isinstance(m, ActQuantizer) and m.quant_type.value == "int"]

    def hook(self, module, args, out):
        want_x, want_y, want_s = self.records[self.calls]
        # JAX's per-channel scale lies on the last axis of its values
        want_s = to_port(np.broadcast_to(want_s, np.shape(want_y)))
        want_x, want_y = to_port(want_x), to_port(want_y)
        self.calls += 1
        got_y, got_s = out.value.detach().numpy(), out.scale.detach().numpy()
        assert got_y.shape == want_y.shape
        # a learned LOG_FP scale is 2 ** v: XLA's float32 pow is not
        # correctly rounded under jit (2 ulps)
        s = np.broadcast_to(got_s, got_y.shape)
        assert np.all(np.abs(s - want_s) <= 2 * np.spacing(want_s))
        want_codes = np.round(want_y / want_s)
        got_codes = np.round(got_y / s)
        differ = got_codes != want_codes
        if differ.any():
            s = s[differ]
            got_x = args[0].detach().numpy()[differ]
            c_got, c_want = got_codes[differ], want_codes[differ]
            half = (c_got + c_want) / 2
            ok = ((np.abs(c_got - c_want) == 1)
                  & ((got_x / s - half) * (want_x[differ] / s - half) <= 0)
                  & (np.abs(got_x - want_x[differ]) <= TIE_SHARE * np.abs(want_x).max()))
            assert ok.all(), (f"quantizer call {self.calls - 1}: {int((~ok).sum())} codes "
                              "differ from JAX's away from a .5 tie")
            self.flips += int(differ.sum())
        # JAX's codes on the port's own grid, unchanged in the gradient
        forced = want_codes * np.broadcast_to(got_s, got_y.shape)
        if np.array_equal(forced, got_y):
            return out
        return QuantTensor(out.value + torch.from_numpy((forced - got_y).astype(np.float32)),
                           out.scale, out.zero_point, out.bit_width, signed=out.signed,
                           training=out.training)

    def remove(self):
        for h in self.handles:
            h.remove()


def twin_paths(named) -> dict:
    return {path: type(mod).__name__ for path, mod in named
            if type(mod).__name__.startswith("Int8Inference")}


# -- the modes of the conv twin ------------------------------------------------

def jax_act_cfg(signed: bool, threshold: float):
    return JaxQuantConfig(bit_width=8.0, signed=signed, narrow_range=False,
                          scaling_impl=JaxScalingImplType.PARAMETER, scaling_const=threshold)


def port_act_cfg(signed: bool, threshold: float):
    return QuantConfig(bit_width=8.0, signed=signed, narrow_range=False,
                       scaling_impl=ScalingImplType.PARAMETER, scaling_const=threshold)


def mode_case(name):
    return next(m for m in MODES if m[0] == name)


def build_jax_mode_conv(name, use_bias: bool):
    from brevitas_tpu.quant import presets as jp

    _, cin, cout, k, pad, groups, grid = mode_case(name)
    in_q = jax_act_cfg(grid == "frozen_signed", 1.5) if grid.startswith("frozen") else None
    m = JaxQuantConv1d(cin, cout, k, padding=[(pad, pad)], groups=groups, use_bias=use_bias,
                       weight_quant=jp.Int8WeightPerChannelFloat, input_quant=in_q,
                       rngs=nnx.Rngs(MODE_IDS.index(name)))
    if use_bias:
        m.bias[...] = jnp.asarray(np.random.default_rng(40 + MODE_IDS.index(name))
                                  .standard_normal(cout).astype(np.float32) * 0.1)
    return m


def mode_input(name):
    """(B, T, C) values over both clamps of the grid."""
    _, cin, *_ = mode_case(name)
    rng = np.random.default_rng(60 + MODE_IDS.index(name))
    return (rng.standard_normal((BATCH, 16, cin)) * 0.8).astype(np.float32)


def jax_grid_quantizer(grid):
    if grid == "carried_signed":
        return JaxQuantHardTanh(jax_act_cfg(True, 1.0), return_quant_tensor=True)
    return JaxQuantReLU(jax_act_cfg(False, 2.0), return_quant_tensor=True)


def port_grid_quantizer(grid):
    if grid == "carried_signed":
        return QuantHardTanh(port_act_cfg(True, 1.0), return_quant_tensor=True)
    return QuantReLU(port_act_cfg(False, 2.0), return_quant_tensor=True)


# -- the JAX references ----------------------------------------------------------

def _jax_model(key):
    jax_fn = CONFIGS[key][0]
    return jax_fn(num_features=FEATURES, topology=TOPOLOGY, rngs=nnx.Rngs(0))


@pytest.fixture(scope="module")
def jax_ref():
    """Every JAX result of the file, as numpy."""
    r = {}
    models = nnx.jit(lambda: {key: _jax_model(key) for key in CONFIGS})()
    r["init"] = {key: jax_arrays(m) for key, m in models.items()}
    xs = {key: jnp.asarray(features(i)) for i, key in enumerate(CONFIGS)}

    def forward(models, xs):
        out = {}
        for key, m in models.items():
            store = []
            with jax_act_records(store):
                out[key] = (m(xs[key]), store)
        return out

    # the train-mode forward moves the BatchNorm statistics
    graphdef, state = nnx.split(models)

    @jax.jit
    def train(state, xs):
        ms = nnx.merge(graphdef, state)
        out = forward(ms, xs)
        return out, nnx.state(ms)

    out, state = train(state, xs)
    nnx.update(models, state)
    r["train"] = jax.tree.map(np.asarray, out)
    r["after_train"] = {key: jax_arrays(m) for key, m in models.items()}

    # the eval forward, the conversion (traced: the twins' arrays are the
    # state's) and the converted forward in one program; the bit widths of
    # the conversion concrete (ROADMAP S10)
    for m in models.values():
        jax_eval_mode(m)
    graphdef, state = nnx.split(models)
    r["twins"] = {}

    @jax.jit
    def serve(state, xs):
        ms = nnx.merge(graphdef, state)
        out = {"eval": forward(ms, xs)}
        with jax.ensure_compile_time_eval():
            for key, m in ms.items():
                jax_convert(m)
                r["twins"][key] = twin_paths(jax_named_modules(m))
        out["converted"] = forward(ms, xs)
        return out

    r.update(jax.tree.map(np.asarray, serve(state, xs)))

    # each mode of the conv twin: without a bias under one jit (the epilogue
    # has no add for XLA to contract into an FMA: S1); the first mode again
    # with its bias, eagerly
    convs = nnx.jit(lambda: {name: build_jax_mode_conv(name, use_bias=False)
                             for name in MODE_IDS})()
    r["mode_state"] = {name: jax_arrays(m) for name, m in convs.items()}
    mode_x = {name: jnp.asarray(mode_input(name)) for name in MODE_IDS}
    grids = {g: jax_grid_quantizer(g) for g in ("carried_signed", "carried_unsigned")}
    for m in [*convs.values(), *grids.values()]:
        jax_eval_mode(m)

    # built eagerly: a twin built inside a trace lets XLA rewrite the
    # arithmetic of its frozen scales (1-ulp differences from the eager twin)
    twins = {name: JaxInt8InferenceConv(conv) for name, conv in convs.items()}

    @nnx.jit
    def modes(twins, grids, mode_x):
        out = {}
        for name, twin in twins.items():
            grid = mode_case(name)[-1]
            x = grids[grid](mode_x[name]) if grid.startswith("carried") else mode_x[name]
            out[name] = twin(x)
        return out

    r["mode"] = jax.tree.map(np.asarray, modes(twins, grids, mode_x))
    m = build_jax_mode_conv(MODE_IDS[0], use_bias=True)
    r["mode_state_bias"] = jax_arrays(m)
    jax_eval_mode(m)
    r["mode_bias"] = np.asarray(JaxInt8InferenceConv(m)(mode_x[MODE_IDS[0]]))

    # QuantHardTanh: its default config, and a config without a threshold
    rng = np.random.default_rng(5)
    ht_x = (rng.standard_normal((3, 7, 6)) * 1.5).astype(np.float32)
    r["ht_x"] = ht_x
    cfg_unset = JaxQuantConfig(bit_width=4.0, signed=True,
                               scaling_impl=JaxScalingImplType.PARAMETER)
    for name, ht in (("default", JaxQuantHardTanh(max_val=2.0, min_val=-3.0,
                                                  return_quant_tensor=True)),
                     ("unset", JaxQuantHardTanh(cfg_unset, max_val=0.5, min_val=-0.75,
                                                return_quant_tensor=True))):
        def f(mm, v):
            qt = mm(v)
            return jnp.sum(qt.value * jnp.arange(qt.value.size).reshape(qt.value.shape)), qt

        (_, qt), (gm, gx) = nnx.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            ht, jnp.asarray(ht_x))
        r[f"ht_{name}"] = {"value": np.asarray(qt.value), "scale": np.asarray(qt.scale),
                           "bit_width": float(qt.bit_width), "dx": np.asarray(gx),
                           "dscale": np.asarray(gm["act_quant"]["scaling"]["value"][...]),
                           "state": jax_arrays(ht)}

    # QuantTensor sums: a signed 8-bit and an unsigned 4-bit grid
    a = JaxQuantTensor(jnp.asarray([[0.5, -1.0, 0.25]]), jnp.asarray(0.25), jnp.asarray(0.0),
                       jnp.asarray(8.0), signed=True)
    b = JaxQuantTensor(jnp.asarray([[0.75, 0.0, 3.75]]), jnp.asarray(0.25), jnp.asarray(0.0),
                       jnp.asarray(4.0), signed=False)
    for name, v in (("sum", a + b), ("sum_reversed", b + a)):
        r[f"qt_{name}"] = (np.asarray(v.value), float(v.scale), float(v.bit_width), v.signed)
    return r


# -- the model ---------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(CONFIGS))
def port_run(request, jax_ref):
    """The port repeats each stage from the JAX state of that stage, its
    codes forced to JAX's at certified ties."""
    key = request.param
    model = CONFIGS[key][1](num_features=FEATURES, topology=TOPOLOGY, device="cpu")
    load_jax_state(model, jax_ref["init"][key])
    x = torch.from_numpy(to_port(features(list(CONFIGS).index(key))))
    r = {"key": key, "flips": {}}
    for stage in STAGES:
        if stage == "eval":
            # the JAX model's state after its train-mode forward
            load_jax_state(model, jax_ref["after_train"][key])
            model.eval()
        if stage == "converted":
            G.convert_integer_inference(model)
            r["twins"] = twin_paths(model.named_modules())
        force = ForceJaxCodes(model, jax_ref[stage][key][1])
        with torch.no_grad():
            r[stage] = model(x).numpy()
        force.remove()
        assert force.calls == len(jax_ref[stage][key][1])
        r["flips"][stage] = force.flips
        if stage == "train":
            r["running"] = {n: b.numpy().copy() for n, b in model.named_buffers()
                            if n.endswith((".mean", ".var"))}
    print(f"{key}: codes set to JAX's at certified ties {r['flips']}")
    return r


@pytest.mark.parametrize("stage", STAGES)
def test_quartznet_logits_match_jax(jax_ref, port_run, stage):
    want = to_port(jax_ref[stage][port_run["key"]][0])
    got = port_run[stage]
    assert got.shape == want.shape == (BATCH, 29, FRAMES // 2)
    assert np.isfinite(got).all()
    assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want).max()), stage


def test_quartznet_running_statistics_match_jax(jax_ref, port_run):
    want = jax_ref["after_train"][port_run["key"]]
    assert len(port_run["running"]) == 2 * (1 + 3 + 3 + 1 + 1)
    for name, got in port_run["running"].items():
        exp = want[name]
        assert np.all(np.abs(got - exp) <= 1e-5 * np.abs(exp).max()), name


def test_quartznet_conversion_makes_the_same_twins(jax_ref, port_run):
    want = jax_ref["twins"][port_run["key"]]
    assert port_run["twins"] == want
    # 6 separable blocks (depthwise and pointwise), 2 residual 1 x 1s, the
    # 1 x 1 epilogue and the decoder
    assert len(want) == 16 and set(want.values()) == {"Int8InferenceConv"}


def test_quartznet_pointwise_twins_launch_int8_matmul(jax_ref, monkeypatch):
    """A converted forward calls int8_matmul once per pointwise conv: the
    six separable blocks' pointwise halves, two residual 1 x 1s, the 1 x 1
    epilogue and the decoder."""
    calls = []
    mm = convert_int.int8_matmul
    monkeypatch.setattr(convert_int, "int8_matmul",
                        lambda *a, **k: (calls.append(a[0].shape), mm(*a, **k))[1])
    model = quartznet_15x5(num_features=FEATURES, topology=TOPOLOGY, device="cpu")
    load_jax_state(model, jax_ref["after_train"]["8b"])
    model.eval()
    G.convert_integer_inference(model)
    with torch.no_grad():
        model(torch.from_numpy(to_port(features(0))))
    assert len(calls) == 10
    assert all(shape == (BATCH * FRAMES // 2, shape[1]) for shape in calls)


# -- the conv twin's modes ------------------------------------------------------

def build_port_mode(name, state, use_bias=False):
    from brevitas_tpu_torch.quant import presets

    _, cin, cout, k, pad, groups, grid = mode_case(name)
    in_q = port_act_cfg(grid == "frozen_signed", 1.5) if grid.startswith("frozen") else None
    m = QuantConv1d(cin, cout, k, padding=((pad, pad),), groups=groups, use_bias=use_bias,
                    weight_quant=presets.Int8WeightPerChannelFloat, input_quant=in_q,
                    device="cpu")
    load_jax_state(m, state)
    m.eval()
    return m


@pytest.mark.parametrize("name", MODE_IDS)
def test_int8_inference_conv_mode_matches_jax(jax_ref, name, monkeypatch):
    grid = mode_case(name)[-1]
    conv = build_port_mode(name, jax_ref["mode_state"][name])
    twin = Int8InferenceConv(conv)
    calls = []
    mm = convert_int.int8_matmul
    monkeypatch.setattr(convert_int, "int8_matmul",
                        lambda *a, **k: (calls.append(1), mm(*a, **k))[1])
    x = torch.from_numpy(to_port(mode_input(name)))
    if grid.startswith("carried"):
        q = port_grid_quantizer(grid)
        q.eval()
        x = q(x)
    with torch.no_grad():
        got = twin(x).numpy()
    want_twin = to_port(jax_ref["mode"][name])
    assert got.shape == want_twin.shape
    assert len(calls) == (1 if twin.pointwise and grid != "float" else 0)
    if grid == "float":
        # the float path: the conv of the dequantized weights in float32
        w = twin.w_int.double() * twin.w_scale.double().reshape(-1, 1, 1)
        xv = x.double()
        mass = conv_nd(xv.abs(), w.abs(), conv.stride, conv.pads(xv.shape[2:]), conv.dilation,
                       conv.groups).numpy()
        assert np.all(np.abs(got - want_twin) <= (conv.reduce_size + 2) * 2.0 ** -24 * mass)
    else:
        np.testing.assert_array_equal(got, want_twin)
    if name == "float64_route":
        assert twin.acc_dtype == torch.float64
    elif not twin.pointwise:
        assert twin.acc_dtype == torch.float32
    # the twin serves the function of the fake-quant layer
    with torch.no_grad():
        fq = conv(x)
    fq = fq.value if isinstance(fq, QuantTensor) else fq
    assert np.all(np.abs(got - fq.numpy()) <= 1e-5 * np.abs(fq.numpy()).max() + 1e-6)


def test_int8_inference_conv_bias_epilogue_matches_eager_jax(jax_ref):
    """``acc * (x_scale * w_scale) + bias``, each step rounded, as JAX's
    eager twin forms it."""
    name = MODE_IDS[0]
    twin = Int8InferenceConv(build_port_mode(name, jax_ref["mode_state_bias"], use_bias=True))
    with torch.no_grad():
        got = twin(torch.from_numpy(to_port(mode_input(name)))).numpy()
    assert np.abs(twin.bias.numpy()).min() > 0
    np.testing.assert_array_equal(got, to_port(jax_ref["mode_bias"]))


@pytest.mark.parametrize("fan_in,bits,narrow,want", [
    (87, 8, True, torch.float32),       # QuartzNet's widest depthwise: 1.41 M
    (512, 8, True, torch.float32),      # a 1 x 1 at 512 channels: 8.3 M
    (1032, 8, True, torch.float32),     # 16,773,120: the last under 2^24
    (1033, 8, True, torch.float64),
    (2304, 8, True, torch.float64),     # CNV's 3 x 3 at 256 channels: 37.7 M
    (2304, 4, True, torch.float32),     # at 4 bits: 2.1 M
    (1024, 8, False, torch.float64)])   # |w| up to 128: exactly 2^24
def test_conv_acc_dtype_rule(fan_in, bits, narrow, want):
    assert conv_acc_dtype(fan_in, bits, narrow) == want


def test_int8_inference_conv_refuses_wide_weights():
    conv = QuantConv1d(4, 4, 3, weight_quant=QuantConfig(bit_width=9.0, narrow_range=True),
                       device="cpu")
    with pytest.raises(ValueError):
        Int8InferenceConv(conv)


# -- QuantHardTanh ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["default", "unset"])
def test_quant_hard_tanh_matches_jax(jax_ref, name):
    want = jax_ref[f"ht_{name}"]
    if name == "default":
        ht = QuantHardTanh(max_val=2.0, min_val=-3.0, return_quant_tensor=True)
        # the threshold covers both bounds
        assert ht.act_quant.cfg.scaling_const == 3.0 and ht.act_quant.cfg.narrow_range
    else:
        ht = QuantHardTanh(QuantConfig(bit_width=4.0, signed=True,
                                       scaling_impl=ScalingImplType.PARAMETER),
                           max_val=0.5, min_val=-0.75, return_quant_tensor=True)
        assert ht.act_quant.cfg.scaling_const == 0.75
    load_jax_state(ht, want["state"])
    x = torch.from_numpy(jax_ref["ht_x"]).requires_grad_()
    qt = ht(x)
    weights = torch.arange(qt.value.numel(), dtype=torch.float32).reshape(qt.value.shape)
    (qt.value * weights).sum().backward()
    np.testing.assert_array_equal(qt.value.detach().numpy(), want["value"])
    assert float(qt.scale.detach()) == float(want["scale"])
    assert qt.bit_width == want["bit_width"]
    np.testing.assert_array_equal(x.grad.numpy(), want["dx"])
    dscale = ht.act_quant.scaling.value.grad.numpy()
    assert np.all(np.abs(dscale - want["dscale"]) <= 1e-5 * np.abs(want["dscale"]).max())


# -- QuantTensor algebra --------------------------------------------------------------

def port_pair(training=False):
    a = QuantTensor(torch.tensor([[0.5, -1.0, 0.25]]), torch.tensor(0.25), 0.0, 8.0,
                    signed=True, training=training)
    b = QuantTensor(torch.tensor([[0.75, 0.0, 3.75]]), torch.tensor(0.25), 0.0, 4.0,
                    signed=False, training=training)
    return a, b


@pytest.mark.parametrize("name", ["sum", "sum_reversed"])
def test_quant_tensor_algebra_matches_jax(jax_ref, name):
    a, b = port_pair()
    got = a + b if name == "sum" else b + a
    value, scale, bit_width, signed = jax_ref[f"qt_{name}"]
    np.testing.assert_array_equal(got.value.numpy(), value)
    assert float(got.scale) == scale and got.bit_width == bit_width and got.signed == signed


def test_quant_tensor_sum_of_unequal_scales_raises_outside_training():
    a, b = port_pair()
    b.scale = torch.tensor(0.5)
    with pytest.raises(ValueError):
        a + b
    b.scale = torch.tensor([0.25, 0.25])
    with pytest.raises(ValueError):
        a + b
    a, b = port_pair(training=True)
    b.scale = torch.tensor(0.5)
    out = a + b
    assert float(out.scale) == 0.375 and out.training


def test_quant_tensor_sum_with_plain_values_and_shape_views():
    a, b = port_pair()
    plain = a + torch.ones(1, 3)
    assert plain.scale is None and torch.equal(plain.value, a.value + 1)
    assert (b + QuantTensor(torch.ones(1, 3))).scale is None
    r = a.reshape(3, 1)
    assert r.value.shape == (3, 1) and r.scale is a.scale and r.bit_width == 8.0
    f = a.flatten()
    assert f.value.shape == (3,) and f.signed is True and a.shape == (1, 3)


def test_quartznet_defaults_to_the_card():
    """The default device is the card, which raises where there is none."""
    if torch.cuda.is_available():
        model = quartznet_15x5(num_features=FEATURES, topology=TOPOLOGY)
        assert next(model.parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            quartznet_15x5(num_features=FEATURES, topology=TOPOLOGY)
