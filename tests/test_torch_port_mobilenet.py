"""The port's MobileNetV1 4-bit QAT slice against the JAX package's.

A reduced ``quant_mobilenet_v1(bit_width=4)``: ``width_scale=0.125`` (4 to
128 channels), 64 px inputs, ``pool_size=2`` (the features end at 2 x 2),
batch 4, 10 classes. Every JAX result is computed once for the module, its
models built under ``nnx.jit`` and its references under ``jax.jit``
compiled with ``xla_allow_excess_precision`` off (with it on, XLA on the
CPU drops the bf16 rounding of a bf16 conv's result that JAX's conv VJP
asks for: ROADMAP S11). The port starts from the JAX model's state
(``load_jax_state``); data are made from numpy seeds, NHWC for JAX and
transposed to the port's NCHW.

What is held to JAX:
- one QAT step (bench.py's ``mobilenetv1_4b_qat``: softmax cross-entropy,
  Adam at lr 1e-3, no clipping) in float32 and under
  ``set_compute_dtype(bf16)``: the logits, the loss, every gradient and
  every parameter after Adam;
- the per-channel ``ActQuantizer`` (one learned threshold a channel, over
  axis 1 of the port's activations) on 4-D and 3-D inputs: values, the
  (C, 1, ...) scale, gradients to the input and the thresholds;
- ``IntBias`` on a QuantLinear fed a QuantTensor (MobileNet's head) and on
  a depthwise QuantConv2d fed a per-channel grid: output, scale, bit width
  ``max(bias, acc) + 1``, and the gradients of the input, weight and bias;
  the same depthwise conv again with bf16 operands (the code-domain branch
  on a per-channel grid, which the whole-model step reaches only behind
  every conv below it);
- ``trunc_int_quant`` with ``floor_ste`` and the FLOOR float-to-int map:
  values and straight-through gradients;
- ``QuantAvgPool2d`` on random codes at 2 x 2 and 7 x 7 (the divide-by-64
  case) with a grid, and the plain mean without one: values, scale, bit
  width, gradients.

Tolerances, each with its reason:
- activation codes: a code that differs between the packages is allowed
  only at a certified .5 tie (the two inputs on either side of the same
  half-integer boundary, within 1e-5 of the tensor's largest value of each
  other: convs sum in other orders, and the port forms the BatchNorm
  statistics in float64); it is then set to JAX's in the port;
- logits within 1e-5 of the largest, the loss within 1e-6 relative;
- a BatchNorm output that is 0 in exact arithmetic (the mean of integer
  multiples of one step can equal an element exactly) rounds to either side
  of the ReLU's kink: where one package's ReLU input is 0 after the ReLU
  and the other's is not, both must lie within 1e-5 of the tensor's
  largest value of 0, and the port's input then takes JAX's value, so the
  ReLU passes the gradient where JAX's does;
- gradients in float32 within 1e-4 of each tensor's largest element (the
  BatchNorm backward over N, H and W and the conv sums in other orders),
  the learned thresholds' within 1e-3 (each sums ``code - x / s`` over
  every element of its activation, terms of both signs that cancel, so the
  two packages' float32 sums in other orders differ in more of the
  result's digits: up to 3.4e-4 of the largest seen); in
  bf16 each conv's backward rounds its upstream gradient and both results
  to bf16, so where the packages' float32 values differ in their last bits
  a rounding falls either way (S11) and spreads through the convs below.
  That spread has no useful bound a priori (one bf16 step a conv would
  be 0.2 of the largest element at the stem), so the bf16 limit is set
  from the readings: 2^-6 of a tensor's largest element added to the
  float32 limit, about twice the largest share seen (8.3e-3, the threshold
  of features.2's depthwise stage; 3.8e-3 for any other tensor, and below
  3e-5 beneath features.3 but for features.7's depthwise stage, 5.6e-4).
  The test prints each share. One conv alone, fed the same cotangent, is
  held to one bf16 step of each element (the per-layer check below);
- parameters after Adam within 6.44e-6 lr (optax forms the bias correction
  in float32, torch in float64: S8) plus 4 ulps of the largest of ``p``,
  ``u`` and ``p + u`` plus the difference of the first update ``lr g /
  (|g| + eps)`` of the two packages' gradients;
- the per-channel quantizer, the quantized biases, the truncation and the
  pools exact, except the plain mean (the port sums in float64 and rounds
  once: within 1 ulp of JAX's float32 sum); the IntBias layers' outputs
  within ``(K + 2) 2^-24`` of ``sum |x w| + |b|`` and their input
  gradients of ``sum |g w|`` (float32 sums in other orders) and the truncation's scale gradient within 1e-5 (a float32 sum of
  40 terms in another order). With bf16 operands the depthwise conv's
  output is exact (products of small integer codes summed in float32 are
  exact), and each backward conv's result is rounded to bf16 once, so
  where the packages' float32 sums differ in their last bits the rounding
  can fall either way: its input and weight gradients within one bf16 step
  (2^-7) of each element plus 1e-5 of the largest, the bias's and the
  thresholds' within 1e-5 and 2^-7 of their largest (sums over the
  rounded elements). These module references run eagerly: under
  ``jit`` XLA's float32 pow (the LOG_FP scales) is not correctly rounded.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from brevitas_tpu.core import quant as JQ
from brevitas_tpu.core import restrict as JR
from brevitas_tpu.models import quant_mobilenet_v1 as jax_quant_mobilenet_v1
from brevitas_tpu.models.mobilenetv1 import common_uint_act_quant as jax_uint_act_quant
from brevitas_tpu.nn import QuantAvgPool2d as JaxQuantAvgPool2d
from brevitas_tpu.nn import QuantConv2d as JaxQuantConv2d
from brevitas_tpu.nn import QuantLinear as JaxQuantLinear
from brevitas_tpu.nn import QuantReLU as JaxQuantReLU
from brevitas_tpu.ops import floor_ste as jax_floor_ste
from brevitas_tpu.quant import presets as jax_presets
from brevitas_tpu.quant.config import QuantType as JaxQuantType
from brevitas_tpu.quant.quantizers import ActQuantizer as JaxActQuantizer
from brevitas_tpu.utils import set_compute_dtype as jax_set_compute_dtype
from brevitas_tpu_torch.core import quant as Q
from brevitas_tpu_torch.core import restrict as R
from brevitas_tpu_torch.interop import load_jax_state
from brevitas_tpu_torch.models import quant_mobilenet_v1
from brevitas_tpu_torch.models.mobilenetv1 import common_uint_act_quant
from brevitas_tpu_torch.nn import QuantAvgPool2d, QuantConv2d, QuantLinear, QuantReLU
from brevitas_tpu_torch.nn.conv import conv_nd
from brevitas_tpu_torch.ops import floor_ste
from brevitas_tpu_torch.quant import presets
from brevitas_tpu_torch.quant.quantizers import ActQuantizer, BiasQuantizer
from brevitas_tpu_torch.quant_tensor import QuantTensor
from brevitas_tpu_torch.utils import set_compute_dtype

torch.set_num_threads(1)

NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}
BATCH, PX, CLASSES, LR, ADAM_EPS = 4, 64, 10, 1e-3, 1e-8
MODEL_KW = dict(bit_width=4, width_scale=0.125, num_classes=CLASSES, pool_size=2)
S8_ADAM = 6.44e-6
# one bf16 step relative to the element (8 significant bits)
BF16_ULP = 2.0 ** -7
# of a tensor's largest gradient, added in bf16 (module docstring)
BF16_STEP_SHARE = 2.0 ** -6
TIE_SHARE = 1e-5
# of a learned threshold's largest gradient (module docstring)
SCALE_GRAD_SHARE = 1e-3
# (name, input shape channels-last, channels): the per-channel quantizer
PER_CHANNEL_CASES = [("nhwc", (2, 5, 6, 8), 8), ("nlc", (3, 7, 5), 5)]
# (window, input spatial size, stride): the pools
POOL_CASES = [(2, 4, 2), (7, 7, 1)]


def jax_arrays(model) -> dict:
    return {".".join(map(str, path)): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model)) if path[0] != "rngs"}


def flat(state) -> dict:
    return {".".join(map(str, path)): np.asarray(v[...])
            for path, v in nnx.to_flat_state(state)}


def to_port(v) -> np.ndarray:
    """Channels-last (N, ..., C) to the port's (N, C, ...)."""
    v = np.asarray(v)
    return np.ascontiguousarray(np.moveaxis(v, -1, 1)) if v.ndim > 2 else v


def port_param(t: torch.Tensor, path: str) -> np.ndarray:
    """A port parameter in the JAX layout: conv weights OIHW -> HWIO, the
    head's (out, in) -> (in, out)."""
    v = t.detach().numpy().copy()
    if path.endswith("weight") and v.ndim == 4:
        return np.ascontiguousarray(np.moveaxis(v, (0, 1), (-1, -2)))
    if path.endswith("weight") and v.ndim == 2:
        return v.T
    return v


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
    certified .5 tie and then takes JAX's value, unchanged in its
    gradient."""

    def __init__(self, model, records):
        self.records, self.calls, self.flips, self.kinks = records, 0, 0, 0
        self.handles = [m.register_forward_hook(self.hook) for m in model.modules()
                        if isinstance(m, ActQuantizer) and m.quant_type.value == "int"]
        self.handles += [m.register_forward_pre_hook(self.relu_kink) for m in model.modules()
                         if isinstance(m, QuantReLU)]

    def relu_kink(self, module, args):
        """Before the ReLU whose quantizer makes the next call: where one
        package's input is 0 after the ReLU and the other's is not, both
        must lie within the tie share of 0 (a BatchNorm output that is 0 in
        exact arithmetic, rounded to either side); the port's input then
        takes JAX's value after the ReLU, so the ReLU's gradient mask is
        JAX's."""
        x = args[0].value if isinstance(args[0], QuantTensor) else args[0]
        want_x = to_port(self.records[self.calls][0])
        got_x = torch.relu(x).detach().numpy()
        differ = (got_x == 0) != (want_x == 0)
        if not differ.any():
            return None
        near = TIE_SHARE * np.abs(want_x).max()
        assert np.all(np.abs(x.detach().numpy()[differ]) <= near)
        assert np.all(want_x[differ] <= near)
        self.kinks += int(differ.sum())
        fix = np.where(differ, want_x - x.detach().numpy(), 0.0).astype(np.float32)
        return (x + torch.from_numpy(fix),)

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


def per_channel_input(i):
    _, shape, _ = PER_CHANNEL_CASES[i]
    return (np.random.default_rng(10 + i).standard_normal(shape) * 4.0).astype(np.float32)


def pool_codes(i):
    """(N, H, W, C) values on a 4-bit unsigned grid of 0.2."""
    k, size, _ = POOL_CASES[i]
    rng = np.random.default_rng(30 + i)
    return (rng.integers(0, 16, (2, size, size, 3)) * 0.2).astype(np.float32)


def build_jax_head():
    """MobileNet's head: a 4-bit per-tensor ReLU grid into a QuantLinear
    with IntBias; and a depthwise conv with IntBias on a per-channel grid."""
    relu = JaxQuantReLU(jax_uint_act_quant(4), return_quant_tensor=True)
    lin = JaxQuantLinear(16, 6, use_bias=True,
                         weight_quant=jax_presets.Int8WeightPerTensorFloat.let(bit_width=4.0),
                         bias_quant=jax_presets.IntBias, rngs=nnx.Rngs(7))
    relu_pc = JaxQuantReLU(jax_uint_act_quant(4, per_channel=True), num_channels=6,
                           return_quant_tensor=True)
    dw = JaxQuantConv2d(6, 6, 3, padding=[(1, 1), (1, 1)], groups=6, use_bias=True,
                        weight_quant=jax_presets.Int8WeightPerChannelFloat.let(bit_width=4.0),
                        bias_quant=jax_presets.IntBias, return_quant_tensor=True,
                        rngs=nnx.Rngs(8))
    rng = np.random.default_rng(9)
    lin.bias[...] = jnp.asarray(rng.standard_normal(6).astype(np.float32))
    dw.bias[...] = jnp.asarray(rng.standard_normal(6).astype(np.float32) * 0.1)
    relu_pc.act_quant.scaling.value[...] = jnp.asarray(
        np.log2(np.linspace(1.0, 6.0, 6)).astype(np.float32))
    return relu, lin, relu_pc, dw


def head_inputs():
    rng = np.random.default_rng(12)
    return (rng.standard_normal((3, 16)).astype(np.float32) * 4.0,
            rng.standard_normal((2, 5, 5, 6)).astype(np.float32) * 3.0)


@pytest.fixture(scope="module")
def jax_ref():
    """Every JAX result of the file, as numpy."""
    r = {}
    m32, pcs, head = nnx.jit(lambda: (
        jax_quant_mobilenet_v1(**MODEL_KW, rngs=nnx.Rngs(0)),
        [JaxActQuantizer(jax_uint_act_quant(4, per_channel=True), num_channels=c)
         for _, _, c in PER_CHANNEL_CASES],
        build_jax_head()))()
    r["init"] = jax_arrays(m32)
    mbf = nnx.clone(m32)
    jax_set_compute_dtype(mbf, jnp.bfloat16)
    rng = np.random.default_rng(0)
    x = rng.random((BATCH, PX, PX, 3), dtype=np.float32)
    y = rng.integers(0, CLASSES, BATCH).astype(np.int32)
    r.update(x=x, y=y)
    # the per-channel thresholds spread, so each channel has its own grid
    for i, (q, (_, _, c)) in enumerate(zip(pcs, PER_CHANNEL_CASES)):
        q.scaling.value[...] = jnp.asarray(np.log2(np.linspace(0.5, 6.0, c)).astype(np.float32))
    r["pc_state"] = [jax_arrays(q) for q in pcs]
    r["head_state"] = [jax_arrays(mod) for mod in head]
    models = {"float32": m32, "bf16": mbf}
    opts = {k: nnx.Optimizer(m, optax.adam(LR), wrt=nnx.Param) for k, m in models.items()}
    # each pool case with a 4-bit grid of 0.2 in front, and without a grid
    pool_mods = [(JaxQuantReLU(jax_presets.Uint8ActPerTensorFloat.let(
                      bit_width=4.0, scaling_impl=jax_presets.ScalingImplType.CONST,
                      scaling_const=3.0), return_quant_tensor=True) if grid else None,
                  JaxQuantAvgPool2d(k, stride=stride,
                                    trunc_quant=jax_presets.TruncTo8bit.let(bit_width=4.0),
                                    return_quant_tensor=True))
                 for k, _, stride in POOL_CASES for grid in (True, False)]
    graphdef, state = nnx.split((models, opts))
    pc_x = [jnp.asarray(per_channel_input(i)) for i in range(len(PER_CHANNEL_CASES))]

    @functools.partial(jax.jit, compiler_options=NO_EXCESS_PRECISION)
    def run(state, xv, yv):
        models, opts = nnx.merge(graphdef, state)
        out = {}
        for name, m in models.items():
            def objective(mm):
                store = []
                with jax_act_records(store):
                    logits = mm(xv)
                loss = optax.softmax_cross_entropy_with_integer_labels(logits, yv).mean()
                return loss, (logits, store)

            # bf16's code-domain branch needs concrete bit widths (ROADMAP
            # S10); float32 takes no branch that depends on them
            with (jax.ensure_compile_time_eval() if name == "bf16"
                  else contextlib.nullcontext()):
                (loss, (logits, store)), grads = nnx.value_and_grad(
                    objective, has_aux=True)(m)
            opts[name].update(m, grads)
            out[name] = (loss, logits, store, grads, nnx.state(m, nnx.Param))
        return out

    out = run(state, jnp.asarray(x), jnp.asarray(y))
    for name in models:
        loss, logits, store, grads, after = out[name]
        r[name] = {"loss": float(loss), "logits": np.asarray(logits),
                   "store": [tuple(np.asarray(v) for v in rec) for rec in store],
                   "grads": flat(grads), "after_adam": flat(after)}

    # the modules, eagerly: under jit XLA's float32 pow (the LOG_FP scales)
    # is not correctly rounded, and it may multiply by a reciprocal where
    # the package divides
    head_x = [jnp.asarray(v) for v in head_inputs()]
    pool_x = [jnp.asarray(pool_codes(i)) for i in range(len(POOL_CASES))]
    pc = []
    for q, v in zip(pcs, pc_x):
        def f(qq, v):
            qt = qq(v)
            return jnp.sum(qt.value * jnp.arange(qt.value.size).reshape(
                qt.value.shape)), qt

        (_, qt), (gq, gx) = nnx.value_and_grad(f, argnums=(0, 1), has_aux=True)(q, v)
        pc.append((qt.value, qt.scale, gx, gq["scaling"]["value"][...]))
    r["pc"] = jax.tree.map(np.asarray, pc)

    relu, lin, relu_pc, dw = head

    def f(mods, xl, xc):
        relu, lin, relu_pc, dw = mods
        yl = lin(relu(xl))
        yc = dw(relu_pc(xc))
        return (jnp.sum(yl * jnp.arange(yl.size).reshape(yl.shape))
                + jnp.sum(yc.value * jnp.cos(jnp.arange(yc.value.size)).reshape(
                    yc.value.shape)), (yl, yc))

    (_, (yl, yc)), (gm, gxl, gxc) = nnx.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(head, *head_x)
    r["head"] = {"yl": np.asarray(yl), "yc": np.asarray(yc.value),
                 "scale": np.asarray(yc.scale), "bit_width": float(yc.bit_width),
                 "gxl": np.asarray(gxl), "gxc": np.asarray(gxc),
                 "grads": {f"{i}.{k}": v for i, g in enumerate(gm) for k, v in flat(g).items()}}

    # the depthwise conv with bf16 operands: eagerly, the bit widths are
    # concrete and the code-domain branch engages (S10)
    dw_bf = nnx.clone(dw)
    jax_set_compute_dtype(dw_bf, jnp.bfloat16)

    def f_bf(mods, xc):
        relu_pc, dw = mods
        yc = dw(relu_pc(xc))
        return jnp.sum(yc.value * jnp.cos(jnp.arange(yc.value.size)).reshape(
            yc.value.shape)), yc

    (_, yc), (gm, gxc) = nnx.value_and_grad(f_bf, argnums=(0, 1), has_aux=True)(
        (relu_pc, dw_bf), head_x[1])
    r["dw_bf16"] = {"y": np.asarray(yc.value), "gx": np.asarray(gxc),
                    "grads": {f"{i}.{k}": v for i, g in enumerate(gm)
                              for k, v in flat(g).items()}}

    pools = []
    for (relu, pool), v in zip(pool_mods, [v for v in pool_x for _ in (0, 1)]):
        def f(relu, pool, v):
            qt = pool(relu(v) if relu is not None else v)
            return jnp.sum(qt.value * jnp.arange(qt.value.size).reshape(
                qt.value.shape)), qt

        (_, qt), dx = nnx.value_and_grad(f, argnums=2, has_aux=True)(relu, pool, v)
        pools.append((qt.value, qt.scale, qt.bit_width, dx))
    r["pools"] = [tuple(None if v is None else np.asarray(v) for v in p) for p in pools]

    # trunc_int_quant and floor_ste, eagerly
    rng = np.random.default_rng(21)
    tx = (rng.integers(0, 700, 40) * 0.125 + rng.standard_normal(40) * 1e-4).astype(np.float32)
    r["trunc_x"] = tx

    def trunc(v, s):
        return jnp.sum(JQ.trunc_int_quant(v, s, jnp.asarray(0.0), jnp.asarray(10.0),
                                          jnp.asarray(4.0),
                                          float_to_int=JR.float_to_int_fn(
                                              JR.FloatToIntImpl.FLOOR))
                       * jnp.arange(40.0))

    val = JQ.trunc_int_quant(jnp.asarray(tx), jnp.asarray(0.125), jnp.asarray(0.0),
                             jnp.asarray(10.0), jnp.asarray(4.0),
                             float_to_int=jax_floor_ste)
    gx, gs = jax.grad(trunc, argnums=(0, 1))(jnp.asarray(tx), jnp.asarray(0.125))
    fv, fg = jax.vjp(jax_floor_ste, jnp.asarray(tx - 40.0))
    r["trunc"] = {"value": np.asarray(val), "dx": np.asarray(gx), "dscale": float(gs),
                  "floor": np.asarray(fv), "floor_grad": np.asarray(fg(jnp.ones(40))[0])}
    return r


# -- the QAT step ---------------------------------------------------------------

@pytest.fixture(scope="module", params=["float32", "bf16"])
def port_step(request, jax_ref):
    """The port's step from the JAX model's initial state, its codes forced
    to JAX's at certified ties: logits, loss, gradients, Adam."""
    ref = jax_ref[request.param]
    pm = quant_mobilenet_v1(**MODEL_KW, device="cpu")
    load_jax_state(pm, jax_ref["init"])
    if request.param == "bf16":
        set_compute_dtype(pm, torch.bfloat16)
    opt = torch.optim.Adam(pm.parameters(), lr=LR)
    force = ForceJaxCodes(pm, ref["store"])
    logits = pm(torch.from_numpy(to_port(jax_ref["x"])))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(jax_ref["y"]).long())
    loss.backward()
    force.remove()
    assert force.calls == len(ref["store"])
    r = {"dtype": request.param, "loss": float(loss.detach()),
         "logits": logits.detach().numpy(), "flips": force.flips, "calls": force.calls,
         "grads": {n: port_param(p.grad, n) for n, p in pm.named_parameters()}}
    opt.step()
    r["after_adam"] = {n: port_param(p, n) for n, p in pm.named_parameters()}
    print(f"{request.param}: {force.flips} codes set to JAX's at certified ties, "
          f"{force.kinks} ReLU inputs at certified kinks")
    return r


def test_mobilenet_step_logits_and_loss_match_jax(jax_ref, port_step):
    ref = jax_ref[port_step["dtype"]]
    # every one of the 27 ReLUs' quantizers called once
    assert port_step["calls"] == 27
    assert port_step["logits"].shape == (BATCH, CLASSES)
    assert np.all(np.abs(port_step["logits"] - ref["logits"])
                  <= 1e-5 * np.abs(ref["logits"]).max())
    assert np.isfinite(port_step["loss"])
    assert port_step["loss"] == pytest.approx(ref["loss"], rel=1e-6)


def test_mobilenet_step_gradients_match_jax(jax_ref, port_step):
    want = jax_ref[port_step["dtype"]]["grads"]
    assert set(want) == set(port_step["grads"])
    bf16 = port_step["dtype"] == "bf16"
    for path, exp in want.items():
        got = port_step["grads"][path]
        assert got.shape == exp.shape, path
        seen = np.abs(got - exp).max() / np.abs(exp).max()
        print(f"{port_step['dtype']} {path}: {seen:.3e} of the largest")
        share = (SCALE_GRAD_SHARE if path.endswith("scaling.value") else 1e-4) + (
            BF16_STEP_SHARE if bf16 else 0.0)
        assert np.all(np.abs(got - exp) <= share * np.abs(exp).max()), path


def test_mobilenet_step_parameters_after_adam_match_jax(jax_ref, port_step):
    ref = jax_ref[port_step["dtype"]]
    want = ref["after_adam"]
    assert set(want) == set(port_step["after_adam"])
    first_update = lambda g: LR * g / (np.abs(g) + ADAM_EPS)  # noqa: E731
    for path, exp in want.items():
        got = port_step["after_adam"][path]
        operand = np.maximum(np.maximum(np.abs(jax_ref["init"][path]), np.abs(exp)),
                             np.float32(LR))
        tol = (S8_ADAM * LR + 4 * np.spacing(operand)
               + np.abs(first_update(port_step["grads"][path])
                        - first_update(ref["grads"][path])))
        assert np.all(np.abs(got - exp) <= tol), path


def test_mobilenet_structure_follows_jax():
    m = quant_mobilenet_v1(**MODEL_KW, device="cpu")
    acts = [mod.act_quant for mod in m.modules() if isinstance(mod, QuantReLU)]
    per_channel = [a.per_channel for a in acts]
    # the stem and the pointwise ReLUs of every stage but the last
    assert per_channel == [True] + [False, True] * 11 + [False, False] * 2
    assert m.features[0].conv.weight_quant.cfg.bit_width == 8.0
    assert m.features[0].conv.padding == "VALID"
    assert m.output.bias_quant.cfg.requires_input_scale
    assert m.final_pool.trunc_quant.cfg.bit_width == 4.0


def test_mobilenet_per_tensor_quantizers_take_the_fake_quant_kernel_path(monkeypatch):
    """The quantizers whose grid is one value (13 depthwise ReLUs, the last
    stage's 2 pointwise ReLUs, the head's weight and its IntBias) reach
    int_fake_quant with a one-element scale: on the card, the fake_quant
    kernel. The per-channel ones keep the plain chain."""
    from brevitas_tpu_torch.quant import quantizers

    seen = []
    fq = quantizers.int_fake_quant

    def spy(x, scale, *a, **k):
        seen.append(quantizers._one_value(scale, x) and quantizers._one_value(a[0], x))
        return fq(x, scale, *a, **k)

    monkeypatch.setattr(quantizers, "int_fake_quant", spy)
    m = quant_mobilenet_v1(**MODEL_KW, device="cpu")
    m(torch.rand(2, 3, PX, PX))
    assert sum(seen) == 17
    # 28 weights (27 per channel), 27 ReLUs (12 per channel), the bias
    assert len(seen) == 28 + 27 + 1


# -- the per-channel quantizer ------------------------------------------------------

@pytest.mark.parametrize("i", range(len(PER_CHANNEL_CASES)),
                         ids=[c[0] for c in PER_CHANNEL_CASES])
def test_per_channel_act_quantizer_matches_jax(jax_ref, i):
    _, shape, c = PER_CHANNEL_CASES[i]
    q = ActQuantizer(common_uint_act_quant(4, per_channel=True), num_channels=c)
    load_jax_state(q, jax_ref["pc_state"][i])
    assert q.scaling.value.shape == (c,) and q.static_int_params() is None
    x = torch.from_numpy(to_port(per_channel_input(i))).requires_grad_()
    qt = q(x)
    assert qt.scale.shape == (c,) + (1,) * (x.ndim - 2)
    weights = torch.from_numpy(to_port(np.arange(x.numel(), dtype=np.float32)
                                       .reshape(shape)))
    (qt.value * weights).sum().backward()
    want_v, want_s, want_dx, want_ds = jax_ref["pc"][i]
    np.testing.assert_array_equal(qt.value.detach().numpy(), to_port(want_v))
    np.testing.assert_array_equal(qt.scale.detach().numpy().reshape(-1), want_s)
    np.testing.assert_array_equal(x.grad.numpy(), to_port(want_dx))
    got_ds = q.scaling.value.grad.numpy()
    assert np.all(np.abs(got_ds - want_ds) <= 1e-5 * np.abs(want_ds).max())


def test_per_channel_act_quantizer_needs_its_channels():
    with pytest.raises(ValueError):
        ActQuantizer(common_uint_act_quant(4, per_channel=True))


def test_per_channel_grid_reaches_only_depthwise_convs():
    relu = QuantReLU(common_uint_act_quant(4, per_channel=True), num_channels=4,
                     return_quant_tensor=True)
    conv = QuantConv2d(4, 6, 1, use_bias=False, device="cpu",
                       weight_quant=presets.Int8WeightPerChannelFloat)
    with pytest.raises(ValueError):
        conv(relu(torch.rand(1, 4, 3, 3)))


# -- IntBias ----------------------------------------------------------------------

def test_int_bias_matches_jax(jax_ref):
    relu = QuantReLU(common_uint_act_quant(4), return_quant_tensor=True)
    lin = QuantLinear(16, 6, use_bias=True,
                      weight_quant=presets.Int8WeightPerTensorFloat.let(bit_width=4.0),
                      bias_quant=presets.IntBias, device="cpu")
    relu_pc = QuantReLU(common_uint_act_quant(4, per_channel=True), num_channels=6,
                        return_quant_tensor=True)
    dw = QuantConv2d(6, 6, 3, padding=((1, 1), (1, 1)), groups=6, use_bias=True,
                     weight_quant=presets.Int8WeightPerChannelFloat.let(bit_width=4.0),
                     bias_quant=presets.IntBias, return_quant_tensor=True, device="cpu")
    mods = (relu, lin, relu_pc, dw)
    for mod, state in zip(mods, jax_ref["head_state"]):
        load_jax_state(mod, state)
    xl_np, xc_np = head_inputs()
    xl = torch.from_numpy(xl_np).requires_grad_()
    xc = torch.from_numpy(to_port(xc_np)).requires_grad_()
    yl = lin(relu(xl))
    yc = dw(relu_pc(xc))
    want = jax_ref["head"]
    cos = torch.from_numpy(to_port(np.cos(np.arange(want["yc"].size, dtype=np.float32))
                                   .reshape(want["yc"].shape)))
    ((yl * torch.arange(yl.numel()).reshape(yl.shape)).sum() + (yc.value * cos).sum()).backward()
    # float32 sums in other orders: within (K + 2) 2^-24 of sum |x w| + |b|
    with torch.no_grad():
        xq, wq = relu(xl).value.abs(), lin.quant_weight().value.abs()
        mass_l = xq.double() @ wq.double().t() + lin.bias.abs().double()
        xc_q, wc_q = relu_pc(xc).value.abs().double(), dw.quant_weight().value.abs().double()
        mass_c = conv_nd(xc_q, wc_q, dw.stride, dw.pads(xc_q.shape[2:]), dw.dilation,
                         dw.groups) + dw.bias.abs().double().reshape(-1, 1, 1)
    assert np.all(np.abs(yl.detach().numpy() - want["yl"])
                  <= (16 + 2) * 2.0 ** -24 * mass_l.numpy())
    assert np.all(np.abs(yc.value.detach().numpy() - to_port(want["yc"]))
                  <= (9 + 2) * 2.0 ** -24 * mass_c.numpy())
    np.testing.assert_array_equal(yc.scale.detach().numpy().reshape(-1),
                                  want["scale"].reshape(-1))
    assert yc.scale.shape == (6, 1, 1)
    # the accumulator law's 15 x 14 x 9 = 1,890 -> 11 bits (max_int of an
    # unsigned narrow 4-bit range is 14); the bias takes it, the output one more
    assert yc.bit_width == want["bit_width"] == 12.0
    # the input gradients: sums of |g w| terms in other orders
    g_l = torch.arange(yl.numel(), dtype=torch.float64).reshape(yl.shape)
    mass_gl = (g_l @ wq.double()).numpy()
    xa = xc_q.clone().requires_grad_()
    conv_nd(xa, wc_q, dw.stride, dw.pads(xa.shape[2:]), dw.dilation, dw.groups).backward(
        cos.abs().double())
    assert np.all(np.abs(xl.grad.numpy() - want["gxl"]) <= (6 + 2) * 2.0 ** -24 * mass_gl)
    assert np.all(np.abs(xc.grad.numpy() - to_port(want["gxc"]))
                  <= (9 + 2) * 2.0 ** -24 * xa.grad.numpy())
    grads = {f"{i}.{n}": port_param(p.grad, n)
             for i, mod in enumerate(mods) for n, p in mod.named_parameters()}
    assert set(grads) == set(want["grads"])
    for path, exp in want["grads"].items():
        assert np.all(np.abs(grads[path] - exp) <= 1e-5 * np.abs(exp).max()), path


@pytest.mark.parametrize("field", ["requires_input_bit_width", "requires_input_scale"])
def test_int_bias_off_the_accumulator_grid_is_refused(field):
    """An INT bias scaled by its own statistics is not ported: the quantizer
    refuses it when built. A constant bit width is (slice 9c): the bias
    takes the config's bit width, not the accumulator's, on the
    accumulator's scale."""
    cfg = presets.IntBias.let(**{field: False})
    if field == "requires_input_scale":
        with pytest.raises(NotImplementedError):
            BiasQuantizer(cfg)
        return
    out = BiasQuantizer(cfg)(torch.tensor([0.3, -2.0, 40.0]), input_scale=torch.tensor(0.25),
                             input_bit_width=30.0)
    assert out.bit_width == float(cfg.bit_width) == 8.0
    # 40 / 0.25 = 160 passes the 8-bit grid's 127
    assert torch.equal(out.value, torch.tensor([0.25, -2.0, 31.75]))


def test_int_bias_depthwise_bf16_code_domain_matches_jax(jax_ref):
    """The depthwise conv of ``test_int_bias_matches_jax`` with bf16
    operands, fed the same per-channel grid and cotangent as JAX's: the
    code-domain branch with a (C, 1, 1) input scale, forward and backward."""
    relu_pc = QuantReLU(common_uint_act_quant(4, per_channel=True), num_channels=6,
                        return_quant_tensor=True)
    dw = QuantConv2d(6, 6, 3, padding=((1, 1), (1, 1)), groups=6, use_bias=True,
                     weight_quant=presets.Int8WeightPerChannelFloat.let(bit_width=4.0),
                     bias_quant=presets.IntBias, return_quant_tensor=True, device="cpu")
    load_jax_state(relu_pc, jax_ref["head_state"][2])
    load_jax_state(dw, jax_ref["head_state"][3])
    set_compute_dtype(dw, torch.bfloat16)
    want = jax_ref["dw_bf16"]
    xc = torch.from_numpy(to_port(head_inputs()[1])).requires_grad_()
    yc = dw(relu_pc(xc))
    cos = torch.from_numpy(to_port(np.cos(np.arange(want["y"].size, dtype=np.float32))
                                   .reshape(want["y"].shape)))
    (yc.value * cos).sum().backward()
    # exact: small integer codes' products summed in float32, the same
    # rescale and bias as JAX's
    np.testing.assert_array_equal(yc.value.detach().numpy(), to_port(want["y"]))
    assert yc.scale.shape == (6, 1, 1)

    def close(got, exp, elementwise):
        big = np.abs(exp).max()
        tol = (BF16_ULP * np.abs(exp) + 1e-5 * big if elementwise
               else (1e-5 + BF16_ULP) * big)
        return np.all(np.abs(got - exp) <= tol)

    assert close(xc.grad.numpy(), to_port(want["gx"]), True)
    grads = {f"{i}.{n}": port_param(p.grad, n)
             for i, mod in enumerate((relu_pc, dw)) for n, p in mod.named_parameters()}
    assert set(grads) == set(want["grads"])
    for path, exp in want["grads"].items():
        print(f"{path}: {np.abs(grads[path] - exp).max() / np.abs(exp).max():.3e} "
              "of the largest")
        assert close(grads[path], exp, path.endswith("weight")), path


# -- truncation ---------------------------------------------------------------------

def test_trunc_int_quant_and_floor_ste_match_jax(jax_ref):
    want = jax_ref["trunc"]
    tx = torch.from_numpy(jax_ref["trunc_x"]).requires_grad_()
    s = torch.tensor(0.125, requires_grad=True)
    assert R.float_to_int_fn(R.FloatToIntImpl.FLOOR) is floor_ste
    y = Q.trunc_int_quant(tx, s, 0.0, 10.0, 4.0, float_to_int=floor_ste)
    np.testing.assert_array_equal(y.detach().numpy(), want["value"])
    (y * torch.arange(40.0)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), want["dx"])
    # a float32 sum of 40 terms, in another order
    assert float(s.grad) == pytest.approx(want["dscale"], rel=1e-5)
    v = (torch.from_numpy(jax_ref["trunc_x"]) - 40.0).requires_grad_()
    f = floor_ste(v)
    f.backward(torch.ones(40))
    np.testing.assert_array_equal(f.detach().numpy(), want["floor"])
    np.testing.assert_array_equal(v.grad.numpy(), want["floor_grad"])


@pytest.mark.parametrize("grid", [True, False], ids=["grid", "no_grid"])
@pytest.mark.parametrize("i", range(len(POOL_CASES)), ids=["2x2", "7x7"])
def test_quant_avg_pool_matches_jax(jax_ref, i, grid):
    k, _, stride = POOL_CASES[i]
    relu = QuantReLU(presets.Uint8ActPerTensorFloat.let(
        bit_width=4.0, scaling_impl=presets.ScalingImplType.CONST, scaling_const=3.0),
        return_quant_tensor=True) if grid else None
    pool = QuantAvgPool2d(k, stride=stride, trunc_quant=presets.TruncTo8bit.let(bit_width=4.0),
                          return_quant_tensor=True)
    x = torch.from_numpy(to_port(pool_codes(i))).requires_grad_()
    qt = pool(relu(x) if relu is not None else x)
    want_v, want_s, want_bw, want_dx = jax_ref["pools"][2 * i + (0 if grid else 1)]
    weights = torch.from_numpy(to_port(np.arange(want_v.size, dtype=np.float32)
                                       .reshape(want_v.shape)))
    (qt.value * weights).sum().backward()
    got = qt.value.detach().numpy()
    if grid:
        np.testing.assert_array_equal(got, to_port(want_v))
        assert float(qt.scale) == float(want_s) == float(np.float32(0.2))
        # 4 bits + ceil(log2(window)) truncated back to 4: a 7 x 7 window
        # divides by 64
        assert qt.bit_width == float(want_bw) == 4.0
        codes = np.round(to_port(pool_codes(i)) / 0.2)
        sums = torch.nn.functional.avg_pool2d(torch.from_numpy(codes), k, stride,
                                              divisor_override=1).numpy()
        np.testing.assert_array_equal(np.round(got / 0.2),
                                      np.floor(sums / (4 if k == 2 else 64)))
    else:
        assert qt.scale is None and want_s is None
        assert np.all(np.abs(got - to_port(want_v)) <= np.spacing(np.abs(to_port(want_v))))
    np.testing.assert_array_equal(x.grad.numpy(), to_port(want_dx))


def test_mobilenet_defaults_to_the_card():
    """The default device is the card, which raises where there is none."""
    if torch.cuda.is_available():
        assert next(quant_mobilenet_v1(**MODEL_KW).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            quant_mobilenet_v1(**MODEL_KW)
