"""The port's CNV conv QAT slice against the JAX package's.

Every JAX result is computed once for the module, under two ``jax.jit``
calls compiled with ``xla_allow_excess_precision`` off, and kept as numpy.
With it on (XLA's default), XLA on the CPU runs a bf16 conv as a float32 conv
and drops the bf16 rounding of its result, which the JAX package's custom
VJP asks for (``nn/conv.py:_partial_vjp_conv``) and a TPU performs; off, the
jitted reference follows the rule as written (and as eager JAX computes it).
The port starts from the JAX model's state (``load_jax_state``), and data
are made from numpy seeds, channels-last for JAX and transposed for the
port.

What is held to JAX:
- ``core.restrict``'s POWER_OF_TWO (ROUND and CEIL) and LOG_FP: ``preprocess``
  and ``forward``, values and straight-through gradients; CNV's input
  quantizer's scale, exactly 2^-7;
- ``QuantConv2d`` and ``QuantConv1d`` with a 4-bit per-tensor or per-channel
  weight quantizer, a bias and a 4-bit input quantizer (one case without),
  over SAME at stride 2 on odd sizes, explicit uneven pads, dilation 2 and
  groups up to the channel count, in float32 and in bf16 (the code-domain
  branch): the output and the gradients of the input, the weight and the
  bias;
- ``QuantMaxPool2d`` and ``QuantMaxPool1d`` (VALID, SAME, explicit uneven):
  values, the passed-through metadata and the gradient (a window's first
  maximum takes it, in both packages);
- the channel ``BatchNorm`` against ``nnx.BatchNorm`` on NHWC: training
  output, gradients, running statistics, evaluation output;
- the HWIO -> OIHW (WIO -> OIW) carry of ``load_jax_state``, a learned
  per-channel scale stored (1, ..., 1, O) included;
- one training step of ``cnv(4, 4, 8, per_channel_weights=True)`` (bench.py's
  ``cnv_int4pc_qat`` model) on the full 32 x 32 input in float32 and in bf16:
  logits, loss, every gradient, the parameters after one Adam step (optax
  against ``torch.optim.Adam``, lr 1e-3) and after ``clip_weights``; the
  forward of ``cnv(4, 4, 4)`` (the trainer's const-scale weights) and of
  ``cnv(None, None, None)`` (bench's float baseline);
- the trainer: ``load_cifar10`` against JAX's on files the test writes, and
  ``main`` training CNV_4W4A on synthetic data and on those files.

The step runs at batch 4, not 2: over a batch of two, the FC layers'
BatchNorm maps any two rows to about +-1, and the gradient through it is
``(g1 - g2) (1 - y^2) / 2`` with ``1 - y^2`` near 1e-4, a float32
cancellation that leaves the gradients upstream at rounding-noise level in
both packages.

Tolerances, each with its reason:
- restrict: POWER_OF_TWO values and gradients exact (integer exponents);
  LOG_FP within 2 float32 ulps (XLA's float32 ``pow`` is not correctly
  rounded);
- conv outputs: within ``(K + 2) 2^-24`` of ``sum |x w| + |b|``, K the
  fan-in: XLA and torch sum in different orders, and XLA on the CPU fuses
  the code-domain rescale and the bias add into an FMA (ROADMAP S1);
- conv gradients in float32: within 1e-5 of the size of the terms each sums
  (``sum |g w|`` for the input, ``sum |g x|`` for the weight, ``sum |g|``
  for the bias), the weight's also within 1e-5 of its largest element: the
  weight quantizer's statistics pass the scale's gradient, a float32 sum
  over the weight's group, to its largest element. In bf16 the same, plus
  one bf16 step of the element's size: a bf16 rounding may fall either way
  where the two packages' float32 values before it differ in their last
  bits (ROADMAP S11);
- max-pool and the carry: exact. BatchNorm: the port forms the statistics
  in float64 and rounds once (exactly the float64 statistics rounded, which
  the test checks); JAX sums in float32, so outputs and running statistics
  within 1e-5 of their largest element, gradients within 1e-5 of theirs;
- the CNV step: a code that differs between the packages is allowed only at
  a certified .5 tie: the two packages' inputs to that quantizer lie on
  either side of the same half-integer code boundary, within 1e-5 of the
  tensor's largest value of each other (float32 sums in another order, and
  float64 against float32 BatchNorm statistics). Each such code is then
  set to JAX's in the port's forward, so the rest of the step compares the
  same codes. The JAX code-domain branch engages only where its bit widths
  are concrete, so the JAX step is traced inside
  ``jax.ensure_compile_time_eval()`` (ROADMAP S10); the port's bit widths
  are Python numbers. Logits within 1e-5 and the loss within 1e-6 relative
  (float32 sums, float64 BatchNorm and rsqrt in the port). Gradients in
  float32 within 1e-4 of each tensor's largest element (the BatchNorm
  backward over N, H and W and the conv sums in other orders). In bf16 each
  conv's backward rounds its upstream gradient and both results to bf16, so
  where the packages' float32 values differ in their last bits a rounding
  falls either way (S11), and the flips spread through every conv below: a
  tensor's gradient is held within ``2 (n + 1) 2^-8`` of its largest
  element, n the convs between it and the loss, plus 1e-4 as in float32.
  Parameters after Adam within 6.44e-6 lr (optax forms Adam's bias
  correction in float32, torch in float64: S8) plus 4 ulps of the largest
  of ``p``, ``u`` and ``p + u`` (where the sum rounds) plus the difference
  of the first update ``lr g / (|g| + eps)`` of the two packages'
  gradients; the clipped weights the same, inside [-1, 1].
"""

import functools
import math
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from brevitas_tpu.core import restrict as JR
from brevitas_tpu.examples import bnn_pynq as jax_bnn_pynq
from brevitas_tpu.models import cnv as jax_cnv
from brevitas_tpu.models.common import common_act_quant as jax_act_quant
from brevitas_tpu.nn import QuantConv1d as JaxQuantConv1d
from brevitas_tpu.nn import QuantConv2d as JaxQuantConv2d
from brevitas_tpu.nn import QuantIdentity as JaxQuantIdentity
from brevitas_tpu.nn import QuantMaxPool1d as JaxQuantMaxPool1d
from brevitas_tpu.nn import QuantMaxPool2d as JaxQuantMaxPool2d
from brevitas_tpu.quant import presets as jax_presets
from brevitas_tpu.quant.config import ScalingImplType as JaxScalingImplType
from brevitas_tpu.utils import set_compute_dtype as jax_set_compute_dtype
from brevitas_tpu_torch.core import restrict as R
from brevitas_tpu_torch.examples import bnn_pynq
from brevitas_tpu_torch.interop import load_jax_state
from brevitas_tpu_torch.models import CNV, cnv
from brevitas_tpu_torch.models.common import BatchNorm, common_act_quant
from brevitas_tpu_torch.nn import (
    QuantConv1d,
    QuantConv2d,
    QuantIdentity,
    QuantLinear,
    QuantMaxPool1d,
    QuantMaxPool2d,
)
from brevitas_tpu_torch.nn.conv import QuantConvTranspose2d, conv_nd
from brevitas_tpu_torch.quant import presets
from brevitas_tpu_torch.quant.config import ScalingImplType
from brevitas_tpu_torch.quant.quantizers import ActQuantizer
from brevitas_tpu_torch.quant_tensor import QuantTensor
from brevitas_tpu_torch.utils import set_compute_dtype

torch.set_num_threads(1)

NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}
BATCH, LR, ADAM_EPS = 4, 1e-3, 1e-8
# of lr: optax's float32 1 - 0.999 is 1.2875e-5 off, so its sqrt(v_hat), and
# the first update, 6.44e-6 (torch forms the bias corrections in float64:
# ROADMAP S8)
S8_ADAM = 6.44e-6
BF16_STEP = 2.0 ** -8

# restrict: (restriction, float-to-int map); stored values with ties of both
# parities and values on both sides of an integer
RESTRICT_CASES = [(R.RestrictType.POWER_OF_TWO, R.FloatToIntImpl.ROUND),
                  (R.RestrictType.POWER_OF_TWO, R.FloatToIntImpl.CEIL),
                  (R.RestrictType.LOG_FP, R.FloatToIntImpl.ROUND)]
RESTRICT_IDS = [f"{r.value}-{f.value}" for r, f in RESTRICT_CASES]
RESTRICT_STORED = np.array([-7.3, -3.5, -2.5, -0.0113, 0.0, 0.5, 1.5, 2.0, 3.25], np.float32)

# convs: (name, spatial dims, in, out, kernel, stride, padding, dilation,
# groups, spatial size, input quantizer)
CONV_CASES = [
    ("same_s2_odd", 2, 4, 6, 3, 2, "SAME", 1, 1, (9, 7), True),
    ("explicit_uneven", 2, 4, 6, 3, 1, ((0, 2), (1, 0)), 1, 1, (8, 8), True),
    ("dilation2", 2, 4, 6, 3, 1, "VALID", 2, 1, (11, 9), True),
    ("depthwise", 2, 4, 4, 3, 1, "SAME", 1, 4, (8, 6), True),
    ("no_input_quant", 2, 4, 6, 3, 1, "VALID", 1, 1, (7, 7), False),
    ("1d_same_s2_odd", 1, 4, 6, 5, 2, "SAME", 1, 1, (13,), True),
    ("1d_explicit_uneven", 1, 4, 6, 3, 1, ((2, 0),), 1, 1, (10,), True),
    ("1d_dilation2_groups", 1, 4, 6, 3, 1, "SAME", 2, 2, (12,), True),
]
CONV_KEYS = [(c[0], sc, dt) for c in CONV_CASES for sc in ("per_tensor", "per_channel")
             for dt in ("float32", "bf16")]
CONV_IDS = ["-".join(k) for k in CONV_KEYS]

# max-pools: (name, spatial dims, kernel, stride, padding, spatial size)
POOL_CASES = [("valid_k2", 2, 2, None, "VALID", (8, 6)),
              ("same_k3_s2_odd", 2, 3, 2, "SAME", (7, 9)),
              ("explicit_uneven", 2, 2, 1, ((1, 0), (0, 2)), (5, 6)),
              ("1d_same_k3_s2", 1, 3, 2, "SAME", (11,))]
POOL_IDS = [c[0] for c in POOL_CASES]
BN_SHAPE = (3, 5, 7, 6)  # NHWC


def jax_state_arrays(model) -> dict:
    return {".".join(map(str, path)): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model)) if path[0] != "rngs"}


def flat(state) -> dict:
    return {".".join(map(str, path)): np.asarray(v[...])
            for path, v in nnx.to_flat_state(state)}


def to_port(v: np.ndarray) -> np.ndarray:
    """Channels-last (N, *spatial, C) to the port's (N, C, *spatial)."""
    return np.ascontiguousarray(np.moveaxis(v, -1, 1))


def conv_case(name):
    return next(c for c in CONV_CASES if c[0] == name)


def conv_weight_quant(pkg, scaling: str):
    base = pkg.Int8WeightPerChannelFloat if scaling == "per_channel" \
        else pkg.Int8WeightPerTensorFloat
    return base.let(bit_width=4.0)


def conv_inputs(key):
    name, scaling, _ = key
    _, dims, cin, cout, *_, size, _ = conv_case(name)
    rng = np.random.default_rng(CONV_CASES.index(conv_case(name)))
    # |x| up to about 2 reaches both clamps of the 4-bit input grid (1/7)
    x = (rng.standard_normal((2, *size, cin)) * 0.6).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, bias


def conv_cotangent(key):
    """The upstream gradient of the conv's (N, *spatial, O) output: XLA's
    output size, ``(n + lo + hi - d (k - 1) - 1) // s + 1``."""
    name, _, _ = key
    _, dims, _, cout, k, stride, pad, dil, _, size, _ = conv_case(name)
    port = QuantConv2d if dims == 2 else QuantConv1d
    pads = port(4, 4, k, stride=stride, padding=pad, dilation=dil, weight_quant=None).pads(size)
    out = [(n + lo + hi - dil * (k - 1) - 1) // stride + 1 for n, (lo, hi) in zip(size, pads)]
    rng = np.random.default_rng(200 + CONV_KEYS.index(key))
    return rng.standard_normal((2, *out, cout)).astype(np.float32)


def build_jax_conv(key):
    name, scaling, dtype = key
    _, dims, cin, cout, k, stride, pad, dil, groups, _, in_q = conv_case(name)
    cls = JaxQuantConv2d if dims == 2 else JaxQuantConv1d
    m = cls(cin, cout, k, stride=stride, padding=pad, dilation=dil, groups=groups,
            weight_quant=conv_weight_quant(jax_presets, scaling),
            input_quant=jax_act_quant(4) if in_q else None,
            rngs=nnx.Rngs(CONV_CASES.index(conv_case(name))))
    m.bias[...] = jnp.asarray(conv_inputs(key)[1])
    if dtype == "bf16":
        m.compute_dtype = jnp.bfloat16
    return m


def build_port_conv(key, state):
    name, scaling, dtype = key
    _, dims, cin, cout, k, stride, pad, dil, groups, _, in_q = conv_case(name)
    cls = QuantConv2d if dims == 2 else QuantConv1d
    m = cls(cin, cout, k, stride=stride, padding=pad, dilation=dil, groups=groups,
            weight_quant=conv_weight_quant(presets, scaling),
            input_quant=common_act_quant(4) if in_q else None, device="cpu")
    load_jax_state(m, state)
    if dtype == "bf16":
        m.compute_dtype = torch.bfloat16
    return m


def build_jax_carry(dims):
    """A conv with a learned per-channel weight scale, stored (1, ..., 1, O)."""
    cfg = dict(bit_width=4.0, scaling_impl=JaxScalingImplType.PARAMETER)
    m = (JaxQuantConv2d if dims == 2 else JaxQuantConv1d)(
        3, 5, 3, weight_quant=jax_presets.Int8WeightPerChannelFloat.let(**cfg),
        rngs=nnx.Rngs(4))
    m.weight_quant.scaling.value[...] = jnp.asarray(
        np.linspace(0.05, 0.2, 5, dtype=np.float32).reshape((1,) * (dims + 1) + (5,)))
    return m


def carry_input(dims):
    return np.random.default_rng(3).standard_normal((2, *(9,) * dims, 3)).astype(np.float32)


def build_jax_pool(case):
    _, dims, k, stride, pad, _ = case
    cls = JaxQuantMaxPool2d if dims == 2 else JaxQuantMaxPool1d
    return cls(k, stride, padding=pad, return_quant_tensor=True)


def pool_input(i):
    _, dims, k, stride, pad, size = POOL_CASES[i]
    rng = np.random.default_rng(50 + i)
    # a 4-bit grid of 1/7 over N(0, 0.6): codes repeat, so windows hold ties
    return (rng.standard_normal((2, *size, 3)) * 0.6).astype(np.float32)


def jax_act_io(m, x):
    """``CNV.__call__`` step by step: the logits and each activation
    quantizer's input and output value, in order."""
    ios = []

    def quant(lyr, v):
        out = lyr(v)
        ios.append((v, out.value))
        return out

    x = quant(m.input_quant, 2.0 * x - 1.0)
    for lyr in m.conv_features:
        x = quant(lyr, x) if isinstance(lyr, JaxQuantIdentity) else lyr(x)
    x = x.reshape(x.shape[0], -1)
    for lyr in m.linear_features:
        x = quant(lyr, x) if isinstance(lyr, JaxQuantIdentity) else lyr(x)
    return m.norm(x), ios


@pytest.fixture(scope="module")
def jax_ref():
    """Every JAX result of the file, as numpy."""
    r = {}
    # restrict
    stored = jnp.asarray(RESTRICT_STORED)
    g = jnp.linspace(0.5, 1.5, RESTRICT_STORED.size, dtype=jnp.float32)
    for (restrict, f2i), rid in zip(RESTRICT_CASES, RESTRICT_IDS):
        y, vjp = jax.vjp(lambda v: JR.forward(restrict, v, f2i), stored)
        r[rid] = {"forward": np.asarray(y), "grad": np.asarray(vjp(g)[0]),
                  "pre_float": JR.preprocess(restrict, 0.3),
                  "pre_tensor": np.asarray(JR.preprocess(restrict, jnp.asarray([0.3, 6.0])))}
    in_quant = JaxQuantIdentity(jax_act_quant(8, max_val=1.0 - 2.0 ** (-7), narrow_range=False,
                                              restrict=JR.RestrictType.POWER_OF_TWO),
                                return_quant_tensor=True)
    r["input_scale"] = float(in_quant(jnp.zeros((2,))).scale)

    # every module, built under one jit (the initializers compile as one
    # program)
    @nnx.jit
    def build():
        convs = {key: build_jax_conv(key) for key in CONV_KEYS}
        carries = {dims: build_jax_carry(dims) for dims in (1, 2)}
        return (convs, carries, jax_cnv(4, 4, 8, per_channel_weights=True, rngs=nnx.Rngs(0)),
                jax_cnv(4, 4, 4, rngs=nnx.Rngs(1)), jax_cnv(None, None, None, rngs=nnx.Rngs(2)))

    convs, carries, m32, m444, mfp = build()
    xs = {key: jnp.asarray(conv_inputs(key)[0]) for key in CONV_KEYS}
    gs = {key: jnp.asarray(conv_cotangent(key)) for key in CONV_KEYS}
    r["conv_state"] = {key: jax_state_arrays(convs[key]) for key in CONV_KEYS}
    r["carry_state"] = {dims: jax_state_arrays(m) for dims, m in carries.items()}
    carry_x = {dims: jnp.asarray(carry_input(dims)) for dims in (1, 2)}
    pool_q = JaxQuantIdentity(jax_act_quant(4), return_quant_tensor=True)
    pools = [build_jax_pool(c) for c in POOL_CASES]
    pool_x = [jnp.asarray(pool_input(i)) for i in range(len(POOL_CASES))]
    rng = np.random.default_rng(77)
    bn = nnx.BatchNorm(BN_SHAPE[-1], epsilon=1e-4, momentum=0.9, use_running_average=False,
                       rngs=nnx.Rngs(0))
    bn.scale[...] = jnp.asarray(rng.uniform(0.5, 1.5, BN_SHAPE[-1]).astype(np.float32))
    bn.bias[...] = jnp.asarray(rng.standard_normal(BN_SHAPE[-1]).astype(np.float32))
    bn.mean[...] = jnp.asarray(rng.standard_normal(BN_SHAPE[-1]).astype(np.float32))
    bn.var[...] = jnp.asarray(rng.uniform(0.5, 2.0, BN_SHAPE[-1]).astype(np.float32))
    r["bn_init"] = jax_state_arrays(bn)
    bn_x = (rng.standard_normal(BN_SHAPE) * 2.0 + 0.7).astype(np.float32)
    bn_g = rng.standard_normal(BN_SHAPE).astype(np.float32)
    r.update(bn_x=bn_x, bn_g=bn_g)

    graphdef, state = nnx.split((convs, carries, pool_q, pools, bn))

    @functools.partial(jax.jit, compiler_options=NO_EXCESS_PRECISION)
    def modules(state, xs, gs, carry_x, pool_x, bn_x, bn_g):
        convs, carries, pool_q, pools, bn = nnx.merge(graphdef, state)
        out = {"conv": {}, "pool": []}
        # the code-domain branch needs concrete bit widths (ROADMAP S10)
        with jax.ensure_compile_time_eval():
            for key in CONV_KEYS:
                m, g = convs[key], gs[key]

                def f(mm, v, g=g):
                    y = mm(v)
                    return jnp.sum(y * g), y

                (_, y), (gm, gx) = nnx.value_and_grad(f, argnums=(0, 1), has_aux=True)(
                    m, xs[key])
                out["conv"][key] = (y, gx, gm["weight"][...], gm["bias"][...])
        out["carry"] = {dims: m(carry_x[dims]) for dims, m in carries.items()}
        for pool, v in zip(pools, pool_x):
            def f(v, pool=pool):
                qt = pool(pool_q(v))
                return jnp.sum(qt.value * jnp.arange(qt.value.size).reshape(qt.value.shape)), qt
            (_, qt), dx = jax.value_and_grad(f, has_aux=True)(v)
            out["pool"].append((qt.value, qt.scale, qt.bit_width, dx))
        def f(b, v):
            y = b(v)
            return jnp.sum(y * bn_g), y

        (_, y), (gbn, dx) = nnx.value_and_grad(f, argnums=(0, 1), has_aux=True)(bn, bn_x)
        out["bn_train"] = (y, dx, gbn["scale"][...], gbn["bias"][...])
        out["bn_running"] = (bn.mean[...], bn.var[...])
        bn.use_running_average = True
        out["bn_eval"] = bn(bn_x)
        return out

    out = jax.tree.map(np.asarray, modules(state, xs, gs, carry_x, pool_x, jnp.asarray(bn_x),
                                           jnp.asarray(bn_g)))
    r.update(conv=out["conv"], carry=out["carry"], pool=out["pool"], bn_train=out["bn_train"],
             bn_running=out["bn_running"], bn_eval=out["bn_eval"])

    # the CNV step, float32 and bf16, from one initial state
    rng = np.random.default_rng(0)
    x = rng.random((BATCH, 32, 32, 3), dtype=np.float32)
    y = rng.integers(0, 10, BATCH).astype(np.int32)
    r.update(x=x, y=y)
    r["init"] = jax_state_arrays(m32)
    mbf = nnx.clone(m32)
    jax_set_compute_dtype(mbf, jnp.bfloat16)
    r["init_444"], r["init_fp"] = jax_state_arrays(m444), jax_state_arrays(mfp)
    models = {"float32": m32, "bf16": mbf}
    opts = {k: nnx.Optimizer(m, optax.adam(LR), wrt=nnx.Param) for k, m in models.items()}
    graphdef, state = nnx.split((models, opts, m444, mfp))

    @functools.partial(jax.jit, compiler_options=NO_EXCESS_PRECISION)
    def step(state, xv, yv):
        models, opts, m444, mfp = nnx.merge(graphdef, state)
        out = {"logits_444": m444(xv), "logits_fp": mfp(xv)}
        with jax.ensure_compile_time_eval():
            for name, m in models.items():
                def objective(mm):
                    logits, ios = jax_act_io(mm, xv)
                    return jax_bnn_pynq.sqr_hinge_loss(logits, yv), (logits, ios)

                (loss, (logits, ios)), grads = nnx.value_and_grad(objective, has_aux=True)(m)
                opts[name].update(m, grads)
                after = nnx.state(m, nnx.Param)
                after = jax.tree.map(lambda v: v + 0, after)  # a copy, not the Variables
                m.clip_weights(-1.0, 1.0)
                out[name] = (loss, logits, ios, grads, after, nnx.state(m, nnx.Param))
        return out

    out = step(state, jnp.asarray(x), jnp.asarray(y))
    r["logits_444"], r["logits_fp"] = np.asarray(out["logits_444"]), np.asarray(out["logits_fp"])
    for name in models:
        loss, logits, ios, grads, after, clipped = out[name]
        r[name] = {"loss": float(loss), "logits": np.asarray(logits),
                   "ios": [(np.asarray(a), np.asarray(b)) for a, b in ios],
                   "grads": flat(grads), "after_adam": flat(after), "clipped": flat(clipped)}
    return r


# -- restrict ------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(RESTRICT_CASES)), ids=RESTRICT_IDS)
def test_restrict_matches_jax(jax_ref, i):
    restrict, f2i = RESTRICT_CASES[i]
    want = jax_ref[RESTRICT_IDS[i]]
    assert R.preprocess(restrict, 0.3) == want["pre_float"] == math.log2(0.3)
    pre = R.preprocess(restrict, torch.tensor([0.3, 6.0]))
    np.testing.assert_array_equal(pre.numpy(), want["pre_tensor"])
    v = torch.from_numpy(RESTRICT_STORED.copy()).requires_grad_()
    y = R.forward(restrict, v, f2i)
    y.backward(torch.linspace(0.5, 1.5, RESTRICT_STORED.size))
    got_y, got_g = y.detach().numpy(), v.grad.numpy()
    if restrict == R.RestrictType.POWER_OF_TWO:
        np.testing.assert_array_equal(got_y, want["forward"])
        np.testing.assert_array_equal(got_g, want["grad"])
        # integer exponents: the values are powers of two
        assert np.all(np.log2(got_y) == np.round(np.log2(got_y)))
    else:
        for got, exp in ((got_y, want["forward"]), (got_g, want["grad"])):
            assert np.all(np.abs(got - exp) <= 2 * np.spacing(np.abs(exp)))


def test_restrict_fp_passes_and_int_is_not_ported():
    """FP passes its value. The INT restriction is ported since slice 8: it
    stores the value as it is and rounds it (parity with JAX in
    ``tests/test_torch_port_quant_options.py``)."""
    v = torch.tensor([0.3, 2.0])
    assert R.preprocess(R.RestrictType.FP, 0.3) == 0.3
    assert R.forward(R.RestrictType.FP, v) is v
    assert R.preprocess(R.RestrictType.INT, 0.3) == 0.3
    assert R.forward(R.RestrictType.INT, torch.tensor([0.3, 2.5, -1.6])).tolist() == [0.0, 2.0,
                                                                                      -2.0]


def test_cnv_input_quantizer_scale_is_two_to_minus_seven(jax_ref):
    """Q1.7: the threshold 1 - 2^-7 restricted to a power of two by CEIL is
    1, divided by the integer threshold 128."""
    q = ActQuantizer(common_act_quant(8, max_val=1.0 - 2.0 ** (-7), narrow_range=False,
                                      restrict=R.RestrictType.POWER_OF_TWO))
    out = q(torch.tensor([-1.0, -0.5, 0.3, 0.999]))
    assert float(out.scale) == 2.0 ** -7 == jax_ref["input_scale"]
    np.testing.assert_array_equal(out.value.numpy(),
                                  np.array([-1.0, -0.5, 38 / 128, 127 / 128], np.float32))


# -- convs ---------------------------------------------------------------------

def _abs_mass(port, x_in, w_in, g):
    """Float64 ``sum |x w|`` of each output, and the size of the terms of
    the input's and the weight's gradients, ``sum |g w|`` and ``sum |g x|``."""
    xa = x_in.detach().abs().double().requires_grad_()
    wa = w_in.detach().abs().double().requires_grad_()
    y = conv_nd(xa, wa, port.stride, port.pads(xa.shape[2:]), port.dilation, port.groups)
    y.backward(g.abs().double())
    return y.detach().numpy(), xa.grad.numpy(), wa.grad.numpy()


@pytest.mark.parametrize("key", CONV_KEYS, ids=CONV_IDS)
def test_quant_conv_matches_jax(jax_ref, key):
    name, scaling, dtype = key
    dims = conv_case(name)[1]
    port = build_port_conv(key, jax_ref["conv_state"][key])
    x = torch.from_numpy(to_port(conv_inputs(key)[0])).requires_grad_()
    want_y, want_dx, want_dw, want_db = jax_ref["conv"][key]
    g = torch.from_numpy(to_port(conv_cotangent(key)))
    y = port(x)
    y.backward(g)
    assert y.shape == g.shape and y.dtype == torch.float32
    # the operands as they enter the conv: the quantized values, or their
    # codes in the code-domain branch (scaled back, the same size)
    with torch.no_grad():
        qx = port.input_quant(x)
        w_in = port.quant_weight().value
    y_mass, dx_mass, dw_mass = _abs_mass(port, qx.value, w_in, g)
    fan_in = port.reduce_size
    bias = np.abs(port.bias.detach().numpy()).reshape(-1, *(1,) * dims)
    tol_y = (fan_in + 2) * 2.0 ** -24 * (y_mass + bias)
    assert np.all(np.abs(y.detach().numpy() - to_port(want_y)) <= tol_y), key
    bf16 = dtype == "bf16"
    got_dx, got_dw = x.grad.numpy(), port.weight.grad.numpy()
    want_dx = to_port(want_dx)
    want_dw = np.ascontiguousarray(np.moveaxis(want_dw, (-1, -2), (0, 1)))  # HWIO -> OIHW
    step = lambda v: BF16_STEP * np.abs(v) if bf16 else 0.0  # noqa: E731
    assert np.all(np.abs(got_dx - want_dx) <= 1e-5 * dx_mass + step(want_dx)), key
    tol_dw = 1e-5 * (dw_mass + np.abs(want_dw).max()) + step(want_dw)
    assert np.all(np.abs(got_dw - want_dw) <= tol_dw), key
    g_mass = np.abs(g.numpy()).sum(axis=tuple(i for i in range(g.ndim) if i != 1))
    assert np.all(np.abs(port.bias.grad.numpy() - want_db) <= 1e-5 * g_mass), key


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_code_domain_conv_output_scale_lies_on_the_channel_axis(jax_ref, dtype):
    """With a per-channel weight and a quantized input the output scale is
    (O, 1, 1) against the (N, O, H, W) output, and with return_quant_tensor
    the output carries it."""
    key = ("same_s2_odd", "per_channel", dtype)
    port = build_port_conv(key, jax_ref["conv_state"][key])
    port.return_quant_tensor = True
    out = port(torch.from_numpy(to_port(conv_inputs(key)[0])))
    assert isinstance(out, QuantTensor) and out.scale.shape == (6, 1, 1)
    w_scale = port.quant_weight().scale.reshape(-1)
    np.testing.assert_array_equal(out.scale.reshape(-1).detach().numpy(),
                                  (w_scale * (1.0 / 7.0)).detach().numpy())
    np.testing.assert_allclose(out.value.detach().numpy(),
                               to_port(jax_ref["conv"][key][0]), rtol=1e-5, atol=1e-5)


def test_transposed_convs_are_not_ported():
    with pytest.raises(NotImplementedError):
        QuantConvTranspose2d(4, 4, 3)


def test_conv_runs_in_float32_under_a_tf32_setting(monkeypatch):
    """The module's conv takes the highest float32 matmul precision inside
    and restores the caller's TF32 setting after; its integer sums are
    exact."""
    seen = []
    matmul = torch.matmul
    monkeypatch.setattr(torch, "matmul", lambda *a, **k: (
        seen.append(torch.get_float32_matmul_precision()), matmul(*a, **k))[1])
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        m = QuantConv2d(64, 16, 3, weight_quant=None, use_bias=False, device="cpu")
        with torch.no_grad():
            m.weight.copy_(torch.randint(-7, 8, m.weight.shape))
        x = torch.randint(-128, 128, (2, 64, 9, 9)).float().requires_grad_()
        y = m(x)
        y.backward(torch.ones_like(y))
        # the forward's product, the backward's two
        assert seen == ["highest"] * 3 and torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)
    want = torch.nn.functional.conv2d(x.double(), m.weight.double(), padding=1)
    np.testing.assert_array_equal(y.detach().numpy(), want.detach().numpy())


# -- max-pools ------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(POOL_CASES)), ids=POOL_IDS)
def test_quant_max_pool_matches_jax(jax_ref, i):
    _, dims, k, stride, pad, _ = POOL_CASES[i]
    pool = (QuantMaxPool2d if dims == 2 else QuantMaxPool1d)(k, stride, padding=pad,
                                                              return_quant_tensor=True)
    q = QuantIdentity(common_act_quant(4), return_quant_tensor=True)
    x = torch.from_numpy(to_port(pool_input(i))).requires_grad_()
    qt = pool(q(x))
    want_v, want_s, want_bw, want_dx = jax_ref["pool"][i]
    weights = torch.from_numpy(to_port(np.arange(want_v.size, dtype=np.float32)
                                       .reshape(want_v.shape)))
    (qt.value * weights).sum().backward()
    np.testing.assert_array_equal(qt.value.detach().numpy(), to_port(want_v))
    assert float(qt.scale) == float(want_s) and qt.bit_width == float(want_bw)
    assert qt.zero_point == 0.0 and qt.signed is True
    np.testing.assert_array_equal(x.grad.numpy(), to_port(want_dx))
    # windows hold ties: each passes its gradient to one element only
    assert (x.grad != 0).sum() <= qt.value.numel()


# -- channel BatchNorm ------------------------------------------------------------

@pytest.fixture(scope="module")
def port_bn(jax_ref):
    bn = BatchNorm(BN_SHAPE[-1], momentum=0.9, eps=1e-4, channel_axis=1)
    load_jax_state(bn, jax_ref["bn_init"])
    x = torch.from_numpy(to_port(jax_ref["bn_x"])).requires_grad_()
    y = bn(x)
    y.backward(torch.from_numpy(to_port(jax_ref["bn_g"])))
    out = {"y": y.detach().numpy(), "dx": x.grad.numpy(), "dscale": bn.scale.grad.numpy(),
           "dbias": bn.bias.grad.numpy()}
    out["running"] = (bn.mean.numpy().copy(), bn.var.numpy().copy())
    bn.eval()
    with torch.no_grad():
        out["eval"] = bn(x.detach()).numpy()
    return out


def test_channel_batch_norm_statistics_are_float64_rounded_once(jax_ref):
    x = torch.from_numpy(to_port(jax_ref["bn_x"]))
    bn = BatchNorm(BN_SHAPE[-1], channel_axis=1)
    mean, var = bn._batch_stats(x)
    x64 = jax_ref["bn_x"].astype(np.float64).reshape(-1, BN_SHAPE[-1])
    m64 = x64.mean(0)
    np.testing.assert_array_equal(mean.numpy(), m64.astype(np.float32))
    np.testing.assert_array_equal(
        var.numpy(), np.maximum((x64 * x64).mean(0) - m64 * m64, 0.0).astype(np.float32))


def test_channel_batch_norm_train_matches_jax(jax_ref, port_bn):
    want_y, want_dx, want_ds, want_db = jax_ref["bn_train"]
    for got, exp in ((port_bn["y"], to_port(want_y)), (port_bn["dx"], to_port(want_dx)),
                     (port_bn["dscale"], want_ds), (port_bn["dbias"], want_db)):
        assert np.all(np.abs(got - exp) <= 1e-5 * np.abs(exp).max())


def test_channel_batch_norm_running_statistics_and_eval_match_jax(jax_ref, port_bn):
    for got, exp in zip(port_bn["running"], jax_ref["bn_running"]):
        assert np.all(np.abs(got - exp) <= 1e-5 * np.abs(exp).max())
    want = to_port(jax_ref["bn_eval"])
    assert np.all(np.abs(port_bn["eval"] - want) <= 1e-5 * np.abs(want).max())


# -- the carry -------------------------------------------------------------------

@pytest.mark.parametrize("dims", [1, 2])
def test_conv_state_carries_to_the_port_layout(jax_ref, dims):
    state = jax_ref["carry_state"][dims]
    assert state["weight_quant.scaling.value"].shape == (1,) * (dims + 1) + (5,)
    cfg = dict(bit_width=4.0, scaling_impl=ScalingImplType.PARAMETER)
    pm = (QuantConv2d if dims == 2 else QuantConv1d)(
        3, 5, 3, weight_quant=presets.Int8WeightPerChannelFloat.let(**cfg), device="cpu")
    load_jax_state(pm, state)
    want_w = np.moveaxis(state["weight"], (-1, -2), (0, 1))
    np.testing.assert_array_equal(pm.weight.detach().numpy(), want_w)
    np.testing.assert_array_equal(pm.weight_quant.scaling.value.detach().numpy().reshape(-1),
                                  state["weight_quant.scaling.value"].reshape(-1))
    assert pm.weight_quant.scaling.value.shape == (5,) + (1,) * (dims + 1)
    got = pm(torch.from_numpy(to_port(carry_input(dims)))).detach().numpy()
    want = jax_ref["carry"][dims]
    assert np.all(np.abs(got - to_port(want)) <= 1e-6 * np.abs(want).max())


# -- the CNV step -----------------------------------------------------------------

class ForceJaxCodes:
    """Forward hooks on the port's activation quantizers (in the order
    ``jax_act_io`` records JAX's) that certify every output that differs
    from JAX's as a .5 tie (see the module docstring) and then give JAX's
    value, unchanged in its gradient."""

    def __init__(self, model: CNV, ios):
        self.ios, self.flips = ios, 0
        quants = [model.input_quant] + [m for m in [*model.conv_features,
                                                     *model.linear_features]
                                        if isinstance(m, QuantIdentity)]
        assert len(quants) == len(ios) == 9
        self.handles = [q.register_forward_hook(self._hook(i)) for i, q in enumerate(quants)]

    def _hook(self, i):
        def hook(module, args, out):
            want_x, want_y = (to_port(v) if v.ndim == 4 else v for v in self.ios[i])
            got_y = out.value.detach().numpy()
            differ = got_y != want_y
            if not differ.any():
                return out
            got_x = args[0].value if isinstance(args[0], QuantTensor) else args[0]
            got_x = got_x.detach().numpy()
            s = float(out.scale)
            u_got, u_want = got_x[differ] / s, want_x[differ] / s
            # the half-integer between the two codes
            half = (np.round(got_y[differ] / s) + np.round(want_y[differ] / s)) / 2
            certified = ((np.abs(np.round(got_y[differ] / s) - np.round(want_y[differ] / s)) == 1)
                         & ((u_got - half) * (u_want - half) <= 0)
                         & (np.abs(got_x[differ] - want_x[differ])
                            <= 1e-5 * np.abs(want_x).max()))
            assert certified.all(), (f"quantizer {i}: {int((~certified).sum())} codes differ "
                                     "from JAX's away from a .5 tie")
            self.flips += int(differ.sum())
            forced = out.value + torch.from_numpy(want_y - got_y)
            return QuantTensor(forced, out.scale, out.zero_point, out.bit_width,
                               signed=out.signed, training=out.training)
        return hook

    def remove(self):
        for h in self.handles:
            h.remove()


def port_tensor(t: torch.Tensor, path: str) -> np.ndarray:
    """A port tensor in the JAX layout: linear weights (out, in) -> (in, out),
    conv weights OIHW -> HWIO."""
    v = t.detach().numpy().copy()
    if path.endswith("weight") and v.ndim == 4:
        return np.ascontiguousarray(np.moveaxis(v, (0, 1), (-1, -2)))
    if path.endswith("weight") and v.ndim == 2 and path.startswith("linear_features"):
        return v.T
    return v


@pytest.fixture(scope="module", params=["float32", "bf16"])
def port_step(request, jax_ref):
    """The port's step from the JAX model's initial state, its codes forced
    to JAX's at certified ties: loss, gradients, torch.optim.Adam,
    clip_weights; then the trainer's own train_step from the same state."""
    ref = jax_ref[request.param]

    def build():
        pm = cnv(4, 4, 8, per_channel_weights=True, device="cpu")
        load_jax_state(pm, jax_ref["init"])
        if request.param == "bf16":
            set_compute_dtype(pm, torch.bfloat16)
        return pm

    x = torch.from_numpy(to_port(jax_ref["x"]))
    y = torch.from_numpy(jax_ref["y"])
    pm = build()
    force = ForceJaxCodes(pm, ref["ios"])
    opt = torch.optim.Adam(pm.parameters(), lr=LR)
    logits = pm(x)
    loss = bnn_pynq.sqr_hinge_loss(logits, y)
    loss.backward()
    force.remove()
    r = {"dtype": request.param, "loss": float(loss.detach()), "logits": logits.detach().numpy(),
         "flips": force.flips,
         "grads": {n: port_tensor(p.grad, n) for n, p in pm.named_parameters()}}
    opt.step()
    r["after_adam"] = {n: port_tensor(p, n) for n, p in pm.named_parameters()}
    pm.clip_weights(-1.0, 1.0)
    r["clipped"] = {n: port_tensor(p, n) for n, p in pm.named_parameters()}
    trainer = build()
    force = ForceJaxCodes(trainer, ref["ios"])
    r["trainer_loss"] = float(bnn_pynq.train_step(
        trainer, torch.optim.Adam(trainer.parameters(), lr=LR), x, y))
    force.remove()
    r["trainer"] = {n: port_tensor(p, n) for n, p in trainer.named_parameters()}
    print(f"{request.param}: {force.flips} codes set to JAX's at certified ties")
    return r


def test_cnv_step_logits_and_loss_match_jax(jax_ref, port_step):
    ref = jax_ref[port_step["dtype"]]
    assert port_step["logits"].shape == (BATCH, 10)
    assert np.all(np.abs(port_step["logits"] - ref["logits"])
                  <= 1e-5 * np.abs(ref["logits"]).max())
    assert np.isfinite(port_step["loss"])
    assert port_step["loss"] == pytest.approx(ref["loss"], rel=1e-6)
    assert port_step["trainer_loss"] == port_step["loss"]


def _convs_below(path: str) -> int:
    """The convs between a parameter and the loss (bf16 roundings of the
    backward on the way)."""
    if not path.startswith("conv_features"):
        return 0
    idx = int(path.split(".")[1])
    conv_at = [0, 3, 7, 10, 14, 17]
    return sum(1 for c in conv_at if c > idx)


def test_cnv_step_gradients_match_jax(jax_ref, port_step):
    want = jax_ref[port_step["dtype"]]["grads"]
    assert set(want) == set(port_step["grads"])
    bf16 = port_step["dtype"] == "bf16"
    for path, exp in want.items():
        got = port_step["grads"][path]
        assert got.shape == exp.shape, path
        share = 1e-4 + (2 * (_convs_below(path) + 1) * BF16_STEP if bf16 else 0.0)
        assert np.all(np.abs(got - exp) <= share * np.abs(exp).max()), path


def _adam_tolerance(jax_ref, port_step, path):
    first_update = lambda g: LR * g / (np.abs(g) + ADAM_EPS)  # noqa: E731
    g_port, g_jax = port_step["grads"][path], jax_ref[port_step["dtype"]]["grads"][path]
    want = jax_ref[port_step["dtype"]]["after_adam"][path]
    # the sum rounds at the larger of its operands and its result
    operand = np.maximum(np.maximum(np.abs(jax_ref["init"][path]), np.abs(want)),
                         np.float32(LR))
    return (S8_ADAM * LR + 4 * np.spacing(operand)
            + np.abs(first_update(g_port) - first_update(g_jax)))


@pytest.mark.parametrize("stage", ["after_adam", "clipped"])
def test_cnv_step_parameters_match_jax(jax_ref, port_step, stage):
    want = jax_ref[port_step["dtype"]][stage]
    assert set(want) == set(port_step[stage])
    for path, exp in want.items():
        got = port_step[stage][path]
        assert np.all(np.abs(got - exp) <= _adam_tolerance(jax_ref, port_step, path)), path
    weights = [p for p in want if p.endswith("weight") and want[p].ndim in (2, 4)]
    assert len(weights) == 9
    if stage == "clipped":
        for path in weights:
            got = port_step["clipped"][path]
            assert np.abs(got).max() <= 1.0
            np.testing.assert_array_equal(port_step["trainer"][path], got)
        assert any((np.abs(port_step["after_adam"][p]) > 1).any() for p in weights)


def test_set_compute_dtype_reaches_every_conv_and_linear():
    m = cnv(4, 4, 8, per_channel_weights=True, device="cpu")
    set_compute_dtype(m, torch.bfloat16)
    layers = [lyr for lyr in m.modules() if isinstance(lyr, (QuantConv2d, QuantLinear))]
    assert len(layers) == 9 and all(lyr.compute_dtype == torch.bfloat16 for lyr in layers)


@pytest.mark.parametrize("which", ["444", "fp"])
def test_cnv_forward_matches_jax(jax_ref, which):
    """cnv(4, 4, 4): the trainer's const-scale weights, per-tensor on
    fake_quant; cnv(None, None, None): bench's float baseline."""
    bits = (4, 4, 4) if which == "444" else (None, None, None)
    pm = cnv(*bits, device="cpu")
    load_jax_state(pm, jax_ref[f"init_{which}"])
    with torch.no_grad():
        got = pm(torch.from_numpy(to_port(jax_ref["x"]))).numpy()
    want = jax_ref[f"logits_{which}"]
    assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want).max())


# -- the trainer -------------------------------------------------------------------

def _write_cifar10(root) -> str:
    """The CIFAR-10 python-version layout at a tiny size: five training
    batches of two images and a test batch of three, under
    ``cifar-10-batches-py``."""
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d)
    rng = np.random.default_rng(11)
    for name, n in [*((f"data_batch_{i}", 2) for i in range(1, 6)), ("test_batch", 3)]:
        batch = {b"data": rng.integers(0, 256, (n, 3072)).astype(np.uint8),
                 b"labels": [int(v) for v in rng.integers(0, 10, n)]}
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump(batch, f)
    return str(root)


@pytest.mark.parametrize("split", ["train", "test"])
def test_load_cifar10_matches_jax_in_nchw(tmp_path, split):
    root = _write_cifar10(tmp_path)
    x, y = bnn_pynq.load_cifar10(root, split)
    want_x, want_y = jax_bnn_pynq.load_cifar10(root, split)
    assert x.shape == (10 if split == "train" else 3, 3, 32, 32) and x.dtype == np.float32
    np.testing.assert_array_equal(x, to_port(want_x))
    np.testing.assert_array_equal(y, want_y)


def test_load_synthetic_cnv_is_the_jax_draw_in_nchw():
    x, y = bnn_pynq.load_synthetic("test", "cnv", n=16)
    want_x, want_y = jax_bnn_pynq.load_synthetic("test", "cnv", n=16)
    np.testing.assert_array_equal(x, to_port(want_x))
    np.testing.assert_array_equal(y, want_y)


def test_bnn_pynq_main_trains_cnv_on_synthetic_data(monkeypatch, capsys):
    load = bnn_pynq.load_synthetic
    # a short epoch: 32 training images at batch 16, 16 to evaluate
    monkeypatch.setattr(bnn_pynq, "load_synthetic",
                        lambda split, kind, n=2048: load(split, kind, n=min(n, 32) // (
                            1 if split == "train" else 2)))
    acc = bnn_pynq.main(["--device", "cpu", "--network", "CNV_4W4A", "--dataset", "synthetic",
                         "--epochs", "1", "--batch-size", "16"])
    out = capsys.readouterr().out
    assert 0.0 <= acc <= 1.0
    assert '"best_val_acc"' in out and "epoch 0: mean loss" in out


def test_bnn_pynq_main_trains_cnv_on_cifar10_files(tmp_path, capsys):
    root = _write_cifar10(tmp_path)
    acc = bnn_pynq.main(["--device", "cpu", "--network", "CNV_8W8A", "--dataset", "cifar10",
                         "--data-dir", root, "--epochs", "1", "--batch-size", "5"])
    assert acc in (0.0, 1 / 3, 2 / 3, 1.0)
    assert '"best_val_acc"' in capsys.readouterr().out


def test_parse_network_builds_cnv_with_its_eight_bit_input():
    builder, kind, w, a = bnn_pynq.parse_network("CNV_4W4A")
    assert (builder.__name__, kind, w, a) == ("cnv", "cnv", 4, 4)
    m = builder(weight_bit_width=w, act_bit_width=a, device="cpu")
    assert m.input_quant.act_quant.cfg.bit_width == 8.0
