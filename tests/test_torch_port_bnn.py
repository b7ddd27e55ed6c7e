"""The port's bnn_pynq networks at 1 and 2 bits against the JAX package's.

What is held to JAX, every model-level JAX result computed once for the
module under one ``nnx.jit`` and kept as numpy:

- ``ops``: ``binary_sign``, ``round_to_zero``, ``dpu_round`` and their
  straight-through functions, with ``ternary_sign_ste``, values and
  gradients, at 0, at .5 ties of both signs and at integers;
- ``core.quant``: ``binary_quant``, ``clamped_binary_quant`` and
  ``ternary_quant``, values and the gradients of the input and the scale,
  at 0, at exactly +-scale and at +-threshold * scale;
- the BINARY and TERNARY weight and activation quantizers (the presets and
  the trainer's ``common_*_quant(1)``): values, gradients and the
  ``QuantTensor`` metadata, and a binary ``QuantLinear`` whose accumulator
  bit width is ``ceil(log2(0)) = -inf`` in both packages;
- TFC at 1W1A, 1W2A and 2W2A (784 -> 64 -> 64 -> 64 -> 10, batch 32), three
  steps each, and CNV_1W1A (batch 4, 32 x 32), one step, of the trainer's
  step (the square hinge loss, Adam at lr 0.02, then ``clip_weights(-1,
  1)``): in JAX the computation of ``examples.bnn_pynq.train_step`` (its
  loss, ``nnx.value_and_grad``, optax Adam, ``clip_weights``) under
  ``nnx.jit``, each activation quantizer's input and output recorded; the
  port's ``examples.bnn_pynq.train_step``, from the JAX model's initial
  state (``load_jax_state``); dropout 0 (the packages' random streams
  differ);
- the trainer: ``load_cfg`` on all 11 shipped configs (the port's own
  copies, byte-equal to the JAX package's), ``main`` training one of them,
  the default network, and ``--resume`` repeating a straight run.

A binary activation is the sign of a BatchNorm output, and at
  initialization (bias 0) that output is exactly 0 wherever a channel's
  mean equals one of its integer conv sums. XLA's jitted mean multiplies by
  1/n, so it can leave such an output a rounding below 0 (code -1) where the
  port's exact mean gives 0 (code +1): ROADMAP S3a. The steps certify each
  such code (``ForceJaxCodes``) and give the port JAX's value. At CNV_1W1A's
  one such code, JAX's own jitted backward recomputes that output on the
  other side of 0 and forms the next conv's weight gradient with +1, the
  value its forward did not use; the port uses the forward's value. That
  input channel of that weight's gradient (and its Adam update) is left out
  of the comparison, and CNV runs one step, since the next step starts from
  that difference.

Tolerances, each with its reason:
- ops, STEs, quantizer values and input gradients, and every code: exact.
  Binary and ternary values are +-scale or 0, and the 2-bit codes are
  rounded from the same float32 values. A scale's gradient is a float32
  sum over the tensor, in another order in torch than in XLA: within 1e-6
  of the sum of its terms' sizes;
- the steps' logits within 1e-5 of their largest, losses within rtol 1e-6:
  TensorNorm and BatchNorm sum in another order in torch than in XLA, and
  the port forms rsqrt in float64 (ROADMAP S1);
- gradients within 1e-4 of each tensor's largest element (S1; every
  operand here is float32, so S11's bf16 rounding does not arise);
- parameters after the steps within ``2 * S8`` (6.4e-6) of the sum of the
  updates' sizes, plus 4 ulps a step of the parameter, plus the difference
  of the two packages' Adam updates ``lr m / (sqrt(v) + eps)`` formed in
  float64 from their own gradients (S8: optax forms Adam's bias
  corrections in float32, torch in float64, 6.4e-6 of an update through
  the second moment's and measured up to 1.23e-5 of the updates' sum in
  all over these steps; an update divides by ``sqrt(v)``, so a gradient
  that differs at rounding level moves it by that share). Running
  statistics within 1e-5 (S1).
"""

import configparser
import dataclasses
import filecmp
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from brevitas_tpu.core import quant as JQ
from brevitas_tpu.examples import bnn_pynq as jax_bnn_pynq
from brevitas_tpu.models import cnv as jax_cnv
from brevitas_tpu.models.common import common_act_quant as jax_act_quant
from brevitas_tpu.models.common import common_weight_quant as jax_weight_quant
from brevitas_tpu.models.fc import FC as JaxFC
from brevitas_tpu.nn import QuantIdentity as JaxQuantIdentity
from brevitas_tpu.nn import QuantLinear as JaxQuantLinear
from brevitas_tpu.ops import numeric as jnum
from brevitas_tpu.ops import ste as jste
from brevitas_tpu.quant import presets as jax_presets
from brevitas_tpu.quant.quantizers import ActQuantizer as JaxActQuantizer
from brevitas_tpu.quant.quantizers import ParameterQuantizer as JaxParameterQuantizer
from brevitas_tpu_torch import ops
from brevitas_tpu_torch.core import quant as Q
from brevitas_tpu_torch.examples import bnn_pynq
from brevitas_tpu_torch.interop import load_jax_state
from brevitas_tpu_torch.models import cnv, lfc, sfc, tfc
from brevitas_tpu_torch.models.common import common_act_quant, common_weight_quant
from brevitas_tpu_torch.models.fc import FC
from brevitas_tpu_torch.nn import QuantIdentity, QuantLinear
from brevitas_tpu_torch.quant import presets
from brevitas_tpu_torch.quant.quantizers import ActQuantizer, ParameterQuantizer

torch.set_num_threads(1)

LR, ADAM_EPS = 0.02, 1e-8
S8_ADAM = 6.4e-6  # of an update: float64 against float32 bias corrections (ROADMAP S8)
TFC_WIDTHS, FC_BATCH, CNV_BATCH = (64, 64, 64), 32, 4
NETS = {"tfc_1w1a": (1, 1), "tfc_1w2a": (1, 2), "tfc_2w2a": (2, 2), "cnv_1w1a": (1, 1)}
# trainer steps a network: CNV takes one (see the module docstring)
STEPS = {"tfc_1w1a": 3, "tfc_1w2a": 3, "tfc_2w2a": 3, "cnv_1w1a": 1}
# the weighted layer each activation quantizer feeds, in _jax_io's order
NEXT_WEIGHT = {"fc": ["hidden.0.weight", "hidden.3.weight", "hidden.6.weight", "head.weight"],
               "cnv": [f"conv_features.{i}.weight" for i in (0, 3, 7, 10, 14, 17)]
               + [f"linear_features.{i}.weight" for i in (0, 3, 6)]}
# 0, .5 ties of both signs, integers, and values either side of them
OP_X = np.array([0.0, -0.0, 0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 1.0, -1.0, 0.49999997, -0.49999997,
                 3.7, -3.7, 1e-30, -1e-30], np.float32)
OPS = ["binary_sign", "round_to_zero", "dpu_round"]
STES = ["binary_sign_ste", "ternary_sign_ste", "round_to_zero_ste", "dpu_round_ste"]
OP_G = np.linspace(0.5, 2.0, OP_X.size).astype(np.float32)
SCALE, TERNARY_T = np.float32(0.75), 0.5
# 0, exactly +-scale, +-threshold * scale, inside and outside the clamp
QUANT_X = np.array([0.0, -0.0, 0.75, -0.75, 0.375, -0.375, 0.3, -0.3, 0.9, -0.9, 2.0, -2.0,
                    0.37500003, -0.37500003, 0.74999994, -0.74999994], np.float32)
QUANT_G = np.linspace(0.5, 2.0, QUANT_X.size).astype(np.float32)
QUANT_FNS = ["binary_quant", "clamped_binary_quant", "ternary_quant"]
QUANTIZERS = {"binary_weight": ("weight", "SignedBinaryWeightPerTensorConst"),
              "ternary_weight": ("weight", "SignedTernaryWeightPerTensorConst"),
              "binary_act": ("act", "SignedBinaryActPerTensorConst"),
              "ternary_act": ("act", "SignedTernaryActPerTensorConst"),
              "common_weight_1": ("weight", None), "common_act_1": ("act", None)}
CFGS = sorted(f[:-4] for f in os.listdir(bnn_pynq.CFG_DIR) if f.endswith(".ini"))


def jax_state_arrays(model) -> dict:
    return {".".join(map(str, path)): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model)) if path[0] != "rngs"}


def flat(state) -> dict:
    return {".".join(map(str, path)): np.asarray(v[...])
            for path, v in nnx.to_flat_state(state)}


def to_port(v: np.ndarray) -> np.ndarray:
    """NHWC to the port's NCHW."""
    return np.ascontiguousarray(np.moveaxis(v, -1, 1))


def port_tensor(t: torch.Tensor, path: str) -> np.ndarray:
    """A port tensor in the JAX layout: linear weights (out, in) -> (in, out),
    conv weights OIHW -> HWIO."""
    v = t.detach().numpy().copy()
    if path.endswith("weight") and v.ndim == 4:
        return np.ascontiguousarray(np.moveaxis(v, (0, 1), (-1, -2)))
    if path.endswith("weight") and v.ndim == 2:
        return v.T
    return v


def _quant_rng_input(shape, seed):
    # spans both clamps and the ternary threshold at scale 0.1 and 1.0
    return (np.random.default_rng(seed).standard_normal(shape) * 0.8).astype(np.float32)


def _build_jax_quantizer(name, w):
    side, preset = QUANTIZERS[name]
    if side == "weight":
        cfg = getattr(jax_presets, preset) if preset else jax_weight_quant(1)
        return JaxParameterQuantizer(cfg, jnp.asarray(w))
    cfg = getattr(jax_presets, preset) if preset else jax_act_quant(1)
    return JaxActQuantizer(cfg)


def _build_port_quantizer(name, w):
    side, preset = QUANTIZERS[name]
    if side == "weight":
        cfg = getattr(presets, preset) if preset else common_weight_quant(1)
        return ParameterQuantizer(cfg, torch.from_numpy(w))
    cfg = getattr(presets, preset) if preset else common_act_quant(1)
    return ActQuantizer(cfg)


def _jax_io(m, x, kind):
    """The model's forward step by step: the logits and each activation
    quantizer's input and output value, in order."""
    ios = []

    def quant(lyr, v):
        out = lyr(v)
        ios.append((v, out.value))
        return out

    if kind == "fc":
        x = 2.0 * x.reshape(x.shape[0], -1) - 1.0
        x = quant(m.input_quant, x)
        for i in range(0, len(m.hidden), 3):
            x = quant(m.hidden[i + 2], m.hidden[i + 1](m.hidden[i](x)))
        return m.norm(m.head(x)), ios
    x = quant(m.input_quant, 2.0 * x - 1.0)
    for lyr in m.conv_features:
        x = quant(lyr, x) if isinstance(lyr, JaxQuantIdentity) else lyr(x)
    x = x.reshape(x.shape[0], -1)
    for lyr in m.linear_features:
        x = quant(lyr, x) if isinstance(lyr, JaxQuantIdentity) else lyr(x)
    return m.norm(x), ios


def _data(name):
    rng = np.random.default_rng(11 + list(NETS).index(name))
    n = STEPS[name]
    if name.startswith("cnv"):
        x = rng.random((n, CNV_BATCH, 32, 32, 3), dtype=np.float32)
        return x, rng.integers(0, 10, (n, CNV_BATCH)).astype(np.int32)
    x = rng.random((n, FC_BATCH, 28, 28, 1), dtype=np.float32)
    return x, rng.integers(0, 10, (n, FC_BATCH)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_ref():
    """Every JAX result of the file, as numpy."""
    fns = {"binary_quant": lambda v, c: JQ.binary_quant(v, c),
           "clamped_binary_quant": lambda v, c: JQ.clamped_binary_quant(v, c),
           "ternary_quant": lambda v, c: JQ.ternary_quant(v, c, TERNARY_T)}
    qin = {name: (_quant_rng_input((6, 10), 40 + i), _quant_rng_input((6, 10), 60 + i))
           for i, name in enumerate(QUANTIZERS)}
    signed = {}

    # the ops, functions and quantizers under one jit: their values are
    # signs, rounds and +-scale, the same bits as eager JAX
    @jax.jit
    def small(x, g, qx, s, qg, qin):
        out = {"ops": {name: getattr(jnum, name)(x) for name in OPS}, "ste": {}, "quant": {},
               "quantizers": {}}
        for name in STES:
            y, vjp = jax.vjp(getattr(jste, name), x)
            out["ste"][name] = (y, vjp(g)[0])
        for name, fn in fns.items():
            (y, bw), vjp = jax.vjp(fn, qx, s)
            out["quant"][name] = (y, bw, *vjp((qg, jnp.zeros_like(bw))))
        for name, (w, gq) in qin.items():
            q = _build_jax_quantizer(name, w)
            qt, vjp = jax.vjp(lambda v: q(v), w)
            signed[name] = qt.signed
            out["quantizers"][name] = {"y": qt.value, "dx": vjp(dataclasses.replace(
                jax.tree.map(jnp.zeros_like, qt), value=gq))[0], "scale": qt.scale,
                "zero_point": qt.zero_point, "bit_width": qt.bit_width}
        return out

    r = jax.tree.map(np.asarray, small(*(jnp.asarray(v) for v in (OP_X, OP_G, QUANT_X, SCALE,
                                                                   QUANT_G)), qin))
    r["quant"] = {k: (y, float(bw), dx, float(ds)) for k, (y, bw, dx, ds) in r["quant"].items()}
    for name, (w, gq) in qin.items():
        r["quantizers"][name].update(x=w, g=gq, bit_width=float(r["quantizers"][name]["bit_width"]),
                                     signed=signed[name])
    # every model, built under one jit (the initializers compile as one
    # program)
    @nnx.jit
    def build():
        models = {}
        for name, (wb, ab) in NETS.items():
            if name.startswith("cnv"):
                models[name] = jax_cnv(wb, ab, 8, rngs=nnx.Rngs(3))
            else:
                models[name] = JaxFC(out_features=TFC_WIDTHS, weight_bit_width=wb,
                                     act_bit_width=ab, in_bit_width=ab, dropout=0.0,
                                     rngs=nnx.Rngs(list(NETS).index(name)))
        lin = JaxQuantLinear(12, 5, use_bias=False, weight_quant=jax_weight_quant(1),
                             input_quant=jax_act_quant(1), return_quant_tensor=True,
                             rngs=nnx.Rngs(5))
        return models, lin

    models, lin = build()
    lin_x = _quant_rng_input((3, 12), 90)
    qt = lin(jnp.asarray(lin_x))
    r["linear"] = {"state": jax_state_arrays(lin), "x": lin_x, "y": np.asarray(qt.value),
                   "scale": np.asarray(qt.scale), "bit_width": float(qt.bit_width),
                   "signed": qt.signed}
    r["init"] = {name: jax_state_arrays(m) for name, m in models.items()}
    data = {name: _data(name) for name in NETS}

    @nnx.jit(static_argnames=("kind",))
    def step(m, opt, x, y, kind):
        def objective(mm):
            logits, ios = _jax_io(mm, x, kind)
            return jax_bnn_pynq.sqr_hinge_loss(logits, y), (logits, ios)

        (loss, (logits, ios)), grads = nnx.value_and_grad(objective, has_aux=True)(m)
        opt.update(m, grads)
        m.clip_weights(-1.0, 1.0)
        return loss, logits, ios, grads

    r["steps"] = {}
    for name, m in models.items():
        opt = nnx.Optimizer(m, optax.adam(LR), wrt=nnx.Param)
        xs, ys = data[name]
        r["steps"][name] = []
        for i in range(STEPS[name]):
            loss, logits, ios, grads = step(m, opt, jnp.asarray(xs[i]), jnp.asarray(ys[i]),
                                            "cnv" if name.startswith("cnv") else "fc")
            r["steps"][name].append({"loss": float(loss), "logits": np.asarray(logits),
                                     "ios": [(np.asarray(a), np.asarray(b)) for a, b in ios], "grads": flat(grads),
                                     "state": jax_state_arrays(m)})
    r["data"] = data
    return r


# -- ops ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", OPS)
def test_numeric_ops_match_jax_exactly(jax_ref, name):
    got = getattr(ops, name)(torch.from_numpy(OP_X)).numpy()
    want = jax_ref["ops"][name]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))  # -0.0 kept
    if name == "binary_sign":
        assert got[0] == 1.0 and got[1] == 1.0, "binary_sign(0) is +1"


@pytest.mark.parametrize("name", STES)
def test_ste_ops_match_jax_values_and_pass_the_gradient(jax_ref, name):
    x = torch.from_numpy(OP_X).requires_grad_()
    y = getattr(ops, name)(x)
    g = torch.from_numpy(OP_G)
    y.backward(g)
    want_y, want_dx = jax_ref["ste"][name]
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    np.testing.assert_array_equal(x.grad.numpy(), want_dx)
    np.testing.assert_array_equal(x.grad.numpy(), g.numpy())


def test_stochastic_round_ste_floors_with_the_given_noise():
    """floor(x + noise), the gradient straight through to x and none to the
    noise (JAX's ``_stochastic_round(x, noise)`` is held to it in
    ``tests/test_torch_port_quant_options.py``)."""
    x = torch.tensor([0.25, -0.25, 1.5, -1.5], requires_grad=True)
    noise = torch.tensor([0.8, 0.8, 0.2, 0.6], requires_grad=True)
    y = ops.stochastic_round_ste(x, noise)
    y.sum().backward()
    assert y.tolist() == [1.0, 0.0, 1.0, -1.0]
    assert x.grad.tolist() == [1.0] * 4 and noise.grad is None


# -- core.quant -------------------------------------------------------------------

@pytest.mark.parametrize("name", QUANT_FNS)
def test_binary_and_ternary_quant_match_jax(jax_ref, name):
    x = torch.from_numpy(QUANT_X).requires_grad_()
    s = torch.tensor(SCALE, requires_grad=True)
    if name == "ternary_quant":
        y, bw = Q.ternary_quant(x, s, TERNARY_T)
    else:
        y, bw = getattr(Q, name)(x, s)
    y.backward(torch.from_numpy(QUANT_G))
    want_y, want_bw, want_dx, want_ds = jax_ref["quant"][name]
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    np.testing.assert_array_equal(x.grad.numpy(), want_dx)
    assert bw == want_bw
    # a float32 sum over the elements, in another order than XLA's
    terms = np.abs(QUANT_G.astype(np.float64) * np.abs(y.detach().numpy() / SCALE))
    assert abs(float(s.grad) - want_ds) <= 1e-6 * terms.sum()
    if name == "clamped_binary_quant":
        # the where clamp passes a gradient at exactly +-scale, none beyond
        assert x.grad[2] != 0 and x.grad[3] != 0 and x.grad[10] == 0 and x.grad[11] == 0
    if name == "ternary_quant":
        # the strict >: exactly threshold * scale gives 0
        assert y[4] == 0 and y[5] == 0 and y[12] != 0 and y[13] != 0


# -- quantizers --------------------------------------------------------------------

@pytest.mark.parametrize("name", list(QUANTIZERS))
def test_binary_and_ternary_quantizers_match_jax(jax_ref, name):
    want = jax_ref["quantizers"][name]
    q = _build_port_quantizer(name, want["x"])
    x = torch.from_numpy(want["x"]).requires_grad_()
    qt = q(x)
    qt.value.backward(torch.from_numpy(want["g"]))
    np.testing.assert_array_equal(qt.value.detach().numpy(), want["y"])
    np.testing.assert_array_equal(x.grad.numpy(), want["dx"])
    np.testing.assert_array_equal(np.asarray(qt.scale.detach()), want["scale"])
    assert float(qt.zero_point) == float(want["zero_point"]) == 0.0
    assert qt.bit_width == want["bit_width"] and qt.signed is want["signed"] is True
    codes = np.unique(qt.value.detach().numpy() / want["scale"])
    allowed = {-1.0, 1.0} if ("binary" in name or name.endswith("_1")) else {-1.0, 0.0, 1.0}
    assert set(codes.tolist()) <= allowed
    if QUANTIZERS[name][0] == "act":
        assert q.static_int_params() is None


def test_binary_quant_linear_metadata_matches_jax(jax_ref):
    """A binary weight is narrow at 1 bit: max_int is 0, so the accumulator
    bit width is ceil(log2(0)) = -inf in both packages; the code-domain
    branch stays off for it."""
    want = jax_ref["linear"]
    pl = QuantLinear(12, 5, use_bias=False, weight_quant=common_weight_quant(1),
                     input_quant=common_act_quant(1), return_quant_tensor=True, device="cpu")
    load_jax_state(pl, want["state"])
    qt = pl(torch.from_numpy(want["x"]))
    np.testing.assert_allclose(qt.value.detach().numpy(), want["y"], rtol=0, atol=1e-6)
    assert qt.bit_width == want["bit_width"] == float("-inf")
    np.testing.assert_array_equal(np.asarray(qt.scale.detach()), want["scale"])
    assert qt.signed is want["signed"] is True
    pl.compute_dtype = torch.bfloat16
    np.testing.assert_array_equal(pl(torch.from_numpy(want["x"])).value.detach().numpy(),
                                  qt.value.detach().numpy())


def test_binary_calibration_mode_passes_the_float_value():
    q = ActQuantizer(common_act_quant(1))
    q.disable_quant = True
    x = torch.tensor([0.3, -2.0])
    assert torch.equal(q(x).value, x)


# -- the 1- and 2-bit networks: three trainer steps ------------------------------------

def _port_model(name, jax_ref):
    wb, ab = NETS[name]
    if name.startswith("cnv"):
        pm = cnv(wb, ab, 8, device="cpu")
    else:
        pm = FC(out_features=TFC_WIDTHS, weight_bit_width=wb, act_bit_width=ab,
                in_bit_width=ab, dropout=0.0, device="cpu")
    return load_jax_state(pm, jax_ref["init"][name])


class ForceJaxCodes:
    """Forward hooks on the port's activation quantizers, in the order
    ``_jax_io`` records JAX's. Where an output differs from JAX's, the two
    inputs must lie on either side of the boundary between the two codes
    (0 at 1 bit, a .5 tie at 2) and within 1e-5 of the tensor's largest
    value of each other: a BatchNorm output that is exactly on the
    boundary in integer arithmetic (a channel's mean equal to one of its
    integer conv sums), which XLA's mean, a multiply by 1/n, leaves a
    rounding to one side (ROADMAP S3a). Such outputs are counted and given
    JAX's value, unchanged in their gradient; any other difference is
    counted as uncertified."""

    def __init__(self, quants, ios):
        self.ios, self.flips, self.uncertified = ios, 0, 0
        self.flipped = set()  # (quantizer, channel on axis 1)
        self.handles = [q.register_forward_hook(self._hook(i)) for i, q in enumerate(quants)]

    def _hook(self, i):
        def hook(module, args, out):
            want_x, want_y = (to_port(v) if v.ndim == 4 else v for v in self.ios[i])
            got_y = out.value.detach().numpy()
            differ = got_y != want_y
            if not differ.any():
                return out
            got_x = args[0].value if hasattr(args[0], "value") else args[0]
            got_x = got_x.detach().numpy()
            boundary = (got_y[differ] + want_y[differ]) / 2
            certified = (((got_x[differ] - boundary) * (want_x[differ] - boundary) <= 0)
                         & (np.abs(got_x[differ] - want_x[differ])
                            <= 1e-5 * np.abs(want_x).max()))
            self.flips += int(differ.sum())
            self.uncertified += int((~certified).sum())
            self.flipped |= {(i, int(c)) for c in np.argwhere(differ)[:, 1]}
            return dataclasses.replace(out, value=out.value + torch.from_numpy(want_y - got_y))
        return hook

    def remove(self):
        for h in self.handles:
            h.remove()


@pytest.fixture(scope="module", params=list(NETS))
def port_steps(request, jax_ref):
    """The port's three steps from the JAX model's initial state, its codes
    given JAX's at certified boundaries; then the trainer's own train_step
    from the same state, forced the same way."""
    name = request.param
    want = jax_ref["steps"][name]
    pm = _port_model(name, jax_ref)
    quants = [m for m in pm.modules() if isinstance(m, QuantIdentity)]
    ios = []
    record = [q.register_forward_hook(lambda mod, a, out: ios.append(out.value.detach()))
              for q in quants]
    xs, ys = jax_ref["data"][name]
    opt = torch.optim.Adam(pm.parameters(), lr=LR)
    steps, flips, uncertified, flipped = [], 0, 0, set()
    for i in range(STEPS[name]):
        ios.clear()
        x = torch.from_numpy(to_port(xs[i]) if name.startswith("cnv") else xs[i])
        force = ForceJaxCodes(quants, want[i]["ios"])
        opt.zero_grad(set_to_none=True)
        logits = pm(x)
        force.remove()
        flips, uncertified = flips + force.flips, uncertified + force.uncertified
        flipped |= force.flipped
        loss = bnn_pynq.sqr_hinge_loss(logits, torch.from_numpy(ys[i]))
        loss.backward()
        grads = {n: port_tensor(p.grad, n) for n, p in pm.named_parameters()}
        opt.step()
        pm.clip_weights(-1.0, 1.0)
        steps.append({"loss": float(loss), "logits": logits.detach().numpy(),
                      "ios": [v.numpy().copy() for v in ios], "grads": grads,
                      "state": {n: port_tensor(t, n) for n, t in pm.state_dict().items()}})
    for h in record:
        h.remove()
    # the trainer's own step from the same initial state: the same losses
    trainer = _port_model(name, jax_ref)
    tquants = [m for m in trainer.modules() if isinstance(m, QuantIdentity)]
    topt = torch.optim.Adam(trainer.parameters(), lr=LR)
    trainer_losses = []
    for i in range(STEPS[name]):
        force = ForceJaxCodes(tquants, want[i]["ios"])
        trainer_losses.append(float(bnn_pynq.train_step(
            trainer, topt, torch.from_numpy(to_port(xs[i]) if name.startswith("cnv") else xs[i]),
            torch.from_numpy(ys[i]))))
        force.remove()
    print(f"{name}: {flips} codes given JAX's value at certified boundaries")
    kind = "cnv" if name.startswith("cnv") else "fc"
    # a flipped input's channel in the next layer's weight gradient, (in)
    # axis -2 in the JAX layout
    skip = {}
    for q, c in flipped:
        skip.setdefault(NEXT_WEIGHT[kind][q], set()).add(c)
    return {"name": name, "steps": steps, "trainer_losses": trainer_losses, "flips": flips,
            "uncertified": uncertified, "skip": skip,
            "trainer_state": {n: port_tensor(t, n) for n, t in trainer.state_dict().items()}}


def test_bnn_steps_codes_match_jax_exactly(jax_ref, port_steps):
    """Every activation code is JAX's but the few at certified boundaries
    (none uncertified), and every weight code that a step starts from (the
    initial state's, then each one the packages' parameters reach within
    the tolerance of ``test_bnn_steps_parameters_and_state_match_jax``:
    after an Adam step a weight within that tolerance of a code boundary
    may round to either side, S8)."""
    name = port_steps["name"]
    assert port_steps["uncertified"] == 0
    differ = 0
    for i, (got, want) in enumerate(zip(port_steps["steps"], jax_ref["steps"][name])):
        assert len(got["ios"]) == len(want["ios"]) == (4 if name.startswith("tfc") else 9)
        for a, (_, b) in zip(got["ios"], want["ios"]):
            differ += int((a != (to_port(b) if b.ndim == 4 else b)).sum())
    assert differ == port_steps["flips"]
    # the weight codes at scale 1 that the first step starts from: the
    # binary sign at 1 bit, round at 2
    code = (lambda v: np.where(v >= 0, 1, -1)) if NETS[name][0] == 1 else np.round
    pm = _port_model(name, jax_ref)
    for path, t in pm.state_dict().items():
        if path.endswith("weight") and t.ndim in (2, 4):
            np.testing.assert_array_equal(code(port_tensor(t, path)),
                                          code(jax_ref["init"][name][path]), err_msg=path)


def test_bnn_steps_logits_and_losses_match_jax(jax_ref, port_steps):
    name = port_steps["name"]
    for got, want in zip(port_steps["steps"], jax_ref["steps"][name]):
        assert np.all(np.abs(got["logits"] - want["logits"])
                      <= 1e-5 * np.abs(want["logits"]).max())
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
    assert port_steps["trainer_losses"] == [s["loss"] for s in port_steps["steps"]]


def _held(port_steps, path, shape) -> np.ndarray:
    """The entries compared: all but a certified flip's input channel in
    the next layer's weight (see the module docstring)."""
    keep = np.ones(shape, bool)
    for c in port_steps["skip"].get(path, ()):
        keep[..., c, :] = False
    return keep


def test_bnn_steps_gradients_match_jax(jax_ref, port_steps):
    name = port_steps["name"]
    for i, (got, want) in enumerate(zip(port_steps["steps"], jax_ref["steps"][name])):
        assert set(got["grads"]) == set(want["grads"])
        for path, exp in want["grads"].items():
            keep = _held(port_steps, path, exp.shape)
            assert np.all(np.abs(got["grads"][path] - exp)[keep] <= 1e-4 * np.abs(exp).max()), \
                (name, i, path)
    # a flip reaches one input channel of one layer, no more
    assert sum(len(v) for v in port_steps["skip"].values()) <= port_steps["flips"]


def _adam_updates(grads_per_step):
    """Adam's updates ``lr m / (sqrt(v) + eps)`` from a run's gradients."""
    m = v = 0.0
    out = []
    for t, g in enumerate(grads_per_step, start=1):
        g = g.astype(np.float64)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        out.append(LR * (m / (1 - 0.9**t)) / (np.sqrt(v / (1 - 0.999**t)) + ADAM_EPS))
    return out


def test_bnn_steps_parameters_and_state_match_jax(jax_ref, port_steps):
    name = port_steps["name"]
    got_steps, want_steps = port_steps["steps"], jax_ref["steps"][name]
    got, want = got_steps[-1]["state"], want_steps[-1]["state"]
    assert set(got) == set(want), set(got) ^ set(want)
    for path, exp in want.items():
        if path in got_steps[0]["grads"]:
            u_got = _adam_updates([s["grads"][path] for s in got_steps])
            u_want = _adam_updates([s["grads"][path] for s in want_steps])
            drift = sum(np.abs(a - b) for a, b in zip(u_got, u_want))
            tol = (2 * S8_ADAM * sum(np.abs(u) for u in u_want) + drift
                   + len(got_steps) * 4 * np.spacing(np.abs(exp)))
        else:
            # BatchNorm's and TensorNorm's running statistics (S1)
            tol = 1e-5 * np.maximum(np.abs(exp).max(), 1.0)
        keep = _held(port_steps, path, exp.shape)
        assert np.all((np.abs(got[path] - exp) <= tol)[keep]), (name, path)
    assert all(np.abs(got[p]).max() <= 1.0 for p in got if p.endswith("weight"))
    for path, v in port_steps["trainer_state"].items():
        np.testing.assert_array_equal(v, got[path], err_msg=path)


# -- the builders' defaults ------------------------------------------------------------

@pytest.mark.parametrize("builder", [tfc, sfc, lfc, cnv], ids=lambda b: b.__name__)
def test_builders_default_to_one_bit_and_train(builder):
    m = builder(device="cpu")
    assert m.input_quant.act_quant.quant_type.value == ("int" if builder is cnv else "binary")
    shape = (2, 3, 32, 32) if builder is cnv else (2, 28, 28, 1)
    x = torch.from_numpy(np.random.default_rng(0).random(shape, dtype=np.float32))
    y = m(x)
    y.sum().backward()
    assert y.shape == (2, 10) and torch.isfinite(y).all()
    assert all(p.grad is not None for p in m.parameters())


def test_dropout_on_a_binary_quant_tensor_moves_into_the_scale():
    """1/keep goes into the scale: the codes stay +-1 (and 0 where dropped)."""
    m = tfc(device="cpu", dropout=0.5)
    qt = m.input_quant(torch.linspace(-1, 1, 64).reshape(2, 32))
    out = m._dropout(qt)
    assert float(out.scale) == float(qt.scale) / 0.5
    assert set(torch.unique(out.value / out.scale).tolist()) <= {-1.0, 0.0, 1.0}


# -- the trainer --------------------------------------------------------------------

@pytest.mark.parametrize("name", CFGS)
def test_load_cfg_matches_jax(name):
    """The port's copy of each shipped config is byte-equal to the JAX
    package's and resolves to the same builder arguments, kind and dataset;
    the port builds the network."""
    jax_path = os.path.join(os.path.dirname(jax_bnn_pynq.__file__), "cfg", name + ".ini")
    assert filecmp.cmp(os.path.join(bnn_pynq.CFG_DIR, name + ".ini"), jax_path, shallow=False)
    _, jkw, jkind, jds = jax_bnn_pynq.load_cfg(name)
    builder, kw, kind, ds = bnn_pynq.load_cfg(name)
    assert (kw, kind, ds) == (jkw, jkind, jds)
    ini = configparser.ConfigParser()
    ini.read(jax_path)
    if kind == "fc":
        assert builder.keywords["out_features"] == tuple(
            int(v) for v in ini["MODEL"]["OUT_FEATURES"].strip("[] ").split(","))
    else:
        assert builder.keywords["in_channels"] == ini["MODEL"].getint("IN_CHANNELS")
    m = builder(**kw, device="cpu")
    assert m.norm is not None
    # a path resolves as the name does
    assert bnn_pynq.load_cfg(jax_path)[1:] == (kw, kind, ds)


def test_bnn_pynq_main_trains_a_cfg(tmp_path, capsys):
    acc = bnn_pynq.main(["--device", "cpu", "--cfg", "tfc_1w2a", "--epochs", "1",
                         "--batch-size", "512", "--ckpt-dir", str(tmp_path)])
    assert 0.0 <= acc <= 1.0 and '"best_val_acc"' in capsys.readouterr().out


def test_bnn_pynq_defaults_to_lfc_1w1a():
    args = bnn_pynq.parse_args([])
    assert args.network == "LFC_1W1A" and args.cfg is None
    builder, kind, w, a = bnn_pynq.parse_network(args.network)
    assert (builder.__name__, kind, w, a) == ("lfc", "fc", 1, 1)


def test_bnn_pynq_resume_repeats_a_straight_run(tmp_path):
    """One epoch, then --resume for a second, equals two straight epochs bit
    for bit: the checkpoint holds the model's and Adam's state, the dropout
    generator's state (dropout 0.2 here) and the next epoch."""
    common = ["--device", "cpu", "--network", "TFC_1W2A", "--batch-size", "512",
              "--log-every", "100"]
    straight, _, acc = bnn_pynq.train(bnn_pynq.parse_args(
        common + ["--epochs", "2", "--ckpt-dir", str(tmp_path / "a")]))
    bnn_pynq.main(common + ["--epochs", "1", "--ckpt-dir", str(tmp_path / "b")])
    ckpt = tmp_path / "b" / bnn_pynq.CHECKPOINT
    saved = torch.load(ckpt, weights_only=True)
    assert saved["epoch"] == 1 and saved["dropout_generator"] is not None
    shutil.copy(ckpt, tmp_path / "resume.pt")
    resumed, _, acc2 = bnn_pynq.train(bnn_pynq.parse_args(
        common + ["--epochs", "2", "--ckpt-dir", str(tmp_path / "b"),
                  "--resume", str(tmp_path / "resume.pt")]))
    want, got = straight.state_dict(), resumed.state_dict()
    assert set(want) == set(got)
    for k in want:
        assert torch.equal(want[k], got[k]), k
    assert acc == acc2
