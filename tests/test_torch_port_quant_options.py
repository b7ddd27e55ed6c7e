"""The QAT quantizers' other options in the port against the JAX package's.

Each option is held to the JAX quantizer built from the same preset, the
port's state filled from JAX's (``load_jax_state``), inputs from numpy
seeds. The JAX references run once for the module. XLA's algebraic
simplifier turns a division by a constant (a scale's ``threshold / 255``)
into a multiply by its reciprocal, an ulp off (ROADMAP S13), so the stats
ops and the one-call cases run under one ``jit`` with that pass off, which
gives eager JAX's bits; the two-phase quantizer runs eagerly, since under
``jit`` XLA also contracts its running statistics' multiply-adds into
FMAs (S1).

What is held:
- the stats ops MIN_MAX, MIN, PERCENTILE_LOW and PERCENTILE_INTERVAL
  (``kthvalue``'s index rule), values and gradients;
- ROUND_TO_ZERO and DPU_ROUND rounding, and the INT restriction of a
  learned scale;
- zero points: STATS of the weight (``ShiftedUint8WeightPerTensorFloat``
  and ``PerChannelFloat``), a learned PARAMETER one, quantized onto the grid
  and not, and the two-phase PARAMETER_FROM_STATS one
  (``ShiftedUint8ActPerTensorFloat`` at 3 collection steps) over its
  collection, its handoff and after, then in eval, with its buffer, value
  and counter, and the two-phase scale beside it;
- STOCHASTIC_ROUND: the straight-through function on the same noise, and a
  quantizer whose noise is JAX's first draw;
- learned bit widths (the ``*LearnedBitWidth`` presets): values, the
  ``QuantTensor`` bit width and the offset's gradient;
- ``int_fake_quant``'s rule for the ``fake_quant`` kernel on each option.

Tolerances, each with its reason:
- values, codes, zero points, bit widths and input gradients that pass
  straight through: exact;
- a gradient that is a float32 sum over the tensor (a scale's, a zero
  point's, a learned bit width's, and an input's where the statistics route
  one back to a few elements): within 1e-5 of the sum of its terms' sizes,
  torch and XLA summing in different orders (S1, S8);
- the two-phase scale's running buffer: within 2 float32 ulps, since JAX
  updates it inside ``lax.cond``, which XLA compiles and may contract
  into an FMA (S1); the zero point's buffer, updated by ``jnp.where``
  eagerly, is exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from brevitas_tpu.core import stats as JS
from brevitas_tpu.ops import ste as jste
from brevitas_tpu.quant import presets as jax_presets
from brevitas_tpu.quant.config import ScalingImplType as JaxScalingImplType
from brevitas_tpu.quant.config import ZeroPointImplType as JaxZeroPointImplType
from brevitas_tpu.quant.quantizers import ActQuantizer as JaxActQuantizer
from brevitas_tpu.quant.quantizers import ParameterQuantizer as JaxParameterQuantizer
from brevitas_tpu_torch.core import stats as S
from brevitas_tpu_torch.interop import load_jax_state
from brevitas_tpu_torch.ops import round_ste, stochastic_round_ste
from brevitas_tpu_torch.quant import presets
from brevitas_tpu_torch.quant.config import ScalingImplType, ZeroPointImplType
from brevitas_tpu_torch.quant.quantizers import (
    ActQuantizer,
    ParameterQuantizer,
    kernel_rule,
)

torch.set_num_threads(1)

SHAPE = (16, 24)
NO_ALGSIMP = {"xla_disable_hlo_passes": "algsimp"}
STATS_CASES = {"min_max": ("abs_min_max", {}), "min": ("negative_min_or_zero", {}),
               "percentile_low": ("negative_percentile_or_zero", {"q": 10.0}),
               "percentile_low_tiny": ("negative_percentile_or_zero", {"q": 0.001}),
               "percentile_interval": ("percentile_interval", {"low_q": 5.0, "high_q": 95.0})}
TWO_PHASE_STEPS, TWO_PHASE_CALLS = 3, 5
ZP_INIT = 0.37


def _weight_cases(pkg, ztype):
    int8w = pkg.Int8WeightPerTensorFloat
    return {
        "round_to_zero": ("weight", int8w.let(float_to_int="round_to_zero")),
        "dpu_round": ("weight", int8w.let(float_to_int="dpu_round", bit_width=3.0)),
        "int_restrict": ("weight", int8w.let(
            scaling_impl=pkg_scaling(pkg).PARAMETER, scaling_const=3.3, restrict_scaling="int")),
        "shifted_weight": ("weight", pkg.ShiftedUint8WeightPerTensorFloat),
        "shifted_weight_per_channel": ("weight", pkg.ShiftedUint8WeightPerChannelFloat),
        "zp_parameter": ("act", pkg.Uint8ActPerTensorFloat.let(
            scaling_impl=pkg_scaling(pkg).CONST, scaling_const=2.0,
            zero_point_impl=ztype.PARAMETER)),
        "zp_parameter_quantized": ("act", pkg.Uint8ActPerTensorFloat.let(
            scaling_impl=pkg_scaling(pkg).CONST, scaling_const=2.0,
            zero_point_impl=ztype.PARAMETER, quantize_zero_point=True)),
        "learned_bit_width_weight": ("weight", pkg.Int8WeightPerTensorFloatLearnedBitWidth),
        "learned_bit_width_act": ("act", pkg.Int8ActPerTensorFloatLearnedBitWidth),
    }


def pkg_scaling(pkg):
    return JaxScalingImplType if pkg is jax_presets else ScalingImplType


CASES = list(_weight_cases(presets, ZeroPointImplType))


def _input(seed, shape=SHAPE):
    # a spread that reaches the 3-bit clamp and puts values on both sides of 0
    return (np.random.default_rng(seed).standard_normal(shape) * 1.3 + 0.2).astype(np.float32)


def jax_arrays(model) -> dict:
    return {".".join(map(str, path)): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model)) if "rngs" not in path}


def _set_jax(q, name):
    """Give learned zero points and bit widths a value away from their
    initial one, so that their gradients and shifts are not at a kink."""
    if name.startswith("zp_parameter"):
        q.zero_point.value[...] = jnp.asarray(ZP_INIT)
    if name.startswith("learned_bit_width"):
        q.bit_width_impl.offset[...] = jnp.asarray(3.4)  # round(|3.4| + 2) = 5 bits


@pytest.fixture(scope="module")
def jax_ref():
    r = {"stats_in": (_input(1, (3, 40)), _input(2, (3,))), "cases": {}}
    quants, inputs = {}, {}
    for i, (name, (side, cfg)) in enumerate(_weight_cases(jax_presets,
                                                          JaxZeroPointImplType).items()):
        w, gy = _input(10 + i), _input(30 + i)
        q = JaxParameterQuantizer(cfg, jnp.asarray(w)) if side == "weight" \
            else JaxActQuantizer(cfg)
        _set_jax(q, name)
        r["cases"][name] = {"state": jax_arrays(q), "x": w, "g": gy}
        quants[name], inputs[name] = q, (jnp.asarray(w), jnp.asarray(gy))
    graphdef, state = nnx.split(quants)

    # the stats ops and the one-call cases under one jit with XLA's
    # algebraic simplifier off, so that a division by a constant stays a
    # division: the same bits as eager JAX (see the module docstring)
    @functools.partial(jax.jit, compiler_options=NO_ALGSIMP)
    def cases(state, inputs, x, g):
        quants = nnx.merge(graphdef, state)
        out = {"stats": {}}
        for key, (fn, kw) in STATS_CASES.items():
            y, vjp = jax.vjp(lambda v, fn=fn, kw=kw: getattr(JS, fn)(v, **kw), x)
            out["stats"][key] = (y, vjp(g)[0])
        for name, q in quants.items():
            w, gy = inputs[name]

            def f(qq, v, gy=gy):
                qt = qq(v)
                return jnp.sum(qt.value * gy), qt

            (_, qt), (gq, gx) = nnx.value_and_grad(f, argnums=(0, 1), has_aux=True)(q, w)
            out[name] = {"y": qt.value, "dx": gx, "grads": nnx.state(gq), "scale": qt.scale,
                         "zp": qt.zero_point, "bit_width": qt.bit_width}
        return out

    out = cases(state, inputs, *(jnp.asarray(v) for v in r["stats_in"]))
    r["stats"] = jax.tree.map(np.asarray, out.pop("stats"))
    for name, o in out.items():
        grads = {".".join(map(str, p)): np.asarray(v[...])
                 for p, v in nnx.to_flat_state(o.pop("grads")) if "rngs" not in p}
        r["cases"][name].update({k: np.asarray(v) for k, v in o.items()}, grads=grads)
    # the two-phase zero point and scale over their collection and after
    cfg = jax_presets.ShiftedUint8ActPerTensorFloat.let(collect_stats_steps=TWO_PHASE_STEPS)
    q = JaxActQuantizer(cfg)
    r["two_phase_init"] = jax_arrays(q)
    calls = []
    for i in range(TWO_PHASE_CALLS):
        x, gy = _input(50 + i), _input(70 + i)

        def f(qq, v, gy=gy):
            qt = qq(v)
            return jnp.sum(qt.value * gy), qt

        (_, qt), (gq, gx) = nnx.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            q, jnp.asarray(x))
        calls.append({"x": x, "g": gy, "y": np.asarray(qt.value), "dx": np.asarray(gx),
                      "zp": np.asarray(qt.zero_point), "scale": np.asarray(qt.scale),
                      "grads": jax_arrays(gq), "state": jax_arrays(q)})
        if i == TWO_PHASE_STEPS:
            # the handoff call's input again, past the handoff: the port's
            # handoff call gives the learned values the gradient this gives
            # them (JAX's handoff call gives them none; see the test)
            _, (gq, _) = nnx.value_and_grad(f, argnums=(0, 1), has_aux=True)(
                nnx.clone(q), jnp.asarray(x))
            calls[-1]["steady_grads"] = jax_arrays(gq)
    q.eval_mode()
    x = _input(90)
    qt = q(jnp.asarray(x))
    r["two_phase"] = {"calls": calls, "eval": (x, np.asarray(qt.value), np.asarray(qt.zero_point),
                                               np.asarray(qt.scale))}
    # stochastic rounding: the function on given noise, and a quantizer's first draw
    x, noise, gy = _input(100) * 4, np.random.default_rng(101).random(SHAPE, np.float32), \
        _input(102)
    y, vjp = jax.vjp(lambda v, n: jste._stochastic_round(v, n), jnp.asarray(x),
                     jnp.asarray(noise))
    r["stochastic_fn"] = (x, noise, gy, np.asarray(y), np.asarray(vjp(jnp.asarray(gy))[0]))
    cfg = jax_presets.Int8ActPerTensorFloat.let(
        float_to_int="stochastic_round", scaling_impl=JaxScalingImplType.CONST,
        scaling_const=1.5, bit_width=4.0)
    q = JaxActQuantizer(cfg, rngs=nnx.Rngs(stochastic_round=0))
    first_noise = jax.random.uniform(nnx.Rngs(stochastic_round=0).stochastic_round(), SHAPE,
                                     jnp.float32)
    x = _input(103)
    r["stochastic_quant"] = (x, np.asarray(first_noise), np.asarray(q(jnp.asarray(x)).value))
    return r


# -- stats ops ---------------------------------------------------------------------

@pytest.mark.parametrize("key", list(STATS_CASES))
def test_stats_ops_match_jax(jax_ref, key):
    fn, kw = STATS_CASES[key]
    x, g = jax_ref["stats_in"]
    xt = torch.from_numpy(x).requires_grad_()
    y = getattr(S, fn)(xt, **kw)
    y.backward(torch.from_numpy(g))
    want_y, want_dx = jax_ref["stats"][key]
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    np.testing.assert_array_equal(xt.grad.numpy(), want_dx)


def test_stats_fn_resolves_the_new_ops():
    x = torch.from_numpy(_input(5, (2, 50)))
    assert torch.equal(S.stats_fn("min_max")(x), S.abs_min_max(x))
    assert torch.equal(S.stats_fn("min")(x), S.negative_min_or_zero(x))
    assert torch.equal(S.stats_fn("percentile_low", low_percentile_q=1.0)(x),
                       S.negative_percentile_or_zero(x, 1.0))
    assert torch.equal(S.stats_fn("percentile_interval", low_percentile_q=1.0,
                                  high_percentile_q=99.0)(x),
                       S.percentile_interval(x, 1.0, 99.0))
    with pytest.raises(ValueError):
        S.stats_fn("percentile_interval", high_percentile_q=99.0)
    assert (S.negative_min_or_zero(x.abs()) == 0).all()


# -- each option on a quantizer -----------------------------------------------------

def _port_case(name, want):
    side, cfg = _weight_cases(presets, ZeroPointImplType)[name]
    q = ParameterQuantizer(cfg, torch.from_numpy(want["x"])) if side == "weight" \
        else ActQuantizer(cfg)
    return load_jax_state(q, want["state"])


def _sum_tol(terms) -> float:
    return 1e-5 * float(np.sum(np.abs(terms)))


@pytest.mark.parametrize("name", CASES)
def test_quantizer_option_matches_jax(jax_ref, name):
    want = jax_ref["cases"][name]
    q = _port_case(name, want)
    x = torch.from_numpy(want["x"]).requires_grad_()
    qt = q(x)
    (qt.value * torch.from_numpy(want["g"])).sum().backward()
    np.testing.assert_array_equal(qt.value.detach().numpy(), want["y"])
    np.testing.assert_array_equal(np.asarray(qt.scale.detach()).reshape(want["scale"].shape),
                                  want["scale"])
    np.testing.assert_array_equal(np.asarray(torch.as_tensor(qt.zero_point).detach()).reshape(
        want["zp"].shape), want["zp"])
    assert float(torch.as_tensor(qt.bit_width)) == float(want["bit_width"])
    # the input's gradient: straight through where the statistics route none
    # back, a float32 sum at the few elements they do
    gx = x.grad.numpy()
    mass = np.abs(want["g"]).sum()
    assert np.all(np.abs(gx - want["dx"]) <= 1e-5 * mass)
    same = gx == want["dx"]
    assert same.mean() > 0.9, name
    # a parameter that the call does not reach (the two-phase scale's value
    # while it collects) has no gradient in torch and zeros in JAX
    grads = {n: torch.zeros(()) if p.grad is None else p.grad for n, p in q.named_parameters()}
    assert set(grads) == set(want["grads"]), (set(grads), set(want["grads"]))
    for path, exp in want["grads"].items():
        got = np.broadcast_to(grads[path].numpy(), exp.shape)
        assert np.all(np.abs(got - exp) <= _sum_tol(want["g"]) * (1 + np.abs(want["x"]).max())
                      + 1e-12), (name, path, got, exp)
    if name.startswith("learned_bit_width"):
        assert float(qt.bit_width) == 5.0 and torch.is_tensor(qt.bit_width)
        assert float(grads["bit_width_impl.offset"]) != 0.0
    if name.startswith("zp_parameter"):
        assert float(grads["zero_point.value"]) != 0.0


def test_round_to_zero_truncates_the_codes(jax_ref):
    """The option changes what round half to even would give."""
    want = jax_ref["cases"]["round_to_zero"]
    codes = want["y"] / want["scale"]
    rounded = np.round(want["x"] / want["scale"])
    assert (np.abs(codes) <= np.abs(rounded)).all() and (codes != rounded).any()


# -- the two-phase zero point ------------------------------------------------------------

@pytest.fixture(scope="module")
def port_two_phase(jax_ref):
    cfg = presets.ShiftedUint8ActPerTensorFloat.let(collect_stats_steps=TWO_PHASE_STEPS)
    q = load_jax_state(ActQuantizer(cfg), jax_ref["two_phase_init"])
    calls = []
    for want in jax_ref["two_phase"]["calls"]:
        for p in q.parameters():
            p.grad = None
        x = torch.from_numpy(want["x"]).requires_grad_()
        qt = q(x)
        (qt.value * torch.from_numpy(want["g"])).sum().backward()
        calls.append({"y": qt.value.detach().numpy(), "dx": x.grad.numpy(),
                      "zp": float(qt.zero_point), "scale": float(qt.scale),
                      "grads": {n: None if p.grad is None else p.grad.numpy().copy()
                                for n, p in q.named_parameters()},
                      "state": {n: t.detach().numpy().copy() for n, t in q.state_dict().items()}})
    q.eval()
    x, *_ = jax_ref["two_phase"]["eval"]
    with torch.no_grad():
        qt = q(torch.from_numpy(x))
    return {"calls": calls, "eval": (qt.value.numpy(), float(qt.zero_point), float(qt.scale))}


@pytest.mark.parametrize("i", range(TWO_PHASE_CALLS))
def test_two_phase_zero_point_matches_jax(jax_ref, port_two_phase, i):
    """Calls 0-2 collect (the batch's statistics), call 3 hands the buffers
    off to the learned values, call 4 uses them."""
    want, got = jax_ref["two_phase"]["calls"][i], port_two_phase["calls"][i]
    np.testing.assert_array_equal(got["y"], want["y"])
    assert got["zp"] == float(want["zp"]) and got["scale"] == float(want["scale"])
    mass = np.abs(want["g"]).sum()
    assert np.all(np.abs(got["dx"] - want["dx"]) <= 1e-5 * mass)
    for path, exp in want["state"].items():
        v = got["state"][path].reshape(exp.shape)
        if path == "scaling.buffer":
            assert np.all(np.abs(v - exp) <= 2 * np.spacing(np.abs(exp))), path
        else:
            np.testing.assert_array_equal(v, exp, err_msg=path)
    assert int(got["state"]["zero_point.counter"]) == min(i + 1, TWO_PHASE_STEPS + 1)
    # at the handoff JAX writes the buffer into the learned values and reads
    # them back, so its gradient does not reach them; the port, as the
    # reference does, copies the buffer into the parameters and returns
    # them: they take the gradient that JAX's next call would give them
    # (ROADMAP S12)
    grads = want["steady_grads"] if i == TWO_PHASE_STEPS else want["grads"]
    for path, exp in grads.items():
        g = got["grads"][path]
        g = np.zeros_like(exp) if g is None else g.reshape(exp.shape)
        assert np.all(np.abs(g - exp) <= 1e-5 * mass * (1 + np.abs(want["x"]).max())), path
    if i == TWO_PHASE_STEPS:
        assert float(want["grads"]["zero_point.value"]) == 0.0
        assert float(want["steady_grads"]["zero_point.value"]) != 0.0
    if i >= TWO_PHASE_STEPS:
        assert got["grads"]["zero_point.value"] is not None


def test_two_phase_zero_point_eval_matches_jax(jax_ref, port_two_phase):
    _, want_y, want_zp, want_scale = jax_ref["two_phase"]["eval"]
    got_y, got_zp, got_scale = port_two_phase["eval"]
    np.testing.assert_array_equal(got_y, want_y)
    assert got_zp == float(want_zp) and got_scale == float(want_scale)


def test_two_phase_zero_point_is_refused_on_weights():
    with pytest.raises(ValueError):
        ParameterQuantizer(presets.Int8WeightPerTensorFloat.let(
            zero_point_impl=ZeroPointImplType.PARAMETER_FROM_STATS), torch.ones(3, 4))


def test_calibration_mode_advances_the_zero_point():
    cfg = presets.ShiftedUint8ActPerTensorFloat.let(collect_stats_steps=2)
    q = ActQuantizer(cfg)
    q.disable_quant = True
    x = torch.from_numpy(_input(7))
    assert torch.equal(q(x).value, x)
    assert int(q.zero_point.counter) == 1 and int(q.scaling.counter) == 1
    assert float(q.zero_point.buffer) == float(S.negative_percentile_or_zero(
        x.reshape(1, -1), cfg.low_percentile_q))


# -- stochastic rounding ---------------------------------------------------------------

def test_stochastic_round_ste_matches_jax_on_the_same_noise(jax_ref):
    x, noise, gy, want_y, want_dx = jax_ref["stochastic_fn"]
    xt = torch.from_numpy(x).requires_grad_()
    y = stochastic_round_ste(xt, torch.from_numpy(noise))
    y.backward(torch.from_numpy(gy))
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    np.testing.assert_array_equal(xt.grad.numpy(), want_dx)


def test_stochastic_round_quantizer_matches_jax_on_its_noise(jax_ref, monkeypatch):
    """The port's quantizer draws its own noise from a generator it holds;
    given JAX's first draw instead, it quantizes as JAX does."""
    x, noise, want = jax_ref["stochastic_quant"]
    cfg = presets.Int8ActPerTensorFloat.let(
        float_to_int="stochastic_round", scaling_impl=ScalingImplType.CONST,
        scaling_const=1.5, bit_width=4.0)
    q = ActQuantizer(cfg)
    own = q(torch.from_numpy(x)).value
    monkeypatch.setattr(q.float_to_int, "noise", lambda v: torch.from_numpy(noise))
    np.testing.assert_array_equal(q(torch.from_numpy(x)).value.numpy(), want)
    # its own draws: seeded, repeatable, and not round half to even
    q2 = ActQuantizer(cfg)
    assert torch.equal(q2(torch.from_numpy(x)).value, own)
    assert not torch.equal(q2(torch.from_numpy(x)).value, own)


# -- the kernel's rule -----------------------------------------------------------------

@pytest.mark.parametrize("name", CASES + ["stochastic", "round"])
def test_kernel_rule_sends_each_option_where_it_belongs(jax_ref, name):
    """The fake_quant kernel takes round half to even at one scale and
    zero point (a learned or quantized zero point included) and a constant
    bit width; a learned bit width, other roundings and per-channel grids
    take the chain."""
    x = torch.from_numpy(_input(3))
    if name == "stochastic":
        q = ActQuantizer(presets.Int8ActPerTensorFloat.let(float_to_int="stochastic_round"))
    elif name == "round":
        q = ActQuantizer(presets.Int8ActPerTensorFloat)
    else:
        q = _port_case(name, jax_ref["cases"][name])
    qt = q(x)
    takes = kernel_rule(x, qt.scale, qt.zero_point, qt.bit_width, q._float_to_int)
    want = name in ("shifted_weight", "zp_parameter", "zp_parameter_quantized", "round",
                    "int_restrict")
    assert takes == want, name
    if name == "learned_bit_width_weight":
        # only the learned bit width keeps it off the kernel
        assert kernel_rule(x, qt.scale, qt.zero_point, float(qt.bit_width), round_ste)
