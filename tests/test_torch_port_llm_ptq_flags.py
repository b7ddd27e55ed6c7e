"""``examples/llm_ptq.py``'s other flags against the JAX package's:
``--mx`` (groupwise INT weights), ``--rotate``, ``--awq`` and ``--gpfq``.

Every JAX reference is computed once for the module: ``main``'s steps run
eagerly on a tiny float QuantTransformer (gpt, ``main``'s default arch;
dim 32, depth 1, at its initial state: the trained flows are in
``tests/test_torch_port_llm_ptq.py``), once with ``--rotate --awq
--gpfq`` and once with ``--mx --gptq`` (``--weight-group 16``: two groups
in each 32-wide row), recording the state and the codes between the
passes. The port repeats each pass from JAX's state before it, and each
flow from the float state. GPFQ's solve runs under ``jax.jit`` as
``apply_gpfq`` runs it; the groupwise quantizers and the MX layer's
gradient under one ``jit`` each, the groupwise one with XLA's algebraic
simplifier off (ROADMAP S13), which keeps eager JAX's bits.

Tolerances, each with its reason:
- groupwise quantizers (codes and the full-shape scales) and the
  Hadamard matrix: bit for bit. The group maxima are exact, the
  power-of-two scale is 2 to an integer power, the float one a single
  division, and the codes a division and a round;
- the rotated weights within 8 float32 ulps of JAX's, or 2^-20 of the
  weight's largest magnitude where the sum cancels: the products sum
  ``head_dim`` terms in another order (torch's matmul, XLA's dot). The
  rotated model's function: ``tests/test_rotate.py``'s tolerance;
- AWQ: the same alpha in each region, ``s`` within 4 ulps of JAX's and
  the migrated weights within 6: the port forms ``a ** alpha`` in float64
  and rounds once, XLA's float32 pow is not correctly rounded, and the
  activation maxima come through LayerNorm, whose arithmetic differs in
  the last bits (ROADMAP S1), as for SmoothQuant;
- GPFQ on JAX's own (W, X, scale) and from JAX's state: codes equal
  except in at most 1 % of a layer, each by one step (ROADMAP S15: the
  residual's products round in another order, and the recursion carries
  a code that flips at a .5 boundary into the rows after it); JAX's GPFQ
  moves far more codes than that off nearest rounding;
- the flows: the same regions and twin kinds, the codes under the rule
  above, and bits per character within 1e-4 of JAX's (the measured gaps
  are printed; 1e-4 is well below what the quantization moves).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import brevitas_tpu.graph as JG
import brevitas_tpu.nn as jqnn
from brevitas_tpu.examples import llm_ptq as jax_llm_ptq
from brevitas_tpu.examples.lm import _batches as jax_batches
from brevitas_tpu.graph.autograph import extract_act_equalization_regions as jax_regions
from brevitas_tpu.graph.gpfq import _gpfq_solve as jax_gpfq_solve
from brevitas_tpu.graph.gptq import _scale_for_problem as jax_scale_for_problem
from brevitas_tpu.graph.learned_round import freeze_weight_scale as jax_freeze
from brevitas_tpu.quant import presets as jp
from brevitas_tpu.quant.quantizers import ActQuantizer as JaxActQuantizer
from brevitas_tpu.quant.quantizers import ParameterQuantizer as JaxParameterQuantizer
from brevitas_tpu.utils import eval_mode as jax_eval_mode
from brevitas_tpu_torch import graph as PG
from brevitas_tpu_torch import nn as qnn
from brevitas_tpu_torch.examples import llm_ptq
from brevitas_tpu_torch.examples.lm import _CORPUS, _batches
from brevitas_tpu_torch.graph import rotate
from brevitas_tpu_torch.graph.calibrate import _set_disable_quant
from brevitas_tpu_torch.graph.gpfq import _gpfq_solve
from brevitas_tpu_torch.graph.gptq import eligible_for_gptq
from brevitas_tpu_torch.interop import load_jax_state
from brevitas_tpu_torch.models import QuantLlama
from brevitas_tpu_torch.quant import presets
from brevitas_tpu_torch.quant.quantizers import ParameterQuantizer
from test_torch_port_llm_ptq import (
    BPC_TOL,
    FLOW,
    GPTQ_FLIP_SHARE,
    _assert_codes_close,
    _flow_args,
    _jax_model,
    _port_model,
    _ulps,
    jax_state_arrays,
    jax_weight_codes,
    port_weight_codes,
)

torch.set_num_threads(1)

# main's flags on gpt; --mx with --gptq, which leaves MX weights alone
FLAG_FLOWS = {"rotate_awq_gpfq": dict(rotate=True, awq=True, gpfq=True),
              "mx": dict(mx=True, weight_group=16, gptq=True)}
# groupwise quantizer cases: the JAX (in, out) / HWIO weight shapes, two
# groups of 32 in each output channel's reduction
GROUP_WEIGHTS = {"linear": (64, 16), "conv": (2, 2, 16, 8)}
GROUP_PRESETS = ("MXInt8Weight", "MXInt4Weight", "Int8WeightPerGroupFloat",
                 "Int4WeightPerGroupFloat")
ROT_ULPS, ROT_ATOL_SHARE = 8, 2.0 ** -20
# XLA's algebraic simplifier turns a division by a constant into a
# reciprocal multiply under jit (ROADMAP S13): off, the references keep
# eager JAX's bits
NO_ALGSIMP = {"xla_disable_hlo_passes": "algsimp"}
AWQ_S_ULPS, AWQ_W_ULPS = 4, 6


def _np(x):
    return np.asarray(x)


def _to_port_layout(w: np.ndarray) -> np.ndarray:
    """A JAX (in, out) linear weight as (out, in); an HWIO kernel as OIHW."""
    if w.ndim == 2:
        return w.T
    return np.transpose(w, (3, 2, 0, 1))


def _group_weight(kind):
    rng = np.random.default_rng(123456)
    w = rng.standard_normal(GROUP_WEIGHTS[kind]).astype(np.float32)
    # magnitudes that vary along the reduction axis: each group its own scale
    return w * np.linspace(0.05, 2.0, w.shape[-2], dtype=np.float32)[:, None]


def _jax_quantize(model, args):
    """``brevitas_tpu.examples.llm_ptq.main``'s quantizer swap, MX included."""
    from brevitas_tpu.nn.linear import QuantLinear

    if args.mx:
        wq = jp.MXInt8Weight.let(bit_width=float(args.bit_width),
                                 scaling_per_group=args.weight_group)
    else:
        wq = jp.Int8WeightPerChannelFloat.let(bit_width=float(args.bit_width))
    aq = jp.Int8ActPerTensorFloat.let(bit_width=float(args.bit_width),
                                      collect_stats_steps=max(args.calib_batches, 1))
    for _, mod in JG.find_modules(model, QuantLinear):
        mod.weight_quant = JaxParameterQuantizer(wq, mod.weight[...], channel_axis=1)
        mod.input_quant = JaxActQuantizer(aq.let())


def _jax_flag_flow(model, args, calib, test_data, rec):
    """``main``'s passes after the swap, in its order, each recorded, and
    the quantized model's bits per character on ``test_data``."""
    forward = lambda m, b: m(b, causal=True)  # noqa: E731
    if args.rotate:
        pairs, head_dim = JG.transformer_rotation_pairs(model)
        rec["before_rotation"] = jax_state_arrays(model)
        rec["rotations"] = [_np(r) for r in JG.apply_rotation(model, pairs, block_size=head_dim)]
        rec["after_rotation"] = jax_state_arrays(model)
    regions = jax_regions(model, calib[0][:1])
    if args.awq:
        res = JG.apply_awq(model, regions, calib, forward_fn=forward)
        rec["awq"] = {i: (a, _np(s)) for i, (a, s) in res.items()}
        rec["after_awq"] = jax_state_arrays(model)
    else:
        JG.apply_act_equalization(model, regions, calib, alpha=0.5, forward_fn=forward)
    with JG.calibration_mode(model):
        for b in calib:
            forward(model, b)
    rec["before_solve"] = jax_state_arrays(model)
    rec["codes_before_solve"] = jax_weight_codes(model)
    if args.gptq:
        JG.apply_gptq(model, calib, forward_fn=forward)
    if args.gpfq:
        JG.apply_gpfq(model, calib, forward_fn=forward)
    rec["codes"] = jax_weight_codes(model)
    jax_eval_mode(model)
    rec["quant_bpc"] = jax_llm_ptq.bits_per_char(model, *test_data)
    return regions


def _jax_flag_flows():
    """Each flag flow on a new gpt built eagerly as ``main`` builds it (a
    model through ``nnx.jit`` or ``nnx.clone`` would list its layers by
    name, and GPFQ solves them in that order). The float state is the
    initial one: the passes, not the training, are under test here (the
    trained flows are in ``tests/test_torch_port_llm_ptq.py``)."""
    xs, ys, vocab = jax_batches(_CORPUS, FLOW["seq_len"], FLOW["batch"],
                                FLOW["train_steps"] + FLOW["calib_batches"] + 2, 0)
    n = FLOW["train_steps"]
    calib = list(xs[n:n + FLOW["calib_batches"]])
    test_x, test_y = xs[n + FLOW["calib_batches"]:], ys[n + FLOW["calib_batches"]:]
    out = {"vocab": vocab, "calib": [_np(b) for b in calib]}
    for name, flags in FLAG_FLOWS.items():
        m = _jax_model("gpt", vocab)
        out.setdefault("float_state", jax_state_arrays(m))
        args = _flow_args(**flags)
        _jax_quantize(m, args)
        rec = out[name] = {}
        rec["regions"] = _jax_flag_flow(m, args, calib, (test_x, test_y), rec)
        try:
            JG.convert_integer_inference(m)
        except TypeError as e:  # the JAX package's MX twin (ROADMAP S5)
            rec["convert_error"] = str(e)
            continue
        rec["kinds"] = sorted(type(mod).__name__ for _, mod in JG.named_modules(m)
                              if "Inference" in type(mod).__name__)
        rec["served_bpc"] = jax_llm_ptq.bits_per_char(m, test_x, test_y)
    return out


def _gpfq_problem():
    """JAX's own (W, X, scale): a 3-bit per-channel QuantLinear 32 -> 32 on
    128 correlated input rows (the shape of the flows' attention
    projections)."""
    rng = np.random.default_rng(11)
    base = rng.standard_normal((128, 8)).astype(np.float32)
    mix = rng.standard_normal((8, 32)).astype(np.float32)
    x = jnp.asarray(base @ mix + 0.1 * rng.standard_normal((128, 32)).astype(np.float32))
    layer = jqnn.QuantLinear(32, 32, weight_quant=jp.Int8WeightPerChannelFloat.let(bit_width=3),
                             rngs=nnx.Rngs(5))
    jax_freeze(layer)
    scale, nmin, nmax = jax_scale_for_problem(layer, 0, 1)
    W = layer.weight[...]
    Q, sqerr = jax.jit(jax_gpfq_solve)(W, x, scale, nmin, nmax)
    return {"W": _np(W), "X": _np(x), "scale": _np(scale), "nmin": float(nmin),
            "nmax": float(nmax), "Q": _np(Q), "sqerr": float(sqerr)}


def _jax_mx_linear_step():
    """An MX QuantLinear's loss and weight gradient on one batch, eagerly."""
    import optax

    rng = np.random.default_rng(3)
    x = rng.standard_normal((32, 64)).astype(np.float32)
    y = (np.arange(32) % 16).astype(np.int32)
    layer = jqnn.QuantLinear(64, 16, weight_quant=jp.MXInt8Weight, rngs=nnx.Rngs(0))

    def loss_fn(m):
        return optax.softmax_cross_entropy_with_integer_labels(m(jnp.asarray(x)),
                                                               jnp.asarray(y)).mean()

    loss, grads = nnx.jit(nnx.value_and_grad(loss_fn))(layer)
    return {"x": x, "y": y, "weight": _np(layer.weight[...]), "bias": _np(layer.bias[...]),
            "loss": float(loss), "dweight": _np(grads.weight[...]),
            "dbias": _np(grads.bias[...])}


def _jax_awq_weight():
    """The linear weight of ``tests/test_awq.py``'s ``_NormLinear(32, 16,
    nnx.Rngs(0))``, drawn as it draws it (the norm first)."""
    rngs = nnx.Rngs(0)
    nnx.RMSNorm(32, rngs=rngs)
    lin = jqnn.QuantLinear(32, 16, use_bias=False, weight_quant=jp.Int8WeightPerTensorFloat,
                           rngs=rngs)
    return _np(lin.weight[...])


@pytest.fixture(scope="module")
def jax_ref():
    @functools.partial(jax.jit, compiler_options=NO_ALGSIMP)
    def groupwise(ws):
        out = {}
        for kind, w in ws.items():
            for name in GROUP_PRESETS:
                qt = JaxParameterQuantizer(getattr(jp, name), w, channel_axis=w.ndim - 1)(w)
                out[kind, name] = (qt.int(float_datatype=True), qt.scale)
        return out

    ref = {"groups": jax.tree.map(_np, groupwise(
        {kind: jnp.asarray(_group_weight(kind)) for kind in GROUP_WEIGHTS}))}
    ref["hadamard"] = {n: _np(JG.hadamard_matrix(n)) for n in (2, 16)}
    ref["mx_step"] = _jax_mx_linear_step()
    ref["awq_weight"] = _jax_awq_weight()
    ref["flows"] = _jax_flag_flows()
    ref["gpfq"] = _gpfq_problem()  # after the flows: their GPFQ compiled its shape
    return ref


# -- groupwise (MX) weights ------------------------------------------------------


@pytest.mark.parametrize("kind", list(GROUP_WEIGHTS))
@pytest.mark.parametrize("name", GROUP_PRESETS)
def test_groupwise_quantizer_matches_jax(jax_ref, kind, name):
    """Codes and the full-shape scale bit for bit: the port's (out, in) and
    OIHW weights group in the JAX package's element order, (in) and
    (kh, kw, I)."""
    want_codes, want_scale = jax_ref["groups"][kind, name]
    w = torch.from_numpy(_to_port_layout(_group_weight(kind)).copy())
    qt = ParameterQuantizer(getattr(presets, name), w, channel_axis=0)(w)
    assert tuple(qt.scale.shape) == tuple(w.shape)
    np.testing.assert_array_equal(qt.int().numpy(), _to_port_layout(want_codes))
    np.testing.assert_array_equal(qt.scale.numpy(), _to_port_layout(want_scale))
    np.testing.assert_array_equal(qt.value.numpy(), (qt.int().float() * qt.scale).numpy())
    groups = np.unique(qt.scale.numpy().reshape(w.shape[0], -1), axis=1)
    assert groups.shape[1] <= 2  # two groups of 32 in each channel
    if name.startswith("MX"):
        log2s = np.log2(qt.scale.numpy())
        np.testing.assert_array_equal(log2s, np.round(log2s))


@pytest.mark.parametrize("cfg,jcfg,match", [
    (presets.MXInt8Weight.let(scaling_per_group=48), jp.MXInt8Weight.let(scaling_per_group=48),
     "divisible"),
    (presets.MXInt8Weight.let(scaling_per_output_channel=True),
     jp.MXInt8Weight.let(scaling_per_output_channel=True), "per-output-channel"),
], ids=["not_divisible", "per_channel"])
def test_groupwise_validation_matches_jax(cfg, jcfg, match):
    """``tests/test_groupwise.py``'s validation errors, in both packages."""
    with pytest.raises(ValueError, match=match):
        ParameterQuantizer(cfg, torch.ones((8, 64)), channel_axis=0)
    with pytest.raises(ValueError, match=match):
        JaxParameterQuantizer(jcfg, jnp.ones((64, 8)), channel_axis=1)


def test_groupwise_refuses_other_layouts_and_float_elements():
    """The port wants the output channel first; the MX float elements wait
    for the FLOAT quantizer."""
    with pytest.raises(ValueError, match="output channel axis first"):
        ParameterQuantizer(presets.MXInt8Weight, torch.ones((64, 8)), channel_axis=1)
    with pytest.raises(NotImplementedError, match="float"):
        ParameterQuantizer(presets.MXInt8Weight.let(quant_type="float"), torch.ones((8, 64)))


def test_mx_linear_step_matches_jax_and_trains(jax_ref):
    """An MX QuantLinear's loss and gradients equal JAX's (the gradient
    reaches each group's largest weight through its scale), then 30 Adam
    steps lower the loss, as in ``tests/test_groupwise.py``."""
    r = jax_ref["mx_step"]
    layer = qnn.QuantLinear(64, 16, weight_quant=presets.MXInt8Weight)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(r["weight"].T.copy()))
        layer.bias.copy_(torch.from_numpy(r["bias"]))
    x, y = torch.from_numpy(r["x"]), torch.from_numpy(r["y"]).long()
    loss = torch.nn.functional.cross_entropy(layer(x), y)
    loss.backward()
    np.testing.assert_allclose(float(loss), r["loss"], rtol=1e-6)
    np.testing.assert_allclose(layer.weight.grad.numpy(), r["dweight"].T, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(layer.bias.grad.numpy(), r["dbias"], rtol=1e-5, atol=1e-7)
    opt = torch.optim.Adam(layer.parameters(), lr=1e-2)
    losses = []
    for _ in range(30):
        loss = torch.nn.functional.cross_entropy(layer(x), y)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    # groupwise weights give the output no scale
    qlayer = qnn.QuantLinear(64, 16, weight_quant=presets.MXInt4Weight.let(scaling_per_group=16),
                             input_quant=presets.Int8ActPerTensorFloat.let(collect_stats_steps=1),
                             return_quant_tensor=True)
    qlayer(x)
    qlayer.eval()
    assert qlayer(x).scale is None


class _Net(torch.nn.Module):
    def __init__(self, *layers):
        super().__init__()
        self.layers = torch.nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


@pytest.mark.parametrize("solve", ["gptq", "gpfq"])
def test_weight_solvers_skip_groupwise_layers(solve):
    """GPTQ and GPFQ leave an MX layer's weights as they are and solve the
    per-channel layer after it."""
    g = torch.Generator().manual_seed(0)
    mx = qnn.QuantLinear(64, 32, weight_quant=presets.MXInt8Weight, generator=g)
    pc = qnn.QuantLinear(32, 8, weight_quant=presets.Int8WeightPerChannelFloat.let(bit_width=3),
                         generator=g)
    assert not eligible_for_gptq(mx) and eligible_for_gptq(pc)
    net = _Net(mx, pc).eval()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((64, 64)).astype(np.float32))
    w_mx, w_pc = mx.weight.detach().clone(), pc.weight.detach().clone()
    report = getattr(PG, f"apply_{solve}")(net, [x])
    assert list(report) == ["layers.1"]
    assert torch.equal(mx.weight, w_mx) and not torch.equal(pc.weight, w_pc)


@pytest.mark.parametrize("input_quant", ["static", "dynamic", "none"])
def test_convert_leaves_groupwise_linears_on_fake_quant(jax_ref, input_quant):
    """No integer twin takes a groupwise weight: each refuses it and the
    layer keeps its fake-quant forward. (The JAX package's twin fails on
    the scale's shape instead, with an error its conversion does not
    catch: ROADMAP S5.)"""
    iq = {"static": presets.Int8ActPerTensorFloat.let(collect_stats_steps=1),
          "dynamic": presets.Int8DynamicActPerTokenFloat, "none": None}[input_quant]
    layer = qnn.QuantLinear(64, 16, weight_quant=presets.MXInt4Weight, input_quant=iq)
    net = _Net(layer)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((4, 64)).astype(np.float32))
    with torch.no_grad():
        net(x)
        net.eval()
        fake = net(x)
        PG.convert_integer_inference(net)
        assert net.layers[0] is layer
        assert torch.equal(net(x), fake)
    assert "incompatible shapes" in jax_ref["flows"]["mx"]["convert_error"]


# -- rotation -----------------------------------------------------------------------


def test_hadamard_matches_jax_and_random_hadamard_is_orthogonal(jax_ref):
    for n, want in jax_ref["hadamard"].items():
        np.testing.assert_array_equal(PG.hadamard_matrix(n).numpy(), want)
    for n in (4, 32, 128):
        r = PG.random_hadamard(n, torch.Generator().manual_seed(1))
        np.testing.assert_allclose((r @ r.T).numpy(), np.eye(n), atol=1e-5)
        assert set(np.unique(np.abs(r.numpy()) * np.sqrt(n)).round(6)) == {1.0}
    with pytest.raises(ValueError, match="power of two"):
        PG.hadamard_matrix(12)


class _Pair(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.a = qnn.QuantLinear(16, 64, weight_quant=None, generator=g)
        self.b = qnn.QuantLinear(64, 8, weight_quant=None, generator=g)

    def forward(self, x):
        return self.b(self.a(x))


def test_rotation_preserves_a_linear_pair():
    """``tests/test_rotate.py``'s linear pair, with the port's own signs:
    one block and blocks of 16."""
    m = _Pair()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 16)).astype(np.float32))
    with torch.no_grad():
        y0 = m(x)
        for bs in (None, 16):
            PG.apply_rotation(m, [("a", "b")], block_size=bs)
            np.testing.assert_allclose(m(x).numpy(), y0.numpy(), rtol=1e-4, atol=1e-5)


def _jax_rotations(monkeypatch, mats):
    """The port's rotation, given JAX's matrices in pair order."""
    it = iter(mats)
    monkeypatch.setattr(rotate, "random_hadamard",
                        lambda n, generator: torch.from_numpy(next(it).copy()))


def _flow_model(jax_ref, state):
    flows = jax_ref["flows"]
    m = _port_model("gpt", flows["vocab"])
    llm_ptq.quantize(m, _flow_args(**FLAG_FLOWS["rotate_awq_gpfq"]))
    return load_jax_state(m, state).eval()


def test_rotation_matches_jax(jax_ref, monkeypatch):
    """``apply_rotation`` from JAX's state with JAX's matrices: the rotated
    weights and biases within ``ROT_ULPS``, and the float function kept."""
    rec = jax_ref["flows"]["rotate_awq_gpfq"]
    m = _flow_model(jax_ref, rec["before_rotation"])
    ids = torch.tensor(jax_ref["flows"]["calib"][0])
    _set_disable_quant(m, True)
    with torch.no_grad():
        y0 = m(ids)
    _jax_rotations(monkeypatch, rec["rotations"])
    pairs, head_dim = PG.transformer_rotation_pairs(m)
    assert pairs == [("blocks.0.attn.v_proj", "blocks.0.attn.out_proj")] and head_dim == 16
    used = PG.apply_rotation(m, pairs, block_size=head_dim)
    np.testing.assert_array_equal(used[0].numpy(), rec["rotations"][0])
    worst = 0
    for path in ("blocks.0.attn.v_proj.weight", "blocks.0.attn.v_proj.bias",
                 "blocks.0.attn.out_proj.weight"):
        want = rec["after_rotation"][path]
        got = m.get_submodule(path.rpartition(".")[0]).get_parameter(path.rpartition(".")[2])
        got = got.detach().numpy()
        got = got.T if got.ndim == 2 else got
        ulps = _ulps(got, want)
        near = np.abs(got - want) <= ROT_ATOL_SHARE * np.abs(want).max()
        worst = max(worst, int(ulps[~near].max(initial=0)))
    print(f"rotation: weights within {worst} ulps of JAX's (beyond cancellation)")
    assert worst <= ROT_ULPS
    with torch.no_grad():
        np.testing.assert_allclose(m(ids).numpy(), y0.numpy(), rtol=2e-3, atol=2e-4)


# -- AWQ --------------------------------------------------------------------------------


def test_awq_matches_jax_from_its_state(jax_ref):
    rec = jax_ref["flows"]["rotate_awq_gpfq"]
    m = _flow_model(jax_ref, rec["after_rotation"])
    calib = [torch.tensor(b) for b in jax_ref["flows"]["calib"]]
    regions = [(list(s), list(k)) for s, k in rec["regions"]]
    res = PG.apply_awq(m, regions, calib, forward_fn=lambda mm, b: mm(b, causal=True))
    assert sorted(res) == sorted(rec["awq"]) == [0, 1, 2]
    for i, (alpha, s) in res.items():
        assert alpha == rec["awq"][i][0], (i, alpha, rec["awq"][i][0])
    worst_s = max(int(_ulps(res[i][1].numpy(), rec["awq"][i][1]).max()) for i in res)
    worst_w = 0
    for path, want in rec["after_awq"].items():
        if path.endswith(("ln1.scale", "ln2.scale", "ln_f.scale", ".weight")) and \
                "quant" not in path and not path.startswith("embed"):
            owner, _, name = path.rpartition(".")
            mod = m.get_submodule(owner)
            t = getattr(mod, name).detach()
            t = t.t() if isinstance(mod, qnn.QuantLinear) else t
            worst_w = max(worst_w, int(_ulps(t.numpy(), want).max()))
    print(f"AWQ: alphas {[a for a, _ in res.values()]}, s within {worst_s} ulps of JAX's, "
          f"weights within {worst_w}")
    assert worst_s <= AWQ_S_ULPS and worst_w <= AWQ_W_ULPS
    # each sink's weight quantizer is rebuilt on the migrated weights
    for mod in m.modules():
        if isinstance(mod, qnn.QuantLinear):
            assert mod.weight_quant.channel_axis == 0 and not mod.weight_quant.training


def test_awq_preserves_function_and_helps_weight_only_quant(jax_ref):
    """``tests/test_awq.py`` on its own weights and data: the float function
    kept; on salient input channels AWQ picks alpha > 0 and cuts a 4-bit
    weight-only error."""
    from brevitas_tpu_torch.models.common import RMSNorm

    rng = np.random.default_rng(123456)
    x = rng.standard_normal((256, 32)).astype(np.float32)
    x[:, :4] *= 20.0
    x = torch.from_numpy(x)

    class NormLinear(torch.nn.Module):
        def __init__(self, act_quant):
            super().__init__()
            self.norm = RMSNorm(32)
            self.lin = qnn.QuantLinear(
                32, 16, use_bias=False,
                weight_quant=presets.Int8WeightPerTensorFloat.let(bit_width=4.0),
                input_quant=presets.Int8ActPerTensorFloat.let(collect_stats_steps=2)
                if act_quant else None)
            with torch.no_grad():
                self.lin.weight.copy_(torch.from_numpy(jax_ref["awq_weight"].T.copy()))

        def forward(self, v):
            return self.lin(self.norm(v))

    def run(m, awq):
        with torch.no_grad():
            m(x)
            m.eval()
            _set_disable_quant(m, True)
            y_float = m(x)
            alpha = PG.apply_awq(m, [(["norm"], ["lin"])], [x])[0][0] if awq else None
            _set_disable_quant(m, True)
            y_kept = m(x)
            _set_disable_quant(m, False)
            return y_float, y_kept, m(x), alpha

    y0, y1, _, _ = run(NormLinear(True), True)
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=1e-3, atol=1e-4)
    yf, _, yq, _ = run(NormLinear(False), False)
    _, _, yq_awq, alpha = run(NormLinear(False), True)
    err_plain = float(torch.mean((yq - yf) ** 2))
    err_awq = float(torch.mean((yq_awq - yf) ** 2))
    assert alpha is not None and alpha > 0.0
    assert err_awq < err_plain * 0.99, (err_awq, err_plain)


# -- GPFQ -------------------------------------------------------------------------------


def test_gpfq_solve_matches_jax(jax_ref):
    r = jax_ref["gpfq"]
    got, sqerr = _gpfq_solve(torch.from_numpy(r["W"].copy()), torch.from_numpy(r["X"].copy()),
                             torch.from_numpy(r["scale"].copy()), r["nmin"], r["nmax"])
    codes, want = np.round(got.numpy() / r["scale"]), np.round(r["Q"] / r["scale"])
    share = float(np.mean(codes != want))
    print(f"GPFQ codes that differ from JAX's: {share:.4%} of {codes.size}")
    assert share <= GPTQ_FLIP_SHARE and np.abs(codes - want).max() <= 1
    assert codes.min() >= r["nmin"] and codes.max() <= r["nmax"]
    # the recursion's residual is X (W - Q)
    E = torch.from_numpy(r["X"]) @ (torch.from_numpy(r["W"]) - got)
    np.testing.assert_allclose(float(torch.sum(E * E)), float(sqerr), rtol=1e-4)
    np.testing.assert_allclose(float(sqerr), r["sqerr"], rtol=1e-4)
    nearest = np.clip(np.round(r["W"] / r["scale"]), r["nmin"], r["nmax"])
    assert np.mean(want != nearest) > 10 * GPTQ_FLIP_SHARE  # JAX's GPFQ moves codes


def test_apply_gpfq_matches_jax_from_its_state(jax_ref):
    """From JAX's state just before GPFQ (rotation, AWQ, calibration done):
    the captures with the earlier layers already solved, the frozen scale,
    the layer order and the write-back."""
    rec = jax_ref["flows"]["rotate_awq_gpfq"]
    m = _flow_model(jax_ref, rec["before_solve"])
    _assert_codes_close(port_weight_codes(m), rec["codes_before_solve"], "before GPFQ")
    calib = [torch.tensor(b) for b in jax_ref["flows"]["calib"]]
    report = PG.apply_gpfq(m, calib, forward_fn=lambda mm, b: mm(b, causal=True))
    assert list(report) == list(rec["codes"])
    assert all(gpfq <= near for near, gpfq in report.values())
    _assert_codes_close(port_weight_codes(m), rec["codes"], "apply_gpfq")
    moved = {p: float(np.mean(rec["codes"][p] != rec["codes_before_solve"][p]))
             for p in rec["codes"]}
    print(f"JAX's GPFQ moves {min(moved.values()):.4%} to {max(moved.values()):.4%} "
          "of a layer's codes off nearest rounding")
    assert min(moved.values()) > 5 * GPTQ_FLIP_SHARE, moved


def test_gpfq_end_to_end_pipeline():
    """``tests/test_gpfq.py``'s pipeline: 3-bit per-channel weights and
    calibrated inputs on a two-layer ReLU net; GPFQ beats nearest."""
    rng = np.random.default_rng(123456)
    base = rng.standard_normal((256, 6)).astype(np.float32)
    mix = rng.standard_normal((6, 24)).astype(np.float32)
    data = torch.from_numpy(base @ mix + 0.1 * rng.standard_normal((256, 24)).astype(np.float32))
    batches = [data[:128], data[128:]]

    def ptq(gpfq):
        g = torch.Generator().manual_seed(7)
        kw = dict(weight_quant=presets.Int8WeightPerChannelFloat.let(bit_width=3),
                  input_quant=presets.Int8ActPerTensorFloat.let(collect_stats_steps=2),
                  generator=g)
        l1, l2 = qnn.QuantLinear(24, 48, **kw), qnn.QuantLinear(48, 10, **kw)
        m = _Net(l1, torch.nn.ReLU(), l2)
        with torch.no_grad():
            _set_disable_quant(m, True)
            y_float = m(batches[0])
            _set_disable_quant(m, False)
            with PG.calibration_mode(m):
                for b in batches:
                    m(b)
            if gpfq:
                PG.apply_gpfq(m, batches)
            m.eval()
            return float(torch.mean((m(batches[0]) - y_float) ** 2))

    assert ptq(True) < ptq(False)


# -- the flows ---------------------------------------------------------------------------


@pytest.mark.parametrize("flow", list(FLAG_FLOWS))
def test_flag_flow_matches_jax(jax_ref, flow, monkeypatch):
    """``main``'s steps with the flow's flags from JAX's float state, held
    as ``test_flow_matches_jax`` holds the default flows; the rotation
    takes JAX's matrices (ROADMAP S17)."""
    ref = jax_ref["flows"]
    want = ref[flow]
    xs, ys, vocab = _batches(_CORPUS, FLOW["seq_len"], FLOW["batch"],
                             FLOW["train_steps"] + FLOW["calib_batches"] + 2, 0)
    n = FLOW["train_steps"]
    calib = list(xs[n:n + FLOW["calib_batches"]])
    test_x, test_y = xs[n + FLOW["calib_batches"]:], ys[n + FLOW["calib_batches"]:]
    m = _port_model("gpt", vocab)
    load_jax_state(m, ref["float_state"]).eval()
    if "rotations" in want:
        _jax_rotations(monkeypatch, want["rotations"])
    args = _flow_args(**FLAG_FLOWS[flow])
    llm_ptq.quantize(m, args)
    regions, steps = llm_ptq.post_training(m, args, calib)
    m.eval()
    codes = port_weight_codes(m)
    quant_bpc = llm_ptq.bits_per_char(m, test_x, test_y)
    PG.convert_integer_inference(m)
    served_bpc = llm_ptq.bits_per_char(m, test_x, test_y)
    kinds = sorted(type(mod).__name__ for mod in m.modules() if "Inference" in type(mod).__name__)
    print(f"{flow}: quant {quant_bpc} / {want['quant_bpc']}, served {served_bpc} / "
          f"{want.get('served_bpc')} (port / JAX)")
    assert regions == [(list(s), list(k)) for s, k in want["regions"]]
    _assert_codes_close(codes, want["codes"], flow)
    assert abs(quant_bpc - want["quant_bpc"]) < BPC_TOL
    if flow == "mx":
        # GPTQ skips MX layers in both packages, and no twin takes them
        assert steps == {"gptq": 0, "gpfq": 0}
        assert all(np.array_equal(want["codes"][p], want["codes_before_solve"][p])
                   for p in want["codes"])
        assert kinds == [] and served_bpc == quant_bpc
        assert "incompatible shapes" in want["convert_error"]  # JAX's twin (S5)
    else:
        assert steps == {"gptq": 0, "gpfq": 5 * 32 + 128 + 32}
        assert kinds == want["kinds"] == ["Int8InferenceLinear"] * 7
        assert abs(served_bpc - want["served_bpc"]) < BPC_TOL


def test_mx_quant_bpc_ignores_the_weight_solver():
    """``--mx`` with ``--gptq``, ``--gpfq`` or neither: the same quant bpc,
    bit for bit (GPTQ and GPFQ skip groupwise weights, as in JAX)."""
    argv = ["--train-steps", "4", "--batch", "4", "--seq-len", "16", "--dim", "32", "--depth",
            "1", "--heads", "2", "--calib-batches", "1", "--mx", "--weight-group", "16",
            "--device", "cpu"]
    bpcs = {extra: llm_ptq.main(argv + ([extra] if extra else []))["quant_bpc"]
            for extra in ("", "--gptq", "--gpfq")}
    assert len(set(bpcs.values())) == 1, bpcs


# -- the entry point ---------------------------------------------------------------------

# tests/test_awq.py's argv (test_llm_ptq_cli_awq_smoke), each flag on it
CLI_ARGV = ["--arch", "llama", "--train-steps", "8", "--batch", "8", "--seq-len", "24",
            "--dim", "32", "--depth", "1", "--heads", "2", "--calib-batches", "2",
            "--device", "cpu"]


@pytest.mark.parametrize("flags", [("--awq", "--bit-width", "4"), ("--gpfq", "--convert-int"),
                                   ("--rotate", "--convert-int"), ("--mx", "--convert-int")],
                         ids=["awq", "gpfq", "rotate", "mx"])
def test_llm_ptq_cli_flag(flags):
    """Each flag through ``main`` on the CPU: ``--awq`` with
    ``tests/test_awq.py``'s argv and bounds, the others on the same argv
    with integer serving."""
    res = llm_ptq.main(CLI_ARGV + list(flags))
    assert np.isfinite(res["float_bpc"]) and np.isfinite(res["quant_bpc"])
    assert res["quant_bpc"] < res["float_bpc"] + 1.5
    flag = flags[0][2:]
    assert res[flag] and res["smoothquant"] == (flag != "awq")
    assert (flag in res["stage_ms"]) == (flag != "mx")
    if flag == "gpfq":
        steps = sum(mod.in_features for mod in QuantLlama(device="cpu", vocab_size=res["vocab"],
                                                          dim=32, depth=1, num_heads=2).modules()
                    if isinstance(mod, qnn.QuantLinear))
        assert res["gpfq_steps"] == steps and res["gptq_steps"] == 0
    if "--convert-int" in flags:
        assert np.isfinite(res["served_bpc"])
        assert abs(res["served_bpc"] - res["quant_bpc"]) < 1e-3
        if flag == "mx":
            assert res["served_bpc"] == res["quant_bpc"]
