"""The port's LLM post-training quantization slice against the JAX package's.

``examples/llm_ptq.py`` and what it reaches: dynamic per-tensor and
per-token int8 activation quantizers, ``DynamicInt8InferenceLinear``, the
traced graph and the SmoothQuant regions it gives, ``apply_act_equalization``,
GPTQ (``_gptq_solve`` and ``apply_gptq``), and the flow as a whole on a
tiny QuantLlama and a tiny QuantTransformer (gpt, ``main``'s default
arch), each trained by JAX and carried across with ``load_jax_state``.
``main``'s other flags are held to JAX in
``tests/test_torch_port_llm_ptq_flags.py``.
Every JAX reference is computed once for the module, eagerly (the quantizer
and twin references: under ``jit`` XLA turns a scale's division by a
constant into a reciprocal multiply, ROADMAP S13); GPTQ's solve runs under
``jax.jit`` as ``apply_gptq`` runs it. Models are depth 1 and 32 wide.

Tolerances, each with its reason:
- dynamic quantizers (values and scales) and the dynamic serving twin:
  bit for bit. The per-token maximum, the division by the integer
  threshold and the int32 accumulator are exact, and the epilogue's two
  products and the bias add are single roundings in the same order;
- traced regions and hand lists: equal as path lists;
- SmoothQuant's factors within 4 float32 ulps of JAX's and the smoothed
  weights within 6: the port forms ``a ** alpha`` in float64 and rounds
  once, XLA's float32 pow is not correctly rounded, and the activation
  maxima come through RMSNorm, whose rsqrt XLA does not round correctly
  (S1). The smoothed model's function: rtol 1e-3, atol 1e-4, the JAX
  package's own check (``tests/test_llama.py``);
- ``_gptq_solve`` on JAX's own (W, H, scale): codes equal except in at most
  1 % of them, the share printed. Cholesky and the solve come from LAPACK
  here and from XLA there, and the recursion carries each row's rounding
  error into every later row, so a code that flips at a .5 boundary moves
  the rows after it;
- ``apply_gptq`` from JAX's own state, and the flow as a whole: each
  QuantLinear's weight codes equal JAX's except in at most 1 % of a
  layer, each by one step (two in gpt's dynamic flow, whose SmoothQuant
  factors come out 1-3 ulps from JAX's: GPTQ carries one fc2 flip into
  the rows after it), for the reason above: a layer whose input came
  through the attention or the MLP's SiLU (float32 exp and softmax, other
  last bits in XLA and torch) gets a Hessian with other last bits. None
  differs here (the share is printed). JAX's GPTQ moves over 20 % of
  every layer's codes off nearest rounding, so a GPTQ that did nothing
  fails, and so did one that took the layers in another order (the order
  of an ``nnx.clone``, by name: 2.8 % of ``down_proj``'s codes differed);
- the flow's bits per character, fake-quant and served, within 1e-4 of
  JAX's: the gaps measured are at most 1.1e-6 on llama and 4.3e-5 on gpt
  (its dynamic flow's codes above; the float model's 1.0e-6,
  from the two packages' float32 sums), and 1e-4 is far below what the
  quantization itself moves (5e-4 to 8e-4 here).
"""

import argparse

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
from brevitas_tpu.graph.autograph import _classify_prim as jax_classify
from brevitas_tpu.graph.autograph import extract_act_equalization_regions as jax_regions
from brevitas_tpu.graph.autograph import trace_module_graph as jax_trace
from brevitas_tpu.graph.gptq import _gptq_solve as jax_gptq_solve
from brevitas_tpu.graph.gptq import _scale_for_problem as jax_scale_for_problem
from brevitas_tpu.graph.learned_round import freeze_weight_scale as jax_freeze
from brevitas_tpu.models.llama import QuantLlama as JaxLlama
from brevitas_tpu.models.llama import llama_smoothquant_regions as jax_llama_regions
from brevitas_tpu.models.transformer import QuantTransformer as JaxTransformer
from brevitas_tpu.models.transformer import transformer_smoothquant_regions as jax_tf_regions
from brevitas_tpu.quant import presets as jp
from brevitas_tpu.quant.quantizers import ActQuantizer as JaxActQuantizer
from brevitas_tpu.quant.quantizers import ParameterQuantizer as JaxParameterQuantizer
from brevitas_tpu.utils import eval_mode as jax_eval_mode
from brevitas_tpu_torch import graph as PG
from brevitas_tpu_torch import nn as qnn
from brevitas_tpu_torch.examples import llm_ptq
from brevitas_tpu_torch.examples.lm import _CORPUS, _batches
from brevitas_tpu_torch.graph.autograph import _classify_prim, trace_module_graph
from brevitas_tpu_torch.graph.calibrate import _set_disable_quant
from brevitas_tpu_torch.graph.convert_int import DynamicInt8InferenceLinear
from brevitas_tpu_torch.graph.gptq import _gptq_solve
from brevitas_tpu_torch.interop import load_jax_state
from brevitas_tpu_torch.models import QuantLlama, QuantTransformer
from brevitas_tpu_torch.models.llama import llama_smoothquant_regions
from brevitas_tpu_torch.models.transformer import transformer_smoothquant_regions
from brevitas_tpu_torch.quant import presets
from brevitas_tpu_torch.quant.quantizers import ActQuantizer

torch.set_num_threads(1)

TOKENS = (4, 6, 16)
QUANTIZER_CASES = {"per_tensor_8": ("Int8DynamicActPerTensorFloat", 8.0),
                   "per_token_8": ("Int8DynamicActPerTokenFloat", 8.0),
                   "per_tensor_4": ("Int8DynamicActPerTensorFloat", 4.0),
                   "per_token_4": ("Int8DynamicActPerTokenFloat", 4.0)}
# (input preset, bias, dynamic output quantizer, the second request's factor)
TWIN_CASES = {"per_token_bias_output_quant": ("Int8DynamicActPerTokenFloat", True, True, 10.0),
              "per_tensor": ("Int8DynamicActPerTensorFloat", False, False, 100.0)}
# hidden 32: every block linear 32 x 32, so GPTQ's jitted solve compiles
# for two shapes (and the head's), not four
TINY = dict(dim=32, depth=1, num_heads=2, hidden=32)
TINY_GPT = dict(dim=32, depth=1, num_heads=2)
FLOW = dict(train_steps=12, batch=8, seq_len=16, calib_batches=1)
# main's two PTQ branches: dynamic per-token inputs with GPTQ, and static
# calibration (the attention core's quantizers and int8 serving are held to
# JAX's in tests/test_torch_port_llama.py)
FLOWS = {"dynamic_gptq": dict(dynamic_act=True, gptq=True, kv_bits=0),
         "static": dict(dynamic_act=False, gptq=False, kv_bits=0)}
# each flow on each architecture: QuantLlama, and QuantTransformer (gpt,
# main's default)
FLOW_CASES = {"dynamic_gptq": ("llama", "dynamic_gptq"), "static": ("llama", "static"),
              "gpt_dynamic_gptq": ("gpt", "dynamic_gptq"), "gpt_static": ("gpt", "static")}
GPTQ_FLIP_SHARE = 0.01
# gpt's dynamic flow: SmoothQuant's factors come out 1-3 ulps from JAX's
# (S1), the weights after it up to 4; from JAX's own state GPTQ gives JAX's
# codes, but in the flow one fc2 code flips at a .5 boundary and GPTQ
# carries it into the rows after it, one of them by two steps
GPT_FLOW_MAX_STEP = 2
BPC_TOL = 1e-4
SQ_S_ULPS, SQ_W_ULPS = 4, 6


def _np(x):
    return np.asarray(x)


def jax_state_arrays(model) -> dict:
    return {".".join(map(str, path)): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model)) if path[0] != "rngs"}


def _flow_args(**kw) -> argparse.Namespace:
    base = dict(bit_width=8, calib_batches=FLOW["calib_batches"], no_smoothquant=False,
                smoothquant_alpha=0.5, dynamic_act=False, gptq=False, kv_bits=0, mx=False,
                rotate=False, awq=False, gpfq=False)
    base.update(kw)
    return argparse.Namespace(**base)


class JaxNet(nnx.Module):
    def __init__(self, layer):
        self.l1 = layer

    def __call__(self, x):
        return self.l1(x)


class PortNet(torch.nn.Module):
    def __init__(self, layer):
        super().__init__()
        self.l1 = layer

    def forward(self, x):
        return self.l1(x)


def _twin_inputs(case):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(TOKENS).astype(np.float32)
    x[1, 3] *= 50.0  # an outlier token
    return x, x * TWIN_CASES[case][3]


def _jax_twin(case):
    preset, bias, out_q, _ = TWIN_CASES[case]
    layer = jqnn.QuantLinear(16, 32, use_bias=bias, weight_quant=jp.Int8WeightPerChannelFloat,
                             input_quant=getattr(jp, preset),
                             output_quant=jp.Int8DynamicActPerTensorFloat if out_q else None,
                             rngs=nnx.Rngs(3))
    if bias:
        layer.bias[...] = jnp.asarray(
            np.random.default_rng(8).standard_normal(32).astype(np.float32))
    net = JaxNet(layer)
    jax_eval_mode(net)
    state = jax_state_arrays(net)
    x, x2 = _twin_inputs(case)
    fake = _np(net(jnp.asarray(x)))
    JG.convert_integer_inference(net)
    assert type(net.l1).__name__ == "DynamicInt8InferenceLinear"
    return {"state": state, "fake": fake, "served": _np(net(jnp.asarray(x))),
            "second": _np(net(jnp.asarray(x2)))}


def jax_quantize(model, args):
    """``brevitas_tpu.examples.llm_ptq.main``'s quantizer swap."""
    from brevitas_tpu.nn.attention import QuantMultiheadAttention
    from brevitas_tpu.nn.linear import QuantLinear

    wq = jp.Int8WeightPerChannelFloat.let(bit_width=float(args.bit_width))
    aq = jp.Int8ActPerTensorFloat.let(bit_width=float(args.bit_width),
                                      collect_stats_steps=max(args.calib_batches, 1))
    for _, mod in JG.find_modules(model, QuantLinear):
        mod.weight_quant = JaxParameterQuantizer(wq, mod.weight[...], channel_axis=1)
        mod.input_quant = JaxActQuantizer(aq.let())
    if args.kv_bits:
        kvq = aq.let(bit_width=float(args.kv_bits))
        uq = jp.Uint8ActPerTensorFloat.let(collect_stats_steps=max(args.calib_batches, 1))
        for _, mha in JG.find_modules(model, QuantMultiheadAttention):
            mha.q_quant = JaxActQuantizer(aq.let())
            mha.k_quant = JaxActQuantizer(kvq.let())
            mha.v_quant = JaxActQuantizer(kvq.let())
            mha.probs_quant = JaxActQuantizer(uq.let())


def jax_post_training(model, args, calib, record):
    """``main``'s steps after the swap: regions, SmoothQuant, calibration or
    dynamic act quant, GPTQ. ``record`` receives the traced graph, the state
    before SmoothQuant, its factors and the state after."""
    forward = lambda m, b: m(b, causal=True)  # noqa: E731
    graph = jax_trace(model, calib[0][:1])
    record["reach"] = _reach(graph.nodes, lambda n: n.kind == "module", lambda n: n.succs,
                             lambda n: n.path, jax_classify)
    # main's smoothquant_regions(model, sample_tokens), its graph kept
    regions = jax_regions(model, calib[0][:1], graph=graph)
    record["hand"] = (jax_llama_regions(model) if isinstance(model, JaxLlama)
                      else jax_tf_regions(model))
    record["before_sq"] = jax_state_arrays(model)
    s = JG.apply_act_equalization(model, regions, calib, alpha=args.smoothquant_alpha,
                                  forward_fn=forward)
    record["sq_s"] = {i: _np(v) for i, v in s.items()}
    record["after_sq"] = jax_state_arrays(model)
    if args.dynamic_act:
        jax_llm_ptq.use_dynamic_act_quant(model, args.bit_width)
    else:
        with JG.calibration_mode(model):
            for b in calib:
                forward(model, b)
    record["codes_before_gptq"] = jax_weight_codes(model)
    record["before_gptq"] = jax_state_arrays(model)
    if args.gptq:
        JG.apply_gptq(model, calib, forward_fn=forward)
    record["codes"] = jax_weight_codes(model)
    return regions


def jax_weight_codes(model) -> dict:
    """Each QuantLinear's integer weight codes, (out, in) as the port's."""
    from brevitas_tpu.nn.linear import QuantLinear

    return {path: _np(mod.quant_weight().int()).T for path, mod in
            JG.find_modules(model, QuantLinear)}


def port_weight_codes(model) -> dict:
    with torch.no_grad():
        return {path: mod.quant_weight().int().numpy() for path, mod in
                PG.find_modules(model, qnn.QuantLinear)}


def _reach(nodes, is_module, succs, path_of, classify):
    """Module path -> the module paths its output reaches through
    reshaping-only calls: the traced graph's structure between modules."""
    out = {}
    for node in nodes:
        if not is_module(node):
            continue
        found, seen, stack = set(), set(), list(succs(node))
        while stack:
            n = stack.pop()
            if id(n) in seen:
                continue
            seen.add(id(n))
            if is_module(n):
                found.add(path_of(n))
            elif classify(n) == "reshaping":
                stack.extend(succs(n))
        out[path_of(node)] = found
    return out


def _gptq_problem():
    """JAX's own (W, H, scale): a 3-bit per-channel QuantLinear 32 -> 32 on
    correlated inputs (GPTQ's Hessian weighting matters there)."""
    rng = np.random.default_rng(11)
    base = rng.standard_normal((128, 8)).astype(np.float32)
    mix = rng.standard_normal((8, 32)).astype(np.float32)
    x = jnp.asarray(base @ mix + 0.1 * rng.standard_normal((128, 32)).astype(np.float32))
    layer = jqnn.QuantLinear(32, 32, weight_quant=jp.Int8WeightPerChannelFloat.let(bit_width=3),
                             rngs=nnx.Rngs(5))
    jax_freeze(layer)
    scale, nmin, nmax = jax_scale_for_problem(layer, 0, 1)
    W = layer.weight[...]
    H = x.T @ x
    solve = jax.jit(jax_gptq_solve, static_argnames=("damp",))
    Wn = solve(W, H, scale, nmin, nmax, damp=0.01)
    return {"W": _np(W), "H": _np(H), "scale": _np(scale), "nmin": float(nmin),
            "nmax": float(nmax), "Wn": _np(Wn)}


def _jax_model(arch, vocab, seed=0):
    kw = dict(vocab_size=vocab, weight_quant=jp.NoneWeightQuant, act_quant=jp.NoneActQuant,
              uact_quant=jp.NoneActQuant, rngs=nnx.Rngs(seed))
    if arch == "llama":
        return JaxLlama(**kw, **TINY)
    return JaxTransformer(max_len=FLOW["seq_len"], **kw, **TINY_GPT)


def _jax_flows(arch="llama"):
    """JAX trains a tiny float model of ``arch``, then runs each flow of
    ``main`` on a copy of it."""
    xs, ys, vocab = jax_batches(_CORPUS, FLOW["seq_len"], FLOW["batch"],
                                FLOW["train_steps"] + FLOW["calib_batches"] + 2, 0)
    model = _jax_model(arch, vocab)
    n = FLOW["train_steps"]
    jax_llm_ptq._train_float(model, xs[:n], ys[:n], 1e-3)
    jax_eval_mode(model)
    calib = list(xs[n:n + FLOW["calib_batches"]])
    test_x, test_y = xs[n + FLOW["calib_batches"]:], ys[n + FLOW["calib_batches"]:]
    out = {"float_state": jax_state_arrays(model), "vocab": vocab,
           "calib": [_np(b) for b in calib],
           "float_bpc": jax_llm_ptq.bits_per_char(model, test_x, test_y)}
    for name, flow in FLOWS.items():
        # a new model with the trained state, not nnx.clone: a clone lists
        # its submodules by name, and GPTQ solves the layers in that order
        m = _jax_model(arch, vocab)
        nnx.update(m, nnx.state(model))
        args = _flow_args(**flow)
        jax_quantize(m, args)
        rec = out[name] = {}
        rec["regions"] = jax_post_training(m, args, calib, rec)
        jax_eval_mode(m)
        rec["quant_bpc"] = jax_llm_ptq.bits_per_char(m, test_x, test_y)
        JG.convert_integer_inference(m)
        rec["kinds"] = sorted(type(mod).__name__ for _, mod in JG.named_modules(m)
                              if "Inference" in type(mod).__name__)
        rec["served_bpc"] = jax_llm_ptq.bits_per_char(m, test_x, test_y)
    return out


@pytest.fixture(scope="module")
def jax_ref():
    ref = {"quantizers": {}, "twins": {}}
    x = np.random.default_rng(5).standard_normal(TOKENS).astype(np.float32)
    x[1, 3] *= 50.0
    ref["x"] = x
    for case, (preset, bits) in QUANTIZER_CASES.items():
        qt = JaxActQuantizer(getattr(jp, preset).let(bit_width=bits))(jnp.asarray(x))
        ref["quantizers"][case] = (_np(qt.value), _np(qt.scale))
    for case in TWIN_CASES:
        ref["twins"][case] = _jax_twin(case)
    ref["gptq"] = _gptq_problem()
    ref["flows"] = flows = _jax_flows()
    ref["gpt_flows"] = _jax_flows("gpt")
    ref["ids"] = flows["calib"][0][:1]
    # the traced graph, its regions and the hand lists, as each arch's
    # dynamic flow recorded them (the graph does not depend on the weights)
    ref["graphs"] = {"llama": flows["dynamic_gptq"], "gpt": ref["gpt_flows"]["dynamic_gptq"]}
    return ref


# -- dynamic quantizers -------------------------------------------------------


@pytest.mark.parametrize("case", list(QUANTIZER_CASES))
def test_dynamic_quantizer_matches_jax(jax_ref, case):
    preset, bits = QUANTIZER_CASES[case]
    q = ActQuantizer(getattr(presets, preset).let(bit_width=bits))
    want_v, want_s = jax_ref["quantizers"][case]
    for training in (True, False):
        q.train(training)
        qt = q(torch.from_numpy(jax_ref["x"]))
        np.testing.assert_array_equal(qt.value.numpy(), want_v)
        np.testing.assert_array_equal(qt.scale.numpy(), want_s)
    assert tuple(qt.scale.shape) == ((4, 6, 1) if "token" in case else ())
    assert q.static_int_params() is None  # per-call state: the caller must call it
    assert not list(q.buffers()) and not list(q.parameters())  # stateless


def test_dynamic_calibration_is_noop():
    """calibration_mode passes the float value and leaves nothing behind
    (``tests/test_dynamic_quant.py``)."""
    layer = qnn.QuantLinear(8, 4, input_quant=presets.Int8DynamicActPerTensorFloat,
                            generator=torch.Generator().manual_seed(0))
    net = PortNet(layer).eval()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 8)).astype(np.float32))
    with torch.no_grad():
        y0 = net(x)
        with PG.calibration_mode(net):
            y_cal = net(x)
            float_y = x @ layer.quant_weight().value.t() + layer.bias
        y1 = net(x)
    np.testing.assert_array_equal(y_cal.numpy(), float_y.numpy())
    np.testing.assert_array_equal(y1.numpy(), y0.numpy())
    assert not net.training


@pytest.mark.parametrize("cfg,match", [
    (presets.Int8ActPerTensorFloat.let(scaling_per_token=True), "DYNAMIC"),
    (presets.Int8DynamicActPerTokenFloat.let(scaling_per_output_channel=True), "exclusive"),
    (presets.Int8DynamicActPerTokenFloat.let(zero_point_impl="parameter"), "symmetric"),
], ids=["not_dynamic", "per_channel", "zero_point"])
def test_per_token_errors_match_jax(cfg, match):
    jcfg = jp.Int8DynamicActPerTokenFloat.let(**{
        "DYNAMIC": dict(scaling_impl="parameter_from_stats"),
        "exclusive": dict(scaling_per_output_channel=True),
        "symmetric": dict(zero_point_impl="parameter")}[match])
    with pytest.raises(ValueError, match=match):
        ActQuantizer(cfg, num_channels=16)
    with pytest.raises(ValueError, match=match):
        JaxActQuantizer(jcfg, num_channels=16)


# -- DynamicInt8InferenceLinear -------------------------------------------------


@pytest.mark.parametrize("case", list(TWIN_CASES))
def test_dynamic_twin_matches_jax(jax_ref, case):
    preset, bias, out_q, _ = TWIN_CASES[case]
    want = jax_ref["twins"][case]
    layer = qnn.QuantLinear(16, 32, use_bias=bias, weight_quant=presets.Int8WeightPerChannelFloat,
                            input_quant=getattr(presets, preset),
                            output_quant=presets.Int8DynamicActPerTensorFloat if out_q else None)
    net = load_jax_state(PortNet(layer), want["state"]).eval()
    x, x2 = (torch.from_numpy(v) for v in _twin_inputs(case))
    with torch.no_grad():
        fake = net(x)
        PG.convert_integer_inference(net)
        assert isinstance(net.l1, DynamicInt8InferenceLinear)
        served, second = net(x), net(x2)
    np.testing.assert_array_equal(served.numpy(), want["served"])
    np.testing.assert_array_equal(second.numpy(), want["second"])
    # the twin is numerically the fake-quant model
    np.testing.assert_allclose(served.numpy(), fake.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(fake.numpy(), want["fake"], rtol=1e-5, atol=1e-6)


def test_dynamic_linear_input_blocks_the_attention_twin():
    """With dynamic inputs and no attention quantizers the attention stays a
    module and each projection becomes a dynamic twin, as in JAX."""
    m = _port_tiny("llama")
    assert llm_ptq.use_dynamic_act_quant(m) == 8
    m.eval()
    PG.convert_integer_inference(m)
    assert sum(isinstance(mod, DynamicInt8InferenceLinear) for mod in m.modules()) == 8
    assert isinstance(m.blocks[0].attn, qnn.QuantMultiheadAttention)


# -- the traced graph ---------------------------------------------------------------


def _port_tiny(arch, vocab=40):
    kw = dict(vocab_size=vocab, weight_quant=presets.NoneWeightQuant,
              act_quant=presets.NoneActQuant, uact_quant=presets.NoneActQuant, device="cpu")
    m = (QuantLlama(**kw, **TINY) if arch == "llama"
         else QuantTransformer(max_len=FLOW["seq_len"], **kw, **TINY_GPT))
    llm_ptq.quantize(m, _flow_args())
    return m


def _regions(ref_regions):
    return [(list(s), list(k)) for s, k in ref_regions]


@pytest.mark.parametrize("arch", ["llama", "gpt"])
def test_traced_regions_match_jax(jax_ref, arch):
    want = jax_ref["graphs"][arch]
    m = _port_tiny(arch, jax_ref["flows"]["vocab"])
    got = PG.extract_act_equalization_regions(m, torch.tensor(jax_ref["ids"]).long())
    assert got == _regions(want["regions"])
    assert llm_ptq.smoothquant_regions(m, torch.tensor(jax_ref["ids"]).long()) == got
    hand = llm_ptq.smoothquant_regions(m)
    assert hand == (llama_smoothquant_regions(m) if arch == "llama"
                    else transformer_smoothquant_regions(m))
    assert hand == _regions(want["hand"])
    # the traced list is a superset of the hand list: the final norm -> head too
    traced = {(s[0], tuple(k)) for s, k in got}
    assert all((s[0], tuple(sorted(k))) in traced for s, k in hand)
    assert len(got) == len(hand) + 1


@pytest.mark.parametrize("arch", ["llama", "gpt"])
def test_traced_graph_matches_jax_between_modules(jax_ref, arch):
    """Every module node, and the modules its output reaches through
    reshaping-only calls, as in JAX's graph."""
    m = _port_tiny(arch, jax_ref["flows"]["vocab"])
    g = trace_module_graph(m, torch.tensor(jax_ref["ids"]).long())
    got = _reach(g.nodes, lambda n: n.kind == "module", lambda n: n.succs,
                 lambda n: n.path, _classify_prim)
    assert got == jax_ref["graphs"][arch]["reach"]
    assert all(node.module is m.get_submodule(path) for path, node in g.modules.items())


def test_trace_leaves_the_model_untouched():
    m = _port_tiny("llama")
    before = {k: v.clone() for k, v in m.state_dict().items()}
    PG.trace_module_graph(m, torch.zeros((1, 8), dtype=torch.long))
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k]), k


# -- SmoothQuant ----------------------------------------------------------------------


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _sq_port(jax_ref):
    """The dynamic flow's model as JAX had it before SmoothQuant, its
    calibration batches and its regions."""
    flows = jax_ref["flows"]
    m = _port_tiny("llama", flows["vocab"])
    load_jax_state(m, flows["dynamic_gptq"]["before_sq"])
    calib = [torch.tensor(b) for b in flows["calib"]]
    return m, calib, _regions(flows["dynamic_gptq"]["regions"])


def test_smoothquant_factors_and_weights_match_jax(jax_ref):
    m, calib, regions = _sq_port(jax_ref)
    want = jax_ref["flows"]["dynamic_gptq"]
    s = PG.apply_act_equalization(m, regions, calib, alpha=0.5,
                                  forward_fn=lambda mm, b: mm(b, causal=True))
    assert sorted(s) == sorted(want["sq_s"]) == [0, 1, 2]
    worst_s = max(int(_ulps(s[i].numpy(), want["sq_s"][i]).max()) for i in s)
    after = want["after_sq"]
    worst_w, n = 0, 0
    for path in after:
        if path.endswith(("norm.scale", ".weight")) and "quant" not in path:
            owner, _, name = path.rpartition(".")
            mod = m.get_submodule(owner)
            t = getattr(mod, name).detach()
            t = t.t() if isinstance(mod, qnn.QuantLinear) and name == "weight" else t
            worst_w = max(worst_w, int(_ulps(t.numpy(), after[path]).max()))
            n += 1
    print(f"SmoothQuant: factors within {worst_s} ulps of JAX's, {n} weights within {worst_w}")
    assert n == 8 + 2 + 1 + 1  # the linears, the block norms, the final norm, the embedding
    assert worst_s <= SQ_S_ULPS and worst_w <= SQ_W_ULPS


def test_smoothquant_preserves_function(jax_ref):
    m, calib, regions = _sq_port(jax_ref)
    m.eval()
    _set_disable_quant(m, True)
    with torch.no_grad():
        y0 = m(calib[0])
    PG.apply_act_equalization(m, regions, calib, alpha=0.5,
                              forward_fn=lambda mm, b: mm(b, causal=True))
    _set_disable_quant(m, True)
    with torch.no_grad():
        y1 = m(calib[0])
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=1e-3, atol=1e-4)
    assert not m.training


def test_smoothquant_refuses_a_float_sink():
    m = QuantLlama(device="cpu", vocab_size=40, **TINY)
    with pytest.raises(TypeError):
        PG.apply_act_equalization(m, [(["final_norm"], ["blocks.0.attn"])], [])


# -- GPTQ -------------------------------------------------------------------------------


def test_gptq_solve_matches_jax(jax_ref):
    r = jax_ref["gptq"]
    got = _gptq_solve(torch.from_numpy(r["W"]).clone(), torch.from_numpy(r["H"]),
                      torch.from_numpy(r["scale"]), r["nmin"], r["nmax"], 0.01).numpy()
    codes, want = np.round(got / r["scale"]), np.round(r["Wn"] / r["scale"])
    share = float(np.mean(codes != want))
    print(f"GPTQ codes that differ from JAX's: {share:.4%} of {codes.size}")
    assert share <= GPTQ_FLIP_SHARE
    assert codes.min() >= r["nmin"] and codes.max() <= r["nmax"]
    np.testing.assert_allclose(got, codes * r["scale"], rtol=1e-5, atol=1e-7)


def _gptq_linear_case(bits, per_channel):
    rng = np.random.default_rng(123456)
    wq = (presets.Int8WeightPerChannelFloat if per_channel
          else presets.Int8WeightPerTensorFloat).let(bit_width=bits)
    layer = qnn.QuantLinear(48, 24, weight_quant=wq, generator=torch.Generator().manual_seed(0))
    base = rng.standard_normal((128, 8)).astype(np.float32)
    mix = rng.standard_normal((8, 48)).astype(np.float32)
    x = torch.from_numpy(base @ mix + 0.1 * rng.standard_normal((128, 48)).astype(np.float32))
    return layer, x


def test_gptq_linear_beats_nearest():
    """``tests/test_gptq.py``'s linear case in the port."""
    layer, x = _gptq_linear_case(3, False)
    net = PortNet(layer).eval()
    with torch.no_grad():
        y_fp = x @ layer.weight.t()
        y_nearest = net(x)
    (near, gptq), = PG.apply_gptq(net, [x]).values()
    assert gptq < near
    with torch.no_grad():
        y_gptq = net(x)
    assert float(((y_gptq - y_fp) ** 2).mean()) < float(((y_nearest - y_fp) ** 2).mean())


def test_gptq_weights_on_grid():
    layer, x = _gptq_linear_case(4, True)
    PG.apply_gptq(PortNet(layer), [x[:64, :48]])
    with torch.no_grad():
        qt = layer.quant_weight()
    np.testing.assert_allclose(qt.value.numpy(), layer.weight.detach().numpy(), rtol=0, atol=1e-6)


def _smooth_images(seed, shape):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))
    return (x + torch.roll(x, 1, 2) + torch.roll(x, 1, 3)) / 3.0


@pytest.mark.parametrize("groups", [1, 2])
def test_gptq_conv_beats_nearest(groups):
    """``tests/test_gptq.py``'s conv cases: the patch-matrix problems, one a
    group."""
    conv = qnn.QuantConv2d(6, 12, 3, padding="SAME", groups=groups,
                           weight_quant=presets.Int8WeightPerChannelFloat.let(bit_width=3),
                           generator=torch.Generator().manual_seed(0))
    net = PortNet(conv).eval()
    x = _smooth_images(1, (4, 6, 10, 10))
    w_fp = conv.weight.detach().clone()
    with torch.no_grad():
        y_nearest = net(x)
    (near, gptq), = PG.apply_gptq(net, [x]).values()
    ref = qnn.QuantConv2d(6, 12, 3, padding="SAME", groups=groups, weight_quant=None)
    with torch.no_grad():
        ref.weight.copy_(w_fp)
        ref.bias.copy_(conv.bias)
        y_fp, y_gptq = ref(x), net(x)
    assert gptq < near
    assert float(((y_gptq - y_fp) ** 2).mean()) < float(((y_nearest - y_fp) ** 2).mean())
    with torch.no_grad():
        np.testing.assert_allclose(conv.quant_weight().value.numpy(), conv.weight.numpy(),
                                   rtol=0, atol=1e-6)


# -- the flow as a whole -----------------------------------------------------------------


def _port_model(arch, vocab):
    kw = dict(device="cpu", vocab_size=vocab, weight_quant=presets.NoneWeightQuant,
              act_quant=presets.NoneActQuant, uact_quant=presets.NoneActQuant)
    if arch == "llama":
        return QuantLlama(**kw, **TINY)
    return QuantTransformer(max_len=FLOW["seq_len"], **kw, **TINY_GPT)


@pytest.mark.parametrize("case", list(FLOW_CASES))
def test_flow_matches_jax(jax_ref, case):
    arch, flow = FLOW_CASES[case]
    ref = jax_ref["flows" if arch == "llama" else "gpt_flows"]
    xs, ys, vocab = _batches(_CORPUS, FLOW["seq_len"], FLOW["batch"],
                             FLOW["train_steps"] + FLOW["calib_batches"] + 2, 0)
    assert vocab == ref["vocab"]
    n = FLOW["train_steps"]
    calib = list(xs[n:n + FLOW["calib_batches"]])
    test_x, test_y = xs[n + FLOW["calib_batches"]:], ys[n + FLOW["calib_batches"]:]
    m = _port_model(arch, vocab)
    load_jax_state(m, ref["float_state"]).eval()
    float_bpc = llm_ptq.bits_per_char(m, test_x, test_y)
    args = _flow_args(**FLOWS[flow])
    llm_ptq.quantize(m, args)
    regions, _ = llm_ptq.post_training(m, args, calib)
    m.eval()
    codes = port_weight_codes(m)
    quant_bpc = llm_ptq.bits_per_char(m, test_x, test_y)
    PG.convert_integer_inference(m)
    served_bpc = llm_ptq.bits_per_char(m, test_x, test_y)
    want = ref[flow]
    print(f"{case}: float {float_bpc} / {ref['float_bpc']}, quant {quant_bpc} / "
          f"{want['quant_bpc']}, served {served_bpc} / {want['served_bpc']} (port / JAX)")
    assert regions == [(list(s), list(k)) for s, k in want["regions"]]
    kinds = sorted(type(mod).__name__ for mod in m.modules() if "Inference" in type(mod).__name__)
    assert kinds == want["kinds"]
    # the weight codes layer by layer: GPTQ's inputs (captured with the
    # layers before already rounded), its Hessian, the frozen scale, the
    # layer order and the write-back all show here
    _assert_codes_close(codes, want["codes"], case, GPT_FLOW_MAX_STEP if arch == "gpt" else 1)
    assert abs(float_bpc - ref["float_bpc"]) < 1e-4
    assert abs(quant_bpc - want["quant_bpc"]) < BPC_TOL
    assert abs(served_bpc - want["served_bpc"]) < BPC_TOL


def _assert_codes_close(got: dict, want: dict, what: str, max_step: int = 1) -> None:
    """Weight codes layer by layer: at most ``GPTQ_FLIP_SHARE`` of a
    layer's differ, each by one step (a flip at a .5 boundary), or by
    ``max_step`` where GPTQ carries a flip into the rows after it."""
    assert sorted(got) == sorted(want)
    diff = {p: got[p].astype(np.int64) - want[p].astype(np.int64) for p in got}
    shares = {p: float(np.mean(d != 0)) for p, d in diff.items()}
    total = sum(int(np.count_nonzero(d)) for d in diff.values()) / sum(
        d.size for d in diff.values())
    print(f"{what}: weight codes that differ from JAX's: {total:.4%} of all, "
          f"worst layer {max(shares.values()):.4%}")
    assert max(shares.values()) <= GPTQ_FLIP_SHARE, shares
    assert all(int(np.abs(d).max(initial=0)) <= max_step for d in diff.values())


def test_apply_gptq_matches_jax_from_its_state(jax_ref):
    """``apply_gptq`` alone, from JAX's own state just before GPTQ (after
    SmoothQuant and the dynamic quantizers): the captures with the earlier
    layers already rounded, H from them, the frozen scale, the layer order
    and the write-back."""
    flows = jax_ref["flows"]
    want = flows["dynamic_gptq"]
    m = _port_tiny("llama", flows["vocab"])
    llm_ptq.use_dynamic_act_quant(m, 8)
    load_jax_state(m, want["before_gptq"])
    _assert_codes_close(port_weight_codes(m), want["codes_before_gptq"], "before GPTQ")
    calib = [torch.tensor(b) for b in flows["calib"]]
    report = PG.apply_gptq(m, calib, forward_fn=lambda mm, b: mm(b, causal=True))
    assert list(report) == list(want["codes"])  # every linear, in JAX's order
    _assert_codes_close(port_weight_codes(m), want["codes"], "apply_gptq")


def test_apply_gptq_matches_jax_from_its_state_gpt(jax_ref):
    """The same on gpt: from JAX's state before GPTQ every code is JAX's
    (the flow's extra step, ``GPT_FLOW_MAX_STEP``, comes from the ulps
    SmoothQuant leaves before it)."""
    flows = jax_ref["gpt_flows"]
    want = flows["dynamic_gptq"]
    m = _port_tiny("gpt", flows["vocab"])
    llm_ptq.use_dynamic_act_quant(m, 8)
    load_jax_state(m, want["before_gptq"])
    calib = [torch.tensor(b) for b in flows["calib"]]
    report = PG.apply_gptq(m, calib, forward_fn=lambda mm, b: mm(b, causal=True))
    assert list(report) == list(want["codes"])
    _assert_codes_close(port_weight_codes(m), want["codes"], "apply_gptq gpt")


def test_jax_gptq_moves_codes_beyond_the_flip_share(jax_ref):
    """The code comparisons can see a GPTQ that does nothing: JAX's GPTQ
    moves far more of every layer's codes off nearest rounding than the
    share the port may differ by."""
    want = jax_ref["flows"]["dynamic_gptq"]
    moved = {p: float(np.mean(want["codes"][p] != want["codes_before_gptq"][p]))
             for p in want["codes"]}
    print(f"JAX's GPTQ moves {min(moved.values()):.4%} to {max(moved.values()):.4%} "
          "of a layer's codes off nearest rounding")
    assert min(moved.values()) > 20 * GPTQ_FLIP_SHARE, moved


# -- the entry point ------------------------------------------------------------------------


def test_llm_ptq_pipeline_small():
    """``tests/test_dynamic_quant.py``'s argv and bounds, at --device cpu."""
    r = llm_ptq.main(["--train-steps", "40", "--depth", "1", "--dim", "32", "--heads", "2",
                      "--seq-len", "32", "--batch", "16", "--gptq", "--dynamic-act",
                      "--convert-int", "--device", "cpu"])
    assert r["quant_bpc"] < r["float_bpc"] + 0.1
    assert r["served_bpc"] < r["float_bpc"] + 0.1
    assert abs(r["served_bpc"] - r["quant_bpc"]) < 1e-3
    assert r["gptq_steps"] == 4 * 32 + 32 + 128 + 32 and r["regions"] == 3


def test_llm_ptq_cli_llama_smoke():
    """``tests/test_llama.py``'s argv and bounds, at --device cpu."""
    res = llm_ptq.main(["--arch", "llama", "--train-steps", "8", "--batch", "8",
                        "--seq-len", "24", "--dim", "32", "--depth", "1", "--heads", "2",
                        "--calib-batches", "2", "--convert-int", "--kv-bits", "4",
                        "--device", "cpu"])
    assert res["arch"] == "llama"
    assert np.isfinite(res["float_bpc"]) and np.isfinite(res["quant_bpc"])
    assert res["served_bpc"] is not None and np.isfinite(res["served_bpc"])
    assert res["quant_bpc"] < res["float_bpc"] + 1.5


def test_main_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        llm_ptq.main(["--train-steps", "1"])
