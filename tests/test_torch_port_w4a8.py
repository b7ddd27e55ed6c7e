"""The port's W4A8 serving slice against the JAX package's.

W4A8: weights of 4 bits with a scale per output channel, 8-bit activations.
The port's ``int4_matmul`` (which takes its plain version on the CPU) is
held to JAX's eager ``int4_matmul_reference`` bit for bit, and to the Pallas
``int4_matmul`` in interpret mode at the shapes that kernel tiles. The
per-channel weight quantizers, the packed branch of ``Int8InferenceLinear``
and a small W4A8 QuantLlama are held to the JAX package's on the same numpy
inputs, with the JAX state carried across by ``load_jax_state``.

Tolerances, each with its reason:
- integer GEMMs, scales and codes: exact. The int32 accumulator is exact in
  both packages and the epilogue rounds each step in the same order;
- the Pallas kernel with a bias: 2 ulp, because XLA contracts the
  epilogue's multiply and bias add into one FMA under jit (as for
  ``int8_matmul``, ``tests/test_torch_port_kernels.py``);
- codes at the serving twins' inputs: exact, except where JAX's value before
  rounding lies within 1e-4 of a .5 tie (certified one by one);
- float outputs of whole models: rtol = atol = 1e-4, the serving tests'
  bound (torch and XLA may differ in the last bit of a float32 matmul,
  RoPE's sin/cos, silu and rsqrt).
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from jax.experimental.pallas import tpu as pltpu

from brevitas_tpu import config as jax_config
from brevitas_tpu import graph as JG
from brevitas_tpu.graph import convert_int as jax_convert_int
from brevitas_tpu.kernels import int4 as jax_int4
from brevitas_tpu.models.llama import QuantLlama as JaxLlama
from brevitas_tpu.nn import QuantEmbedding as JaxQuantEmbedding
from brevitas_tpu.nn import QuantLinear as JaxQuantLinear
from brevitas_tpu.quant import presets as jax_presets
from brevitas_tpu.quant.quantizers import ActQuantizer as JaxActQuantizer
from brevitas_tpu.quant.quantizers import ParameterQuantizer as JaxParameterQuantizer
from brevitas_tpu.utils import eval_mode as jax_eval_mode
from brevitas_tpu_torch import config as port_config
from brevitas_tpu_torch import graph as PG
from brevitas_tpu_torch.graph.convert_int import Int8InferenceLinear
from brevitas_tpu_torch.interop import load_jax_state
from brevitas_tpu_torch.kernels import int4_matmul
from brevitas_tpu_torch.models import QuantLlama as PortLlama
from brevitas_tpu_torch.nn import QuantEmbedding as PortQuantEmbedding
from brevitas_tpu_torch.nn import QuantLinear as PortQuantLinear
from brevitas_tpu_torch.quant import presets as port_presets
from brevitas_tpu_torch.quant.quantizers import ActQuantizer as PortActQuantizer
from brevitas_tpu_torch.quant.quantizers import ParameterQuantizer as PortParameterQuantizer

torch.set_num_threads(1)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def jax_state_arrays(model) -> dict:
    return {".".join(map(str, path)): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model)) if path[0] != "rngs"}


# -- the kernel's plain version --------------------------------------------

# (M, K, N, bias, act, per-channel scale): M in {1, 5, 16, 37}, odd K/2
# (3, 1, 513, 15), N off the 64-column tile
INT4_CASES = [
    (1, 6, 10, False, None, True),
    (5, 2, 3, True, "relu", False),
    (16, 1026, 100, True, None, True),
    (37, 784, 70, False, "relu", True),
    (16, 30, 130, True, "relu", False),
    (5, 1026, 100, False, None, False),
    (37, 6, 1, True, None, True),
    (1, 1026, 70, True, "relu", True),
]


def _int4_case(rng, m, k, n, with_bias, per_channel):
    x = rng.integers(-128, 128, (m, k), dtype=np.int8)
    w_packed = rng.integers(-128, 128, (k // 2, n), dtype=np.int8)
    xs = np.float32(rng.uniform(0.001, 0.05))
    ws = (rng.uniform(0.001, 0.05, n) if per_channel else rng.uniform(0.001, 0.05))
    ws = np.asarray(ws, np.float32)
    b = rng.standard_normal(n).astype(np.float32) if with_bias else None
    return x, w_packed, xs, ws, b


@pytest.mark.parametrize("m,k,n,with_bias,act,per_channel", INT4_CASES)
def test_int4_matmul_matches_jax_reference_exactly(rng, m, k, n, with_bias, act,
                                                    per_channel):
    x, wp, xs, ws, b = _int4_case(rng, m, k, n, with_bias, per_channel)
    port = int4_matmul(_t(x), _t(wp), _t(xs), _t(ws), _t(b), act=act).numpy()
    ref = np.asarray(jax_int4.int4_matmul_reference(_j(x), _j(wp), _j(xs), _j(ws), _j(b),
                                                    act=act))
    assert port.shape == (m, n) and port.dtype == np.float32
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("m,k,n,with_bias,act,per_channel", [
    (5, 1024, 512, False, None, True),
    (5, 1024, 512, True, "relu", True),
    (16, 2048, 512, True, None, False),
])
def test_int4_matmul_matches_pallas_kernel(rng, m, k, n, with_bias, act, per_channel):
    x, wp, xs, ws, b = _int4_case(rng, m, k, n, with_bias, per_channel)
    port = int4_matmul(_t(x), _t(wp), _t(xs), _t(ws), _t(b), act=act).numpy()
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jax_int4.int4_matmul(_j(x), _j(wp), _j(xs), _j(ws), _j(b),
                                                 act=act))
    if b is None:
        np.testing.assert_array_equal(port, pallas)
    else:
        # the FMA of the jitted epilogue: the product's rounding at most
        product = port - b
        tol = 2 * np.spacing(np.abs(product)) + 2 * np.spacing(np.abs(port))
        assert np.all(np.abs(port - pallas) <= tol)


def test_int4_matmul_refuses_devices_without_a_kernel():
    with pytest.raises(ValueError):
        int4_matmul(torch.zeros((2, 4), dtype=torch.int8, device="meta"),
                    torch.zeros((2, 3), dtype=torch.int8, device="meta"), 1.0, 1.0)


# -- per-channel weight quantizers -------------------------------------------

WEIGHT_PRESETS = ["Int4WeightPerChannelFloat", "Int8WeightPerChannelFloat",
                  "Int4WeightPerTensorFloat"]


@pytest.mark.parametrize("preset", WEIGHT_PRESETS)
def test_parameter_quantizer_matches_jax(rng, preset):
    """A weight (out, in) in the port is (in, out) in the JAX package: the
    output channel is axis 0 here and axis 1 there."""
    w = rng.standard_normal((24, 40)).astype(np.float32)
    pq = PortParameterQuantizer(getattr(port_presets, preset), _t(w), channel_axis=0)
    jq = JaxParameterQuantizer(getattr(jax_presets, preset), _j(w.T), channel_axis=1)
    with torch.no_grad():
        pt = pq(_t(w))
    jt = jq(_j(w.T))
    np.testing.assert_array_equal(pt.scale.numpy().reshape(-1),
                                  np.asarray(jt.scale).reshape(-1))
    np.testing.assert_array_equal(pt.int().numpy().T, np.asarray(jt.int()))
    np.testing.assert_array_equal(pt.value.numpy().T, np.asarray(jt.value))


@pytest.mark.parametrize("preset", WEIGHT_PRESETS)
def test_quant_linear_and_embedding_match_jax(rng, preset):
    jl = JaxQuantLinear(40, 24, weight_quant=getattr(jax_presets, preset), rngs=nnx.Rngs(0))
    pl = PortQuantLinear(40, 24, weight_quant=getattr(port_presets, preset))
    load_jax_state(pl, jax_state_arrays(jl))
    je = JaxQuantEmbedding(30, 16, weight_quant=getattr(jax_presets, preset),
                           rngs=nnx.Rngs(1))
    pe = PortQuantEmbedding(30, 16, weight_quant=getattr(port_presets, preset))
    load_jax_state(pe, jax_state_arrays(je))
    x = rng.standard_normal((3, 40)).astype(np.float32)
    ids = rng.integers(0, 30, (2, 5))
    with torch.no_grad():
        pw, pe_w = pl.quant_weight(), pe.weight_quant(pe.weight)
        py, pids = pl(_t(x)).numpy(), pe(torch.from_numpy(ids)).numpy()
    jw, je_w = jl.quant_weight(), je.weight_quant(je.weight[...])
    np.testing.assert_array_equal(pw.scale.numpy().reshape(-1), np.asarray(jw.scale).reshape(-1))
    np.testing.assert_array_equal(pw.int().numpy().T, np.asarray(jw.int()))
    # the embedding keeps one scale per vocabulary row in both packages
    assert pe_w.scale.numel() == (30 if "PerChannel" in preset else 1)
    np.testing.assert_array_equal(pe_w.scale.numpy().reshape(-1),
                                  np.asarray(je_w.scale).reshape(-1))
    np.testing.assert_array_equal(pe_w.int().numpy(), np.asarray(je_w.int()))
    np.testing.assert_array_equal(pids, np.asarray(je(jnp.asarray(ids))))
    np.testing.assert_allclose(py, np.asarray(jl(_j(x))), rtol=1e-5, atol=1e-6)


def test_per_channel_activation_scaling_still_refused():
    with pytest.raises(NotImplementedError):
        PortActQuantizer(port_presets.Int8ActPerTensorFloat.let(scaling_per_output_channel=True))


# -- the packed branch of Int8InferenceLinear --------------------------------

def _port_linear(k, n, input_quant):
    return PortQuantLinear(k, n, weight_quant=port_presets.Int4WeightPerChannelFloat,
                           input_quant=None if input_quant is None
                           else getattr(port_presets, input_quant).let(collect_stats_steps=1))


@functools.lru_cache(maxsize=None)
def _calibrated_pair(k, n, input_quant):
    """A W4A8 QuantLinear with a bias in both packages, the port's carrying
    the JAX state, in eval mode. Its input grid is set as one calibration
    step would leave it (threshold 3 in the buffer, the counter at 1), so
    the JAX quantizer need not run. Built once per shape: the twins only
    read it."""
    rng = np.random.default_rng(k * n)
    jl = JaxQuantLinear(k, n, weight_quant=jax_presets.Int4WeightPerChannelFloat,
                        input_quant=None if input_quant is None
                        else getattr(jax_presets, input_quant).let(collect_stats_steps=1),
                        rngs=nnx.Rngs(0))
    jl.bias[...] = jnp.asarray(rng.standard_normal(n).astype(np.float32) * 0.1)
    if input_quant is not None:
        jl.input_quant.scaling.buffer[...] = jnp.asarray(3.0, jnp.float32)
        jl.input_quant.scaling.counter[...] = jnp.asarray(1, jnp.int32)
    pl = _port_linear(k, n, input_quant)
    load_jax_state(pl, jax_state_arrays(jl))
    jax_eval_mode(jl)
    pl.eval()
    return jl, pl


@pytest.mark.parametrize("k,n,input_quant,jax_packs", [
    (512, 512, "Int8ActPerTensorFloat", True),
    (100, 70, "Int8ActPerTensorFloat", False),
    (784, 10, "Uint8ActPerTensorFloat", False),
])
def test_frozen_input_twin_matches_jax(rng, k, n, input_quant, jax_packs):
    """Where the JAX package packs (512-aligned), the bytes and the output
    equal its ``int4_matmul`` route; where it does not, the output equals
    its plain int8 route, which has the same accumulator and epilogue."""
    jl, pl = _calibrated_pair(k, n, input_quant)
    jt, pt = jax_convert_int.Int8InferenceLinear(jl), Int8InferenceLinear(pl)
    assert pt.w_int is None and tuple(pt.w_packed.shape) == (k // 2, n)
    assert (jt.w_packed is not None) == jax_packs
    if jax_packs:
        np.testing.assert_array_equal(pt.w_packed.numpy(), np.asarray(jt.w_packed))
    else:
        np.testing.assert_array_equal(pt.w_packed.numpy(),
                                      np.asarray(jax_int4.pack_int4_rows(jt.w_int)))
    np.testing.assert_array_equal(pt.bias.numpy(), np.asarray(jt.bias))
    x = rng.standard_normal((5, k)).astype(np.float32)
    with torch.no_grad():
        port = pt(_t(x)).numpy()
    np.testing.assert_array_equal(port, np.asarray(jt(_j(x))))


@pytest.mark.parametrize("signed", [True, False])
def test_carried_grid_twin_with_packed_weights_matches_jax(rng, signed):
    """No input quantizer: the grid arrives with a QuantTensor input and an
    unsigned grid's re-centre by 128 folds into the bias."""
    jl, pl = _calibrated_pair(512, 512, None)
    jt, pt = jax_convert_int.Int8InferenceLinear(jl), Int8InferenceLinear(pl)
    assert pt.w_packed is not None and jt.w_packed is not None
    preset = "Int8ActPerTensorFloat" if signed else "Uint8ActPerTensorFloat"
    jq = JaxActQuantizer(getattr(jax_presets, preset).let(collect_stats_steps=1))
    pq = PortActQuantizer(getattr(port_presets, preset).let(collect_stats_steps=1))
    x = np.abs(rng.standard_normal((6, 512))).astype(np.float32) * (1 if signed else 2)
    if signed:
        x -= 0.5
    jqt = jq(_j(x))
    with torch.no_grad():
        pqt = pq(_t(x))
        np.testing.assert_array_equal(pqt.value.numpy(), np.asarray(jqt.value))
        port = pt(pqt).numpy()
    np.testing.assert_array_equal(port, np.asarray(jt(jqt)))


def test_no_grid_fallback_unpacks_the_packed_weights(rng, monkeypatch):
    """Without an input grid the twin serves the dequantized weights in
    float. The JAX package's fallback unpacks packed weights with the
    interleaved ``unpack_int4`` and fails on their shape (a reference
    fault), so the port is held to its unpacked route."""
    jl, pl = _calibrated_pair(512, 512, None)
    pt = Int8InferenceLinear(pl)
    assert pt.w_packed is not None
    monkeypatch.setattr(jax_config, "INT4_PACKED_SERVING", False)
    jt = jax_convert_int.Int8InferenceLinear(jl)
    assert jt.w_packed is None
    x = rng.standard_normal((4, 512)).astype(np.float32)
    with torch.no_grad():
        port = pt(_t(x)).numpy()
    # float32 matmuls: torch and XLA sum in other orders
    np.testing.assert_allclose(port, np.asarray(jt(_j(x))), rtol=1e-5, atol=1e-5)


def _calibrated_port_linear(rng, k, n):
    pl = _port_linear(k, n, "Int8ActPerTensorFloat")
    with torch.no_grad():
        pl(_t(rng.standard_normal((8, k)).astype(np.float32)))
    return pl.eval()


def test_odd_input_width_stays_unpacked(rng):
    pt = Int8InferenceLinear(_calibrated_port_linear(rng, 7, 5))
    assert pt.w_packed is None and tuple(pt.w_int.shape) == (7, 5)


def test_packing_switch(rng, monkeypatch):
    pl = _calibrated_port_linear(rng, 64, 32)
    monkeypatch.setattr(port_config, "INT4_PACKED_SERVING", False)
    pt = Int8InferenceLinear(pl)
    assert pt.w_packed is None and pt.w_int is not None
    x = _t(rng.standard_normal((3, 64)).astype(np.float32))
    monkeypatch.setattr(port_config, "INT4_PACKED_SERVING", True)
    with torch.no_grad():
        assert torch.equal(pt(x), Int8InferenceLinear(pl)(x))


# -- a small W4A8 QuantLlama, end to end ---------------------------------------

# every linear 512-aligned, so the JAX package packs them all as well
LLAMA = dict(vocab_size=512, dim=512, depth=1, num_heads=8, hidden=512)
B, T, STEPS = 2, 8, 6

_jax_forward = nnx.jit(lambda m, ids: m(ids))
_jax_decode = nnx.jit(lambda m, ids, caches, pos: m.decode_step(ids, caches, pos))


def _record_inputs(cls, store):
    """Wrap ``cls.__call__``/``forward`` to store every input it receives."""
    name = "forward" if issubclass(cls, torch.nn.Module) else "__call__"
    orig = getattr(cls, name)

    def call(self, x, *args, **kw):
        store.append((self, x))
        return orig(self, x, *args, **kw)
    return name, orig, call


def _jax_integer_forward(jm, ids):
    """The JAX twin's jitted forward: its logits and, in call order, each
    serving twin's input with that twin's input grid (the scale an output
    of the jit, the static zero point and bounds read while tracing)."""
    store, grids = [], []
    name, orig, call = _record_inputs(jax_convert_int.Int8InferenceLinear, store)

    def forward(m, v):
        setattr(jax_convert_int.Int8InferenceLinear, name, call)
        try:
            logits = m(v)
        finally:
            setattr(jax_convert_int.Int8InferenceLinear, name, orig)
        grids.extend((t.x_zp, t.x_lo, t.x_hi) for t, _ in store)
        return logits, [(t.x_scale, x) for t, x in store]

    logits, seen = nnx.jit(forward)(jm, jnp.asarray(ids))
    return np.asarray(logits), [
        (types.SimpleNamespace(x_scale=s, x_zp=zp, x_lo=lo, x_hi=hi), np.asarray(x))
        for (s, x), (zp, lo, hi) in zip(seen, grids)]


def _codes(twin, x):
    """(codes, value before rounding) at a frozen-input twin's input."""
    pre = np.asarray(x) / float(np.asarray(twin.x_scale)) + twin.x_zp
    return np.clip(np.round(pre), twin.x_lo, twin.x_hi), pre


@pytest.fixture(scope="module")
def w4a8_llama():
    ids = np.random.default_rng(0).integers(0, LLAMA["vocab_size"], (B, T)).astype(np.int32)
    jm = JaxLlama(weight_quant=jax_presets.Int4WeightPerChannelFloat, rngs=nnx.Rngs(0),
                  **LLAMA)
    pm = PortLlama(weight_quant=port_presets.Int4WeightPerChannelFloat, device="cpu",
                   **LLAMA)
    _jax_forward(jm, jnp.asarray(ids))  # calibration: one train-mode forward
    load_jax_state(pm, jax_state_arrays(jm))
    ids_t = torch.from_numpy(ids).long()
    r = {"jm": jm, "pm": pm}
    with torch.no_grad():
        jax_eval_mode(jm)
        pm.eval()
        r["fake"] = (pm(ids_t).numpy(), np.asarray(_jax_forward(jm, jnp.asarray(ids))))
        JG.convert_integer_inference(jm)
        PG.convert_integer_inference(pm)
        # the twins' inputs, recorded in call order
        port_inputs = []
        name, orig, call = _record_inputs(Int8InferenceLinear, port_inputs)
        setattr(Int8InferenceLinear, name, call)
        try:
            port_logits = pm(ids_t).numpy()
        finally:
            setattr(Int8InferenceLinear, name, orig)
        jax_logits, jax_inputs = _jax_integer_forward(jm, ids)
        r["int"] = (port_logits, jax_logits)
        r["inputs"] = (port_inputs, jax_inputs)
        jc, pc = jm.init_decode_caches(B, T), pm.init_decode_caches(B, T)
        r["steps"] = []
        for t in range(STEPS):
            lj, jc = _jax_decode(jm, jnp.asarray(ids[:, t:t + 1]), jc, jnp.int32(t))
            lp, pc = pm.decode_step(ids_t[:, t:t + 1], pc, t)
            r["steps"].append((lp.numpy(), np.asarray(lj)))
    return r


def _close(port, jax_out):
    np.testing.assert_allclose(np.asarray(port), np.asarray(jax_out), rtol=1e-4, atol=1e-4)


def test_w4a8_llama_packs_every_linear_in_both_packages(w4a8_llama):
    p_twins = {path: m for path, m in w4a8_llama["pm"].named_modules()
               if isinstance(m, Int8InferenceLinear)}
    j_twins = {path: m for path, m in JG.named_modules(w4a8_llama["jm"])
               if isinstance(m, jax_convert_int.Int8InferenceLinear)}
    assert len(p_twins) == 7 + 1 and set(p_twins) == set(j_twins)
    for path, pt in p_twins.items():
        jt = j_twins[path]
        assert pt.w_int is None and jt.w_packed is not None, path
        np.testing.assert_array_equal(pt.w_packed.numpy(), np.asarray(jt.w_packed))
        np.testing.assert_array_equal(pt.w_scale.numpy(), np.asarray(jt.w_scale))


def test_w4a8_llama_fake_quant_logits_match_jax(w4a8_llama):
    port, jax_out = w4a8_llama["fake"]
    assert port.shape == (B, T, LLAMA["vocab_size"]) and np.isfinite(port).all()
    _close(port, jax_out)


def test_w4a8_llama_prefill_matches_jax(w4a8_llama):
    _close(*w4a8_llama["int"])


def test_w4a8_llama_decode_steps_match_jax(w4a8_llama):
    for port, jax_out in w4a8_llama["steps"]:
        _close(port, jax_out)
    # and the port's own decode its own prefill (the JAX package's check)
    for t, (port, _) in enumerate(w4a8_llama["steps"]):
        np.testing.assert_allclose(port[:, 0], w4a8_llama["int"][0][:, t],
                                   rtol=1e-4, atol=1e-4)


def test_w4a8_llama_codes_at_twin_inputs_match_jax(w4a8_llama):
    port_in, jax_in = w4a8_llama["inputs"]
    assert len(port_in) == len(jax_in) == 8
    for (pt, px), (jt, jx) in zip(port_in, jax_in):
        pc, _ = _codes(pt, px.numpy())
        jcodes, jpre = _codes(jt, jx)
        mismatch = pc != jcodes
        frac = np.abs(jpre - np.floor(jpre) - 0.5)
        assert np.all(frac[mismatch] <= 1e-4), (
            f"{int(mismatch.sum())} codes differ away from a .5 tie")
