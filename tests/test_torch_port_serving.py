"""The port's serving slice against the JAX package's, end to end.

A small FC (784 -> 64 -> 64 -> 10) is built in JAX, its state carried into
the port with ``load_jax_state``, and both packages run serve.py's recipe:
calibrate on one batch, eval, ``convert_integer_inference``. Three serving
modes: frozen-input int8 (``build_int8_model``'s input quantizers),
carried-grid int8 (8-bit FC without input quantizers) and w4a16 (4-bit FC).
Every model has dropout 0: the two packages draw different random numbers.

Tolerances: integer codes match exactly, except where JAX's value before
rounding lies within 1e-4 of a .5 tie (``assert_codes_match`` certifies
each such mismatch). Logits match to rtol = atol = 1e-4: torch and XLA on
the CPU differ in rsqrt and in summation order.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from brevitas_tpu import graph as JG
from brevitas_tpu.models.fc import FC as JaxFC
from brevitas_tpu.nn import QuantLinear as JaxQuantLinear
from brevitas_tpu.quant import presets as jax_presets
from brevitas_tpu.quant.quantizers import ActQuantizer as JaxActQuantizer
from brevitas_tpu.utils import eval_mode as jax_eval_mode
from brevitas_tpu_torch import graph as PG
from brevitas_tpu_torch.examples import serve as port_serve
from brevitas_tpu_torch.graph.convert_int import (
    Int8InferenceLinear,
    WeightOnlyInt4InferenceLinear,
)
from brevitas_tpu_torch.interop import load_jax_state
from brevitas_tpu_torch.models.fc import FC as PortFC
from brevitas_tpu_torch.nn import QuantLinear as PortQuantLinear
from brevitas_tpu_torch.quant import presets as port_presets
from brevitas_tpu_torch.quant.quantizers import ActQuantizer as PortActQuantizer

torch.set_num_threads(1)

WIDTHS = (64, 64)
MODES = {  # mode -> (bit width, frozen input quantizers, serving twin)
    "int8_frozen": (8, True, Int8InferenceLinear),
    "int8_carried": (8, False, Int8InferenceLinear),
    "w4a16": (4, False, WeightOnlyInt4InferenceLinear),
}


def jax_state_arrays(model) -> dict:
    """The JAX model's nnx state flattened to numpy arrays by dot path (its
    random-number keys have no numpy form and no counterpart)."""
    return {".".join(map(str, path)): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model))
            if path[0] != "rngs"}


def build_pair(mode):
    bits, frozen, _ = MODES[mode]
    kw = dict(weight_bit_width=bits, act_bit_width=bits, in_bit_width=bits,
              out_features=WIDTHS, dropout=0.0)
    jm = JaxFC(rngs=nnx.Rngs(0), **kw)
    pm = PortFC(device="cpu", **kw)
    if frozen:
        for _, mod in JG.named_modules(jm):
            if isinstance(mod, JaxQuantLinear):
                mod.input_quant = JaxActQuantizer(
                    jax_presets.Int8ActPerTensorFloat.let(collect_stats_steps=1))
        for mod in pm.modules():
            if isinstance(mod, PortQuantLinear):
                mod.input_quant = PortActQuantizer(
                    port_presets.Int8ActPerTensorFloat.let(collect_stats_steps=1))
    load_jax_state(pm, jax_state_arrays(jm))
    return jm, pm


def serve_recipe(jm, pm):
    """serve.py's recipe in both packages: calibrate on one batch, eval,
    convert."""
    calib = np.random.default_rng(1).random((64, 28, 28, 1), dtype=np.float32)
    jm(jnp.asarray(calib))
    with torch.no_grad():
        pm(torch.from_numpy(calib))
    jax_eval_mode(jm)
    pm.eval()


def forward_with_inputs(m, x, as_array):
    """FC's eval forward, returning the logits and the input of each linear
    (QuantTensors from the activation quantizers)."""
    inputs = []
    x = m.input_quant(2.0 * x.reshape(x.shape[0], -1) - 1.0)
    for i in range(0, len(m.hidden), 3):
        inputs.append(x)
        x = m.hidden[i + 2](m.hidden[i + 1](m.hidden[i](x)))
    inputs.append(x)
    return as_array(m.norm(m.head(x))), inputs


def twin_codes(twin, qt, numpy_of):
    """(integer codes, value before rounding) at a serving layer's input:
    the frozen input grid when the twin has one, else the carried grid."""
    value, scale = numpy_of(qt.value), numpy_of(qt.scale)
    x_scale = getattr(twin, "x_scale", None)
    if x_scale is not None:
        pre = value / numpy_of(x_scale) + twin.x_zp
        return np.clip(np.round(pre), twin.x_lo, twin.x_hi), pre
    pre = value / scale
    return np.round(pre), pre


def assert_codes_match(port_codes, jax_codes, jax_pre, what):
    mismatch = port_codes != jax_codes
    frac = np.abs(jax_pre - np.floor(jax_pre) - 0.5)
    assert np.all(frac[mismatch] <= 1e-4), (
        f"{what}: {int(mismatch.sum())} codes differ away from a .5 tie")


@pytest.mark.parametrize("mode", list(MODES))
def test_serving_matches_jax(mode):
    jm, pm = build_pair(mode)
    serve_recipe(jm, pm)
    linears = [0, 3, "head"]
    if MODES[mode][1]:
        for idx in linears:
            jl = jm.head if idx == "head" else jm.hidden[idx]
            pl = pm.head if idx == "head" else pm.hidden[idx]
            np.testing.assert_array_equal(
                pl.input_quant.scaling.buffer.numpy(),
                np.asarray(jl.input_quant.scaling.buffer[...]),
                err_msg=f"calibrated input scale of linear {idx}")
    JG.convert_integer_inference(jm)
    PG.convert_integer_inference(pm)
    twin_type = MODES[mode][2]
    assert all(isinstance(pm.head if i == "head" else pm.hidden[i], twin_type)
               for i in linears)

    x = np.random.default_rng(0).random((16, 28, 28, 1), dtype=np.float32)
    jax_logits, jax_inputs = forward_with_inputs(jm, jnp.asarray(x), np.asarray)
    with torch.no_grad():
        port_logits, port_inputs = forward_with_inputs(
            pm, torch.from_numpy(x), lambda t: t.numpy())
    for idx, jq, pq in zip(linears, jax_inputs, port_inputs):
        jt = jm.head if idx == "head" else jm.hidden[idx]
        pt = pm.head if idx == "head" else pm.hidden[idx]
        jc, jpre = twin_codes(jt, jq, np.asarray)
        pc, _ = twin_codes(pt, pq, lambda t: t.detach().numpy())
        assert_codes_match(pc, jc, jpre, f"{mode} input codes of linear {idx}")
    assert port_logits.shape == (16, 10) and np.all(np.isfinite(port_logits))
    np.testing.assert_allclose(port_logits, jax_logits, rtol=1e-4, atol=1e-4)


def test_load_jax_state_rejects_unknown_paths():
    _, pm = build_pair("int8_carried")
    with pytest.raises(AttributeError):
        load_jax_state(pm, {"hidden.0.nonexistent.weight": np.zeros(3, np.float32)})
    with pytest.raises(ValueError):
        load_jax_state(pm, {"hidden.0.weight": np.zeros((3, 3), np.float32)})


@pytest.mark.parametrize("extra", [[], ["--float"]])
def test_serve_main_on_cpu(capsys, extra):
    out = port_serve.main(["--requests", "40", "--batch-size", "16", "--device", "cpu",
                           *extra])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert (line["requests"], line["batches"], line["devices"]) == (40, 3, 1)
    assert line["integer_path"] is (not extra) and line["throughput_rps"] > 0


def test_fc_dropout_keeps_the_quant_grid():
    """Training-mode dropout zeroes codes and moves 1/keep into the scale, so
    the surviving codes are the undropped ones."""
    kw = dict(weight_bit_width=8, act_bit_width=8, in_bit_width=8, out_features=WIDTHS,
              device="cpu", generator=torch.Generator().manual_seed(3))
    dropped, plain = PortFC(dropout=0.5, **kw), PortFC(dropout=0.0, **kw)
    x = torch.from_numpy(np.random.default_rng(4).random((32, 784), dtype=np.float32))
    with torch.no_grad():
        qd = dropped._dropout(dropped.input_quant(x))
        qp = plain.input_quant(x)
    kept = qd.value != 0
    assert 0.3 < float(kept.float().mean()) < 0.7
    assert torch.equal(qd.int()[kept], qp.int()[kept])
    assert float(qd.scale) == float(qp.scale) / 0.5


def test_serve_main_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_serve.main(["--requests", "4", "--batch-size", "4"])
