"""The port's QuantTransformer and ``serve.py --decode`` against the JAX
package's.

A tiny QuantTransformer (vocab 64, dim 64, depth 2, 4 heads, max_len 24) is
built in JAX with serve.py's decode-mode quantizers (two calibration
steps), its state carried into the port with ``load_jax_state``, and both
packages calibrate it with two passes under ``calibration_mode``, convert it
and decode. Two models: the int8 KV cache, and 4-bit K/V grids whose
serving twin packs the cache two positions per byte (``--kv-bits 4``).

Tolerances, each with its reason:
- LayerNorm: 2e-6 relative. The port forms the mean, variance and rsqrt in
  float64 and rounds once; XLA sums and takes rsqrt in float32;
- quantizer scales after calibration: 1e-6 relative, counters exact. The
  quantizers behind a LayerNorm see inputs that differ in the last bit
  (LayerNorm above), already after the first pass, and the second pass's
  running average is one FMA under XLA on the CPU but two roundings in the
  port (ROADMAP Queue 3);
- QuantReLU codes and scales: exact;
- logits: rtol = atol = 1e-4, the serving tests' bound (float32 matmul
  order, LayerNorm above); greedy tokens: exact.
"""

import argparse
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from brevitas_tpu import config as jax_config
from brevitas_tpu import graph as JG
from brevitas_tpu.models.transformer import QuantTransformer as JaxTransformer
from brevitas_tpu.nn import QuantReLU as JaxQuantReLU
from brevitas_tpu.quant import presets as jax_presets
from brevitas_tpu.quant.quantizers import ActQuantizer as JaxActQuantizer
from brevitas_tpu.utils import eval_mode as jax_eval_mode
from brevitas_tpu_torch import config as port_config
from brevitas_tpu_torch import graph as PG
from brevitas_tpu_torch.examples import serve as port_serve
from brevitas_tpu_torch.graph.convert_int import Int8InferenceAttention, Int8InferenceLinear
from brevitas_tpu_torch.interop import load_jax_state
from brevitas_tpu_torch.models import QuantTransformer as PortTransformer
from brevitas_tpu_torch.models.common import LayerNorm
from brevitas_tpu_torch.nn import QuantReLU as PortQuantReLU
from brevitas_tpu_torch.quant import presets as port_presets
from brevitas_tpu_torch.quant.quantizers import ActQuantizer as PortActQuantizer

torch.set_num_threads(1)

DIMS = dict(vocab_size=64, dim=64, depth=2, num_heads=4, max_len=24)
B, T, STEPS = 2, 10, 6


def port_array(model, path: str) -> np.ndarray:
    owner_path, _, name = path.rpartition(".")
    return getattr(model.get_submodule(owner_path), name).detach().numpy().copy()


def jax_state_arrays(model) -> dict:
    return {".".join(map(str, path)): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model)) if path[0] != "rngs"}


def test_layer_norm_matches_flax(rng):
    jn = nnx.LayerNorm(48, rngs=nnx.Rngs(0))
    jn.scale[...] = jnp.asarray(rng.uniform(0.5, 1.5, 48).astype(np.float32))
    jn.bias[...] = jnp.asarray(rng.standard_normal(48).astype(np.float32))
    pn = LayerNorm(48)
    load_jax_state(pn, jax_state_arrays(jn))
    x = (rng.standard_normal((3, 7, 48)) * 4 + 2).astype(np.float32)
    with torch.no_grad():
        port = pn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(port, np.asarray(jn(jnp.asarray(x))), rtol=2e-6, atol=2e-6)


def test_layer_norm_of_a_constant_row_is_its_bias():
    """The variance E[x^2] - E[x]^2 is clamped at 0, as in flax."""
    pn = LayerNorm(8)
    with torch.no_grad():
        pn.bias.copy_(torch.arange(8.0))
        out = pn(torch.full((2, 8), 3.0))
    assert torch.equal(out, torch.arange(8.0).expand(2, 8))


def test_quant_relu_codes_match_jax(rng):
    cfg = "Uint8ActPerTensorFloat"
    jr = JaxQuantReLU(getattr(jax_presets, cfg).let(collect_stats_steps=1),
                      return_quant_tensor=True)
    pr = PortQuantReLU(getattr(port_presets, cfg).let(collect_stats_steps=1),
                       return_quant_tensor=True)
    calib, x = (rng.standard_normal((2, 64, 32)) * 2).astype(np.float32)
    jr(jnp.asarray(calib))
    jax_eval_mode(jr)
    with torch.no_grad():
        pr(torch.from_numpy(calib))
        pr.eval()
        pq = pr(torch.from_numpy(x))
    jq = jr(jnp.asarray(x))
    assert not pq.signed and pq.int().dtype == torch.uint8
    np.testing.assert_array_equal(pq.scale.numpy(), np.asarray(jq.scale))
    np.testing.assert_array_equal(pq.int().numpy(), np.asarray(jq.int()))


def _build(kv_bits):
    """serve.py's decode-mode model in both packages, the port carrying the
    JAX state."""
    aq = dict(collect_stats_steps=2)
    jm = JaxTransformer(**DIMS, act_quant=jax_presets.Int8ActPerTensorFloat.let(**aq),
                        uact_quant=jax_presets.Uint8ActPerTensorFloat.let(**aq),
                        rngs=nnx.Rngs(0))
    pm = PortTransformer(**DIMS, act_quant=port_presets.Int8ActPerTensorFloat.let(**aq),
                         uact_quant=port_presets.Uint8ActPerTensorFloat.let(**aq),
                         device="cpu")
    if kv_bits:
        for jb, pb in zip(jm.blocks, pm.blocks):
            for name in ("k_quant", "v_quant"):
                setattr(jb.attn, name, JaxActQuantizer(
                    jax_presets.Int8ActPerTensorFloat.let(bit_width=4.0, **aq)))
                setattr(pb.attn, name, PortActQuantizer(
                    port_presets.Int8ActPerTensorFloat.let(bit_width=4.0, **aq)))
    load_jax_state(pm, jax_state_arrays(jm))
    return jm, pm


_jax_forward = nnx.jit(lambda m, ids: m(ids))
_jax_decode = nnx.jit(lambda m, ids, caches, pos: m.decode_step(ids, caches, pos))


@pytest.fixture(scope="module", params=[0, 4], ids=["int8kv", "int4kv"])
def run(request):
    """Both packages through calibration, conversion and decoding."""
    kv_bits = request.param
    ids = np.random.default_rng(0).integers(0, DIMS["vocab_size"], (B, T)).astype(np.int32)
    jm, pm = _build(kv_bits)
    ids_t = torch.from_numpy(ids).long()
    with JG.calibration_mode(jm):
        _jax_forward(jm, jnp.asarray(ids))
        _jax_forward(jm, jnp.roll(jnp.asarray(ids), 1, axis=1))
    jax_eval_mode(jm)
    with torch.no_grad(), PG.calibration_mode(pm):
        pm(ids_t)
        pm(torch.roll(ids_t, 1, dims=1))
    pm.eval()
    calibrated = {path: want for path, want in jax_state_arrays(jm).items()
                  if ".scaling." in path}
    r = {"kv_bits": kv_bits, "jm": jm, "pm": pm, "ids": ids, "calibrated": calibrated,
         "port_calibrated": {path: port_array(pm, path) for path in calibrated},
         "port_modes": [(m.training, getattr(m, "disable_quant", False))
                        for m in pm.modules()]}
    policy = (jax_config.INT4_KV_CACHE, port_config.INT4_KV_CACHE)
    if kv_bits:  # serve.py's --kv-bits 4 asks for the packed cache
        jax_config.INT4_KV_CACHE = port_config.INT4_KV_CACHE = "1"
    try:
        with torch.no_grad():
            r["fake"] = (pm(ids_t).numpy(), np.asarray(_jax_forward(jm, jnp.asarray(ids))))
            JG.convert_integer_inference(jm)
            PG.convert_integer_inference(pm)
    finally:
        jax_config.INT4_KV_CACHE, port_config.INT4_KV_CACHE = policy
    with torch.no_grad():
        r["int"] = (pm(ids_t).numpy(), np.asarray(_jax_forward(jm, jnp.asarray(ids))))
        jc, pc = jm.init_decode_caches(B, DIMS["max_len"]), pm.init_decode_caches(B, DIMS["max_len"])
        r["steps"] = []
        for t in range(STEPS):
            lj, jc = _jax_decode(jm, jnp.asarray(ids[:, t:t + 1]), jc, jnp.int32(t))
            lp, pc = pm.decode_step(ids_t[:, t:t + 1], pc, t)
            r["steps"].append((lp.numpy(), np.asarray(lj)))
        r["caches"] = (pc, jc)
    return r


def _close(port, jax_out):
    np.testing.assert_allclose(np.asarray(port), np.asarray(jax_out), rtol=1e-4, atol=1e-4)


def test_calibration_mode_matches_jax(run):
    """Two passes of the float forward collect the same statistics; on exit
    each buffer becomes the learned scale and the counters close. Counters
    match exactly; scales to 1e-6 relative, as in the Llama slice's
    calibration test: the float forward differs in the last bits (LayerNorm
    in float64 here, float32 matmul order), which can move a percentile by
    an ulp, and the second pass's running average ``buf * 0.9 + 0.1 * stat``
    runs inside ``lax.cond`` in the JAX package, where XLA on the CPU
    contracts it into one FMA while the port rounds each step (ROADMAP
    Queue 3)."""
    n_scales = 0
    for path, want in run["calibrated"].items():
        got = run["port_calibrated"][path]
        if path.endswith(".counter"):
            np.testing.assert_array_equal(got, want, err_msg=path)
            assert int(got) == 3, path  # steps + 1: collection closed
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=path)
            n_scales += 1
    # buffer and value of 13 activation quantizers a block and the head's
    assert n_scales == 2 * (2 * 13 + 1)
    # quantization is back on, and eval mode as before the context
    assert run["port_modes"] == [(False, False)] * len(run["port_modes"])


def test_fake_quant_logits_match_jax(run):
    port, jax_out = run["fake"]
    assert port.shape == (B, T, DIMS["vocab_size"]) and np.isfinite(port).all()
    _close(port, jax_out)


def test_integer_forward_matches_jax(run):
    pm, jm = run["pm"], run["jm"]
    n_attn = sum(isinstance(m, Int8InferenceAttention) for m in pm.modules())
    n_lin = sum(isinstance(m, Int8InferenceLinear) for m in pm.modules())
    assert (n_attn, n_lin) == (2, 2 * 6 + 1)
    for pb, jb in zip(pm.blocks, jm.blocks):
        assert pb.attn.kv_int4 == jb.attn.kv_int4 == bool(run["kv_bits"])
    _close(*run["int"])


def test_decode_steps_match_jax(run):
    for port, jax_out in run["steps"]:
        _close(port, jax_out)
    for (pk, pv), (jk, jv) in zip(*run["caches"]):
        for p, j in ((pk, jk), (pv, jv)):
            assert tuple(p.shape) == tuple(j.shape) and p.dtype == torch.int8
            np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    # and the port's decode its own full forward
    for t, (port, _) in enumerate(run["steps"]):
        np.testing.assert_allclose(port[:, 0], run["int"][0][:, t], rtol=1e-4, atol=1e-4)


def test_generate_matches_jax(run):
    ids, jm = run["ids"], run["jm"]
    with torch.no_grad():
        port = run["pm"].generate(torch.from_numpy(ids[:, :3]).long(), num_tokens=4,
                                  max_len=DIMS["max_len"])
    # QuantTransformer.generate's steps, through the jitted decode above
    caches, want = jm.init_decode_caches(B, DIMS["max_len"]), []
    tok = jnp.asarray(ids[:, :1])
    for pos in range(6):
        logits, caches = _jax_decode(jm, tok, caches, jnp.int32(pos))
        tok = jnp.asarray(ids[:, pos + 1:pos + 2]) if pos < 2 else jnp.argmax(logits, -1)
        if pos >= 2:
            want.append(np.asarray(tok[:, 0]))
    np.testing.assert_array_equal(port.numpy(), np.stack(want, axis=1))


# the fields of the JAX package's decode_demo line (brevitas_tpu/examples/serve.py)
DECODE_FIELDS = {"mode", "tokens", "tokens_per_sec", "ms_per_token_step", "kv_bits",
                 "kv_cache_bytes", "integer_path"}


@pytest.mark.parametrize("kv_bits", [0, 4])
def test_serve_decode_on_cpu(capsys, kv_bits):
    out = port_serve.main(["--decode", "--device", "cpu", "--decode-tokens", "8",
                           "--decode-batch", "3", "--decode-dim", "32",
                           "--kv-bits", str(kv_bits)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out and set(line) == DECODE_FIELDS
    assert (line["mode"], line["tokens"], line["kv_bits"]) == ("decode", 24, kv_bits)
    assert line["integer_path"] is True and line["tokens_per_sec"] > 0
    # batch 3 x 4 KV heads x (8 + 8) positions x head_dim 8, per block, K and V;
    # the packed cache holds two positions per byte
    assert line["kv_cache_bytes"] == 2 * 2 * 3 * 4 * 16 * 8 // (2 if kv_bits else 1)
    assert port_config.INT4_KV_CACHE == "auto"  # the policy is restored


def test_serve_decode_model_is_calibrated_and_converted():
    ns = argparse.Namespace(decode_tokens=8, decode_batch=2, decode_dim=32, kv_bits=4)
    model, ids, max_len = port_serve.build_decode_model(ns, torch.device("cpu"))
    assert tuple(ids.shape) == (2, 16) and max_len == 16
    assert all(blk.attn.kv_int4 for blk in model.blocks)
    counters = [m.counter for m in model.modules() if hasattr(m, "counter")]
    assert counters and all(int(c) == 3 for c in counters)
    with torch.no_grad():
        toks = model.generate(ids[:, :1], 4, max_len)
    assert tuple(toks.shape) == (2, 4) and int(toks.max()) < 256


def test_serve_decode_refuses_the_fake_quant_model():
    with pytest.raises(NotImplementedError):
        port_serve.main(["--decode", "--float", "--device", "cpu"])
