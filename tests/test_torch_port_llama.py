"""The port's Llama serving slice against the JAX package's, end to end.

A tiny QuantLlama (vocab 64, dim 64, depth 2, 4 heads, T = 10) is built in
JAX, calibrated there with one train-mode forward (as ``bench.py``'s Llama
legs do), and its state carried into the port with ``load_jax_state``. Two
models: multi-head attention with the int8 KV cache, and grouped-query
attention (2 KV heads) with a 4-bit K/V grid, whose serving twin packs the
decode cache two positions per byte. Both packages then run the fake-quant
forward, ``convert_integer_inference``, the causal prefill of the integer
twin and six greedy decode steps. The JAX side runs each of its forward and
decode functions under one ``nnx.jit``, which halves its compile time.

Tolerances: logits rtol = atol = 1e-4, the serving tests' bound. torch and
XLA on the CPU may differ in the last bit of a float32 matmul, RoPE's
sin/cos, silu and RMSNorm's rsqrt; after the quantizers such a bit can flip
an integer code at a .5 tie, which would show as a difference of a code
step and fail here. At these seeds none occurs: the logits and the decode
caches are equal bit for bit. The port's own calibration from the same
start matches JAX's scales to 1e-6 relative: the input of the SwiGLU down
projection differs in the last bit (silu in float64 in the port, float32 in
XLA), which moves its percentile by an ulp. The port's decode
matches its own full forward at 1e-4, the JAX package's own check
(``tests/test_llama.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from brevitas_tpu import graph as JG
from brevitas_tpu.models.llama import QuantLlama as JaxLlama
from brevitas_tpu.utils import eval_mode as jax_eval_mode
from brevitas_tpu_torch import config as port_config
from brevitas_tpu_torch import graph as PG
from brevitas_tpu_torch.graph.convert_int import Int8InferenceAttention, Int8InferenceLinear
from brevitas_tpu_torch.interop import load_jax_state
from brevitas_tpu_torch.kernels import unpack_kv_halves
from brevitas_tpu_torch.models import QuantLlama as PortLlama
from brevitas_tpu_torch.nn import QuantLinear as PortQuantLinear

torch.set_num_threads(1)

DIMS = dict(vocab_size=64, dim=64, depth=2, num_heads=4)
MODELS = {"mha_int8kv": {}, "gqa_int4kv": dict(num_kv_heads=2, kv_bit_width=4)}
B, T, STEPS = 2, 10, 6


def jax_state_arrays(model) -> dict:
    return {".".join(map(str, path)): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model)) if path[0] != "rngs"}


def port_array(model, path: str) -> np.ndarray:
    owner_path, _, name = path.rpartition(".")
    owner = model.get_submodule(owner_path)
    t = getattr(owner, name).detach()
    return (t.t() if isinstance(owner, PortQuantLinear) and name == "weight" else t).numpy()


_jax_forward = nnx.jit(lambda m, ids: m(ids))
_jax_decode = nnx.jit(lambda m, ids, caches, pos: m.decode_step(ids, caches, pos))


def _close(port, jax_out):
    np.testing.assert_allclose(np.asarray(port), np.asarray(jax_out), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", params=list(MODELS))
def run(request):
    """Both packages through the whole slice; every result kept for the tests."""
    kw = MODELS[request.param]
    ids = np.random.default_rng(0).integers(0, DIMS["vocab_size"], (B, T)).astype(np.int32)
    jm = JaxLlama(bit_width=8, rngs=nnx.Rngs(0), **DIMS, **kw)
    pm = PortLlama(device="cpu", **DIMS, **kw)
    pm_own = PortLlama(device="cpu", **DIMS, **kw)
    load_jax_state(pm_own, jax_state_arrays(jm))
    _jax_forward(jm, jnp.asarray(ids))  # calibration: one train-mode forward
    calibrated = jax_state_arrays(jm)
    load_jax_state(pm, calibrated)
    ids_t = torch.from_numpy(ids).long()
    r = {"name": request.param, "jm": jm, "pm": pm, "ids": ids, "calibrated": calibrated}
    with torch.no_grad():
        pm_own(ids_t)  # the port's own calibration from the same start
        r["own"] = {p: port_array(pm_own, p) for p in calibrated}
        jax_eval_mode(jm)
        pm.eval()
        r["fake"] = (pm(ids_t).numpy(), np.asarray(_jax_forward(jm, jnp.asarray(ids))))
        JG.convert_integer_inference(jm)
        PG.convert_integer_inference(pm)
        r["int"] = (pm(ids_t).numpy(), np.asarray(_jax_forward(jm, jnp.asarray(ids))))
        jc, pc = jm.init_decode_caches(B, T), pm.init_decode_caches(B, T)
        r["steps"] = []
        for t in range(STEPS):
            lj, jc = _jax_decode(jm, jnp.asarray(ids[:, t:t + 1]), jc, jnp.int32(t))
            lp, pc = pm.decode_step(ids_t[:, t:t + 1], pc, t)
            r["steps"].append((lp.numpy(), np.asarray(lj)))
        r["caches"] = (pc, jc)
    return r


def test_port_calibration_matches_jax(run):
    for path, want in run["calibrated"].items():
        np.testing.assert_allclose(run["own"][path], want, rtol=1e-6, atol=0, err_msg=path)


def test_fake_quant_logits_match_jax(run):
    port, jax_out = run["fake"]
    assert port.shape == (B, T, DIMS["vocab_size"]) and np.isfinite(port).all()
    _close(port, jax_out)


def test_integer_prefill_matches_jax(run):
    pm, jm = run["pm"], run["jm"]
    n_attn = sum(isinstance(m, Int8InferenceAttention) for m in pm.modules())
    n_lin = sum(isinstance(m, Int8InferenceLinear) for m in pm.modules())
    assert (n_attn, n_lin) == (2, 2 * 7 + 1)
    for pb, jb in zip(pm.blocks, jm.blocks):
        assert pb.attn.kv_int4 == jb.attn.kv_int4 == (run["name"] == "gqa_int4kv")
    _close(*run["int"])


def test_decode_steps_match_jax(run):
    for port, jax_out in run["steps"]:
        _close(port, jax_out)
    for (pk, pv), (jk, jv) in zip(*run["caches"]):
        for p, j in ((pk, jk), (pv, jv)):
            assert tuple(p.shape) == tuple(j.shape) and p.dtype == torch.int8
            np.testing.assert_array_equal(p.numpy(), np.asarray(j))
            # the written positions hold the codes and nothing else was touched
            codes = unpack_kv_halves(p) if run["name"] == "gqa_int4kv" else p
            limit = 8 if run["name"] == "gqa_int4kv" else 127
            assert int(codes[:, :STEPS].abs().max()) <= limit
            assert int(codes[:, STEPS:].abs().sum()) == 0


def test_port_decode_matches_full_forward(run):
    full = run["int"][0]
    for t, (port, _) in enumerate(run["steps"]):
        np.testing.assert_allclose(port[:, 0], full[:, t], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("max_len", [10, 255, 256, 300, 1024])
def test_cache_shapes_match_jax(run, max_len):
    for (pk, pv), (jk, jv) in zip(run["pm"].init_decode_caches(3, max_len),
                                  run["jm"].init_decode_caches(3, max_len)):
        assert tuple(pk.shape) == tuple(jk.shape) == tuple(pv.shape) == tuple(jv.shape)


def test_generate_matches_jax_greedy_decoding(run):
    """The port's ``generate`` against JAX's greedy loop (``QuantLlama.generate``'s
    steps, through the jitted decode compiled above)."""
    ids, jm = run["ids"], run["jm"]
    with torch.no_grad():
        port = run["pm"].generate(torch.from_numpy(ids[:, :3]).long(), num_tokens=4,
                                  max_len=T)
    caches, want = jm.init_decode_caches(B, T), []
    tok = jnp.asarray(ids[:, :1])
    for pos in range(6):
        logits, caches = _jax_decode(jm, tok, caches, jnp.int32(pos))
        tok = jnp.asarray(ids[:, pos + 1:pos + 2]) if pos < 2 else jnp.argmax(logits, -1)
        if pos >= 2:
            want.append(np.asarray(tok[:, 0]))
    np.testing.assert_array_equal(port.numpy(), np.stack(want, axis=1))


@pytest.mark.parametrize("policy,kv_bits,head_dim_min,packed", [
    ("auto", 4, 128, True),    # the model asked for a nibble grid
    ("auto", None, 128, False),
    ("0", 4, 128, False),
    ("1", 4, 128, True),
    ("1", None, 128, False),   # 8-bit codes do not fit a nibble
])
def test_int4_kv_policy(monkeypatch, policy, kv_bits, head_dim_min, packed):
    """config.INT4_KV_CACHE with the JAX package's semantics."""
    monkeypatch.setattr(port_config, "INT4_KV_CACHE", policy)
    monkeypatch.setattr(port_config, "INT4_KV_MIN_HEAD_DIM", head_dim_min)
    m = PortLlama(device="cpu", vocab_size=16, dim=32, depth=1, num_heads=2,
                  kv_bit_width=kv_bits)
    with torch.no_grad():
        m(torch.arange(8).reshape(1, 8))
    m.eval()
    PG.convert_integer_inference(m)
    assert m.blocks[0].attn.kv_int4 == packed


def test_load_jax_state_refuses_unknown_paths():
    m = PortLlama(device="cpu", vocab_size=16, dim=32, depth=1, num_heads=2)
    with pytest.raises((KeyError, AttributeError)):
        load_jax_state(m, {"blocks.3.attn.q_proj.weight": np.zeros((32, 32), np.float32)})
    with pytest.raises(KeyError):
        load_jax_state(m, {"blocks.0.attn.nothing": np.zeros((), np.float32)})
    with pytest.raises(ValueError):
        load_jax_state(m, {"final_norm.scale": np.zeros((31,), np.float32)})
