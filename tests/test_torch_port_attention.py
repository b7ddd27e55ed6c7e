"""The port's int8 attention functions against the JAX package's.

The plain PyTorch versions (what the port's wrappers run on a CPU tensor)
are held against the Pallas kernels, run in interpret mode as
``tests/test_int4_kv.py`` runs them, and against the JAX package's plain
paths, on the same numpy codes. Codes span the full range (int8 in
[-127, 127], packed bytes in [-128, 127]); T and D are ragged (D = 12, 33;
Tq != Tk); scores have a spread of a few units, so that the softmax and the
probability grid are exercised. The CUDA kernels themselves run only on the
card (``chip_smoke.py``).

Tolerances: the attention outputs are exact. The integer products are exact
in both packages and both take the softmax as exp(s - max) / sum over the
same float32 values; a summation order that differed in the last bit could
flip a probability code across a .5 boundary, and would show here as a
difference of 128 * p_scale * v_scale or less in the rows concerned (none
occurs at these seeds). The one deviation: the Pallas ``int8_attention``
softmaxes a fully masked row (Tk < Tq, causal) over its 128-column padding
(p = 1/128, not 1/Tk); the port follows the JAX package's plain path there,
and those rows are left out of the comparison with the Pallas kernel only.
Packing is bit for bit.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from brevitas_tpu_torch.kernels import (
    int4kv_decode_attention,
    int4kv_decode_attention_reference,
    int8_attention,
    int8_attention_dispatch,
    int8_attention_reference,
    int8_decode_attention,
    pack_kv_halves,
    unpack_kv_halves,
    update_kv_packed,
)
from brevitas_tpu_torch.kernels.int8_attention import int8_attention_plan

# the JAX package's kernels module exports the functions under the module's name
jax_attn = importlib.import_module("brevitas_tpu.kernels.int8_attention")

torch.set_num_threads(1)

# (BH, Tq, Tk, D, causal, also against the Pallas kernel in interpret mode)
PREFILL_CASES = [
    (3, 24, 24, 16, True, True),
    (2, 24, 24, 16, False, False),
    (3, 20, 9, 12, True, True),     # Tq > Tk: rows 0..10 fully masked
    (2, 9, 20, 33, True, False),    # Tq < Tk: rectangular causal offset
    (2, 17, 23, 8, False, False),
    # the CUDA kernel's edges: 64 query rows a CTA and 64 keys a tile, D
    # padded to 32 for QK^T and to 64-column chunks for PV
    (2, 70, 70, 40, True, False),   # two row blocks and key tiles, D 40
    (2, 80, 40, 64, True, False),   # Tq > Tk over a row block: rows 0..39 fully masked
    (2, 30, 100, 96, False, False),  # non-causal, a ragged second key tile, D 96
    (1, 16, 24, 256, True, False),  # D 256: four output chunks
]
P_SCALE, V_SCALE = np.float32(0.25 / 255), np.float32(0.02)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _codes(rng, shape, lo=-127, hi=128):
    return rng.integers(lo, hi, shape).astype(np.int8)


def _qk_scale(d):
    # scores of standard deviation ~3 for uniform int8 codes
    return np.float32(3.0 / (127 ** 2 / 3 * d ** 0.5))


@pytest.mark.parametrize("bh,tq,tk,d,causal,pallas", PREFILL_CASES)
def test_int8_attention_matches_jax(rng, bh, tq, tk, d, causal, pallas):
    q, k, v = _codes(rng, (bh, tq, d)), _codes(rng, (bh, tk, d)), _codes(rng, (bh, tk, d))
    qk = _qk_scale(d)
    port = int8_attention(_t(q), _t(k), _t(v), _t(qk), _t(P_SCALE), _t(V_SCALE),
                          causal=causal).numpy()
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.float32(qk),
             jnp.float32(P_SCALE), jnp.float32(V_SCALE))
    ref = np.asarray(jax_attn.int8_attention_reference(*jargs, causal=causal))
    np.testing.assert_array_equal(port, ref)
    seen = np.arange(tq) + tk - tq >= 0 if causal else np.ones(tq, bool)
    if pallas:
        with pltpu.force_tpu_interpret_mode():
            kernel = np.asarray(jax_attn.int8_attention(*jargs, causal=causal))
        np.testing.assert_array_equal(port[:, seen], kernel[:, seen])
    if not seen.all():  # a fully masked row attends uniformly over the Tk keys
        np.testing.assert_array_equal(
            port[:, ~seen], np.broadcast_to(port[:, :1], port[:, ~seen].shape))


def test_int8_attention_codes_are_the_softmax_grid(rng):
    bh, tq, tk, d = 2, 12, 12, 16
    q, k, v = _codes(rng, (bh, tq, d)), _codes(rng, (bh, tk, d)), _codes(rng, (bh, tk, d))
    qk = _qk_scale(d)
    out, codes = int8_attention(_t(q), _t(k), _t(v), _t(qk), _t(P_SCALE), _t(V_SCALE),
                                causal=True, return_codes=True)
    s = (q.astype(np.int64) @ k.astype(np.int64).transpose(0, 2, 1)).astype(np.float32) * qk
    s = np.where(np.tril(np.ones((tq, tk), bool)), s, np.finfo(np.float32).min / 2)
    p = np.asarray(jnp.exp(s - s.max(-1, keepdims=True)))
    p = p / p.sum(-1, keepdims=True)
    want = np.clip(np.round(p / P_SCALE), 0, 255)
    assert codes.dtype == torch.uint8
    # numpy's float32 sum order is not XLA's: codes agree but at .5 ties
    assert np.abs(codes.numpy() - want).max() <= 1
    assert (codes.numpy() != want).mean() < 1e-2
    pv = (codes.numpy().astype(np.float64) @ v.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(out.numpy(), pv * (P_SCALE * V_SCALE))


def test_int8_attention_dispatch_gqa_matches_jax(rng):
    """kv_groups reads KV row bh // groups, as JAX's copy-expanded codes do."""
    b, h, kvh, t, d = 2, 4, 2, 16, 16
    q = _codes(rng, (b * h, t, d))
    k, v = _codes(rng, (b * kvh, t, d)), _codes(rng, (b * kvh, t, d))
    scales = (np.float32(0.03), np.float32(0.02), V_SCALE, P_SCALE)
    port = int8_attention_dispatch(_t(q), _t(k), _t(v), *map(_t, scales), head_dim=d,
                                   causal=True, kv_groups=h // kvh).numpy()
    expand = lambda a: np.repeat(a.reshape(b, kvh, t, d), h // kvh, axis=1) \
        .reshape(b * h, t, d)  # noqa: E731
    ref = np.asarray(jax_attn.int8_attention_dispatch(
        jnp.asarray(q), jnp.asarray(expand(k)), jnp.asarray(expand(v)),
        *map(jnp.float32, scales), head_dim=d, causal=True))
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("groups,t,d", [(1, 70, 40), (2, 65, 64), (4, 40, 96)])
def test_int8_attention_kv_groups_match_jax(rng, groups, t, d):
    """kv_groups (1, 2 and 4 query heads a KV head) at the kernel's tile
    edges: the plain version against the JAX package's on copy-expanded
    codes."""
    b, kvh = 2, 2
    h = kvh * groups
    q = _codes(rng, (b * h, t, d))
    k, v = _codes(rng, (b * kvh, t, d)), _codes(rng, (b * kvh, t, d))
    args = (_t(_qk_scale(d)), _t(P_SCALE), _t(V_SCALE))
    port = int8_attention(_t(q), _t(k), _t(v), *args, causal=True, kv_groups=groups).numpy()
    expand = lambda a: np.repeat(a, groups, axis=0)  # noqa: E731
    ref = np.asarray(jax_attn.int8_attention_reference(
        jnp.asarray(q), jnp.asarray(expand(k)), jnp.asarray(expand(v)), jnp.float32(_qk_scale(d)),
        jnp.float32(P_SCALE), jnp.float32(V_SCALE), causal=True))
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("d,offset,plan", [
    (1, 0, "D64 kv:bytes"), (16, 0, "D64 kv:tma"), (40, 0, "D64 kv:bytes"),
    (48, 0, "D64 kv:tma"), (64, 0, "D64 kv:tma"), (64, 4, "D64 kv:bytes"),
    (65, 0, "D128 kv:bytes"), (128, 0, "D128 kv:tma"), (129, 0, "D192 kv:bytes"),
    (192, 0, "D192 kv:tma"), (193, 0, "D256 kv:bytes"), (256, 0, "D256 kv:tma")])
def test_int8_attention_plan(d, offset, plan):
    """The prefill kernel's variant at its boundaries: the head dim padded
    to 64-column output chunks, and TMA tiles only where a row is a
    multiple of 16 bytes and K and V start 16-byte aligned (a contiguous
    view at a 4-byte offset takes byte loads)."""
    q = torch.zeros((1, 4, d), dtype=torch.int8)
    kv = torch.zeros(offset + 8 * d, dtype=torch.int8)[offset:].reshape(1, 8, d)
    assert kv.is_contiguous()
    assert int8_attention_plan(q, kv, kv) == f"rows64 keys64 {plan}"


def test_pack_unpack_update_match_jax_bit_for_bit(rng):
    bh, length, l_half, d = 3, 13, 8, 12
    codes = _codes(rng, (bh, length, d), -8, 8)
    packed = pack_kv_halves(_t(codes), l_half)
    want = np.asarray(jax_attn.pack_kv_halves(jnp.asarray(codes), l_half))
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(unpack_kv_halves(packed).numpy()[:, :length], codes)
    np.testing.assert_array_equal(unpack_kv_halves(packed).numpy(),
                                  np.asarray(jax_attn.unpack_kv_halves(jnp.asarray(want))))
    for pos in (0, 5, 7, 8, 12, 15):
        tok = _codes(rng, (bh, 1, d), -8, 8)
        want = np.asarray(jax_attn.update_kv_packed(jnp.asarray(want), jnp.asarray(tok), pos))
        got = update_kv_packed(packed, _t(tok), pos)
        assert got is packed  # in place
        np.testing.assert_array_equal(packed.numpy(), want)


@pytest.fixture(scope="module")
def decode_case():
    rng = np.random.default_rng(7)
    bh, l_half, d = 2, 128, 64
    q = _codes(rng, (bh, 1, d))
    kp = rng.integers(-128, 128, (bh, l_half, d)).astype(np.int8)
    vp = rng.integers(-128, 128, (bh, l_half, d)).astype(np.int8)
    # q codes ~73 and nibbles ~4.6 in standard deviation: scores of deviation ~3
    scales = (np.float32(0.01), np.float32(3.0 / (73 * 4.6 * 0.01)), np.float32(0.1),
              P_SCALE)
    return q, kp, vp, scales, d


@pytest.mark.parametrize("pos", [0, 77, 127, 128, 200, 255])
def test_int4kv_decode_matches_jax(decode_case, pos):
    q, kp, vp, scales, d = decode_case
    port = int4kv_decode_attention(_t(q), _t(kp), _t(vp), pos, *map(_t, scales),
                                   head_dim=d).numpy()
    jargs = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), pos,
             *map(jnp.float32, scales))
    plain = np.asarray(jax_attn.int4kv_decode_attention(*jargs, head_dim=d,
                                                         use_pallas=False))
    np.testing.assert_array_equal(port, plain)
    if pos in (127, 128):  # the last low-nibble and the first high-nibble position
        with pltpu.force_tpu_interpret_mode():
            pallas = np.asarray(jax_attn.int4kv_decode_attention(*jargs, head_dim=d,
                                                                  use_pallas=True))
        np.testing.assert_array_equal(port, pallas)
    # the int8 cache path on the unpacked codes computes the same function
    k_cache, v_cache = unpack_kv_halves(_t(kp)), unpack_kv_halves(_t(vp))
    np.testing.assert_array_equal(
        int8_decode_attention(_t(q), k_cache, v_cache, pos, *map(_t, scales),
                              head_dim=d).numpy(), port)


# (BH, l_half, D, kv_groups): the head dims the decode kernel sizes its lanes
# by (40: ragged 4-byte words; 128: eight lanes a row) and grouped-query heads,
# at positions in the low half, at its last row, at the first high-half
# position and at the last one
DECODE_SHAPES = [(2, 24, 40, 1), (4, 24, 128, 2), (6, 13, 40, 3)]


@pytest.mark.parametrize("bh,l_half,d,groups", DECODE_SHAPES)
def test_int4kv_decode_head_dims_and_groups_match_jax(bh, l_half, d, groups):
    """The port takes the packed cache at its KV heads; the JAX package has
    no kv_groups here, so it gets the cache repeated per group."""
    rng = np.random.default_rng(11)
    q = _codes(rng, (bh, 1, d))
    kp = rng.integers(-128, 128, (bh // groups, l_half, d)).astype(np.int8)
    vp = rng.integers(-128, 128, (bh // groups, l_half, d)).astype(np.int8)
    # scores of deviation ~3, as in decode_case
    scales = (np.float32(0.01), np.float32(3.0 / (73 * 4.6 * 0.01 * (d / 64) ** 0.5)),
              np.float32(0.1), P_SCALE)
    jk, jv = (jnp.asarray(np.repeat(a, groups, axis=0)) for a in (kp, vp))
    for pos in (l_half // 2, l_half - 1, l_half, 2 * l_half - 1):
        port = int4kv_decode_attention(_t(q), _t(kp), _t(vp), pos, *map(_t, scales),
                                       head_dim=d, kv_groups=groups).numpy()
        plain = np.asarray(jax_attn.int4kv_decode_attention(
            jnp.asarray(q), jk, jv, pos, *map(jnp.float32, scales), head_dim=d,
            use_pallas=False))
        np.testing.assert_array_equal(port, plain, err_msg=f"pos {pos}")


def test_int8_decode_attention_gqa_matches_jax(rng):
    b, h, kvh, length, d = 2, 4, 2, 20, 16
    q = _codes(rng, (b * h, 1, d))
    k, v = _codes(rng, (b * kvh, length, d)), _codes(rng, (b * kvh, length, d))
    scales = (np.float32(0.03), np.float32(0.02), V_SCALE, P_SCALE)
    expand = lambda a: np.repeat(a.reshape(b, kvh, length, d), h // kvh, axis=1) \
        .reshape(b * h, length, d)  # noqa: E731
    for pos in (0, 11, 19):
        port = int8_decode_attention(_t(q), _t(k), _t(v), pos, *map(_t, scales),
                                     head_dim=d, kv_groups=2).numpy()
        ref = np.asarray(jax_attn.int8_decode_attention(
            jnp.asarray(q), jnp.asarray(expand(k)), jnp.asarray(expand(v)), pos,
            *map(jnp.float32, scales), head_dim=d))
        np.testing.assert_array_equal(port, ref)


def test_reference_functions_are_the_cpu_path(rng):
    q, k, v = _codes(rng, (2, 8, 16)), _codes(rng, (2, 8, 16)), _codes(rng, (2, 8, 16))
    args = (_t(q), _t(k), _t(v), _t(_qk_scale(16)), _t(P_SCALE), _t(V_SCALE))
    np.testing.assert_array_equal(int8_attention(*args, causal=True).numpy(),
                                  int8_attention_reference(*args, causal=True).numpy())
    kp = pack_kv_halves(_t(k[:, :, :]), 4)
    dargs = (_t(q[:, :1]), kp, kp, 5, _t(0.02), _t(0.03), _t(V_SCALE), _t(P_SCALE))
    np.testing.assert_array_equal(
        int4kv_decode_attention(*dargs, head_dim=16).numpy(),
        int4kv_decode_attention_reference(*dargs, head_dim=16).numpy())


def test_wrappers_refuse_devices_without_a_kernel():
    z = torch.zeros((2, 4, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        int8_attention(z, z, z, 1.0, 1.0, 1.0)
    with pytest.raises(ValueError):
        int4kv_decode_attention(z[:, :1], z, z, 0, 1.0, 1.0, 1.0, 1.0, head_dim=8)
