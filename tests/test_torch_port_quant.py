"""The port's quantization math and quantizers against the JAX package's,
on the same numpy inputs. Integer codes must match exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brevitas_tpu.core import quant as jax_quant
from brevitas_tpu.core import stats as jax_stats
from brevitas_tpu.nn import QuantIdentity as JaxQuantIdentity
from brevitas_tpu.quant import presets as jax_presets
from brevitas_tpu.quant import quantizers as jax_quantizers
from brevitas_tpu.utils import eval_mode as jax_eval_mode
from brevitas_tpu_torch.core import quant as port_quant
from brevitas_tpu_torch.core import stats as port_stats
from brevitas_tpu_torch.nn import QuantIdentity as PortQuantIdentity
from brevitas_tpu_torch.quant import presets as port_presets
from brevitas_tpu_torch.quant import quantizers as port_quantizers

torch.set_num_threads(1)


@pytest.mark.parametrize("bit_width,signed,narrow_range",
                         [(8.0, True, False), (8.0, True, True), (4.0, True, True),
                          (8.0, False, False), (4.0, False, True)])
def test_int_quant_matches_jax(rng, bit_width, signed, narrow_range):
    x = (rng.standard_normal(4096) * 2).astype(np.float32)
    # exact ties on the grid: x/scale lands on .5 for these entries
    x[:64] = (np.arange(64, dtype=np.float32) - 32.5) * np.float32(0.125)
    scale = np.float32(0.125) if bit_width == 4.0 else np.float32(0.0173)
    kw = dict(signed=signed, narrow_range=narrow_range)
    codes = port_quant.int_quant_to_int(torch.from_numpy(x), torch.tensor(scale), 0.0,
                                        bit_width, **kw).numpy()
    jax_codes = np.asarray(jax_quant.int_quant_to_int(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(0.0), jnp.asarray(bit_width), **kw))
    np.testing.assert_array_equal(codes, jax_codes)
    deq = port_quant.int_quant(torch.from_numpy(x), torch.tensor(scale), 0.0,
                               bit_width, **kw).numpy()
    jax_deq = np.asarray(jax_quant.int_quant(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(0.0), jnp.asarray(bit_width), **kw))
    np.testing.assert_array_equal(deq, jax_deq)
    thr = np.float32(1.7)
    np.testing.assert_array_equal(
        port_quant.rescaling_scale(torch.tensor(thr), bit_width, **kw).numpy(),
        np.asarray(jax_quant.rescaling_scale(jnp.asarray(thr), jnp.asarray(bit_width), **kw)))


@pytest.mark.parametrize("n,q", [(50176, 99.999), (1000, 50.0), (7, 99.999), (3, 1.0)])
def test_abs_percentile_matches_jax(rng, n, q):
    x = rng.standard_normal((2, n)).astype(np.float32)
    np.testing.assert_array_equal(
        port_stats.abs_percentile(torch.from_numpy(x), q).numpy(),
        np.asarray(jax_stats.abs_percentile(jnp.asarray(x), q)))


@pytest.mark.parametrize("steps", [1, 3])
def test_parameter_from_runtime_stats_scaling_matches_jax(rng, steps):
    cfg_kw = dict(collect_stats_steps=steps)
    jax_cfg = jax_presets.Int8ActPerTensorFloat.let(**cfg_kw)
    port_cfg = port_presets.Int8ActPerTensorFloat.let(**cfg_kw)
    jax_s = jax_quantizers.ParameterFromRuntimeStatsScaling(
        jax_cfg, jax_stats.stats_fn(jax_cfg.scaling_stats_op,
                                    high_percentile_q=jax_cfg.high_percentile_q))
    port_s = port_quantizers.ParameterFromRuntimeStatsScaling(
        port_cfg, port_stats.stats_fn(port_cfg.scaling_stats_op,
                                      high_percentile_q=port_cfg.high_percentile_q))
    # The first collected stat is exact. The EMA steps after it run inside
    # the JAX package's lax.cond, where XLA on the CPU contracts
    # buf * 0.9 + 0.1 * stat into an FMA; the port rounds each step, so
    # from there on the two agree to one float32 ulp (2**-23 relative).
    for step in range(steps + 2):
        x = (rng.standard_normal((1, 777)) * (1 + step)).astype(np.float32)
        got = port_s(torch.from_numpy(x)).detach().numpy()
        want = np.asarray(jax_s(jnp.asarray(x)))
        assert int(port_s.counter) == int(jax_s.counter[...])
        pairs = [(got, want), (port_s.buffer.numpy(), np.asarray(jax_s.buffer[...])),
                 (port_s.value.detach().numpy(), np.asarray(jax_s.value[...]))]
        for a, b in pairs:
            if step == 0:
                np.testing.assert_array_equal(a, b, err_msg=f"training step {step}")
            else:
                np.testing.assert_allclose(a, b, rtol=2**-23, atol=0,
                                           err_msg=f"training step {step}")
    jax_s.training = False
    port_s.eval()
    np.testing.assert_allclose(port_s(None).detach().numpy(), np.asarray(jax_s(None)),
                               rtol=2**-23, atol=0)


def test_eval_reads_the_buffer_after_one_calibration_step(rng):
    """serve.py's calibration: steps=1, one training call, then eval serves
    the collected buffer (counter 1 <= steps), not the untouched value."""
    cfg = port_presets.Int8ActPerTensorFloat.let(collect_stats_steps=1)
    s = port_quantizers.ParameterFromRuntimeStatsScaling(
        cfg, port_stats.stats_fn(cfg.scaling_stats_op,
                                 high_percentile_q=cfg.high_percentile_q))
    x = torch.from_numpy(rng.standard_normal((1, 500)).astype(np.float32) * 5)
    s(x)
    s.eval()
    assert int(s.counter) == 1 and float(s.value.detach()) == 1.0
    assert float(s(None)) == float(s.buffer) != 1.0


def test_quant_identity_matches_jax(rng):
    jax_q = JaxQuantIdentity(jax_presets.Int8ActPerTensorFloat.let(collect_stats_steps=2),
                             return_quant_tensor=True)
    port_q = PortQuantIdentity(port_presets.Int8ActPerTensorFloat.let(collect_stats_steps=2),
                               return_quant_tensor=True)
    batches = [(rng.standard_normal((8, 300)) * 3).astype(np.float32) for _ in range(3)]
    for x in batches:
        got, want = port_q(torch.from_numpy(x)), jax_q(jnp.asarray(x))
        np.testing.assert_array_equal(got.value.detach().numpy(), np.asarray(want.value))
    jax_eval_mode(jax_q)
    port_q.eval()
    got, want = port_q(torch.from_numpy(batches[0])), jax_q(jnp.asarray(batches[0]))
    np.testing.assert_array_equal(got.scale.detach().numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.int().numpy(), np.asarray(want.int()))
    assert got.int().dtype == torch.int8 and got.bit_width == 8.0 and got.signed
