"""The port's serving GEMMs against the JAX package's.

The plain PyTorch versions (what the port's wrappers run on a CPU tensor)
are held against the Pallas kernels, run in interpret mode as
``tests/test_kernels.py`` runs them, and against their jnp references, on
the same numpy inputs. Weights span the full code range (int8 in
[-128, 127], int4 in [-8, 7]) so overflow and packing faults show; M, K and
N are odd or not tile multiples (784, 10, 1). The CUDA kernels themselves
run only on the card (``chip_smoke.py``).
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from brevitas_tpu.kernels import int4 as jax_int4
from brevitas_tpu.kernels import int_matmul as jax_int_matmul
from brevitas_tpu_torch.csrc import build
from brevitas_tpu_torch.kernels import (
    int4_weight_only_matmul,
    int4_weight_only_matmul_reference,
    int8_matmul,
    pack_int4_rows,
    unpack_int4_rows,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
EPILOGUES = [(False, None), (True, None), (False, "relu"), (True, "relu")]
# every epilogue at LFC's head shape, plus odd M/N and a K off the tile; the
# small ragged shapes of chip_smoke.py's kernels phase, which reach the CUDA
# launchers' masked byte loads (K 100, N 1, 3 and 10) and ragged last tiles
# in M, N, K and K/2 (M 1 and 37)
INT8_CASES = ([(16, 784, 10, *e) for e in EPILOGUES]
              + [(1, 784, 1, True, "relu"), (13, 100, 64, False, None),
                 (5, 100, 3, True, None), (37, 100, 10, False, "relu"),
                 (1, 100, 1, True, None)])
W4A16_CASES = ([(16, 784, 10, *e) for e in EPILOGUES]
               + [(1, 784, 1, True, "relu"), (37, 100, 3, True, "relu"),
                  (1, 784, 10, False, None)])


def _int8_case(rng, m, k, n, with_bias):
    x = rng.integers(-128, 128, (m, k), dtype=np.int8)
    w = rng.integers(-128, 128, (k, n), dtype=np.int8)
    xs = np.float32(rng.uniform(0.001, 0.05))
    ws = rng.uniform(0.001, 0.05, n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32) if with_bias else None
    return x, w, xs, ws, b


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("m,k,n,with_bias,act", INT8_CASES)
def test_int8_matmul_matches_jax_exactly(rng, m, k, n, with_bias, act):
    x, w, xs, ws, b = _int8_case(rng, m, k, n, with_bias)
    port = int8_matmul(_t(x), _t(w), _t(xs), _t(ws), _t(b), act=act).numpy()
    ref = np.asarray(jax_int_matmul.int8_matmul_reference(
        _j(x), _j(w), _j(xs), _j(ws), _j(b), act=act))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jax_int_matmul.int8_matmul(
            _j(x), _j(w), _j(xs), _j(ws), _j(b), act=act))
    np.testing.assert_array_equal(port, ref)
    if b is None:
        np.testing.assert_array_equal(port, pallas)
    else:
        # interpret mode runs the kernel under jit, and XLA on the CPU
        # contracts the epilogue's multiply and bias add into one FMA; the
        # eager reference and the port round each step, so the two differ
        # by the product's rounding at most
        product = port - b
        tol = 2 * np.spacing(np.abs(product)) + 2 * np.spacing(np.abs(port))
        assert np.all(np.abs(port - pallas) <= tol)


def test_int8_matmul_scalar_weight_scale(rng):
    x, w, xs, _, b = _int8_case(rng, 5, 784, 10, True)
    ws = np.float32(0.02)
    port = int8_matmul(_t(x), _t(w), _t(xs), _t(ws), _t(b)).numpy()
    ref = np.asarray(jax_int_matmul.int8_matmul_reference(
        _j(x), _j(w), _j(xs), _j(ws), _j(b)))
    np.testing.assert_array_equal(port, ref)


def test_pack_int4_rows_round_trip_matches_jax(rng):
    w = rng.integers(-8, 8, (784, 10), dtype=np.int8)
    packed = pack_int4_rows(_t(w))
    assert packed.dtype == torch.int8 and tuple(packed.shape) == (392, 10)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jax_int4.pack_int4_rows(_j(w))))
    np.testing.assert_array_equal(unpack_int4_rows(packed).numpy(), w)


def _w4a16_tolerance(x, w_packed, ws):
    """1e-5 of sum |bf16(x)| |w| * |ws|: bf16 x int4 products are exact in
    float32, so the two versions differ only in summation order."""
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    w = np.abs(unpack_int4_rows(_t(w_packed)).numpy().astype(np.float32))
    return 1e-5 * (np.abs(xb) @ w) * np.abs(ws)


@pytest.mark.parametrize("m,k,n,with_bias,act", W4A16_CASES)
def test_int4_weight_only_matmul_matches_jax(rng, m, k, n, with_bias, act):
    x = (rng.standard_normal((m, k)) * 3).astype(np.float32)
    w_packed = rng.integers(-128, 128, (k // 2, n), dtype=np.int8)
    ws = rng.uniform(0.01, 0.2, n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32) if with_bias else None
    port = int4_weight_only_matmul(_t(x), _t(w_packed), _t(ws), _t(b), act=act).numpy()
    ref = np.asarray(jax_int4.int4_weight_only_matmul_reference(
        _j(x), _j(w_packed), _j(ws), _j(b), act=act))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jax_int4.int4_weight_only_matmul(
            _j(x), _j(w_packed), _j(ws), _j(b), act=act))
    tol = _w4a16_tolerance(x, w_packed, ws)
    assert np.all(np.abs(port - ref) <= tol)
    assert np.all(np.abs(port - pallas) <= tol)


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.zeros((2, 4), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        int8_matmul(x, torch.zeros((4, 3), dtype=torch.int8, device="meta"), 1.0, 1.0)
    with pytest.raises(ValueError):
        int4_weight_only_matmul(torch.zeros((2, 4), device="meta"),
                                torch.zeros((2, 3), dtype=torch.int8, device="meta"), 1.0)


def test_cpu_tensor_takes_the_plain_version(rng):
    x = rng.standard_normal((3, 8)).astype(np.float32)
    w_packed = rng.integers(-128, 128, (4, 5), dtype=np.int8)
    ws = np.ones(5, np.float32)
    np.testing.assert_array_equal(
        int4_weight_only_matmul(_t(x), _t(w_packed), _t(ws)).numpy(),
        int4_weight_only_matmul_reference(_t(x), _t(w_packed), _t(ws)).numpy())


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "brevitas_tpu"}


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    [*(REPO / "brevitas_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py",
     REPO / "kernel_probes.py"]))
def test_port_imports_no_jax(path):
    """Read from the AST: the environment may import JAX in advance, so a
    sys.modules check would prove nothing."""
    tree = ast.parse((REPO / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


LIBRARY_MARKS = ("cublas", "cudnn", "cutlass", "torch/", "ATen", "c10/", "flash")


@pytest.mark.parametrize("name", sorted(build.SOURCES))
def test_kernel_sources_are_hand_written(name):
    """Every kernel is a hand-written sm_90a source in the repo with a plain
    C launcher: no library GEMM or attention, no PyTorch headers."""
    src = build.SOURCES[name].read_text()
    includes = [ln for ln in src.splitlines() if ln.startswith("#include")]
    assert not [ln for ln in includes if any(m in ln for m in LIBRARY_MARKS)], includes
    assert f'extern "C" int {name}_launch(' in src
    assert "compute_90a" in " ".join(build.NVCC_FLAGS)
    assert "--use_fast_math" not in build.NVCC_FLAGS
