"""The port's fake_quant forward: how the kernel covers a tensor, its C
signatures, the step shapes the card times, and the plain version against
JAX's reference over edge float32 inputs.

The CUDA kernel streams 16-byte vectors where ``x`` and ``y`` start on a
16-byte boundary and takes single elements elsewhere; ``fake_quant_plan``
(Python, so these tests reach it) makes that choice.
On the card ``chip_smoke.py`` holds the kernel to the plain version over
every float32 bit pattern (``fake_quant_exhaustive``); here the plain
version is held to JAX's ``fake_quant_reference``, run eagerly (under
``jit`` XLA turns a division by a constant into a reciprocal multiply),
at the same scales and grids, on a strided sample of the bit patterns and
the values around every rounding tie of each grid: the same bits, a NaN
compared only as a NaN, except where XLA on the CPU flushes a subnormal
operand or result to zero (the card does not): each such element is
certified as the flushed chain's value.
"""

import ctypes
import re
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from brevitas_tpu.kernels.fake_quant import fake_quant_reference as jax_fake_quant_reference
from brevitas_tpu_torch.kernels.fake_quant import (
    bind_library,
    fake_quant,
    fake_quant_plan,
    fake_quant_reference,
)
from brevitas_tpu_torch.ops import tensor_clamp

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _cover(x_ptr: int, y_ptr: int, n: int):
    """The element indices the kernel takes as float4 and one at a time,
    from ``fake_quant_plan``, as ``fake_quant_kernel`` walks them."""
    vecs = fake_quant_plan(x_ptr, y_ptr, n)
    assert 0 <= 4 * vecs <= n
    return list(range(0, 4 * vecs, 4)), list(range(4 * vecs, n))


# -- the plan --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 7, 8, 105, 1023, 1024, 1025])
def test_plan_takes_an_aligned_tensor_as_float4_and_a_short_tail(n):
    x = torch.zeros(n)
    y = torch.empty_like(x)
    vector, scalar = _cover(x.data_ptr(), y.data_ptr(), n)
    assert len(vector) == n // 4 and len(scalar) == n % 4


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("trim", [0, 1, 3])
def test_plan_sends_a_view_off_the_16_byte_boundary_to_the_scalar_loop(offset, trim):
    """A contiguous view that starts 4, 8 or 12 bytes into an allocation,
    against a fresh output: the whole tensor one element at a time."""
    flat = torch.zeros(1031)
    x = flat[offset:flat.numel() - trim]
    y = torch.empty_like(x)
    assert x.data_ptr() % 16 == 4 * offset and y.data_ptr() % 16 == 0
    assert fake_quant_plan(x.data_ptr(), y.data_ptr(), x.numel()) == 0


@pytest.mark.parametrize("trim", [0, 1, 2, 3])
def test_plan_takes_a_view_on_the_boundary_as_float4(trim):
    flat = torch.zeros(1031)
    x = flat[4:flat.numel() - trim]
    y = torch.empty_like(x)
    assert fake_quant_plan(x.data_ptr(), y.data_ptr(), x.numel()) == x.numel() // 4


def test_plan_covers_every_element_once_on_16_byte_vectors():
    """Over pointer pairs at every 4-byte offset and lengths 0-40: the
    vectors and the single elements partition the tensor, every vector
    starts on a 16-byte boundary in x and y, and the body runs wherever both
    are on one."""
    base = 1 << 20
    for dx in range(0, 16, 4):
        for dy in range(0, 16, 4):
            for n in range(41):
                x_ptr, y_ptr = base + dx, 2 * base + dy
                vector, scalar = _cover(x_ptr, y_ptr, n)
                assert sorted(scalar + [i + k for i in vector for k in range(4)]) == list(
                    range(n))
                assert all((x_ptr + 4 * i) % 16 == 0 and (y_ptr + 4 * i) % 16 == 0
                           for i in vector)
                assert len(scalar) == (n % 4 if dx == dy == 0 else n)


def test_cpu_views_take_the_plain_version():
    """On the CPU the wrapper computes the plain version on any view, no
    launch counted."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1031).astype(np.float32))
    s = torch.ones(()) / torch.full((), 7.0)
    before = fake_quant.launches
    for start, stop in ((1, None), (2, -3), (4, None), (0, -1)):
        v = x[start:stop]
        assert torch.equal(fake_quant(v, s, 0.0, -7.0, 7.0),
                           fake_quant_reference(v, s, 0.0, -7.0, 7.0))
    assert fake_quant.launches == before


# -- the C launchers' signatures ---------------------------------------------------------

_CTYPE = {"int64_t": ctypes.c_int64, "float": ctypes.c_float, "int": ctypes.c_int}


def _c_params(symbol: str):
    src = (REPO / "brevitas_tpu_torch" / "csrc" / "fake_quant.cu").read_text()
    m = re.search(r'extern "C" \w+ ' + symbol + r"\(([^)]*)\)", src)
    assert m, symbol
    out = []
    for param in m.group(1).split(","):
        decl = " ".join(param.split())
        if "*" in decl or decl.startswith("cudaStream_t"):
            out.append(ctypes.c_void_p)
        else:
            out.append(_CTYPE[decl.rsplit(" ", 1)[0].replace("const ", "")])
    return out


@pytest.mark.parametrize("symbol", ["fake_quant_launch", "fake_quant_backward_launch",
                                    "fake_quant_blocks"])
def test_ctypes_signatures_follow_the_c_launchers(symbol):
    lib = bind_library(SimpleNamespace(**{s: SimpleNamespace() for s in (
        "fake_quant_launch", "fake_quant_backward_launch", "fake_quant_blocks")}))
    assert getattr(lib, symbol).argtypes == _c_params(symbol)


# -- the step shapes chip_smoke.py times -----------------------------------------------

def test_mobilenet_step_shapes_are_the_models_per_tensor_quantizer_inputs(monkeypatch):
    """MOBILENET_FQ_STEP_SHAPES against the shapes the per-tensor quantizers
    of quant_mobilenet_v1(4) see at 224 px (one image here: the batch of 32
    is the first dimension of each activation), every one also
    differentiated in a training step; phase_mobilenet_qat checks the same
    on the card at batch 32."""
    from brevitas_tpu_torch.models import quant_mobilenet_v1
    from brevitas_tpu_torch.quant import quantizers

    seen = []
    fq = quantizers.int_fake_quant

    def spy(x, scale, zero_point, *a, **k):
        if quantizers._one_value(scale, x) and quantizers._one_value(zero_point, x):
            seen.append(tuple(x.shape))
        return fq(x, scale, zero_point, *a, **k)

    monkeypatch.setattr(quantizers, "int_fake_quant", spy)
    m = quant_mobilenet_v1(bit_width=4, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    with torch.no_grad():
        m(torch.rand(1, 3, CS.MN_PX, CS.MN_PX))
    want = Counter()
    for shape, fwd, bwd in CS.MOBILENET_FQ_STEP_SHAPES:
        assert bwd == fwd
        want[shape if len(shape) != 4 else (1,) + shape[1:]] += fwd
        if len(shape) == 4:
            assert shape[0] == CS.MN_BATCH
    assert Counter(seen) == want
    assert sum(want.values()) == CS.MN_FQ[0]


def test_step_shapes_count_each_steps_launches():
    assert sum(f for _, f, _ in CS.FQ_STEP_SHAPES) == 8
    assert sum(f for _, f, _ in CS.CNV_FQ_STEP_SHAPES) == 9
    n = sum(f * int(np.prod(sh)) for sh, f, _ in CS.MOBILENET_FQ_STEP_SHAPES)
    assert n == 65_824_744  # 8 B an element: a 0.1572 ms bound at 3.35 TB/s


# -- the plain version against JAX's reference over edge inputs ----------------------------

def _scales():
    """The exhaustive phase's scales, formed on the CPU (the LOG_FP one as
    the quantizer forms it)."""
    from brevitas_tpu_torch.models.mobilenetv1 import common_uint_act_quant
    from brevitas_tpu_torch.quant.quantizers import ActQuantizer

    bits = [0x3F800001, 0x3F7FFFFF, 0x3FFFFFFF, 0x00800000]
    log_fp = ActQuantizer(common_uint_act_quant(4)).static_int_params()[0].detach()
    out = [np.float32(1) / np.float32(7), np.float32(1), np.float32(2.0 ** -10),
           np.float32(log_fp)] + [np.array(b, np.uint32).view(np.float32)[()] for b in bits]
    out += [np.float32(2e-16), np.float32(1e30)]
    rng = np.random.default_rng(14)
    drawn = np.exp(rng.uniform(np.log(1e-4), np.log(1e2), CS.FQ_EXHAUSTIVE_SEEDED))
    return out + list(drawn.astype(np.float32))


SCALES = _scales()


def _edge_inputs(s: np.float32, lo: float, hi: float, zp: float) -> np.ndarray:
    """Every 65,537th bit pattern, the specials, and each code's .5 tie of
    the grid, x = (k + 0.5 - zp) * s, with its two float32 neighbours."""
    sample = np.arange(0, 1 << 32, 65537, dtype=np.uint64).astype(np.uint32).view(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, np.finfo(np.float32).max,
                        np.finfo(np.float32).tiny, np.float32(1e-45)], np.float32)
    k = np.arange(max(lo, -300.0) - 1, min(hi, 300.0) + 1, dtype=np.float64)
    ties = ((k + 0.5 - zp) * np.float64(s)).astype(np.float32)
    with np.errstate(over="ignore"):
        ties = np.concatenate([ties, np.nextafter(ties, np.float32(np.inf)),
                               np.nextafter(ties, np.float32(-np.inf))])
    return np.concatenate([sample, special, -special, ties])


def _subnormal(t: torch.Tensor) -> torch.Tensor:
    return (t.abs() < torch.finfo(torch.float32).tiny) & (t != 0)


def _flushed(t: torch.Tensor) -> torch.Tensor:
    return torch.where(_subnormal(t), torch.zeros_like(t).copysign(t), t)


def _flushed_chain(x, s, zp, lo, hi):
    """The chain as XLA on the CPU runs it: every subnormal operand and
    result flushed to a zero of its sign."""
    f = _flushed
    q = torch.round(f(f(f(x) / f(s)) + zp))
    return f(f(tensor_clamp(q, lo, hi) - zp) * f(s))


@pytest.mark.parametrize("i", range(len(SCALES)), ids=[f"s{i}" for i in range(len(SCALES))])
def test_plain_version_matches_jax_reference_on_edge_inputs(i):
    """The same bits, a NaN as a NaN, except where XLA on the CPU flushes a
    subnormal (the card and torch keep them): there JAX's value is the
    flushed chain's, element by element, and the chain touches a subnormal."""
    s = SCALES[i]
    st = torch.tensor(s)
    for zp, lo, hi in CS.FQ_EXHAUSTIVE_GRIDS:
        x = _edge_inputs(s, lo, hi, zp)
        xt, zt = torch.from_numpy(x), torch.tensor(np.float32(zp))
        got = fake_quant_reference(xt, st, zt, lo, hi)
        want = torch.from_numpy(np.array(jax_fake_quant_reference(
            jnp.asarray(x), jnp.asarray(s), jnp.asarray(np.float32(zp)), lo=lo, hi=hi)))

        def same(a, b):
            return (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())

        differ = ~same(got, want)
        flushed = same(_flushed_chain(xt, st, zt, lo, hi), want)
        xs = xt / st
        touches = (_subnormal(xt) | _subnormal(st) | _subnormal(xs) | _subnormal(xs + zt)
                   | _subnormal(got))
        bad = differ & ~(flushed & touches)
        assert not bad.any(), (float(s), zp, lo, hi, x[bad.numpy()][:4],
                               got[bad][:4], want[bad][:4])
