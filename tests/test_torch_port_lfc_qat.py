"""The port's LFC INT4 QAT slice against the JAX package's.

Three things are held to JAX, every reference computed once for the module
(two jits) and kept as numpy:

- ``kernels.fake_quant``'s plain versions against JAX's
  ``fake_quant_reference`` (forward and ``jax.vjp``) and the Pallas
  ``fake_quant`` in interpret mode, at odd shapes, zero points 0 and 3, both
  clamp modes, inputs that reach both clamps, and the scale of a 4-bit LFC
  grid, fl(1/7);
- the bf16 code-domain branch: ``compute_dtype_matmul`` against the VJP of
  ``jnp.dot(a.astype(bf16), b.astype(bf16), preferred_element_type=f32)``,
  and a 4-bit ``QuantLinear`` in bf16;
- one training step of the FC family at (784 -> 64 -> 64 -> 10), 4-bit,
  batch 32, dropout 0, in float32 and in bf16: square hinge loss, Adam at
  lr 1e-3 (optax in JAX, ``torch.optim.Adam`` in the port), then
  ``clip_weights(-1, 1)``: bench.py's ``lfc_int4_qat`` step at a small width.
  The port starts from the JAX model's state (``load_jax_state``).

The CUDA kernels run only on the card (``chip_smoke.py`` holds them to these
plain versions there).

Tolerances, each with its reason:
- fake-quant forward and ``dx`` against JAX's reference: exact (the same
  division, rounding and clamp; ``dx = (g * s) / s``, two roundings, in both).
  Against the Pallas kernel: exact except where ``rint(x * (1 / s) + zp)``
  and ``rint(x / s + zp)`` differ, each such element certified;
- ``dscale`` and ``dzp``: within 1e-5 of the size of the parts an autograd
  adds in float32 (for ``dscale``, ``|g (qc - zp)| + |g x / s|`` summed; for
  ``dzp``, ``|g s|`` over every element, since the in-range terms enter
  from ``x / s + zp`` and cancel those of ``(qc - zp) * s``) of the float64
  sum of the per-element terms (``fake_quant_scale_terms``), in both
  packages; the CUDA kernel sums the terms in float64 and is held to 1e-5
  of the terms' own size on the card;
- ``compute_dtype_matmul``: the forward exact on integer codes (products of
  bf16 values are exact in float32 and the sums stay below 2^24) and within
  float32 summation order otherwise (rtol 1e-6 of sum |a b|); each operand's
  gradient equal to JAX's, a bf16 value, except where the float64 product
  lies within 4 float32 ulps of a bf16 rounding boundary (the float32 sums
  of torch and XLA differ in order, so the rounding to bf16 may fall either
  way there; each such element certified);
- the LFC step: loss within rtol 1e-6; in float32 every gradient within
  1e-4 of its largest element: BatchNorm and TensorNorm sum in another
  order in torch than in XLA, and the port forms rsqrt in float64 (XLA's
  float32 rsqrt is not correctly rounded), so the backward's float32 values
  differ in their last bits. In bf16 each gradient element within two bf16
  ulps of its own size plus 1e-3 of the largest element: every operand
  gradient of a product is rounded to bf16, and where the two packages'
  float32 inputs to that rounding differ in their last bits it falls either
  way (in about 0.15 % of the first layer's weight gradients at these
  inputs; a weight's gradient is that bf16 value divided by the weight
  scale 1/7, which spreads one bf16 step over up to 1.75 steps at its own
  size, hence two), and the BatchNorm gradients upstream sum such flipped
  values (measured 2.1e-4 of their largest element); parameters after
  Adam within 6.4e-6 * lr (torch forms Adam's bias corrections in float64,
  optax in float32: ROADMAP S8) plus 4 ulps of the larger operand of ``p +
  u`` plus the difference of the first update ``lr g / (|g| + eps)`` of the
  two packages' gradients; the clipped weights the same, inside [-1, 1].
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx
from jax.experimental.pallas import tpu as pltpu

from brevitas_tpu.examples.bnn_pynq import sqr_hinge_loss as jax_sqr_hinge_loss
from brevitas_tpu.kernels.fake_quant import fake_quant as jax_fake_quant
from brevitas_tpu.kernels.fake_quant import fake_quant_reference as jax_fake_quant_reference
from brevitas_tpu.models.common import common_act_quant as jax_act_quant
from brevitas_tpu.models.common import common_weight_quant as jax_weight_quant
from brevitas_tpu.models.fc import FC as JaxFC
from brevitas_tpu.nn import QuantLinear as JaxQuantLinear
from brevitas_tpu.utils import set_compute_dtype as jax_set_compute_dtype
from brevitas_tpu_torch.examples import bnn_pynq
from brevitas_tpu_torch.interop import load_jax_state
from brevitas_tpu_torch.kernels import (
    fake_quant,
    fake_quant_backward,
    fake_quant_backward_reference,
    fake_quant_reference,
)
from brevitas_tpu_torch.kernels.fake_quant import fake_quant_scale_terms
from brevitas_tpu_torch.models import quant_llama_tiny
from brevitas_tpu_torch.models.common import common_act_quant, common_weight_quant
from brevitas_tpu_torch.models.fc import FC as PortFC
from brevitas_tpu_torch.nn import QuantLinear as PortQuantLinear
from brevitas_tpu_torch.nn.linear import compute_dtype_matmul
from brevitas_tpu_torch.utils import set_compute_dtype

torch.set_num_threads(1)

BITS, WIDTHS, BATCH, LR, ADAM_EPS = 4, (64, 64), 32, 1e-3, 1e-8
S8_ADAM = 6.4e-6  # of lr: float64 against float32 bias corrections (ROADMAP S8)
SCALE = np.float32(1.0) / np.float32(7.0)  # a 4-bit LFC grid's scale, fl(1/7)
# (shape, lo, hi, zero point, ste_clamp): odd shapes, both clamp modes
FQ_CASES = [((3, 5, 7), -8.0, 7.0, 3.0, False), ((61, 67), -8.0, 7.0, 3.0, True),
            ((4096,), -7.0, 7.0, 0.0, False)]
FQ_IDS = [f"{'x'.join(map(str, s))}-zp{int(z)}-{'ste' if t else 'zeroing'}"
          for s, _, _, z, t in FQ_CASES]
MM_SHAPES = {"codes": (32, 64, 16), "values": (24, 96, 40)}  # (M, K, N)


def _fq_inputs(i: int):
    shape, lo, hi, zp, ste = FQ_CASES[i]
    rng = np.random.default_rng(100 + i)
    # |x| up to about 3 reaches both clamps at s = 1/7 (codes -8..7 after a
    # zero point of 3: x in [-1.57, 0.57])
    x = (rng.standard_normal(shape) * 1.2).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, g, SCALE, np.float32(zp), lo, hi, ste


def _mm_inputs(kind: str):
    m, k, n = MM_SHAPES[kind]
    rng = np.random.default_rng(7)
    if kind == "codes":
        a = rng.integers(-7, 8, (m, k)).astype(np.float32)
        b = rng.integers(-7, 8, (k, n)).astype(np.float32)
    else:
        a = rng.standard_normal((m, k)).astype(np.float32)
        b = rng.standard_normal((k, n)).astype(np.float32)
    return a, b, rng.standard_normal((m, n)).astype(np.float32)


def jax_state_arrays(model) -> dict:
    return {".".join(map(str, path)): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model)) if path[0] != "rngs"}


def flat_variables(state) -> dict:
    return {".".join(map(str, path)): v for path, v in nnx.to_flat_state(state)}


def flat(state) -> dict:
    return {k: np.asarray(v[...]) for k, v in flat_variables(state).items()}


@pytest.fixture(scope="module")
def jax_ref():
    """Every JAX result of the file, as numpy."""
    r = {}

    @jax.jit
    def fq_all(cases):
        out = []
        for (x, g, s, z), (_, lo, hi, _, ste) in zip(cases, FQ_CASES):
            y, vjp = jax.vjp(lambda a, b, c: jax_fake_quant_reference(
                a, b, c, lo=lo, hi=hi, ste_clamp=ste), x, s, z)
            out.append((y, vjp(g), jax_fake_quant(x, s, z, lo, hi, ste)))
        return out

    cases = [tuple(jnp.asarray(v) for v in _fq_inputs(i)[:4]) for i in range(len(FQ_CASES))]
    with pltpu.force_tpu_interpret_mode():
        r["fq"] = jax.tree.map(np.asarray, fq_all(cases))

    @jax.jit
    def mm_all(pairs):
        out = []
        for a, b, g in pairs:
            y, vjp = jax.vjp(lambda u, v: jnp.dot(u.astype(jnp.bfloat16), v.astype(jnp.bfloat16),
                                                  preferred_element_type=jnp.float32), a, b)
            out.append((y, vjp(g)))
        return out

    r["mm"] = dict(zip(MM_SHAPES, jax.tree.map(np.asarray, mm_all(
        [tuple(jnp.asarray(v) for v in _mm_inputs(k)) for k in MM_SHAPES]))))

    rng = np.random.default_rng(0)
    x = rng.random((BATCH, 28, 28, 1), dtype=np.float32)
    y = rng.integers(0, 10, BATCH).astype(np.int32)
    lin_x = (rng.standard_normal((BATCH, 64)) * 0.6).astype(np.float32)
    lin_g = rng.standard_normal((BATCH, 16)).astype(np.float32)
    r.update(x=x, y=y, linear_x=lin_x, linear_g=lin_g)
    # a 4-bit QuantLinear with an input quantizer, in bf16
    lin = JaxQuantLinear(64, 16, use_bias=False, weight_quant=jax_weight_quant(BITS),
                         input_quant=jax_act_quant(BITS), rngs=nnx.Rngs(3))
    lin.compute_dtype = jnp.bfloat16
    r["linear_state"] = jax_state_arrays(lin)
    # one LFC step, float32 and bf16, from one initial state
    m32 = JaxFC(out_features=WIDTHS, weight_bit_width=BITS, act_bit_width=BITS,
                in_bit_width=BITS, dropout=0.0, rngs=nnx.Rngs(0))
    r["init"] = jax_state_arrays(m32)
    mbf = nnx.clone(m32)
    jax_set_compute_dtype(mbf, jnp.bfloat16)
    models = {"float32": m32, "bf16": mbf}
    opts = {k: nnx.Optimizer(m, optax.adam(LR), wrt=nnx.Param) for k, m in models.items()}

    @nnx.jit
    def run(lin, models, opts, xv, yv, lxv, lgv):
        # the code-domain branch needs concrete bit widths (see above)
        with jax.ensure_compile_time_eval():
            _, (gm, gx) = nnx.value_and_grad(lambda mm, v: jnp.sum(mm(v) * lgv),
                                             argnums=(0, 1))(lin, lxv)
            out = {"linear": (lin(lxv), gm["weight"][...], gx)}
            for name, m in models.items():
                loss, grads = nnx.value_and_grad(
                    lambda mm: jax_sqr_hinge_loss(mm(xv), yv))(m)
                opts[name].update(m, grads)
                # arrays, not the Variables that clip_weights updates in place
                after = {k: v[...] for k, v in flat_variables(nnx.state(m, nnx.Param)).items()}
                m.clip_weights(-1.0, 1.0)
                out[name] = (loss, grads, after, nnx.state(m, nnx.Param))
        return out

    out = run(lin, models, opts, *(jnp.asarray(v) for v in (x, y, lin_x, lin_g)))
    r["linear"] = jax.tree.map(np.asarray, out["linear"])
    for name in models:
        loss, grads, after, clipped = out[name]
        r[name] = {"loss": float(loss), "grads": flat(grads),
                   "after_adam": {k: np.asarray(v) for k, v in after.items()},
                   "clipped": flat(clipped)}
    return r


# -- fake_quant ----------------------------------------------------------------

@pytest.fixture(scope="module")
def port_fq():
    """The port's plain versions at every case: forward, autograd gradients,
    and the float64 terms of the scale and zero-point sums."""
    out = []
    for i in range(len(FQ_CASES)):
        x, g, s, z, lo, hi, ste = _fq_inputs(i)
        xt, gt = torch.from_numpy(x), torch.from_numpy(g)
        st, zt = torch.tensor(s), torch.tensor(z)
        with torch.no_grad():
            y = fake_quant_reference(xt, st, zt, lo, hi, ste)
        dx, ds, dz = fake_quant_backward_reference(xt, st, zt, gt, lo, hi, ste)
        terms = fake_quant_scale_terms(xt, st, zt, gt, lo, hi, ste)
        out.append({"args": (xt, st, zt, gt, lo, hi, ste), "y": y.numpy(), "dx": dx.numpy(),
                    "ds": float(ds), "dz": float(dz), "terms": [t.numpy() for t in terms]})
    return out


@pytest.mark.parametrize("i", range(len(FQ_CASES)), ids=FQ_IDS)
def test_fake_quant_forward_matches_jax_reference_exactly(jax_ref, port_fq, i):
    want = jax_ref["fq"][i][0]
    got = port_fq[i]["y"]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    x, _, s, z, lo, hi, _ = _fq_inputs(i)
    codes = np.round(x / s + z)
    assert (codes < lo).any() and (codes > hi).any(), "both clamps must be reached"


@pytest.mark.parametrize("i", range(len(FQ_CASES)), ids=FQ_IDS)
def test_fake_quant_forward_matches_pallas_but_at_certified_ties(jax_ref, port_fq, i):
    """The Pallas kernel (interpret mode) multiplies by 1 / s: it differs
    only where that moves the rounding."""
    x, _, s, z, lo, hi, _ = _fq_inputs(i)
    differ = port_fq[i]["y"] != jax_ref["fq"][i][2]
    inv = np.float32(1.0) / s
    moved = np.round(x * inv + z) != np.round(x / s + z)
    assert not np.any(differ & ~moved), f"{int((differ & ~moved).sum())} uncertified"
    print(f"case {FQ_IDS[i]}: {int(differ.sum())} of {differ.size} differ, all at ties "
          "that x * (1/s) and x / s round apart")


@pytest.mark.parametrize("i", range(len(FQ_CASES)), ids=FQ_IDS)
def test_fake_quant_dx_matches_jax_vjp_exactly(jax_ref, port_fq, i):
    """dx = (g * s) / s where the clamp passes, as jax.vjp of the reference
    gives it (the Pallas backward returns g itself there)."""
    np.testing.assert_array_equal(port_fq[i]["dx"], jax_ref["fq"][i][1][0])
    x, g, s, z, lo, hi, ste = _fq_inputs(i)
    q = np.round(x / s + z)
    inr = ste | ((q >= lo) & (q <= hi))
    if i == len(FQ_CASES) - 1:  # 4,096 normal draws: the two roundings move ~9 %
        assert 0.02 < np.mean(port_fq[i]["dx"][inr] != g[inr]) < 0.2


@pytest.mark.parametrize("i", range(len(FQ_CASES)), ids=FQ_IDS)
def test_fake_quant_scale_and_zero_point_sums_match_jax(jax_ref, port_fq, i):
    dref = jax_ref["fq"][i][1]
    ds_terms, dz_terms, ds_parts = port_fq[i]["terms"]
    x, g, s, *_ = _fq_inputs(i)
    dz_mass = np.abs(g.astype(np.float64) * np.float64(s)).sum()
    for name, got, want, terms, mass in (
            ("dscale", port_fq[i]["ds"], float(dref[1]), ds_terms, ds_parts.sum()),
            ("dzp", port_fq[i]["dz"], float(dref[2]), dz_terms, dz_mass)):
        exact = terms.sum()
        assert abs(got - exact) <= 1e-5 * mass, (name, got, exact)
        assert abs(want - exact) <= 1e-5 * mass, (name, want, exact)
    if FQ_CASES[i][4]:  # the straight-through clamp: no zero-point gradient
        assert port_fq[i]["dz"] == 0.0 and not dz_terms.any()


def test_fake_quant_wrappers_take_the_plain_version_on_the_cpu(port_fq):
    """A CPU tensor takes the plain version, autograd included, and
    launches nothing."""
    xt, st, zt, gt, lo, hi, ste = port_fq[2]["args"]
    xg, sg, zg = (t.clone().requires_grad_() for t in (xt, st, zt))
    y = fake_quant(xg, sg, zg, lo, hi, ste)
    y.backward(gt)
    np.testing.assert_array_equal(y.detach().numpy(), port_fq[2]["y"])
    np.testing.assert_array_equal(xg.grad.numpy(), port_fq[2]["dx"])
    assert float(sg.grad) == port_fq[2]["ds"] and float(zg.grad) == port_fq[2]["dz"]
    dx, ds, dz = fake_quant_backward(xt, st, zt, gt, lo, hi, ste, sums=False)
    np.testing.assert_array_equal(dx.numpy(), port_fq[2]["dx"])
    assert ds is None and dz is None
    assert fake_quant.launches == 0 and fake_quant_backward.launches == 0


def test_fake_quant_wrappers_refuse_devices_without_a_kernel():
    x = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError):
        fake_quant(x, 0.5, 0.0, -8.0, 7.0)
    with pytest.raises(ValueError):
        fake_quant_backward(x, 0.5, 0.0, x, -8.0, 7.0)


def test_quantizers_keep_the_chain_on_the_cpu(port_fq):
    """A per-tensor ActQuantizer on a CPU tensor computes what the kernel's
    plain version computes (the chain), without a launch."""
    from brevitas_tpu_torch.quant.quantizers import ActQuantizer

    q = ActQuantizer(common_act_quant(BITS))
    xt = port_fq[0]["args"][0]
    with torch.no_grad():
        got = q(xt)
    want = fake_quant_reference(xt, got.scale, 0.0, -7.0, 7.0)
    np.testing.assert_array_equal(got.value.numpy(), want.numpy())
    assert float(got.scale) == SCALE and fake_quant.launches == 0


# -- the bf16 code-domain branch ----------------------------------------------

def _bf16(v: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(v, np.float32)).bfloat16().float().numpy()


def _near_bf16_boundary(v64: np.ndarray, ulps: int = 4) -> np.ndarray:
    """Where a float64 value lies within ``ulps`` float32 ulps of a point at
    which rounding to bf16 changes."""
    v32 = v64.astype(np.float32)
    step = ulps * np.spacing(np.abs(v32))
    return _bf16(v32 - step) != _bf16(v32 + step)


@pytest.mark.parametrize("kind", list(MM_SHAPES))
def test_compute_dtype_matmul_matches_jax_bf16_dot(jax_ref, kind):
    a, b, g = _mm_inputs(kind)
    want_y, (want_da, want_db) = jax_ref["mm"][kind]
    at, bt = (torch.from_numpy(v).requires_grad_() for v in (a, b))
    y = compute_dtype_matmul(at, bt, torch.bfloat16)
    y.backward(torch.from_numpy(g))
    assert y.dtype == torch.float32
    if kind == "codes":
        np.testing.assert_array_equal(y.detach().numpy(), want_y)
    else:
        mass = np.abs(_bf16(a)).astype(np.float64) @ np.abs(_bf16(b))
        assert np.all(np.abs(y.detach().numpy() - want_y) <= 1e-6 * mass)
    for got, want, exact in ((at.grad.numpy(), want_da, g.astype(np.float64) @ _bf16(b).T),
                             (bt.grad.numpy(), want_db, _bf16(a).T.astype(np.float64) @ g)):
        assert np.array_equal(got, _bf16(got)), "a gradient rounded to bf16"
        differ = got != want
        assert not np.any(differ & ~_near_bf16_boundary(exact)), kind


def test_code_domain_quant_linear_matches_jax(jax_ref):
    """A 4-bit QuantLinear with an input quantizer in bf16: its forward and
    its input and weight gradients."""
    pl = PortQuantLinear(64, 16, use_bias=False, weight_quant=common_weight_quant(BITS),
                         input_quant=common_act_quant(BITS), device="cpu")
    load_jax_state(pl, jax_ref["linear_state"])
    pl.compute_dtype = torch.bfloat16
    x = torch.from_numpy(jax_ref["linear_x"]).requires_grad_()
    y = pl(x)
    y.backward(torch.from_numpy(jax_ref["linear_g"]))
    want_y, want_dw, want_dx = jax_ref["linear"]
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    # the operand gradients before their last division by the scale are
    # bf16 values; certify any flip against the float64 product
    s_x, s_w = np.float32(1) / np.float32(7), np.float32(1) / np.float32(7)
    g_out = jax_ref["linear_g"] * (s_w * s_x)
    w_codes = np.round(jax_ref["linear_state"]["weight"] / s_w)
    x_codes = np.clip(np.round(jax_ref["linear_x"] / s_x), -7, 7)
    for got, want, exact in ((x.grad.numpy(), want_dx, g_out.astype(np.float64) @ w_codes.T),
                             (pl.weight.grad.numpy().T, want_dw,
                              x_codes.T.astype(np.float64) @ g_out)):
        differ = got != want
        assert not np.any(differ & ~_near_bf16_boundary(exact))


def test_set_compute_dtype_sets_layers_and_refuses_attention():
    m = PortFC(out_features=(8,), weight_bit_width=BITS, act_bit_width=BITS,
               in_bit_width=BITS, device="cpu")
    set_compute_dtype(m, torch.bfloat16)
    assert m.hidden[0].compute_dtype == m.head.compute_dtype == torch.bfloat16
    set_compute_dtype(m, None)
    assert m.head.compute_dtype is None
    with pytest.raises(NotImplementedError):
        set_compute_dtype(quant_llama_tiny(device="cpu"), torch.bfloat16)


# -- one LFC training step ------------------------------------------------------

def port_tensor(t: torch.Tensor, path: str) -> np.ndarray:
    """A port tensor in the JAX layout: QuantLinear weights transposed."""
    v = t.detach().numpy().copy()
    return v.T if path.endswith("weight") and path.split(".")[0] in ("hidden", "head") \
        and v.ndim == 2 else v


@pytest.fixture(scope="module", params=["float32", "bf16"])
def port_step(request, jax_ref):
    """The port's step from the JAX model's initial state: loss, gradients,
    torch.optim.Adam, clip_weights; then the trainer's own train_step from
    the same state."""
    def build():
        pm = PortFC(out_features=WIDTHS, weight_bit_width=BITS, act_bit_width=BITS,
                    in_bit_width=BITS, dropout=0.0, device="cpu")
        load_jax_state(pm, jax_ref["init"])
        if request.param == "bf16":
            set_compute_dtype(pm, torch.bfloat16)
        return pm

    x, y = torch.from_numpy(jax_ref["x"]), torch.from_numpy(jax_ref["y"])
    pm = build()
    opt = torch.optim.Adam(pm.parameters(), lr=LR)
    loss = bnn_pynq.sqr_hinge_loss(pm(x), y)
    loss.backward()
    names = [n for n, _ in pm.named_parameters()]
    r = {"dtype": request.param, "loss": float(loss.detach()),
         "grads": {n: port_tensor(p.grad, n) for n, p in pm.named_parameters()}}
    opt.step()
    r["after_adam"] = {n: port_tensor(p, n) for n, p in pm.named_parameters()}
    pm.clip_weights(-1.0, 1.0)
    r["clipped"] = {n: port_tensor(p, n) for n, p in pm.named_parameters()}
    trainer = build()
    r["trainer_loss"] = float(bnn_pynq.train_step(
        trainer, torch.optim.Adam(trainer.parameters(), lr=LR), x, y))
    r["trainer"] = {n: port_tensor(p, n) for n, p in trainer.named_parameters()}
    r["names"] = names
    return r


def test_lfc_step_loss_matches_jax(jax_ref, port_step):
    want = jax_ref[port_step["dtype"]]["loss"]
    assert np.isfinite(port_step["loss"])
    assert port_step["loss"] == pytest.approx(want, rel=1e-6)
    assert port_step["trainer_loss"] == port_step["loss"]


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7).astype(np.float32)


def test_lfc_step_gradients_match_jax(jax_ref, port_step):
    want = jax_ref[port_step["dtype"]]["grads"]
    assert set(want) == set(port_step["grads"])
    bf16 = port_step["dtype"] == "bf16"
    for path, exp in want.items():
        got = port_step["grads"][path]
        assert got.shape == exp.shape, path
        tol = (1e-3 * np.abs(exp).max() + 2 * _bf16_ulp(exp)) if bf16 \
            else 1e-4 * np.abs(exp).max()
        assert np.all(np.abs(got - exp) <= tol), path


def _adam_tolerance(jax_ref, port_step, path):
    first_update = lambda g: LR * g / (np.abs(g) + ADAM_EPS)  # noqa: E731
    g_port, g_jax = port_step["grads"][path], jax_ref[port_step["dtype"]]["grads"][path]
    operand = np.maximum(np.abs(jax_ref["init"][path]), np.float32(LR))
    return (S8_ADAM * LR + 4 * np.spacing(operand)
            + np.abs(first_update(g_port) - first_update(g_jax)))


@pytest.mark.parametrize("stage", ["after_adam", "clipped"])
def test_lfc_step_parameters_match_jax(jax_ref, port_step, stage):
    want = jax_ref[port_step["dtype"]][stage]
    for path, exp in want.items():
        got = port_step[stage][path]
        assert np.all(np.abs(got - exp) <= _adam_tolerance(jax_ref, port_step, path)), path
    weights = [p for p in want if p.endswith("weight") and want[p].ndim == 2]
    if stage == "clipped":
        for path in weights:
            got = port_step["clipped"][path]
            assert np.abs(got).max() <= 1.0
            np.testing.assert_array_equal(port_step["trainer"][path], got)
        # the step pushed some weights past 1 and the clip brought them back
        assert any((np.abs(port_step["after_adam"][p]) > 1).any() for p in weights)


# -- the trainer ---------------------------------------------------------------

def test_bnn_pynq_main_trains_on_the_cpu(capsys):
    acc = bnn_pynq.main(["--device", "cpu", "--network", "TFC_4W4A", "--dataset",
                         "synthetic", "--epochs", "1", "--batch-size", "512"])
    out = capsys.readouterr().out
    assert 0.0 <= acc <= 1.0
    assert '"best_val_acc"' in out and "epoch 0: mean loss" in out


@pytest.mark.parametrize("argv", [
    ["--network", "LFC_1W1A"], ["--network", "LFC_2W2A"], ["--network", "CNV_1W1A"],
    ["--dataset", "digits"], ["--network", "CNV_2W2A"], ["--cfg", "lfc_1w1a"], ["--scan"],
    ["--native-loader"], ["--resume", "best.pkl"]], ids=lambda a: "_".join(a).strip("-"))
def test_bnn_pynq_refuses_what_is_not_ported(argv, tmp_path, monkeypatch):
    """``--scan`` and ``--native-loader`` still raise; the 1- and 2-bit
    networks, ``--dataset digits`` (slice 9c: the repository's digits
    file), ``--cfg`` and ``--resume`` (here from a checkpoint of the default
    network) are ported and run."""
    monkeypatch.chdir(tmp_path)
    left_out = argv[0] in ("--scan", "--native-loader")
    if argv[0] == "--resume":
        m = bnn_pynq.lfc(device="cpu")
        bnn_pynq.save_checkpoint(argv[1], m, torch.optim.Adam(m.parameters()), 0, 0.5)
    run = lambda: bnn_pynq.main(["--device", "cpu", "--epochs", "0"] + argv)  # noqa: E731
    if left_out:
        with pytest.raises(NotImplementedError):
            run()
    else:
        assert run() == (0.5 if argv[0] == "--resume" else 0.0)


def test_parse_network_reads_the_bit_widths():
    builder, kind, w, a = bnn_pynq.parse_network("LFC_4W8A")
    assert (builder.__name__, kind, w, a) == ("lfc", "fc", 4, 8)
