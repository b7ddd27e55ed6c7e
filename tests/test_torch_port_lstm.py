"""The port's QuantLSTM QAT slice against the JAX package's.

One JAX model, built once for the module (under ``nnx.jit``, so that its
initializers compile as one program): ``bench.py``'s quantlstm_int8_qat
model cut to QuantLSTM(8, 128, num_layers=2) with the leg's quantizers
(8-bit activations, unsigned sigmoids, statistics for one step) and an
``nnx.Linear(128, 10)`` head on the last step, batch 8, sequence 6. The JAX
side runs, once: a calibration forward, ``convert_runtime_stats_to_parameter``,
and one jitted step of the forward, ``value_and_grad`` of softmax
cross-entropy and an ``optax.adam(1e-3)`` update over every ``nnx.Param``;
the results are kept as numpy arrays. The port repeats each stage from the
JAX model's state at that stage (carried by ``load_jax_state``), so each
comparison sees one stage's differences only. The cell is also held against
the Pallas kernel in interpret mode and the jnp composition at
``tests/test_kernels.py``'s ``_cell_args`` inputs. The CUDA kernels run only
on the card (``chip_smoke.py``).

Tolerances, each with its reason:
- cell forward: exact, except where a stage's value before rounding lies
  within 4 float32 ulps of a .5 tie (certified and counted). The port forms
  sigmoid and tanh in float64 and rounds once, XLA in float32, and the
  Pallas kernel multiplies by the reciprocal of the scale where the port
  divides;
- cell backward: dgates and dc within rtol = atol = 1e-5 (the
  straight-through gradients pass ``g * s / s`` in autograd, ``g`` in the
  kernel). Each scale's gradient, in both packages, within 1e-5 of
  ``sum(|g q| + |g x / s|)`` of the float64 sum of its terms ``g * (q - x /
  s)`` (``quant_lstm_cell_scale_terms``), and the two within twice that of
  each other: an autograd adds the parts ``g * q`` and ``-g * x / s`` apart
  in float32, and they can be hundreds of times larger than their sum (the
  CUDA kernel sums the terms themselves and is held to 1e-5 of sum |term|
  on the card);
- calibration and conversion: counters exact, scales within 1e-6 relative.
  The quantizers after a sigmoid or a tanh see inputs that differ in the
  last bit (float64 against XLA's float32), so the percentile picks a value
  an ulp apart, and the quantizers downstream follow;
- outputs and (h_n, c_n) of the fused and the module path: exact. A code
  that flipped at a .5 tie (float32 GEMM order, XLA's FMA of f * c + i * g,
  the sigmoid's last bit) would show as a step of that quantizer's grid in
  its batch row and fail here; none occurs at these inputs;
- gradients: each weight's within 1e-4 of its largest element: the
  backward through six recurrent steps carries float32 rounding (the
  straight-through ``g * s / s`` above) from step to step, and an element
  sums B T products that partly cancel; each learned scale's within 1e-4
  of the largest learned-scale gradient of the model: a scale's gradient
  sums terms ``g * (q - x / s)`` over every step, whose parts ``g * q`` are
  as large as the largest scale gradients and cancel, so its float32 error
  is set by that size, not by its own;
- Adam: the port's gradients go through ``optax.adam``'s first update in
  optax's float32 order (``_adam_first_step``), which moves a parameter by
  ``lr * g / (|g| + eps)``. Parameters equal JAX's within 4 ulps of the
  larger operand of ``p + u`` (the update is formed in a few roundings,
  which XLA may fuse; the sum cancels where ``u`` is about ``-p``) plus the
  difference of that first update between the two packages' gradients.
  A gradient that is zero up to
  rounding moves its parameter by up to lr either way: layer 1's input
  quantizer sees layer 0's output on the very grid its calibration gave
  it, so every code is exact and its terms vanish.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from brevitas_tpu.kernels.lstm_cell import quant_lstm_cell as jax_quant_lstm_cell
from brevitas_tpu.nn import QuantLSTM as JaxQuantLSTM
from brevitas_tpu.ops import round_ste as jax_round_ste
from brevitas_tpu.ops import tensor_clamp as jax_tensor_clamp
from brevitas_tpu.quant import presets as jax_presets
from brevitas_tpu.quant.quantizers import (
    convert_runtime_stats_to_parameter as jax_convert_runtime_stats_to_parameter,
)
from brevitas_tpu.utils import set_compute_dtype as jax_set_compute_dtype
from brevitas_tpu_torch.interop import load_jax_state
from brevitas_tpu_torch.kernels import (
    quant_lstm_cell,
    quant_lstm_cell_backward,
    quant_lstm_cell_backward_reference,
    quant_lstm_cell_reference,
)
from brevitas_tpu_torch.kernels.lstm_cell import (
    cell_step,
    gate_columns,
    quant_lstm_cell_backward_plan,
    quant_lstm_cell_scale_terms,
    quant_lstm_cell_table_plan,
    quant_lstm_cell_tables,
    quant_lstm_cell_tables_reference,
    table_layout,
)
from brevitas_tpu_torch.nn import QuantLSTM as PortQuantLSTM
from brevitas_tpu_torch.ops import tensor_clamp
from brevitas_tpu_torch.quant import presets as port_presets
from brevitas_tpu_torch.quant.quantizers import (
    ParameterScaling,
    convert_runtime_stats_to_parameter,
)
from brevitas_tpu_torch.utils import set_compute_dtype

torch.set_num_threads(1)

I, H, LAYERS, B, T, CLASSES = 8, 128, 2, 8, 6, 10
LR, ADAM_EPS = 1e-3, 1e-8  # optax.adam's defaults but lr
BOUNDS = ((-128, 127), (0, 255), (-128, 127), (-128, 127), (-128, 127), (-128, 127))
TIE_ULPS = 4
# the learned parameters of the model, as JAX names them (nnx.state order)
QUANTIZERS = ["input_quant"] + [f"quants.{q}" for q in (
    "cell_acc", "cell_state", "cell_tanh", "forget_acc", "forget_sigmoid", "gate_acc",
    "hidden_state", "hidden_tanh", "in_sigmoid", "out_acc", "out_sigmoid")]
SHARED = ("quants.cell_state", "quants.hidden_state")  # layer 0's, for every layer
SCALES = [f"lstm.layers.{i}.{q}.scaling.value" for i in range(LAYERS) for q in QUANTIZERS
          if not (i > 0 and q in SHARED)]
WEIGHTS = ([f"lstm.layers.{i}.{w}" for i in range(LAYERS) for w in ("w_ih", "w_hh", "bias")]
           + ["head.kernel", "head.bias"])
PARAMS = WEIGHTS + SCALES


def _leg_quantizers(presets):
    act = presets.Int8ActPerTensorFloat.let(collect_stats_steps=1)
    uact = presets.Uint8ActPerTensorFloat.let(collect_stats_steps=1)
    return dict(io_quant=act, gate_acc_quant=act.let(), sigmoid_quant=uact,
                tanh_quant=act.let(), cell_state_quant=act.let())


class JaxModel(nnx.Module):
    def __init__(self):
        self.lstm = JaxQuantLSTM(I, H, num_layers=LAYERS, rngs=nnx.Rngs(0),
                                 **_leg_quantizers(jax_presets))
        # the head's kernel drawn with numpy: nnx's truncated-normal init
        # would add its own sampler to the build's compile
        self.head = nnx.Linear(H, CLASSES, kernel_init=nnx.initializers.zeros_init(),
                               rngs=nnx.Rngs(1))
        self.head.kernel[...] = jnp.asarray(
            np.random.default_rng(1).standard_normal((H, CLASSES)).astype(np.float32)
            / np.sqrt(np.float32(H)))

    def __call__(self, x):
        y, _ = self.lstm(x)
        return self.head(y[:, -1])


class PortModel(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lstm = PortQuantLSTM(I, H, num_layers=LAYERS, device="cpu",
                                  **_leg_quantizers(port_presets))
        self.head = torch.nn.Linear(H, CLASSES)

    def forward(self, x):
        y, _ = self.lstm(x)
        return self.head(y[:, -1])


def jax_state_arrays(model) -> dict:
    return {".".join(map(str, path)): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model))}


def port_tensor(model, path: str, grad: bool = False) -> torch.Tensor:
    """The port's tensor (or its gradient) at a JAX path, as numpy; an
    nnx.Linear kernel is the transposed weight."""
    owner_path, _, name = path.rpartition(".")
    owner = model.get_submodule(owner_path)
    t = owner.weight if name == "kernel" else getattr(owner, name)
    t = (t.grad if grad else t).detach()
    return (t.t() if name == "kernel" else t).numpy().copy()


def port_model(state: dict, converted: bool) -> PortModel:
    pm = PortModel()
    if converted:
        convert_runtime_stats_to_parameter(pm)
    return load_jax_state(pm, state)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX model through calibration, conversion and one training step,
    every result as numpy."""
    rng = np.random.default_rng(0)
    calib = rng.random((B, T, I), dtype=np.float32)
    x = rng.random((B, T, I), dtype=np.float32)
    y = rng.integers(0, CLASSES, B).astype(np.int32)
    jm = nnx.jit(JaxModel)()
    r = {"calib": calib, "x": x, "y": y, "init": jax_state_arrays(jm)}
    nnx.jit(lambda m, v: m(v))(jm, jnp.asarray(calib))
    r["calibrated"] = jax_state_arrays(jm)
    r["n_converted"] = jax_convert_runtime_stats_to_parameter(jm)
    r["converted"] = jax_state_arrays(jm)

    # bench's default: bf16 operands of the fused step (set_compute_dtype),
    # from the same converted state, in the same jit as the training step
    jb = nnx.clone(jm)
    jax_set_compute_dtype(jb, jnp.bfloat16)
    opt = nnx.Optimizer(jm, optax.adam(LR), wrt=nnx.Param)

    def loss_fn(mm, xv, yv):
        out, (h_n, c_n) = mm.lstm(xv)
        logits = mm.head(out[:, -1])
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, yv).mean()
        return ce, (out, h_n, c_n)

    @nnx.jit
    def step(m, o, mb, xv, yv):
        bf16 = nnx.value_and_grad(loss_fn, has_aux=True)(mb, xv, yv)
        (loss, aux), grads = nnx.value_and_grad(loss_fn, has_aux=True)(m, xv, yv)
        o.update(m, grads)
        return loss, aux, grads, bf16

    loss, (out, h_n, c_n), grads, ((loss_b, (out_b, _, _)), grads_b) = step(
        jm, opt, jb, jnp.asarray(x), jnp.asarray(y))
    r["bf16"] = {"loss": float(loss_b), "outputs": np.asarray(out_b),
                 "grads": {".".join(map(str, path)): np.asarray(v[...])
                           for path, v in nnx.to_flat_state(grads_b)}}
    r["loss"] = float(loss)
    r["outputs"] = tuple(np.asarray(a) for a in (out, h_n, c_n))
    r["grads"] = {".".join(map(str, path)): np.asarray(v[...])
                  for path, v in nnx.to_flat_state(grads)}
    r["after_adam"] = jax_state_arrays(jm)
    return r


def _adam_first_step(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``optax.adam``'s first update in optax's float32 order: the moments
    ``(1 - b) * g`` and ``(1 - b) * g * g`` (``1 - b`` formed in float64 and
    rounded, as a weak-typed constant is), each divided by its bias
    correction ``1 - b`` formed in float32, then ``p + (m / (sqrt(v) + eps))
    * -lr``. (torch.optim.Adam forms the corrections in float64, which moves
    the update by up to 6.4e-6 of lr; the card's QAT step runs it.)"""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    b1, b2 = 0.9, 0.999
    m = f32(1 - b1) * g / (1 - f32(b1))
    v = f32(1 - b2) * (g * g) / (1 - f32(b2))
    return p + (m / (torch.sqrt(v) + f32(ADAM_EPS))) * f32(-LR)


@pytest.fixture(scope="module")
def port_step(jax_run):
    """The port's forward, gradients and Adam step from the JAX model's
    converted state, through the fused path."""
    pm = port_model(jax_run["converted"], converted=True)
    x, y = torch.from_numpy(jax_run["x"]), torch.from_numpy(jax_run["y"]).long()
    out, (h_n, c_n) = pm.lstm(x)
    loss = torch.nn.functional.cross_entropy(pm.head(out[:, -1]), y)
    loss.backward()
    grads = {p: port_tensor(pm, p, grad=True) for p in PARAMS}
    with torch.no_grad():
        for param in pm.parameters():
            param.copy_(_adam_first_step(param, param.grad))
    after = {p: port_tensor(pm, p) for p in PARAMS}
    return {"pm": pm, "loss": float(loss.detach()), "grads": grads, "after_adam": after,
            "outputs": tuple(t.detach().numpy() for t in (out, h_n, c_n))}


# -- the cell ------------------------------------------------------------------

def _jnp_cell(gates, c, sa, ss, st, sc, sth, sh):
    """The JAX package's fused step (rnn.py _fused_scan) as one jnp function."""
    def fq(x, s, lo, hi):
        return jax_tensor_clamp(jax_round_ste(x / s), jnp.asarray(float(lo)),
                                jnp.asarray(float(hi))) * s

    (alo, ahi), (slo, shi), (tlo, thi), (clo, chi), (thlo, thhi), (hlo, hhi) = BOUNDS
    ga = fq(gates, sa, alo, ahi)
    i_t = fq(jax.nn.sigmoid(ga[:, :H]), ss[:H], slo, shi)
    f_t = fq(jax.nn.sigmoid(ga[:, H:2 * H]), ss[H:2 * H], slo, shi)
    o_t = fq(jax.nn.sigmoid(ga[:, 3 * H:]), ss[2 * H:], slo, shi)
    g_t = fq(jnp.tanh(ga[:, 2 * H:3 * H]), st, tlo, thi)
    c_new = fq(f_t * c + i_t * g_t, sc, clo, chi)
    return fq(o_t * fq(jnp.tanh(c_new), sth, thlo, thhi), sh, hlo, hhi), c_new


def _cell_args():
    """tests/test_kernels.py's _cell_args inputs, and upstream gradients."""
    rng = np.random.default_rng(123456)
    args = (rng.standard_normal((B, 4 * H)).astype(np.float32) * 2,
            rng.standard_normal((B, H)).astype(np.float32),
            rng.uniform(0.01, 0.05, (4 * H,)).astype(np.float32),
            rng.uniform(0.002, 0.01, (3 * H,)).astype(np.float32),
            np.float32(0.008), np.float32(0.02), np.float32(0.008), np.float32(0.008))
    dh = rng.standard_normal((B, H)).astype(np.float32)
    dcn = rng.standard_normal((B, H)).astype(np.float32)
    return args, dh, dcn


@jax.jit
def _jax_cell_vjp(args, dh, dcn):
    """Forward and gradients of sum(h * dh) + sum(c_new * dcn) (the VJP with
    cotangents dh, dcn) through the Pallas kernel (interpret mode) and the
    jnp composition, under one jit."""
    def pallas(*v):
        return jax_quant_lstm_cell(*v, H, BOUNDS, True)

    outs, grads = [], []
    for fn in (pallas, _jnp_cell):
        out, vjp = jax.vjp(fn, *args)
        outs.append(out)
        grads.append(vjp((dh, dcn)))
    return outs, grads


@pytest.fixture(scope="module")
def cell():
    """The cell in both packages: forward and gradients through the Pallas
    kernel (interpret mode) and the jnp composition (``_jax_cell_vjp``)."""
    args, dh, dcn = _cell_args()
    (pallas_out, jnp_out), (pallas_grads, jnp_grads) = _jax_cell_vjp(
        tuple(jnp.asarray(a) for a in args), jnp.asarray(dh), jnp.asarray(dcn))
    t = [torch.from_numpy(np.asarray(a)) for a in args]
    dh_t, dcn_t = torch.from_numpy(dh), torch.from_numpy(dcn)
    with torch.no_grad():
        port_out = quant_lstm_cell_reference(*t, BOUNDS)
    port_grads = quant_lstm_cell_backward_reference(*t, dh_t, dcn_t, BOUNDS)
    terms, parts, pre, _ = quant_lstm_cell_scale_terms(*t, dh_t, dcn_t, BOUNDS)
    as_np = lambda seq: [np.asarray(v) for v in seq]  # noqa: E731
    return {"args": t, "dh": dh_t, "dcn": dcn_t,
            "out": {"port": as_np(port_out), "pallas": as_np(pallas_out),
                    "jnp": as_np(jnp_out)},
            "grads": {"port": as_np(port_grads), "pallas": as_np(pallas_grads),
                      "jnp": as_np(jnp_grads)},
            "terms": [tm.numpy() for tm in terms], "parts": [p.numpy() for p in parts],
            "pre": [x.numpy() for x in pre]}


def _tie_ulps(pre) -> np.ndarray:
    """Per (b, j): the fewest float32 ulps between a stage's value before
    rounding (the port's forward) and a .5 tie."""
    dist = []
    for v in pre:
        with np.errstate(over="ignore"):
            ulps = np.abs(np.abs(v - np.floor(v)) - 0.5) / np.spacing(np.abs(v))
        dist.append(ulps.reshape(B, -1, H).min(axis=1))
    return np.min(dist, axis=0)


@pytest.mark.parametrize("ref", ["pallas", "jnp"])
def test_cell_forward_matches_jax(cell, ref):
    """h and c_new equal JAX's (the Pallas kernel in interpret mode, or the
    jnp composition), except at certified ties."""
    ties = _tie_ulps(cell["pre"]) <= TIE_ULPS
    for got, want in zip(cell["out"]["port"], cell["out"][ref]):
        differ = got != want
        assert not np.any(differ & ~ties), f"{ref}: {int((differ & ~ties).sum())} differ"
    print(f"cell forward against {ref}: {int(ties.sum())} certified ties of {ties.size}")


@pytest.mark.parametrize("ref", ["pallas", "jnp"])
def test_cell_backward_matches_jax(cell, ref):
    """Against jax.grad of the Pallas kernel's VJP, or of the jnp composition."""
    port, want = cell["grads"]["port"], cell["grads"][ref]
    for got, exp in zip(port[:2], want[:2]):  # dgates, dc
        np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-5, err_msg=ref)
    for got, exp, term, part in zip(port[2:], want[2:], cell["terms"], cell["parts"]):
        dims = (0,) if term.shape[1] == np.size(exp) else (0, 1)
        exact, mass = term.sum(axis=dims), part.sum(axis=dims)
        got, exp = (np.asarray(v, np.float64).reshape(mass.shape) for v in (got, exp))
        assert np.all(np.abs(got - exact) <= 1e-5 * mass)
        assert np.all(np.abs(exp - exact) <= 1e-5 * mass), ref
        assert np.all(np.abs(got - exp) <= 2e-5 * mass), ref


# sa and ss per gate block (the leg's per-tensor gate quantizers, as
# QuantLSTM passes them) or one broadcast value; the JAX cell takes them
# spread over the gate columns, (4H,) and (3H,)
SCALE_FORMS = {"gate": (np.float32([0.02, 0.035, 0.012, 0.045]),
                        np.float32([0.0035, 0.008, 0.0025])),
               "one": (np.float32([0.03]), np.float32([0.0035]))}


@pytest.fixture(scope="module")
def cell_per_tensor():
    """For each SCALE_FORMS entry: the port's plain backward at the compact
    scales (what the wrapper runs on a CPU tensor), JAX's gradients at the
    scales spread over the columns (the jit of ``cell``, reused), the port's
    plain backward at the spread scales, and the float64 terms of each
    scale's gradient at the compact scales."""
    args, dh, dcn = _cell_args()
    dh_t, dcn_t = torch.from_numpy(dh), torch.from_numpy(dcn)
    out = {}
    for form, (sa, ss) in SCALE_FORMS.items():
        spread = [np.repeat(sa, H) if sa.size > 1 else np.full(4 * H, sa[0], np.float32),
                  np.repeat(ss, H) if ss.size > 1 else np.full(3 * H, ss[0], np.float32)]
        full = (args[0], args[1], *spread, *args[4:])
        _, (pallas_grads, jnp_grads) = _jax_cell_vjp(
            tuple(jnp.asarray(a) for a in full), jnp.asarray(dh), jnp.asarray(dcn))
        compact = [torch.from_numpy(np.asarray(a)) for a in (args[0], args[1], sa, ss, *args[4:])]
        wide = [torch.from_numpy(np.asarray(a)) for a in full]
        terms, parts, _, _ = quant_lstm_cell_scale_terms(*compact, dh_t, dcn_t, BOUNDS)
        out[form] = {
            "port": [g.numpy() for g in quant_lstm_cell_backward(*compact, dh_t, dcn_t, BOUNDS)],
            "pallas": [np.asarray(g) for g in pallas_grads],
            "jnp": [np.asarray(g) for g in jnp_grads],
            "spread": [g.numpy() for g in quant_lstm_cell_backward_reference(
                *wide, dh_t, dcn_t, BOUNDS)],
            "terms": [tm.numpy() for tm in terms], "parts": [p.numpy() for p in parts]}
    return out


@pytest.mark.parametrize("form", list(SCALE_FORMS))
@pytest.mark.parametrize("ref", ["pallas", "jnp", "spread"])
def test_cell_backward_per_tensor_scales(cell_per_tensor, form, ref):
    """The backward with sa and ss per gate block or one value, against
    JAX's VJP (Pallas kernel or jnp composition) and the port's own plain
    backward at the scales spread over the columns: dgates and dc as in
    test_cell_backward_matches_jax; each compact scale's gradient is the sum
    of the spread one over the columns that share it, within the same
    bounds of the float64 sum of its terms."""
    c = cell_per_tensor[form]
    port, want = c["port"], c[ref]
    for got, exp in zip(port[:2], want[:2]):
        np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-5, err_msg=ref)
    for got, exp, term, part in zip(port[2:], want[2:], c["terms"], c["parts"]):
        n = np.size(got)
        assert np.shape(got) == (() if np.ndim(got) == 0 else (n,))
        # the spread gradient summed over the columns that share a value
        exp = np.asarray(exp, np.float64).reshape(n, -1).sum(axis=1)
        exact = term.reshape(term.shape[0], n, -1).sum(axis=(0, 2))
        mass = part.reshape(part.shape[0], n, -1).sum(axis=(0, 2))
        got = np.asarray(got, np.float64).reshape(n)
        assert np.all(np.abs(got - exact) <= 1e-5 * mass)
        assert np.all(np.abs(exp - exact) <= 1e-5 * mass), ref
        assert np.all(np.abs(got - exp) <= 2e-5 * mass), ref


@pytest.mark.parametrize("b,rows", [(1, 1), (63, 1), (64, 1), (65, 2), (128, 2), (1024, 16),
                                    (1025, 17)])
def test_backward_plan(b, rows):
    """The backward kernel's rows a thread at its boundaries: one row on
    each of a CTA's 64 row lanes up to B 64, then more; every row covered
    once."""
    assert quant_lstm_cell_backward_plan(b) == rows
    covered = sorted(r * 64 + lane for r in range(rows) for lane in range(64))
    assert [x for x in covered if x < b] == list(range(b))


def test_cell_wrappers_take_the_plain_version_on_the_cpu(cell):
    """A CPU tensor takes the plain version, and no kernel is launched."""
    t, dh, dcn = cell["args"], cell["dh"], cell["dcn"]
    with torch.no_grad():
        got = quant_lstm_cell(*t, BOUNDS)
    for a, b in zip(got, cell["out"]["port"]):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(quant_lstm_cell_backward(*t, dh, dcn, BOUNDS), cell["grads"]["port"]):
        np.testing.assert_array_equal(a.numpy(), b)
    assert quant_lstm_cell.launches == 0 and quant_lstm_cell_backward.launches == 0


def test_cell_wrappers_refuse_devices_without_a_kernel():
    """A tensor on a device without a kernel is refused, never sent to the
    plain version."""
    gates = torch.zeros((2, 8), device="meta")
    c = torch.zeros((2, 2), device="meta")
    scales = (torch.ones(8, device="meta"), torch.ones(6, device="meta"),
              *(torch.ones((), device="meta") for _ in range(4)))
    with pytest.raises(ValueError):
        quant_lstm_cell(gates, c, *scales, BOUNDS)
    with pytest.raises(ValueError):
        quant_lstm_cell_backward(gates, c, *scales, c, c, BOUNDS)


# -- the forward's stage tables and its two addends ---------------------------

# 10-bit accumulators (1024 codes, the most the tables take) and a 4-bit cell
WIDE_BOUNDS = ((-512, 511), (0, 255), (-128, 127), (-8, 7), (-128, 127), (-128, 127))
TABLE_SCALES = {"gate": SCALE_FORMS["gate"], "one": SCALE_FORMS["one"]}


def _table_cell_inputs(form: str, b: int = 6, h: int = 32):
    """Gates and state drawn so that every acc and cell code range is
    reached at both ends, with a NaN gate and a NaN state element, and the
    code -0 at an i and a g gate (tanh keeps the sign) and at a cell state
    (f c' of a tiny negative c, i g = 0); ``sa`` and ``ss`` per gate block
    or one value; the four scalar scales."""
    rng = np.random.default_rng(7)
    gates = rng.standard_normal((b, 4 * h)).astype(np.float32) * 6
    c = rng.standard_normal((b, h)).astype(np.float32) * 2
    gates[0, 0] = np.nan
    c[1, 1] = np.nan
    gates[2, 3] = gates[3, 2 * h + 6] = -1e-4
    gates[2, 2 * h + 5], c[2, 5] = 0.0, -1e-5
    sa, ss = TABLE_SCALES[form]
    return (torch.from_numpy(gates), torch.from_numpy(c), torch.from_numpy(sa),
            torch.from_numpy(ss), *(torch.tensor(v) for v in (0.005, 0.015, 0.005, 0.003)))


def _stages(gates, c, scales, bounds):
    """The plain version's six stages as (code, output) pairs, and (h,
    c_new): ``cell_step`` with each stage's fake-quant written out."""
    h_dim = c.shape[1]
    spread = (gate_columns(scales[0], 4, h_dim), gate_columns(scales[1], 3, h_dim), *scales[2:])
    seen = []

    def stage(x, k):
        q = tensor_clamp(torch.round(x / spread[k]), *bounds[k])
        seen.append((q, q * spread[k]))
        return seen[-1][1]

    return seen, cell_step(gates, c, stage)


def _slots(q: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    """The kernel's slot of each code: q - lo; -0 at n, NaN at n + 1."""
    slot = torch.where(torch.isnan(q), lo, q).long() - lo
    slot = torch.where((q == 0) & torch.signbit(q), n, slot)
    return torch.where(torch.isnan(q), n + 1, slot)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal to the bit (the sign of zero counts), NaN where NaN."""
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(torch.where(nan, 0.0, a).view(torch.int32),
                            torch.where(nan, 0.0, b).view(torch.int32)))


@pytest.mark.parametrize("form,bounds", [("gate", BOUNDS), ("one", BOUNDS),
                                         ("gate", WIDE_BOUNDS)])
def test_tables_reproduce_the_plain_stages(form, bounds):
    """Each table, indexed by the plain version's own codes, gives that
    version's stage outputs bit for bit: gate table k the stage after gate
    k's sigmoid (tanh for g) at its acc code, the cell table the stage
    after tanh(c') at the cell code; every code range reached at both ends,
    codes -0 and NaN included."""
    gates, c, *scales = _table_cell_inputs(form)
    h_dim = c.shape[1]
    seen, (h, c_new) = _stages(gates, c, scales, bounds)
    want_h, want_c = quant_lstm_cell_reference(gates, c, *scales, bounds)
    assert _same_bits(h, want_h) and _same_bits(c_new, want_c)
    tables = quant_lstm_cell_tables_reference(*scales[:5], bounds)
    (alo, ahi), (clo, chi) = bounds[0], bounds[3]
    stride, cell_off, total = table_layout(alo, ahi, clo, chi)
    assert tables.shape == (total,) and total % 4 == 0
    (qa, _), (_, sig), (_, g_t), (qc, _), (_, th), _ = seen
    for q, lo, hi in ((qa, alo, ahi), (qc, clo, chi)):
        finite = q[~torch.isnan(q)]
        assert finite.min() == lo and finite.max() == hi
        assert bool(((q == 0) & torch.signbit(q)).any()) and bool(torch.isnan(q).any())
    outs = (sig[:, :h_dim], sig[:, h_dim:2 * h_dim], g_t, sig[:, 2 * h_dim:])
    for k, want in enumerate(outs):
        code = qa[:, k * h_dim:(k + 1) * h_dim]
        got = tables[k * stride:(k + 1) * stride][_slots(code, alo, ahi - alo + 1)]
        assert _same_bits(got, want), f"gate table {k}"
    got = tables[cell_off:cell_off + chi - clo + 3][_slots(qc, clo, chi - clo + 1)]
    assert _same_bits(got, th), "cell table"


@pytest.mark.parametrize("strides,acc,cell,want", [
    ((1, 0, 1, 0), (-128, 127), (-128, 127), 1292),   # per gate block: the leg's
    ((0, 0, 0, 0), (-128, 127), (-128, 127), 1292),   # one value each
    ((0, 0, 1, 0), (0, 0), (0, 0), 16),               # one code each
    ((H, 1, 1, 0), (-128, 127), (-128, 127), 0),      # sa per column
    ((1, 0, H, 1), (-128, 127), (-128, 127), 0),      # ss per column
    ((1, 0, 1, 0), (-512, 511), (-8, 7), 4124),       # 1024 acc codes
    ((1, 0, 1, 0), (-512, 512), (-8, 7), 0),          # 1025
    ((1, 0, 1, 0), (-8, 7), (0, 1024), 0),            # 1025 cell codes
    ((1, 0, 1, 0), (5, 4), (-8, 7), 0),               # an empty range
    ((1, 0, 1, 0), (2**24 - 9, 2**24), (-8, 7), 68),  # codes up to 2^24
    ((1, 0, 1, 0), (-8, 7), (2**24 - 9, 2**24 + 1), 0),  # past 2^24
])
def test_table_plan(strides, acc, cell, want):
    """The rule the forward's launcher applies (its Python twin; the C side
    is checked against it on the card): the tables serve sa and ss with no
    column stride and ordered code ranges of at most 1024 codes within
    +-2^24; their floats are 4 (n_acc + 2) + n_cell + 2, padded to a
    multiple of 4."""
    got = quant_lstm_cell_table_plan(*strides, *acc, *cell)
    assert got == want
    if want:
        used = 4 * (acc[1] - acc[0] + 3) + cell[1] - cell[0] + 3
        assert got % 4 == 0 and used <= got < used + 4


@pytest.mark.parametrize("form", ["column", "gate", "one"])
def test_tables_wrapper_follows_the_plan(form):
    """On a CPU tensor ``quant_lstm_cell_tables`` builds nothing and gives
    None for every scale form, the plain cell forming each stage itself; no
    kernel is launched. The plan still tells the forms apart: tables for
    one scale per gate block or one value, the direct chain per column."""
    sa, ss = (np.float32(np.linspace(0.01, 0.05, 4 * H)), np.float32(np.linspace(
        0.002, 0.01, 3 * H))) if form == "column" else TABLE_SCALES[form]
    sa_t, ss_t = (torch.from_numpy(v).requires_grad_() for v in (sa, ss))
    scalars = [torch.tensor(v, requires_grad=True) for v in (0.005, 0.015, 0.005)]
    assert quant_lstm_cell_tables(sa_t, ss_t, *scalars, BOUNDS) is None
    assert quant_lstm_cell_tables.launches == 0
    strides = {"column": (H, 1, H, 1), "gate": (1, 0, 1, 0), "one": (0, 0, 0, 0)}[form]
    planned = quant_lstm_cell_table_plan(*strides, *BOUNDS[0], *BOUNDS[3])
    assert (planned == 0) == (form == "column")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["contiguous", "unbind"])
def test_two_addend_cell_on_the_cpu(dtype, layout):
    """``quant_lstm_cell(xp, c, ..., recurrent=p)`` equals the one-tensor
    plain version on ``xp.float() + p``, for a float32 or bf16 ``xp``,
    contiguous or a step of ``x_proj.unbind(1)``; its gradients to ``xp``
    (in ``xp``'s dtype) and to ``p`` equal autograd's through ``.to()`` and
    ``+``."""
    gates, c, *scales = _table_cell_inputs("gate", b=B, h=H)
    rng = np.random.default_rng(11)
    x_np = rng.standard_normal((B, 3, 4 * H)).astype(np.float32) * 3
    p_np = rng.standard_normal((B, 4 * H)).astype(np.float32) * 3
    dh, dcn = (torch.from_numpy(rng.standard_normal((B, H)).astype(np.float32))
               for _ in range(2))
    c = torch.from_numpy(np.nan_to_num(c.numpy()))
    tables = quant_lstm_cell_tables(*scales[:5], BOUNDS)
    runs = []
    for two in (True, False):
        x_all = torch.from_numpy(x_np).to(getattr(torch, dtype)).requires_grad_()
        p = torch.from_numpy(p_np).requires_grad_()
        xp = x_all.unbind(1)[1] if layout == "unbind" else x_all[:, 1].contiguous()
        if two:
            out = quant_lstm_cell(xp, c, *scales, BOUNDS, recurrent=p, tables=tables)
        else:
            out = quant_lstm_cell_reference(xp.to(torch.float32) + p, c, *scales, BOUNDS)
        torch.autograd.backward(out, (dh, dcn))
        assert x_all.grad.dtype == x_all.dtype
        runs.append((*out, x_all.grad, p.grad))
    for got, want in zip(*runs):
        assert _same_bits(got.float(), want.float())


def test_table_wrappers_refuse_devices_without_a_kernel():
    """The table build and the two-addend form refuse a tensor on a device
    without a kernel."""
    scales = (torch.ones(4, device="meta"), torch.ones(3, device="meta"),
              *(torch.ones((), device="meta") for _ in range(4)))
    with pytest.raises(ValueError):
        quant_lstm_cell_tables(*scales[:5], BOUNDS)
    xp, c = torch.zeros((2, 8), device="meta"), torch.zeros((2, 2), device="meta")
    with pytest.raises(ValueError):
        quant_lstm_cell(xp, c, *scales, BOUNDS, recurrent=xp)


# -- the model -----------------------------------------------------------------

@pytest.fixture(scope="module")
def port_calibrated(jax_run):
    """The port's own calibration forward from the JAX model's initial state
    (the module cell: no grid is static yet), then
    convert_runtime_stats_to_parameter."""
    pm = port_model(jax_run["init"], converted=False)
    r = {"fused_before": [layer._fused_cell_params() is not None for layer in pm.lstm.layers]}
    with torch.no_grad():
        pm(torch.from_numpy(jax_run["calib"]))
    r["calibrated"] = {path: port_tensor(pm, path) for path in jax_run["calibrated"]
                       if ".scaling." in path}
    r["n_converted"] = convert_runtime_stats_to_parameter(pm)
    r["pm"] = pm
    return r


def test_calibration_matches_jax(jax_run, port_calibrated):
    """Each quantizer's buffer, value and counter after one calibration
    forward."""
    assert port_calibrated["fused_before"] == [False] * LAYERS
    assert set(port_calibrated["calibrated"]) == {
        p for p in jax_run["calibrated"] if ".scaling." in p}
    for path, got in port_calibrated["calibrated"].items():
        want = jax_run["calibrated"][path]
        if path.endswith(".counter"):
            np.testing.assert_array_equal(got, want, err_msg=path)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=path)


def test_conversion_matches_jax(jax_run, port_calibrated):
    """convert_runtime_stats_to_parameter's learned scales, after which every
    layer takes the cell kernel's route."""
    pm = port_calibrated["pm"]
    assert port_calibrated["n_converted"] == jax_run["n_converted"] == len(SCALES)
    assert set(p for p, _ in pm.named_parameters()) == {
        p.replace("head.kernel", "head.weight") for p in PARAMS}
    for path in SCALES:
        owner = pm.get_submodule(path.rsplit(".", 2)[0])
        assert isinstance(owner.scaling, ParameterScaling)
        assert owner.cfg.scaling_impl == "parameter"
        np.testing.assert_allclose(port_tensor(pm, path), jax_run["converted"][path],
                                   rtol=1e-6, atol=0, err_msg=path)
    for layer in pm.lstm.layers:
        assert layer._kernel_cell_args(layer._fused_cell_params(), torch.float32) is not None


@pytest.mark.parametrize("path", ["fused", "module_cell"])
def test_forward_matches_jax(jax_run, port_step, path):
    """Outputs, h_n and c_n of the fused path or of the module cell, from the
    JAX model's converted state, against JAX's fused path; the fused path's
    loss."""
    if path == "fused":
        got = port_step["outputs"]
        assert port_step["loss"] == pytest.approx(jax_run["loss"], rel=1e-6)
    else:
        pm = port_model(jax_run["converted"], converted=True)
        for layer in pm.lstm.layers:
            layer.fused_cell = False
        with torch.no_grad():
            out, (h_n, c_n) = pm.lstm(torch.from_numpy(jax_run["x"]))
        got = (out.numpy(), h_n.numpy(), c_n.numpy())
    for g, w, name in zip(got, jax_run["outputs"], ("outputs", "h_n", "c_n")):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_array_equal(g, w, err_msg=f"{path} {name}")


@pytest.mark.parametrize("group", ["weights", "learned_scales"])
def test_gradients_match_jax(jax_run, port_step, group):
    """Every parameter's gradient, learned scales included."""
    scale_max = max(np.abs(jax_run["grads"][p]).max() for p in SCALES)
    for path in WEIGHTS if group == "weights" else SCALES:
        got, want = port_step["grads"][path], jax_run["grads"][path]
        assert got.shape == want.shape, path
        size = scale_max if path in SCALES else np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * size, err_msg=path)


def test_adam_step_matches_jax(jax_run, port_step):
    first_update = lambda g: LR * g / (np.abs(g) + ADAM_EPS)  # noqa: E731
    for path in PARAMS:
        got, want = port_step["after_adam"][path], jax_run["after_adam"][path]
        g_port, g_jax = port_step["grads"][path], jax_run["grads"][path]
        # ulps of the sum's larger operand, the parameter or the update
        # (about lr): p + u cancels where u is about -p
        operand = np.maximum(np.abs(jax_run["converted"][path]), np.float32(LR))
        tol = 4 * np.spacing(operand) + np.abs(first_update(g_port) - first_update(g_jax))
        assert np.all(np.abs(got - want) <= tol), path


@pytest.fixture(scope="module")
def port_bf16(jax_run):
    """The fused path with bf16 operands (``set_compute_dtype``) from the
    JAX model's converted state: outputs, loss and gradients."""
    pm = port_model(jax_run["converted"], converted=True)
    set_compute_dtype(pm, torch.bfloat16)
    out, _ = pm.lstm(torch.from_numpy(jax_run["x"]))
    loss = torch.nn.functional.cross_entropy(pm.head(out[:, -1]),
                                             torch.from_numpy(jax_run["y"]).long())
    loss.backward()
    return {"loss": float(loss.detach()), "outputs": out.detach().numpy(),
            "grads": {p: port_tensor(pm, p, grad=True) for p in PARAMS},
            "dtypes": {layer.compute_dtype for layer in pm.lstm.layers}}


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(v), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7).astype(np.float32)


@pytest.mark.parametrize("what", ["outputs", "gradients"])
def test_bf16_fused_path_matches_jax(jax_run, port_bf16, what):
    """bench's default run of the leg: x_proj and W_hh stored in bf16, the
    per-step product of a bf16-rounded h returning float32, the cell in
    float32. Outputs and loss as in float32 (exact; rtol 1e-6). Gradients:
    each operand gradient of the bf16 product is rounded to bf16 in both
    packages, so where their float32 inputs to that rounding differ in the
    last bits it falls either way (in 0.01-0.3 % of a weight's elements at
    these inputs), and W_hh's gradient is summed over the time steps in
    bf16 in both (the scan accumulates the cotangent of its bf16 constant in
    bf16, autograd a bf16 tensor's gradient), so a flipped step moves the
    sum by up to an ulp at each later addition: each weight element within
    four bf16 ulps of its own size plus 1e-3 of its largest element
    (measured 2.0 ulps or 9.5e-4), each learned scale's within 1e-5 of the
    largest learned-scale gradient (measured 3.7e-7)."""
    ref = jax_run["bf16"]
    assert port_bf16["dtypes"] == {torch.bfloat16}
    if what == "outputs":
        np.testing.assert_array_equal(port_bf16["outputs"], ref["outputs"])
        assert port_bf16["loss"] == pytest.approx(ref["loss"], rel=1e-6)
        return
    scale_max = max(np.abs(ref["grads"][p]).max() for p in SCALES)
    for path in PARAMS:
        got, want = port_bf16["grads"][path], ref["grads"][path]
        tol = (1e-5 * scale_max if path in SCALES
               else 1e-3 * np.abs(want).max() + 4 * _bf16_ulp(want))
        assert np.all(np.abs(got - want) <= tol), path


def test_load_jax_state_fills_shared_quantizers_and_the_head(jax_run):
    state = jax_run["converted"]
    # a quantizer that JAX shares appears once, at layer 0's path
    assert not any(k.startswith(f"lstm.layers.1.{q}") for k in state for q in SHARED)
    pm = port_model(state, converted=True)
    for q in SHARED:
        assert pm.get_submodule(f"lstm.layers.1.{q}") is pm.get_submodule(f"lstm.layers.0.{q}")
    for path, want in state.items():
        np.testing.assert_array_equal(port_tensor(pm, path), want, err_msg=path)
    assert tuple(pm.head.weight.shape) == (CLASSES, H)


def test_load_jax_state_refuses_unknown_paths_and_shapes():
    pm = port_model({}, converted=True)
    with pytest.raises((KeyError, AttributeError)):
        load_jax_state(pm, {"lstm.layers.2.w_ih": np.zeros((H, 4 * H), np.float32)})
    with pytest.raises(ValueError):
        load_jax_state(pm, {"head.kernel": np.zeros((CLASSES, H), np.float32)})


@pytest.mark.parametrize("option", [
    "coupled_input_forget_gates", "shared_input_hidden_weights",
    "shared_intra_layer_weight_quant", "shared_intra_layer_gate_acc_quant",
    "cat_output_cell_states"])
def test_quant_lstm_refuses_options_not_ported(option):
    kw = ({option: False} if option == "cat_output_cell_states"
          else {option: True, "bidirectional": True})
    with pytest.raises(NotImplementedError):
        PortQuantLSTM(I, H, device="cpu", **kw)


def test_quant_lstm_defaults_to_the_card():
    """The default device is the card, which raises where there is none."""
    if torch.cuda.is_available():
        assert next(PortQuantLSTM(I, H).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PortQuantLSTM(I, H)
