"""The quantized LSTM cell after its GEMM, forward and backward (port of
``brevitas_tpu/kernels/lstm_cell.py``).

One step of QuantLSTM's fused path: the gate accumulators ``gates`` (B, 4H),
packed (i, f, g, o), and the cell state ``c`` (B, H) go through six
fake-quant stages around the nonlinearities::

    ga  = Q(gates, sa)                      sa: a scale per gate column (4H,),
                                            per gate block (4,), or one value
    i, f, o = Q(sigmoid(ga_i, ga_f, ga_o), ss)   ss (3H,), (3,) or one, packed (i, f, o)
    g   = Q(tanh(ga_g), st)
    c'  = Q(f * c + i * g, sc)
    h   = Q(o * Q(tanh(c'), sth), sh)

with ``Q(x, s) = clamp(round(x / s), lo, hi) * s``: a division (the model
path's ``core/quant.py``; the Pallas kernel multiplies by the reciprocal,
which can move a value across a rounding tie), round half to even, and the
where-based clamp (the bound wins ties, the gradient passes at equality).
sigmoid and tanh are formed in float64 and rounded once, so the CUDA kernels
and the plain version agree bit for bit on the card; torch and XLA differ in
the last bit of their float32 sigmoid and tanh. The backward is the
straight-through estimator of ``round`` with the zeroing clamp: for each
stage ``dx = g * in_range`` and ``ds = sum(g * (q - in_range * x / s))``.

``quant_lstm_cell`` launches ``csrc/quant_lstm_cell.cu`` on a CUDA tensor
inside an ``autograd.Function`` whose backward launches the backward kernel
(``quant_lstm_cell_backward``), and takes the plain version
(``quant_lstm_cell_reference``, differentiated by autograd) on a CPU tensor.
The kernels read ``sa`` and ``ss`` through strides, so a per-block or
broadcast scale is never expanded, and the backward kernel sums its
gradient to the scale's own shape. The backward is one launch: its
float64 scale sums meet inside a CTA per column block and, across blocks,
through a ticket in a scratch buffer made once per device
(:func:`quant_lstm_cell_backward_plan` gives its rows a thread). The TPU
kernel's shape gate (H % 128, B % 8, a Pallas tiling rule) is not carried
over: the CUDA kernels take any B and H.
"""

import functools
from typing import Sequence, Tuple

import torch

from brevitas_tpu_torch.kernels import _launch
from brevitas_tpu_torch.ops import round_ste, sigmoid_f64, tanh_f64, tensor_clamp

Bounds = Sequence[Tuple[float, float]]  # (lo, hi) of acc, sigmoid, tanh_g, cell, tanh_h, hidden

# the backward kernel's CTA: 4 columns x 64 row lanes, 11 float64 partials
# per column block (kCols, kLanes, kSums in csrc/quant_lstm_cell.cu)
BWD_COLS, BWD_LANES, BWD_SUMS = 4, 64, 11


def quant_lstm_cell_backward_plan(b: int) -> int:
    """Rows a thread of the backward kernel at batch ``b`` (64 row lanes a
    CTA): csrc/quant_lstm_cell.cu's ``quant_lstm_cell_backward_plan``, in
    Python."""
    return max(1, -(-b // BWD_LANES))


def gate_columns(s, n: int, h: int):
    """A gate-packed scale in a form that broadcasts against its stage's
    (B, n H) values: one value per gate block (n,) repeated over the
    block's H columns; any other scale as it is."""
    if torch.is_tensor(s) and s.numel() == n and h > 1:
        return s.reshape(n).repeat_interleave(h)
    return s


def _fq(x: torch.Tensor, s, lo: float, hi: float) -> torch.Tensor:
    return tensor_clamp(round_ste(x / s), lo, hi) * s


def cell_step(gates: torch.Tensor, c: torch.Tensor,
              fake_quant) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cell's composition, (h, c_new), with ``fake_quant(x, k)`` the
    fake-quant of stage ``k`` (the index of ``bounds``: acc, sigmoid,
    tanh_g, cell, tanh_h, hidden). The plain version, QuantLSTM's plain
    fused step and the scale-gradient terms each pass their own."""
    h_dim = c.shape[-1]
    ga = fake_quant(gates, 0)
    sig = fake_quant(sigmoid_f64(torch.cat([ga[:, :2 * h_dim], ga[:, 3 * h_dim:]], dim=1)), 1)
    i_t, f_t, o_t = sig[:, :h_dim], sig[:, h_dim:2 * h_dim], sig[:, 2 * h_dim:]
    g_t = fake_quant(tanh_f64(ga[:, 2 * h_dim:3 * h_dim]), 2)
    c_new = fake_quant(f_t * c + i_t * g_t, 3)
    h = fake_quant(o_t * fake_quant(tanh_f64(c_new), 4), 5)
    return h, c_new


def quant_lstm_cell_reference(gates: torch.Tensor, c: torch.Tensor, sa, ss, st, sc, sth,
                              sh, bounds: Bounds) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (h, c_new), each (B, H). Differentiable by
    autograd through ``round_ste`` and ``tensor_clamp``. The scales may be of
    any shape that broadcasts against their stage, and ``sa`` and ``ss`` one
    value per gate block."""
    h_dim = c.shape[-1]
    scales = (gate_columns(sa, 4, h_dim), gate_columns(ss, 3, h_dim), st, sc, sth, sh)
    return cell_step(gates, c, lambda x, k: _fq(x, scales[k], *bounds[k]))


def quant_lstm_cell_backward_reference(gates, c, sa, ss, st, sc, sth, sh, dh, dcn,
                                       bounds: Bounds):
    """The plain version's gradients (autograd of the reference):
    (dgates, dc, dsa, dss, dst, dsc, dsth, dsh), each scale's gradient in
    the scale's shape."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (gates, c, sa, ss, st, sc, sth, sh)]
        h, c_new = quant_lstm_cell_reference(*inputs, bounds)
        return torch.autograd.grad((h, c_new), inputs, (dh, dcn), allow_unused=True)


def quant_lstm_cell_scale_terms(gates, c, sa, ss, st, sc, sth, sh, dh, dcn, bounds: Bounds):
    """Each scale's gradient as the plain version's per-element terms
    ``g * (q - in_range * x / s)`` in float64, ``g`` the gradient at the
    stage's output from the plain version's autograd, ``q`` and ``x / s`` as
    its float32 forward forms them; their float64 sums are what the backward
    kernel's scale gradients are held to. Returns four lists over the six
    stages, each tensor in the stage's shape ((B, 4H), (B, 3H) and four
    (B, H)): the terms; ``|g q| + |g in_range x / s|``, the size of the two
    parts that an autograd adds apart in float32 (each up to 255 times the
    size of their sum), which bounds its rounding; ``x / s`` before
    rounding, in float32; and the forward's (h, c_new)."""
    h_dim = c.shape[-1]
    scales = (gate_columns(sa, 4, h_dim), gate_columns(ss, 3, h_dim), st, sc, sth, sh)
    seen = []

    def stage(x, k):
        lo, hi = bounds[k]
        xs = x.detach() / scales[k]
        code = torch.round(xs)
        y = _fq(x, scales[k], lo, hi)
        y.retain_grad()
        seen.append((y, xs, tensor_clamp(code, lo, hi), (code >= lo) & (code <= hi)))
        return y

    with torch.enable_grad():
        h, c_new = cell_step(gates.detach().requires_grad_(), c.detach().requires_grad_(),
                             stage)
        torch.autograd.backward((h, c_new), (dh, dcn))
    terms, parts = [], []
    for y, xs, q, inr in seen:
        g, xs_in = y.grad.double(), torch.where(inr, xs.double(), 0.0)
        terms.append(g * (q.double() - xs_in))
        parts.append((g * q.double()).abs() + (g * xs_in).abs())
    return terms, parts, [xs for _, xs, _, _ in seen], (h.detach(), c_new.detach())


def _int_bounds(bounds: Bounds):
    """The six (lo, hi) pairs as 12 ints for the launcher."""
    flat = [float(v) for pair in bounds for v in pair]
    if len(flat) != 12 or any(v != int(v) or abs(v) >= 2**31 for v in flat):
        raise ValueError(f"bounds must be six (lo, hi) integer pairs in int32, got {bounds}")
    return [int(v) for v in flat]


def _gate_scale(name: str, s, n: int, h_dim: int, device: torch.device):
    """A gate-packed scale on the card and its (gate, column) strides: one
    value (0, 0), one per gate block (1, 0), or one per column (H, 1); never
    expanded (a stride-0 view of one value is read as that value)."""
    flat = torch.as_tensor(s, dtype=torch.float32, device=device).reshape(-1)
    strides = {1: (0, 0), n: (1, 0), n * h_dim: (h_dim, 1)}.get(flat.numel())
    if strides is None:
        raise ValueError(f"{name} has {flat.numel()} values, expected 1, {n} or {n * h_dim}")
    return flat.contiguous(), *strides


def _cell_operands(gates, c, sa, ss, st, sc, sth, sh):
    """Checked float32 operands on the card: the two matrices, the six
    scales (``sa`` and ``ss`` with their strides; the four scalar scales as
    1-element tensors, read by the kernels from device memory, so no value
    crosses to the host)."""
    device = gates.device
    _launch.check_matrix("gates", gates, torch.float32, device)
    _launch.check_matrix("c", c, torch.float32, device)
    b, gh = gates.shape
    h_dim = c.shape[1]
    if gh != 4 * h_dim or c.shape[0] != b:
        raise ValueError(f"gates {tuple(gates.shape)} and c {tuple(c.shape)} are not "
                         "(B, 4H) and (B, H)")
    sa_t, *sa_str = _gate_scale("sa", sa, 4, h_dim, device)
    ss_t, *ss_str = _gate_scale("ss", ss, 3, h_dim, device)
    scalars = [_launch.f32_vector(name, v, 1, device)
               for name, v in (("st", st), ("sc", sc), ("sth", sth), ("sh", sh))]
    return b, h_dim, [sa_t, ss_t] + scalars, sa_str + ss_str


@functools.lru_cache(maxsize=None)
def _forward_launcher():
    return _launch.bind("quant_lstm_cell", "quant_lstm_cell_launch", 10, 18)


@functools.lru_cache(maxsize=None)
def _backward_launcher():
    return _launch.bind("quant_lstm_cell", "quant_lstm_cell_backward_launch", 17, 18)


_SCRATCH = {}  # device -> float64 tensor: the ticket (in 16 bytes), then the partials


def _backward_scratch(device: torch.device, col_blocks: int) -> torch.Tensor:
    """The backward kernel's ticket and float64 partials, zeroed once when
    made and left at a zero ticket by every launch; grown, never shrunk."""
    need = 2 + BWD_SUMS * col_blocks
    buf = _SCRATCH.get(device)
    if buf is None or buf.numel() < need:
        buf = torch.zeros(need, dtype=torch.float64, device=device)
        _SCRATCH[device] = buf
    return buf


def _forward_kernel(gates, c, sa, ss, st, sc, sth, sh, bounds):
    b, h_dim, scales, strides = _cell_operands(gates, c, sa, ss, st, sc, sth, sh)
    h = torch.empty((b, h_dim), dtype=torch.float32, device=gates.device)
    c_new = torch.empty_like(h)
    _launch.launch(_forward_launcher(), "quant_lstm_cell", gates.device,
                   gates.data_ptr(), c.data_ptr(), *(t.data_ptr() for t in scales),
                   h.data_ptr(), c_new.data_ptr(), b, h_dim, *strides, *_int_bounds(bounds))
    quant_lstm_cell.launches += 1
    return h, c_new


def quant_lstm_cell_backward(gates, c, sa, ss, st, sc, sth, sh, dh, dcn, bounds: Bounds):
    """Gradients of one cell step: (dgates, dc, dsa, dss, dst, dsc, dsth,
    dsh), each scale's in the scale's shape. On a CUDA tensor one launch of
    the backward kernel recomputes the forward from ``gates`` and ``c`` and
    sums each scale's gradient in a fixed order (the same bits on every
    run); on a CPU tensor the plain version's autograd."""
    if gates.device.type == "cpu":
        return quant_lstm_cell_backward_reference(gates, c, sa, ss, st, sc, sth, sh, dh, dcn,
                                                  bounds)
    if gates.device.type != "cuda":
        raise ValueError(f"quant_lstm_cell_backward runs on cuda or cpu, not {gates.device}")
    device = gates.device
    b, h_dim, scales, strides = _cell_operands(gates, c, sa, ss, st, sc, sth, sh)
    _launch.check_matrix("dh", dh, torch.float32, device)
    _launch.check_matrix("dcn", dcn, torch.float32, device)
    if dh.shape != c.shape or dcn.shape != c.shape:
        raise ValueError("dh and dcn must have the shape of c")
    dgates = torch.empty_like(gates)
    dc = torch.empty_like(c)
    dsa = torch.empty(scales[0].numel(), dtype=torch.float32, device=device)
    dss = torch.empty(scales[1].numel(), dtype=torch.float32, device=device)
    dscalars = torch.empty(4, dtype=torch.float32, device=device)
    if b and h_dim:
        scratch = _backward_scratch(device, -(-h_dim // BWD_COLS))
        _launch.launch(_backward_launcher(), "quant_lstm_cell_backward", device,
                       gates.data_ptr(), c.data_ptr(), *(t.data_ptr() for t in scales),
                       dh.data_ptr(), dcn.data_ptr(), dgates.data_ptr(), dc.data_ptr(),
                       dsa.data_ptr(), dss.data_ptr(), dscalars.data_ptr(),
                       scratch.data_ptr() + 16, scratch.data_ptr(), b, h_dim, *strides,
                       *_int_bounds(bounds))
        quant_lstm_cell_backward.launches += 1
    else:
        for t in (dsa, dss, dscalars):
            t.zero_()
    return (dgates, dc, _grad_like(dsa, sa), _grad_like(dss, ss),
            *(_grad_like(dscalars[i], s) for i, s in enumerate((st, sc, sth, sh))))


def _grad_like(g: torch.Tensor, ref):
    """A scale's gradient (as many values as the scale) in the scale's own
    shape; None for a scale that is no tensor."""
    return g.reshape(ref.shape) if torch.is_tensor(ref) else None


class _QuantLSTMCell(torch.autograd.Function):
    """Forward kernel; the backward kernel recomputes the forward from the
    saved ``gates`` and ``c`` (the TPU kernel's residuals)."""

    @staticmethod
    def forward(ctx, gates, c, sa, ss, st, sc, sth, sh, bounds):
        ctx.save_for_backward(gates, c, sa, ss, st, sc, sth, sh)
        ctx.bounds = bounds
        return _forward_kernel(gates, c, sa, ss, st, sc, sth, sh, bounds)

    @staticmethod
    def backward(ctx, dh, dcn):
        gates, c, *scales = ctx.saved_tensors
        dh = torch.zeros_like(c) if dh is None else dh.contiguous()
        dcn = torch.zeros_like(c) if dcn is None else dcn.contiguous()
        return (*quant_lstm_cell_backward(gates, c, *scales, dh, dcn, ctx.bounds), None)


def quant_lstm_cell(gates: torch.Tensor, c: torch.Tensor, sa, ss, st, sc, sth, sh,
                    bounds: Bounds) -> Tuple[torch.Tensor, torch.Tensor]:
    """One quantized LSTM cell step after the GEMM: ``gates`` (B, 4H)
    float32 packed (i, f, g, o), ``c`` (B, H); ``sa`` (4H,), (4,) one per
    gate block, or a scalar, ``ss`` (3H,) packed (i, f, o), (3,) or a
    scalar, ``st, sc, sth, sh`` scalars;
    ``bounds`` the six integer (lo, hi) clamp bounds in the order (acc,
    sigmoid, tanh_g, cell, tanh_h, hidden). Returns (h, c_new), (B, H)
    float32; gradients reach ``gates``, ``c`` and every scale."""
    if gates.device.type == "cpu":
        return quant_lstm_cell_reference(gates, c, sa, ss, st, sc, sth, sh, bounds)
    if gates.device.type != "cuda":
        raise ValueError(f"quant_lstm_cell runs on cuda or cpu, not {gates.device}")
    scales = [s if torch.is_tensor(s) else torch.tensor(float(s), device=gates.device)
              for s in (sa, ss, st, sc, sth, sh)]
    return _QuantLSTMCell.apply(gates, c, *scales, tuple(bounds))


quant_lstm_cell.launches = 0
quant_lstm_cell_backward.launches = 0
