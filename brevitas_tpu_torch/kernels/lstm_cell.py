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
It takes the gates as one tensor, or as two addends ``xp + recurrent`` (the
step's input projection, float32 or bf16, read through its row stride, and
the recurrent product): the kernel forms the sum (torch's add, bit for bit)
and keeps it for the backward, so no separate add or cast runs. With
``tables`` (``quant_lstm_cell_tables``: each gate's sigmoid or tanh stage,
and the cell's tanh stage, as functions of their input's integer code,
built once for a set of scales) the forward reads those stages from shared
memory instead of forming float64 ``exp`` and ``tanh`` per element;
:func:`quant_lstm_cell_table_plan` says which scales and bounds the tables
serve (sa and ss one per gate block or one value, code ranges of at most
``TABLE_MAX_CODES``); every other configuration takes the direct chain.
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
from typing import Optional, Sequence, Tuple

import torch

from brevitas_tpu_torch.kernels import _launch
from brevitas_tpu_torch.ops import round_ste, sigmoid_f64, tanh_f64, tensor_clamp

Bounds = Sequence[Tuple[float, float]]  # (lo, hi) of acc, sigmoid, tanh_g, cell, tanh_h, hidden

# the backward kernel's CTA: 4 columns x 64 row lanes, 11 float64 partials
# per column block (kCols, kLanes, kSums in csrc/quant_lstm_cell.cu)
BWD_COLS, BWD_LANES, BWD_SUMS = 4, 64, 11


# the forward's stage tables (kMaxCodes, kMaxCodeMagnitude in
# csrc/quant_lstm_cell.cu): the most codes a range may hold, and the largest
# code magnitude (every code exact in float32)
TABLE_MAX_CODES, TABLE_MAX_MAGNITUDE = 1024, 1 << 24


def table_layout(alo: int, ahi: int, clo: int, chi: int) -> Tuple[int, int, int]:
    """The stage tables' layout: four gate tables (i, f, g, o) of
    ``ahi - alo + 3`` slots (the codes lo..hi, then -0, then NaN), the cell
    table of ``chi - clo + 3`` from the returned offset, padded to whole
    16-byte chunks. Returns (gate table stride, cell table offset, floats)."""
    stride = ahi - alo + 3
    cell_off = 4 * stride
    return stride, cell_off, -(-(cell_off + chi - clo + 3) // 4) * 4


def quant_lstm_cell_table_plan(sa_gate: int, sa_col: int, ss_gate: int, ss_col: int,
                               alo: int, ahi: int, clo: int, chi: int) -> int:
    """The floats of the forward's stage tables where they serve, else 0
    (the direct chain): sa and ss at strides (gate, column) with no column
    stride (one per gate block or one value), and the acc and cell code
    ranges each ordered, within +-2^24 and at most TABLE_MAX_CODES long.
    csrc/quant_lstm_cell.cu's ``quant_lstm_cell_table_plan``, in Python."""
    if sa_col != 0 or ss_col != 0:
        return 0
    for lo, hi in ((alo, ahi), (clo, chi)):
        if lo < -TABLE_MAX_MAGNITUDE or hi > TABLE_MAX_MAGNITUDE or lo > hi:
            return 0
        if hi - lo + 1 > TABLE_MAX_CODES:
            return 0
    return table_layout(alo, ahi, clo, chi)[2]


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


def quant_lstm_cell_tables_reference(sa, ss, st, sc, sth, bounds: Bounds) -> torch.Tensor:
    """Plain version of the forward's stage tables (``table_layout``): slot
    ``q - lo`` of gate table k (i, f, g, o) holds ``Q(sigmoid(q sa_k),
    ss_k)`` (``Q(tanh(q sa_g), st)`` for g), slot ``q - lo`` of the cell
    table ``Q(tanh(q sc), sth)``, each formed as the plain version forms the
    stage; the two slots after a range hold the codes -0 and NaN. ``sa`` and
    ``ss`` hold one value per gate block ((4,), (3,)) or one value."""
    device = next((s.device for s in (sa, ss, st, sc, sth) if torch.is_tensor(s)),
                  torch.device("cpu"))
    sa, ss, st, sc, sth = (torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)
                           for v in (sa, ss, st, sc, sth))
    if sa.numel() not in (1, 4) or ss.numel() not in (1, 3):
        raise ValueError(f"the tables take sa and ss one per gate block or one value, got "
                         f"{sa.numel()} and {ss.numel()} values")
    (alo, ahi), (slo, shi), (tlo, thi), (clo, chi), (thlo, thhi), _ = _int_pairs(bounds)

    def codes(lo, hi):
        q = torch.arange(lo, hi + 1, device=device).to(torch.float32)
        return torch.cat([q, torch.tensor([-0.0, float("nan")], device=device)])

    qa, parts = codes(alo, ahi), []
    for k in range(4):
        a = qa * sa[k % sa.numel()]
        if k == 2:
            parts.append(_fq(tanh_f64(a), st[0], tlo, thi))
        else:
            parts.append(_fq(sigmoid_f64(a), ss[min(k, 2) % ss.numel()], slo, shi))
    parts.append(_fq(tanh_f64(codes(clo, chi) * sc[0]), sth[0], thlo, thhi))
    flat = torch.cat(parts)
    total = table_layout(alo, ahi, clo, chi)[2]
    return torch.cat([flat, flat.new_zeros(total - flat.numel())])


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


def _int_pairs(bounds: Bounds):
    flat = _int_bounds(bounds)
    return [tuple(flat[i:i + 2]) for i in range(0, 12, 2)]


def _gate_scale(name: str, s, n: int, h_dim: int, device: torch.device):
    """A gate-packed scale on the card and its (gate, column) strides: one
    value (0, 0), one per gate block (1, 0; also at H 1, as the tables take
    it), or one per column (H, 1); never expanded (a stride-0 view of one
    value is read as that value)."""
    flat = torch.as_tensor(s, dtype=torch.float32, device=device).reshape(-1)
    strides = {1: (0, 0), n * h_dim: (h_dim, 1), n: (1, 0)}.get(flat.numel())
    if strides is None:
        raise ValueError(f"{name} has {flat.numel()} values, expected 1, {n} or {n * h_dim}")
    return flat.contiguous(), *strides


def _cell_operands(gates, c, sa, ss, st, sc, sth, sh):
    """Checked float32 operands on the card: ``c`` and the six scales
    (``sa`` and ``ss`` with their strides; the four scalar scales as
    1-element tensors, read by the kernels from device memory, so no value
    crosses to the host), for gates of ``gates``' shape."""
    device = c.device
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
    return _launch.bind("quant_lstm_cell", "quant_lstm_cell_launch", 13, 20)


@functools.lru_cache(maxsize=None)
def _tables_launcher():
    return _launch.bind("quant_lstm_cell", "quant_lstm_cell_tables_launch", 6, 16)


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


def quant_lstm_cell_tables(sa, ss, st, sc, sth, bounds: Bounds):
    """The forward's stage tables for these scales and bounds, or None where
    :func:`quant_lstm_cell_table_plan` gives the direct chain (per-column
    ``sa`` or ``ss``, wide codes). On a CUDA tensor one launch of the table
    kernel; on a CPU tensor None, since only the kernel reads them (the
    plain cell forms every stage itself; the plain tables are
    :func:`quant_lstm_cell_tables_reference`). The tables are no function
    of autograd's: the backward recomputes from the scales."""
    device = next((s.device for s in (sa, ss, st, sc, sth) if torch.is_tensor(s)),
                  torch.device("cpu"))
    if device.type == "cpu":
        return None
    if device.type != "cuda":
        raise ValueError(f"quant_lstm_cell_tables runs on cuda or cpu, not {device}")
    sa_n, ss_n = (torch.as_tensor(v).numel() for v in (sa, ss))
    # one value per gate block or one value; any other count is per column
    strides = [(0, 0) if k == 1 else (1, 0) if k == n else (1, 1)
               for k, n in ((sa_n, 4), (ss_n, 3))]
    (alo, ahi), _, _, (clo, chi), _, _ = _int_pairs(bounds)
    if quant_lstm_cell_table_plan(*strides[0], *strides[1], alo, ahi, clo, chi) == 0:
        return None
    scales = [_launch.f32_vector(name, v, n, device) for name, v, n in (
        ("sa", sa, sa_n), ("ss", ss, ss_n), ("st", st, 1), ("sc", sc, 1), ("sth", sth, 1))]
    tables = torch.empty(table_layout(alo, ahi, clo, chi)[2], dtype=torch.float32,
                         device=device)
    _launch.launch(_tables_launcher(), "quant_lstm_cell_tables", device,
                   *(t.data_ptr() for t in scales), tables.data_ptr(), *strides[0],
                   *strides[1], *_int_bounds(bounds))
    quant_lstm_cell_tables.launches += 1
    return tables


def _addend(xp: torch.Tensor, p: torch.Tensor) -> int:
    """Checks the first addend of a two-addend call against the recurrent
    product ``p``; returns its row stride in elements."""
    if xp.dtype not in (torch.float32, torch.bfloat16) or xp.ndim != 2:
        raise ValueError(f"xp must be a 2-D float32 or bf16 tensor, got {xp.ndim}-D {xp.dtype}")
    if xp.device != p.device:
        raise ValueError(f"xp is on {xp.device}, expected {p.device}")
    if xp.shape != p.shape:
        raise ValueError(f"xp {tuple(xp.shape)} and recurrent {tuple(p.shape)} differ")
    b, n = xp.shape
    ld = xp.stride(0) if b > 1 else n
    if n and (xp.stride(1) != 1 or ld < n or ld >= 2**31):
        raise ValueError(f"xp's rows must be contiguous and at most 2^31 elements apart, got "
                         f"strides {xp.stride()}")
    return ld


def _forward_kernel(xp, p, c, sa, ss, st, sc, sth, sh, bounds, tables=None):
    """One launch of the forward: (gates, h, c_new). ``p`` None: ``xp`` is
    the gates (contiguous float32); else gates = xp + p, formed and written
    by the kernel. ``tables``: the stage tables, or None for the direct
    chain."""
    device = c.device
    if p is None:
        _launch.check_matrix("gates", xp, torch.float32, device)
        gates, xp_ld = xp, xp.shape[1]
    else:
        _launch.check_matrix("recurrent", p, torch.float32, device)
        xp_ld = _addend(xp, p)
        gates = torch.empty_like(p)
    b, h_dim, scales, strides = _cell_operands(gates, c, sa, ss, st, sc, sth, sh)
    bd = _int_bounds(bounds)
    if tables is not None:
        want = quant_lstm_cell_table_plan(*strides, bd[0], bd[1], bd[6], bd[7])
        if want == 0:
            raise ValueError("these scales and bounds take the direct chain: pass no tables")
        if (tables.dtype != torch.float32 or tables.device != device
                or tables.shape != (want,) or tables.data_ptr() % 16):
            raise ValueError(f"tables must be a 16-byte aligned ({want},) float32 tensor on "
                             f"{device}, as quant_lstm_cell_tables makes them")
    h = torch.empty((b, h_dim), dtype=torch.float32, device=device)
    c_new = torch.empty_like(h)
    _launch.launch(_forward_launcher(), "quant_lstm_cell", device,
                   xp.data_ptr(), 0 if p is None else p.data_ptr(), c.data_ptr(),
                   *(t.data_ptr() for t in scales), 0 if tables is None else tables.data_ptr(),
                   0 if p is None else gates.data_ptr(), h.data_ptr(), c_new.data_ptr(),
                   b, h_dim, xp_ld, int(xp.dtype == torch.bfloat16), *strides, *bd)
    quant_lstm_cell.launches += 1
    return gates, h, c_new


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
    _launch.check_matrix("gates", gates, torch.float32, device)
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
    saved ``gates`` and ``c`` (the TPU kernel's residuals). With two addends
    the kernel's sum is saved, and ``dgates`` goes to both: to ``xp`` in its
    own dtype, as autograd's ``.to()`` and ``+`` return it."""

    @staticmethod
    def forward(ctx, xp, p, c, sa, ss, st, sc, sth, sh, bounds, tables):
        gates, h, c_new = _forward_kernel(xp, p, c, sa, ss, st, sc, sth, sh, bounds, tables)
        ctx.save_for_backward(gates, c, sa, ss, st, sc, sth, sh)
        ctx.bounds = bounds
        ctx.xp_dtype = None if p is None else xp.dtype
        return h, c_new

    @staticmethod
    def backward(ctx, dh, dcn):
        gates, c, *scales = ctx.saved_tensors
        dh = torch.zeros_like(c) if dh is None else dh.contiguous()
        dcn = torch.zeros_like(c) if dcn is None else dcn.contiguous()
        dgates, *rest = quant_lstm_cell_backward(gates, c, *scales, dh, dcn, ctx.bounds)
        if ctx.xp_dtype is None:
            return dgates, None, *rest, None, None
        return dgates.to(ctx.xp_dtype), dgates, *rest, None, None


def quant_lstm_cell(gates: torch.Tensor, c: torch.Tensor, sa, ss, st, sc, sth, sh,
                    bounds: Bounds, *, recurrent: Optional[torch.Tensor] = None,
                    tables: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One quantized LSTM cell step after the GEMM: ``gates`` (B, 4H)
    float32 packed (i, f, g, o), ``c`` (B, H); ``sa`` (4H,), (4,) one per
    gate block, or a scalar, ``ss`` (3H,) packed (i, f, o), (3,) or a
    scalar, ``st, sc, sth, sh`` scalars;
    ``bounds`` the six integer (lo, hi) clamp bounds in the order (acc,
    sigmoid, tanh_g, cell, tanh_h, hidden). Returns (h, c_new), (B, H)
    float32; gradients reach ``gates``, ``c`` and every scale.

    ``recurrent``: the gates are ``gates.float() + recurrent``, ``gates``
    then the step's input projection (float32 or bf16, rows contiguous at
    any stride) and ``recurrent`` the float32 recurrent product; both get
    the gradient. ``tables``: ``quant_lstm_cell_tables`` of the same scales
    and bounds, for the table path (the CPU's plain version forms every
    stage itself)."""
    if gates.device.type == "cpu":
        if recurrent is not None:
            gates = gates.to(torch.float32) + recurrent
        return quant_lstm_cell_reference(gates, c, sa, ss, st, sc, sth, sh, bounds)
    if gates.device.type != "cuda":
        raise ValueError(f"quant_lstm_cell runs on cuda or cpu, not {gates.device}")
    scales = [s if torch.is_tensor(s) else torch.tensor(float(s), device=gates.device)
              for s in (sa, ss, st, sc, sth, sh)]
    return _QuantLSTMCell.apply(gates, recurrent, c, *scales, tuple(bounds),
                                None if tables is None else tables.detach())


quant_lstm_cell.launches = 0
quant_lstm_cell_backward.launches = 0
quant_lstm_cell_tables.launches = 0
