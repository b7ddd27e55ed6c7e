"""Per-tensor fake-quant, forward and backward (port of
``brevitas_tpu/kernels/fake_quant.py``).

With a scalar ``scale`` and ``zero_point`` and static integer bounds
``lo``/``hi``::

    q  = round(x / scale + zero_point)      round half to even
    qc = clamp(q, lo, hi)                   where-based: the bound wins, NaN passes
    y  = (qc - zero_point) * scale

This is the model path's chain (``core/quant.py``'s ``int_quant`` with
``round_ste``): a division, where the Pallas kernel multiplies by ``1 /
scale`` and so moves values across rounding ties. The gradient is the
chain's autograd: ``dx = (g * scale) / scale`` where the clamp lets it
through (everywhere with ``ste_clamp``), two roundings that differ from
``g`` in the last bit for about 9 % of elements (the Pallas backward returns
``g``); ``dscale = sum g * ((qc - zp) - in_range * x / scale)``; ``dzp = sum
-g * scale`` over clamped elements (0 with ``ste_clamp``).

``fake_quant`` launches ``csrc/fake_quant.cu`` on a CUDA tensor inside an
``autograd.Function`` whose backward launches the backward kernel
(``fake_quant_backward``): the forward and ``dx`` equal the chain bit for
bit, the two sums are taken in float64 in a fixed order (the same bits on
every run) and are formed only for inputs that need them. On a CPU tensor
it takes the plain version (``fake_quant_reference``, differentiated by
autograd). The TPU kernel's padding to (rows, 128) was a Pallas tiling
rule: the CUDA kernels take any shape.
"""

import ctypes
import functools
from typing import Optional, Tuple

import torch

from brevitas_tpu_torch.csrc import build
from brevitas_tpu_torch.kernels import _launch
from brevitas_tpu_torch.ops import round_ste, tensor_clamp, tensor_clamp_ste


def fake_quant_reference(x: torch.Tensor, scale, zero_point, lo: float, hi: float,
                         ste_clamp: bool = False) -> torch.Tensor:
    """Plain PyTorch version, differentiable by autograd."""
    clamp = tensor_clamp_ste if ste_clamp else tensor_clamp
    q = round_ste(x / scale + zero_point)
    qc = clamp(q, lo, hi)
    return (qc - zero_point) * scale


def fake_quant_backward_reference(x, scale, zero_point, g, lo: float, hi: float,
                                  ste_clamp: bool = False):
    """The plain version's gradients by autograd: (dx, dscale, dzp), each
    scale and zero-point gradient in float32 in its input's shape (None for
    a Python number)."""
    with torch.enable_grad():
        inputs = [x.detach().requires_grad_()]
        inputs += [v.detach().to(x.dtype).requires_grad_() if torch.is_tensor(v) else v
                   for v in (scale, zero_point)]
        y = fake_quant_reference(inputs[0], inputs[1], inputs[2], lo, hi, ste_clamp)
        wrt = [t for t in inputs if torch.is_tensor(t)]
        grads = iter(torch.autograd.grad(y, wrt, g))
        return tuple(next(grads) if torch.is_tensor(t) else None for t in inputs)


def fake_quant_scale_terms(x, scale, zero_point, g, lo: float, hi: float,
                           ste_clamp: bool = False):
    """The per-element terms of ``dscale`` and ``dzp`` in float64, ``x /
    scale`` and the code as the float32 chain forms them: what the backward
    kernel's sums are held to. Returns (dscale terms, dzp terms, the sizes
    of their parts ``|g (qc - zp)| + |g in_range x / scale|``)."""
    xs = x / scale
    q = torch.round(xs + zero_point)
    inr = ((q >= lo) & (q <= hi)) | bool(ste_clamp) | torch.isnan(q)
    qz = (tensor_clamp(q, lo, hi) - zero_point).double()
    g64 = g.double()
    xs_in = torch.where(inr, xs.double(), 0.0)
    s64 = torch.as_tensor(scale, dtype=torch.float32).double()
    ds = g64 * (qz - xs_in)
    dz = torch.where(inr, 0.0, -g64 * s64)
    return ds, dz, (g64 * qz).abs() + (g64 * xs_in).abs()


@functools.lru_cache(maxsize=None)
def _library():
    return bind_library(build.load("fake_quant"))


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``'s launchers with their argument types set (a library built
    from ``csrc/fake_quant.cu``, or a variant of it)."""
    ptr, f32, i64 = ctypes.c_void_p, ctypes.c_float, ctypes.c_int64
    lib.fake_quant_blocks.argtypes = [i64]
    lib.fake_quant_blocks.restype = i64
    lib.fake_quant_launch.argtypes = [ptr, ptr, i64, i64, ptr, f32, ptr, f32, f32, f32, ptr]
    lib.fake_quant_launch.restype = ctypes.c_int
    lib.fake_quant_backward_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64, ptr, f32,
                                               ptr, f32, f32, f32, ctypes.c_int, ptr]
    lib.fake_quant_backward_launch.restype = ctypes.c_int
    return lib


def _scalar_arg(name: str, v, device: torch.device) -> Tuple[Optional[int], float]:
    """(device pointer, 0.0) for a one-element float32 tensor on ``device``,
    read by the kernel on the card so that no value crosses to the host;
    (None, value) for a Python number, passed by value."""
    if not torch.is_tensor(v):
        return None, float(v)
    if v.numel() != 1 or v.dtype != torch.float32 or v.device != device:
        raise ValueError(f"{name} must be a one-element float32 tensor on {device}, got "
                         f"{tuple(v.shape)} {v.dtype} on {v.device}")
    return v.data_ptr(), 0.0


def _operand(name: str, t: torch.Tensor, device: torch.device) -> torch.Tensor:
    if t.dtype != torch.float32 or t.device != device:
        raise ValueError(f"{name} must be a float32 tensor on {device}, got {t.dtype} on "
                         f"{t.device}")
    return t.contiguous()


def _bounds(lo: float, hi: float) -> Tuple[float, float]:
    lo, hi = float(lo), float(hi)
    if lo != int(lo) or hi != int(hi) or lo > hi:
        raise ValueError(f"lo and hi must be integers with lo <= hi, got {lo}, {hi}")
    return lo, hi


def fake_quant_plan(x_ptr: int, y_ptr: int, n: int) -> int:
    """The 16-byte vectors the forward kernel takes of ``n`` float32
    elements from ``x_ptr`` to ``y_ptr`` (its fast path); it takes the
    rest, the last ``n % 4`` or, where either address is off a 16-byte
    boundary (``x`` a view that starts inside an allocation), all of them,
    one at a time."""
    return n // 4 if x_ptr % 16 == 0 and y_ptr % 16 == 0 else 0


def _forward_kernel(x, scale, zero_point, lo, hi):
    device = x.device
    x = _operand("x", x, device)
    s_ptr, s_val = _scalar_arg("scale", scale, device)
    z_ptr, z_val = _scalar_arg("zero_point", zero_point, device)
    y = torch.empty_like(x)
    n = x.numel()
    _launch.launch(_library().fake_quant_launch, "fake_quant", device, x.data_ptr(),
                   y.data_ptr(), n, fake_quant_plan(x.data_ptr(), y.data_ptr(), n), s_ptr,
                   s_val, z_ptr, z_val, *_bounds(lo, hi))
    fake_quant.launches += 1
    return y


def fake_quant_backward(x: torch.Tensor, scale, zero_point, g: torch.Tensor, lo: float,
                        hi: float, ste_clamp: bool = False, sums: bool = True):
    """Gradients (dx, dscale, dzp) of ``fake_quant`` for upstream ``g``;
    ``dscale`` and ``dzp`` are float32 one-element tensors, None when
    ``sums`` is False. On a CUDA tensor the backward kernel recomputes the
    code from ``x``; on a CPU tensor the plain version's autograd."""
    if x.device.type == "cpu":
        dx, ds, dz = fake_quant_backward_reference(x, scale, zero_point, g, lo, hi, ste_clamp)
        return (dx, ds, dz) if sums else (dx, None, None)
    if x.device.type != "cuda":
        raise ValueError(f"fake_quant_backward runs on cuda or cpu, not {x.device}")
    device = x.device
    x = _operand("x", x, device)
    g = _operand("g", g, device)
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} must have the shape of x {tuple(x.shape)}")
    s_ptr, s_val = _scalar_arg("scale", scale, device)
    z_ptr, z_val = _scalar_arg("zero_point", zero_point, device)
    lib = _library()
    dx = torch.empty_like(x)
    part = dsz = None
    if sums:
        # float64 partial sums (dscale, dzp), one pair per block of the
        # first pass; the second pass adds them in block order
        part = torch.empty((max(lib.fake_quant_blocks(x.numel()), 1), 2), dtype=torch.float64,
                           device=device)
        dsz = torch.empty(2, dtype=torch.float32, device=device)
    _launch.launch(lib.fake_quant_backward_launch, "fake_quant_backward", device,
                   x.data_ptr(), g.data_ptr(), dx.data_ptr(),
                   None if part is None else part.data_ptr(),
                   None if dsz is None else dsz.data_ptr(),
                   None if dsz is None else dsz[1:].data_ptr(),
                   x.numel(), s_ptr, s_val, z_ptr, z_val, *_bounds(lo, hi), int(bool(ste_clamp)))
    fake_quant_backward.launches += 1
    if not sums:
        return dx, None, None
    return dx, dsz[0], dsz[1]


class _FakeQuant(torch.autograd.Function):
    """Forward kernel; the backward kernel recomputes the code from the
    saved ``x``."""

    @staticmethod
    def forward(ctx, x, scale, zero_point, lo, hi, ste_clamp):
        ctx.save_for_backward(x, *(v for v in (scale, zero_point) if torch.is_tensor(v)))
        ctx.scalars = tuple(None if torch.is_tensor(v) else v for v in (scale, zero_point))
        ctx.quant = (lo, hi, ste_clamp)
        return _forward_kernel(x, scale, zero_point, lo, hi).view(x.shape)

    @staticmethod
    def backward(ctx, g):
        x, *tensors = ctx.saved_tensors
        tensors = iter(tensors)
        scale, zero_point = (next(tensors) if v is None else v for v in ctx.scalars)
        want_s, want_z = ctx.needs_input_grad[1:3]
        dx, ds, dz = fake_quant_backward(x, scale, zero_point, g.contiguous(), *ctx.quant,
                                         sums=want_s or want_z)
        return (dx.view(x.shape) if ctx.needs_input_grad[0] else None,
                ds.reshape(scale.shape) if want_s else None,
                dz.reshape(zero_point.shape) if want_z else None, None, None, None)


def fake_quant(x: torch.Tensor, scale, zero_point, lo: float, hi: float,
               ste_clamp: bool = False) -> torch.Tensor:
    """Fused per-tensor fake-quant of ``x`` (float32, any shape) with a
    one-element ``scale`` and ``zero_point`` (tensors or numbers) and static
    integer bounds ``lo``/``hi``. Gradients reach ``x`` and every input
    that is a tensor requiring one."""
    if x.device.type == "cpu":
        return fake_quant_reference(x, scale, zero_point, lo, hi, ste_clamp)
    if x.device.type != "cuda":
        raise ValueError(f"fake_quant runs on cuda or cpu, not {x.device}")
    return _FakeQuant.apply(x, scale, zero_point, lo, hi, bool(ste_clamp))


fake_quant.launches = 0
fake_quant_backward.launches = 0
