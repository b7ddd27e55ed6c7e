"""Int8 GEMM with a fused dequant epilogue — the serving GEMM (port of
``brevitas_tpu/kernels/int_matmul.py``).

    y = act( (x_i8 @ w_i8)_i32 * (x_scale * w_scale[col]) + bias )

On a CUDA tensor ``int8_matmul`` launches the hand-written Hopper kernel
``csrc/int8_matmul.cu`` (s8 ``wgmma`` on the tensor cores; its launcher
picks a tiled or a cluster split-K variant, :func:`int8_matmul_plan`); on a
CPU tensor it takes the plain version. The kernel equals the plain version
bit for bit: the accumulation is exact and the epilogue rounds each step in
the same order.
"""

import functools
from typing import Optional

import torch

from brevitas_tpu_torch.kernels import _launch

# the int32 accumulator holds K products of at most 2^14 each
MAX_K = 2**17


def int8_matmul_reference(x_i8: torch.Tensor, w_i8: torch.Tensor, x_scale,
                          w_scale, bias: Optional[torch.Tensor] = None,
                          act: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch version. The products and sums of int8 codes are
    integers below 2^53, so a float64 matmul computes the int32 accumulator
    exactly — torch has no integer matmul on CUDA."""
    acc = torch.matmul(x_i8.to(torch.float64), w_i8.to(torch.float64)).to(torch.int32)
    scale = (torch.as_tensor(x_scale, dtype=torch.float32, device=acc.device)
             * torch.as_tensor(w_scale, dtype=torch.float32, device=acc.device))
    y = acc.to(torch.float32) * scale
    if bias is not None:
        y = y + bias
    if act == "relu":
        y = torch.clamp_min(y, 0.0)
    return y


@functools.lru_cache(maxsize=None)
def _planner():
    return _launch.bind_plan("int8_matmul", "int8_matmul_plan")


def int8_matmul_plan(x_i8: torch.Tensor, w_i8: torch.Tensor) -> str:
    """The variant the CUDA launcher takes for these operands, e.g.
    ``"tiled BT128 x:tma w:tma"`` or ``"splitk8 BT16 x:tma w:bytes"``: tokens
    per tile, K split over a cluster of CTAs or not, and each operand loaded
    by TMA or by the producer's masked byte loads (a stride TMA cannot
    describe)."""
    m, k = x_i8.shape
    code = _planner()(m, w_i8.shape[1], k, x_i8.data_ptr(), w_i8.data_ptr())
    splits = (code >> 8) & 0xFF
    kind = "tiled" if splits == 1 else f"splitk{splits}"
    load = {0: "bytes", 1: "tma"}
    return (f"{kind} BT{code & 0xFF} x:{load[(code >> 16) & 1]} "
            f"w:{load[(code >> 17) & 1]}")


@functools.lru_cache(maxsize=None)
def _launcher():
    return _launch.bind("int8_matmul", "int8_matmul_launch", 6, 4)


@functools.lru_cache(maxsize=None)
def _splits_launcher():
    return _launch.bind("int8_matmul", "int8_matmul_launch_splits", 6, 5)


def int8_matmul(x_i8: torch.Tensor, w_i8: torch.Tensor, x_scale, w_scale,
                bias: Optional[torch.Tensor] = None,
                act: Optional[str] = None) -> torch.Tensor:
    """Fused quantized GEMM: x_i8 (M, K) int8, w_i8 (K, N) int8, x_scale a
    scalar, w_scale a scalar or (N,), bias None or (N,), act None or
    "relu". Returns (M, N) float32."""
    if x_i8.device.type == "cpu":
        return int8_matmul_reference(x_i8, w_i8, x_scale, w_scale, bias, act)
    y = launch_int8_matmul(x_i8, w_i8, x_scale, w_scale, bias, act)
    int8_matmul.launches += 1
    return y


int8_matmul.launches = 0


def launch_int8_matmul(x_i8: torch.Tensor, w_i8: torch.Tensor, x_scale, w_scale,
                       bias: Optional[torch.Tensor] = None, act: Optional[str] = None,
                       splits: int = 0) -> torch.Tensor:
    """The CUDA launch behind :func:`int8_matmul`, uncounted; ``splits``
    forces that many K splits (1 = the tiled variant, 0 = the launcher's
    plan). For measuring the variants against each other."""
    if x_i8.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cuda or cpu, not {x_i8.device}")
    device = x_i8.device
    _launch.check_matrix("x_i8", x_i8, torch.int8, device)
    _launch.check_matrix("w_i8", w_i8, torch.int8, device)
    m, k = x_i8.shape
    if w_i8.shape[0] != k:
        raise ValueError(f"x_i8 {tuple(x_i8.shape)} and w_i8 {tuple(w_i8.shape)} "
                         "do not chain")
    if k > MAX_K:
        raise ValueError(f"K = {k} can overflow the int32 accumulator")
    n = w_i8.shape[1]
    relu = _launch.check_act(act)
    xs = _launch.f32_vector("x_scale", x_scale, 1, device)
    ws = _launch.f32_vector("w_scale", w_scale, n, device, broadcast=True)
    b = None if bias is None else _launch.f32_vector("bias", bias, n, device)
    y = torch.empty((m, n), dtype=torch.float32, device=device)
    args = (x_i8.data_ptr(), w_i8.data_ptr(), xs.data_ptr(), ws.data_ptr(),
            None if b is None else b.data_ptr(), y.data_ptr(), m, n, k, relu)
    name = f"int8_matmul at (M, K, N) = ({m}, {k}, {n})"
    if splits:
        _launch.launch(_splits_launcher(), name, device, *args, splits)
    else:
        _launch.launch(_launcher(), name, device, *args)
    return y
