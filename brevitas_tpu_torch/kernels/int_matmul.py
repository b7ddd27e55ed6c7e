"""Int8 GEMM with a fused dequant epilogue — the serving GEMM (port of
``brevitas_tpu/kernels/int_matmul.py``).

    y = act( (x_i8 @ w_i8)_i32 * (x_scale * w_scale[col]) + bias )

On a CUDA tensor ``int8_matmul`` launches the hand-written Hopper kernel
``csrc/int8_matmul.cu``; on a CPU tensor it takes the plain version. The
kernel equals the plain version bit for bit: the accumulation is exact and
the epilogue rounds each step in the same order.
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
def _launcher():
    return _launch.bind("int8_matmul", "int8_matmul_launch", 6, 4)


def int8_matmul(x_i8: torch.Tensor, w_i8: torch.Tensor, x_scale, w_scale,
                bias: Optional[torch.Tensor] = None,
                act: Optional[str] = None) -> torch.Tensor:
    """Fused quantized GEMM: x_i8 (M, K) int8, w_i8 (K, N) int8, x_scale a
    scalar, w_scale a scalar or (N,), bias None or (N,), act None or
    "relu". Returns (M, N) float32."""
    if x_i8.device.type == "cpu":
        return int8_matmul_reference(x_i8, w_i8, x_scale, w_scale, bias, act)
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
    _launch.launch(_launcher(), "int8_matmul", device,
                   x_i8.data_ptr(), w_i8.data_ptr(), xs.data_ptr(), ws.data_ptr(),
                   None if b is None else b.data_ptr(), y.data_ptr(),
                   m, n, k, relu)
    int8_matmul.launches += 1
    return y


int8_matmul.launches = 0
