"""Int4 weights: split-halves packing, the W4A8 GEMM and the w4a16 GEMM
(port of ``brevitas_tpu/kernels/int4.py``; ported: ``pack_int4_rows``, its
unpack, ``int4_matmul`` and ``int4_weight_only_matmul``).

Packing layout (``pack_int4_rows``): byte row j of the (K/2, N) packed array
holds weight row j in its LOW nibble and weight row j + K/2 in its HIGH
nibble. On a CUDA tensor ``int4_matmul`` and ``int4_weight_only_matmul``
launch the hand-written Hopper kernels ``csrc/int4_matmul.cu`` (s8
``wgmma``, nibbles sign-extended in registers; a tiled or a cluster split-K
variant, :func:`int4_matmul_plan`) and ``csrc/int4_weight_only_matmul.cu``
(bf16 ``wgmma``; :func:`int4_weight_only_matmul_plan`); on a CPU tensor they
take the plain versions.
"""

import functools
from typing import Optional

import torch

from brevitas_tpu_torch.kernels import _launch
from brevitas_tpu_torch.kernels.int_matmul import int8_matmul_reference

# the int32 accumulator holds K products of at most 128 * 8 = 2^10 each
MAX_K = 2**21


def pack_int4_rows(w: torch.Tensor) -> torch.Tensor:
    """(K, N) int4-valued integers -> (K/2, N) packed int8 bytes, row j =
    rows j (low nibble) | j + K/2 (high nibble)."""
    k = w.shape[0]
    if k % 2:
        raise ValueError("K must be even to pack int4 rows")
    w32 = w.to(torch.int32)
    packed = (w32[: k // 2] & 0xF) | ((w32[k // 2:] & 0xF) << 4)
    return torch.where(packed >= 128, packed - 256, packed).to(torch.int8)


def unpack_int4_rows(w_packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4_rows`: (K/2, N) bytes -> (K, N) int8 in
    [-8, 7], both nibbles sign-extended."""
    p = w_packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = p >> 4
    return torch.cat([lo, hi], dim=0).to(torch.int8)


def int4_matmul_reference(x_i8: torch.Tensor, w_packed: torch.Tensor, x_scale,
                          w_scale, bias: Optional[torch.Tensor] = None,
                          act: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch version: the weights unpacked, then the int8 GEMM's
    plain version (an exact int32 accumulator from a float64 matmul, then
    ``float(acc) * (x_scale * w_scale) + bias`` and ReLU, in that order)."""
    return int8_matmul_reference(x_i8, unpack_int4_rows(w_packed), x_scale, w_scale,
                                 bias, act)


@functools.lru_cache(maxsize=None)
def _w4a8_launcher():
    return _launch.bind("int4_matmul", "int4_matmul_launch", 6, 4)


@functools.lru_cache(maxsize=None)
def _w4a8_splits_launcher():
    return _launch.bind("int4_matmul", "int4_matmul_launch_splits", 6, 5)


@functools.lru_cache(maxsize=None)
def _w4a8_planner():
    return _launch.bind_plan("int4_matmul", "int4_matmul_plan")


def int4_matmul_plan(x_i8: torch.Tensor, w_packed: torch.Tensor) -> str:
    """The variant the CUDA launcher takes for these operands, e.g.
    ``"tiled BT128 x:tma w:tma"`` or ``"splitk4 BT16 x:tma w:tma"``: tokens
    per tile, K split over a cluster of CTAs or not, and each operand loaded
    by TMA or by the producer's masked byte loads (where TMA cannot take the
    stride or the tile origin: N % 16 != 0, or K/2 % 16 != 0)."""
    k2, n = w_packed.shape
    code = _w4a8_planner()(x_i8.shape[0], n, k2, x_i8.data_ptr(), w_packed.data_ptr())
    splits = (code >> 8) & 0xFF
    kind = "tiled" if splits == 1 else f"splitk{splits}"
    load = {0: "bytes", 1: "tma"}
    return (f"{kind} BT{code & 0xFF} x:{load[(code >> 16) & 1]} "
            f"w:{load[(code >> 17) & 1]}")


def int4_matmul(x_i8: torch.Tensor, w_packed: torch.Tensor, x_scale, w_scale,
                bias: Optional[torch.Tensor] = None,
                act: Optional[str] = None) -> torch.Tensor:
    """W4A8 GEMM: x_i8 (M, K) int8 codes (the full 8-bit range), w_packed
    (K/2, N) from :func:`pack_int4_rows`, x_scale a scalar, w_scale a scalar
    or (N,), bias None or (N,), act None or "relu". Returns (M, N) float32."""
    if x_i8.device.type == "cpu":
        return int4_matmul_reference(x_i8, w_packed, x_scale, w_scale, bias, act)
    y = launch_int4_matmul(x_i8, w_packed, x_scale, w_scale, bias, act)
    int4_matmul.launches += 1
    return y


int4_matmul.launches = 0


def launch_int4_matmul(x_i8: torch.Tensor, w_packed: torch.Tensor, x_scale, w_scale,
                       bias: Optional[torch.Tensor] = None, act: Optional[str] = None,
                       splits: int = 0) -> torch.Tensor:
    """The CUDA launch behind :func:`int4_matmul`, uncounted; ``splits``
    forces that many K splits (1 = the tiled variant, 0 = the launcher's
    plan). For measuring the variants against each other."""
    if x_i8.device.type != "cuda":
        raise ValueError(f"int4_matmul runs on cuda or cpu, not {x_i8.device}")
    device = x_i8.device
    _launch.check_matrix("x_i8", x_i8, torch.int8, device)
    _launch.check_matrix("w_packed", w_packed, torch.int8, device)
    m, k = x_i8.shape
    k2, n = w_packed.shape
    if k != 2 * k2:
        raise ValueError(f"x_i8 has K = {k} but w_packed holds {2 * k2} rows")
    if k > MAX_K:
        raise ValueError(f"K = {k} can overflow the int32 accumulator")
    relu = _launch.check_act(act)
    xs = _launch.f32_vector("x_scale", x_scale, 1, device)
    ws = _launch.f32_vector("w_scale", w_scale, n, device, broadcast=True)
    b = None if bias is None else _launch.f32_vector("bias", bias, n, device)
    y = torch.empty((m, n), dtype=torch.float32, device=device)
    args = (x_i8.data_ptr(), w_packed.data_ptr(), xs.data_ptr(), ws.data_ptr(),
            None if b is None else b.data_ptr(), y.data_ptr(), m, n, k2, relu)
    name = f"int4_matmul at (M, K, N) = ({m}, {k}, {n})"
    if splits:
        _launch.launch(_w4a8_splits_launcher(), name, device, *args, splits)
    else:
        _launch.launch(_w4a8_launcher(), name, device, *args)
    return y


def int4_weight_only_matmul_reference(x: torch.Tensor, w_packed: torch.Tensor,
                                      w_scale, bias: Optional[torch.Tensor] = None,
                                      act: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch version: x rounded to bf16, the weights unpacked, a
    float32 matmul (bf16 x int4 products are exact in float32), then the
    epilogue."""
    w = unpack_int4_rows(w_packed).to(torch.float32)
    acc = torch.matmul(x.to(torch.bfloat16).to(torch.float32), w)
    y = acc * torch.as_tensor(w_scale, dtype=torch.float32,
                              device=acc.device).reshape(1, -1)
    if bias is not None:
        y = y + bias
    if act == "relu":
        y = torch.clamp_min(y, 0.0)
    return y


@functools.lru_cache(maxsize=None)
def _launcher():
    return _launch.bind("int4_weight_only_matmul",
                        "int4_weight_only_matmul_launch", 5, 4)


@functools.lru_cache(maxsize=None)
def _planner():
    return _launch.bind_plan("int4_weight_only_matmul", "int4_weight_only_matmul_plan")


def int4_weight_only_matmul_plan(x: torch.Tensor, w_packed: torch.Tensor) -> str:
    """The variant the CUDA launcher takes, e.g. ``"F256 BT32 x:vec16 w:tma"``:
    features and tokens per tile, x by 16-byte ``cp.async`` or scalar loads,
    the packed weights by TMA, by one bulk copy per slab (a weight no wider
    than 128 whose row stride TMA cannot describe) or by masked byte loads."""
    k2, n = w_packed.shape
    code = _planner()(x.shape[0], n, k2, x.data_ptr(), w_packed.data_ptr())
    w_load = ("tma", "bulk", "bytes")[(code >> 17) & 3]
    return (f"F{128 * ((code >> 8) & 0xFF)} BT{code & 0xFF} "
            f"x:{'vec16' if (code >> 16) & 1 else 'scalar'} w:{w_load}")


def int4_weight_only_matmul(x: torch.Tensor, w_packed: torch.Tensor, w_scale,
                            bias: Optional[torch.Tensor] = None,
                            act: Optional[str] = None) -> torch.Tensor:
    """w4a16 GEMM: x (M, K) float32, rounded to bf16 as the kernel loads it;
    w_packed (K/2, N) from :func:`pack_int4_rows`; w_scale a scalar or (N,);
    bias None or (N,). Returns (M, N) float32."""
    if x.device.type == "cpu":
        return int4_weight_only_matmul_reference(x, w_packed, w_scale, bias, act)
    if x.device.type != "cuda":
        raise ValueError(f"int4_weight_only_matmul runs on cuda or cpu, not {x.device}")
    device = x.device
    _launch.check_matrix("x", x, torch.float32, device)
    _launch.check_matrix("w_packed", w_packed, torch.int8, device)
    m, k = x.shape
    k2, n = w_packed.shape
    if k != 2 * k2:
        raise ValueError(f"x has K = {k} but w_packed holds {2 * k2} rows")
    relu = _launch.check_act(act)
    ws = _launch.f32_vector("w_scale", w_scale, n, device, broadcast=True)
    b = None if bias is None else _launch.f32_vector("bias", bias, n, device)
    y = torch.empty((m, n), dtype=torch.float32, device=device)
    _launch.launch(_launcher(), f"int4_weight_only_matmul at (M, K, N) = ({m}, {k}, {n})",
                   device,
                   x.data_ptr(), w_packed.data_ptr(), ws.data_ptr(),
                   None if b is None else b.data_ptr(), y.data_ptr(),
                   m, n, k2, relu)
    int4_weight_only_matmul.launches += 1
    return y


int4_weight_only_matmul.launches = 0
