"""Shared checks and argument handling for the ctypes-bound CUDA kernels."""

import ctypes
from typing import Optional

import torch

from brevitas_tpu_torch.csrc import build


def bind(library: str, symbol: str, n_pointers: int, n_ints: int):
    """The C launcher ``symbol`` of ``library``: ``n_pointers`` pointers,
    then ``n_ints`` ints, then the stream; returns a CUDA error code."""
    fn = getattr(build.load(library), symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def bind_plan(library: str, symbol: str):
    """The C function ``symbol(M, N, K, x, w)`` of ``library`` that returns
    the variant its launcher takes for those arguments, packed in an int."""
    fn = getattr(build.load(library), symbol)
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def bind_ints(library: str, symbol: str, n_ints: int):
    """The C function ``symbol`` of ``library`` that takes ``n_ints`` ints
    and returns an int (a plan code)."""
    fn = getattr(build.load(library), symbol)
    fn.argtypes = [ctypes.c_int] * n_ints
    fn.restype = ctypes.c_int
    return fn


def check_matrix(name: str, t: torch.Tensor, dtype: torch.dtype,
                 device: torch.device) -> None:
    if t.dtype != dtype or t.ndim != 2:
        raise ValueError(f"{name} must be a 2-D {dtype} tensor, got "
                         f"{t.ndim}-D {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def f32_vector(name: str, v, n: int, device: torch.device,
               broadcast: bool = False) -> torch.Tensor:
    """``v`` as a contiguous float32 (n,) tensor on ``device``; with
    ``broadcast`` a single value is repeated."""
    t = torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)
    if broadcast and t.numel() == 1:
        t = t.expand(n)
    if t.numel() != n:
        raise ValueError(f"{name} has {t.numel()} values, expected {n}")
    return t.contiguous()


def check_act(act: Optional[str]) -> int:
    if act not in (None, "relu"):
        raise ValueError(f"unsupported act {act!r}")
    return int(act == "relu")


def launch(fn, name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
