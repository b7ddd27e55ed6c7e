"""Int8 attention: the serving core of QuantMultiheadAttention (port of
``brevitas_tpu/kernels/int8_attention.py``).

With symmetric int8 Q/K/V codes and a frozen unsigned probability grid
(scale ``p_scale``, ``p_levels`` levels):

    s   = (q_i8 @ k_i8^T)_i32 * (q_s * k_s / sqrt(d))
    p   = softmax(mask(s))                       exact: global row max first
    p_q = clip(round(p / p_scale), 0, p_levels)  integers
    out = (p_q @ v_i8)_i32 * (p_scale * v_s)

``int8_attention`` (prefill) and ``int4kv_decode_attention`` (one decode
step against a cache packed two positions per byte) launch hand-written
Hopper kernels (``csrc/int8_attention.cu``, ``csrc/int4kv_decode_attention.cu``)
on CUDA tensors and take their plain versions on CPU tensors. The decode
kernel reads each valid packed row once and splits long caches over a
thread-block cluster; :func:`int4kv_decode_attention_plan` names the variant
its launcher takes.
``int8_decode_attention`` (one decode step against an int8 cache) has no
TPU kernel and is plain PyTorch everywhere.

Under grouped-query attention every function takes the K/V codes at the KV
heads with ``kv_groups`` query heads per KV head: query row ``bh`` reads
KV row ``bh // kv_groups``, which is what the JAX package's
``_expand_kv_codes`` computes by copying.

The plain versions form the integer products in float64 (exact: torch has
no integer matmul on CUDA, and float32 could round through TF32) and the
softmax as ``jax.nn.softmax`` does. The kernels' softmax sums in another
order, so a code ``p_q`` can differ by one where ``p / p_scale`` lies
within a few ulps of a .5 boundary; ``return_codes=True`` returns the codes
so that the two versions can be compared code by code.
"""

import functools
import math

import torch

from brevitas_tpu_torch.kernels import _launch
from brevitas_tpu_torch.ops import MASKED_SCORE, causal_mask, softmax

MAX_HEAD_DIM = 256  # the kernels keep one row of up to 256 codes per thread block


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(())


@functools.lru_cache(maxsize=None)
def _sqrt_of(head_dim: int, device: torch.device) -> torch.Tensor:
    # made once: a host-to-device copy per call would block the host
    return torch.tensor(math.sqrt(head_dim), dtype=torch.float32, device=device)


def qk_scale_of(q_scale, k_scale, head_dim: int, device) -> torch.Tensor:
    """(q_s * k_s) / sqrt(d) in float32, in the JAX package's order. The
    divisor is a device tensor: torch multiplies by the reciprocal when a
    CUDA tensor is divided by a host scalar."""
    return (_f32(q_scale, device) * _f32(k_scale, device)) \
        / _sqrt_of(head_dim, torch.device(device))


def _expand(codes: torch.Tensor, kv_groups: int) -> torch.Tensor:
    return codes.repeat_interleave(kv_groups, dim=0) if kv_groups > 1 else codes


def _scores(q_i8: torch.Tensor, k_i8: torch.Tensor, qk_scale) -> torch.Tensor:
    acc = torch.bmm(q_i8.double(), k_i8.double().transpose(1, 2))
    return acc.float() * _f32(qk_scale, q_i8.device)


def _requantized_pv(s: torch.Tensor, v_i8: torch.Tensor, p_scale, v_scale,
                    p_levels: int, return_codes: bool):
    device = s.device
    p_s, v_s = _f32(p_scale, device), _f32(v_scale, device)
    p_q = torch.clamp(torch.round(softmax(s) / p_s), 0, p_levels)
    out = torch.bmm(p_q.double(), v_i8.double()).float() * (p_s * v_s)
    return (out, p_q.to(torch.uint8)) if return_codes else out


def int8_attention_reference(q_i8, k_i8, v_i8, qk_scale, p_scale, v_scale,
                             p_levels: int = 255, causal: bool = False,
                             kv_groups: int = 1, return_codes: bool = False):
    """Plain version. q (BH, Tq, D), k/v (BH / kv_groups, Tk, D) int8.
    Returns (BH, Tq, D) float32 (and the (BH, Tq, Tk) uint8 codes)."""
    k_i8, v_i8 = _expand(k_i8, kv_groups), _expand(v_i8, kv_groups)
    s = _scores(q_i8, k_i8, qk_scale)
    if causal:
        s = torch.where(causal_mask(s.shape[-2], s.shape[-1], s.device), s,
                        MASKED_SCORE)
    return _requantized_pv(s, v_i8, p_scale, v_scale, p_levels, return_codes)


def _check_codes(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.dtype != torch.int8 or t.ndim != 3:
        raise ValueError(f"{name} must be a 3-D int8 tensor, got {t.ndim}-D {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_shapes(q_i8, k_i8, v_i8, kv_groups: int, p_levels: int) -> None:
    bh, _, d = q_i8.shape
    if k_i8.shape != v_i8.shape or k_i8.shape[2] != d:
        raise ValueError(f"q {tuple(q_i8.shape)}, k {tuple(k_i8.shape)} and v "
                         f"{tuple(v_i8.shape)} do not match")
    if kv_groups < 1 or k_i8.shape[0] * kv_groups != bh:
        raise ValueError(f"{bh} query rows do not split into {k_i8.shape[0]} KV "
                         f"rows of {kv_groups} groups")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM} is not supported")
    if not 0 < p_levels <= 255:
        raise ValueError(f"p_levels must lie in [1, 255], got {p_levels}")


def _scales(qk_scale, p_scale, v_scale, device) -> torch.Tensor:
    return torch.stack([_f32(qk_scale, device), _f32(p_scale, device),
                        _f32(v_scale, device)]).contiguous()


@functools.lru_cache(maxsize=None)
def _attention_launcher():
    return _launch.bind("int8_attention", "int8_attention_launch", 6, 7)


def int8_attention(q_i8, k_i8, v_i8, qk_scale, p_scale, v_scale,
                   p_levels: int = 255, causal: bool = False, kv_groups: int = 1,
                   return_codes: bool = False):
    """Fused int8 attention (prefill). q (BH, Tq, D), k/v (BH / kv_groups,
    Tk, D) int8; causal masking is rectangular (row i sees keys up to
    i + Tk - Tq). Returns (BH, Tq, D) float32, and with ``return_codes``
    the (BH, Tq, Tk) uint8 probability codes."""
    if q_i8.device.type == "cpu":
        return int8_attention_reference(q_i8, k_i8, v_i8, qk_scale, p_scale, v_scale,
                                        p_levels, causal, kv_groups, return_codes)
    if q_i8.device.type != "cuda":
        raise ValueError(f"int8_attention runs on cuda or cpu, not {q_i8.device}")
    device = q_i8.device
    for name, t in (("q_i8", q_i8), ("k_i8", k_i8), ("v_i8", v_i8)):
        _check_codes(name, t, device)
    _check_shapes(q_i8, k_i8, v_i8, kv_groups, p_levels)
    bh, tq, d = q_i8.shape
    tk = k_i8.shape[1]
    if tk * p_levels * 128 >= 2**31:
        raise ValueError(f"Tk = {tk} can overflow the int32 PV accumulator")
    out = torch.empty((bh, tq, d), dtype=torch.float32, device=device)
    codes = (torch.zeros((bh, tq, tk), dtype=torch.uint8, device=device)
             if return_codes else None)
    if out.numel():
        scales = _scales(qk_scale, p_scale, v_scale, device)
        _launch.launch(_attention_launcher(), "int8_attention", device,
                       q_i8.data_ptr(), k_i8.data_ptr(), v_i8.data_ptr(),
                       scales.data_ptr(), out.data_ptr(),
                       None if codes is None else codes.data_ptr(),
                       bh, tq, tk, d, kv_groups, p_levels, int(causal))
        int8_attention.launches += 1
    return (out, codes) if return_codes else out


int8_attention.launches = 0


def int8_attention_dispatch(q_i8, k_i8, v_i8, q_scale, k_scale, v_scale, p_scale,
                            head_dim: int, p_levels: int = 255, causal: bool = False,
                            kv_groups: int = 1) -> torch.Tensor:
    """Integer-domain entry point: the kernel on a CUDA tensor, whatever the
    shape (the JAX package's TPU gate does not carry over), the plain version
    on a CPU tensor."""
    qk_scale = qk_scale_of(q_scale, k_scale, head_dim, q_i8.device)
    return int8_attention(q_i8, k_i8, v_i8, qk_scale, p_scale, v_scale,
                          p_levels=p_levels, causal=causal, kv_groups=kv_groups)


def int8_decode_attention(q_i8, k_cache, v_cache, pos: int, q_scale, k_scale,
                          v_scale, p_scale, head_dim: int, p_levels: int = 255,
                          kv_groups: int = 1, return_codes: bool = False):
    """One decode step against an int8 KV cache, plain PyTorch on every
    device (the JAX package has no TPU kernel for it either). q (BH, 1, D)
    int8; k/v caches (BH / kv_groups, L, D) int8, valid through ``pos``.
    Returns (BH, 1, D) float32 (and the (BH, 1, L) uint8 codes)."""
    s = _scores(q_i8, _expand(k_cache, kv_groups),
                qk_scale_of(q_scale, k_scale, head_dim, q_i8.device))
    valid = torch.arange(s.shape[-1], device=s.device) <= pos
    s = torch.where(valid, s, MASKED_SCORE)
    return _requantized_pv(s, _expand(v_cache, kv_groups), p_scale, v_scale,
                           p_levels, return_codes)


# -- int4 KV cache: two positions per byte -------------------------------------
#
# Split halves over positions: byte row r of a (BH, l_half, D) cache holds
# position r in its low nibble and position r + l_half in its high nibble.


def _to_int8_bytes(x32: torch.Tensor) -> torch.Tensor:
    """int32 holding byte values 0..255 (or -128..127) -> int8 bits."""
    x32 = x32 & 0xFF
    return torch.where(x32 >= 128, x32 - 256, x32).to(torch.int8)


def pack_kv_halves(codes: torch.Tensor, l_half: int) -> torch.Tensor:
    """int4 codes (BH, L, D), L <= 2 * l_half -> (BH, l_half, D) bytes."""
    bh, length, d = codes.shape
    c = torch.zeros((bh, 2 * l_half, d), dtype=torch.int32, device=codes.device)
    c[:, :length] = codes.to(torch.int32)
    return _to_int8_bytes((c[:, :l_half] & 0x0F) | ((c[:, l_half:] & 0x0F) << 4))


def unpack_kv_halves(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_kv_halves`: (BH, 2 * l_half, D) int8 codes in
    [-8, 7], both nibbles sign-extended."""
    p = packed.to(torch.int32)
    lo = ((p & 0x0F) ^ 8) - 8
    hi = p >> 4
    return torch.cat([lo, hi], dim=1).to(torch.int8)


def update_kv_packed(packed: torch.Tensor, codes_t: torch.Tensor, pos: int) -> torch.Tensor:
    """Write one token's codes (BH, 1, D) at position ``pos`` into a packed
    cache (BH, l_half, D), IN PLACE (the JAX package returns a new array;
    copying the cache every step would cost more than the step), touching
    only the nibble that owns the position. Returns ``packed``."""
    l_half = packed.shape[1]
    r = pos % l_half
    row = packed[:, r:r + 1].to(torch.int32)
    c = codes_t.to(torch.int32) & 0x0F
    new = (row & ~0x0F) | c if pos < l_half else (row & 0x0F) | (c << 4)
    packed[:, r:r + 1] = _to_int8_bytes(new)
    return packed


def int4kv_decode_attention_reference(q_i8, k_packed, v_packed, pos: int, q_scale,
                                      k_scale, v_scale, p_scale, head_dim: int,
                                      p_levels: int = 255, kv_groups: int = 1,
                                      return_codes: bool = False):
    """Plain version: :func:`int8_decode_attention` on the unpacked caches.
    Returns (BH, 1, D) float32 (and the (BH, 1, 2 * l_half) uint8 codes)."""
    return int8_decode_attention(q_i8, unpack_kv_halves(k_packed),
                                 unpack_kv_halves(v_packed), pos, q_scale, k_scale,
                                 v_scale, p_scale, head_dim, p_levels, kv_groups,
                                 return_codes)


@functools.lru_cache(maxsize=None)
def _decode_launcher():
    return _launch.bind("int4kv_decode_attention", "int4kv_decode_attention_launch",
                        7, 6)


@functools.lru_cache(maxsize=None)
def _decode_splits_launcher():
    return _launch.bind("int4kv_decode_attention",
                        "int4kv_decode_attention_launch_splits", 7, 7)


@functools.lru_cache(maxsize=None)
def _decode_planner():
    return _launch.bind_ints("int4kv_decode_attention", "int4kv_decode_attention_plan", 6)


def _decode_plan_code(bh: int, l_half: int, d: int, kv_groups: int, pos: int,
                      splits: int = 0) -> int:
    code = _decode_planner()(bh, l_half, d, kv_groups, min(pos, 2 * l_half - 1), splits)
    if code < 0:
        raise ValueError(f"int4kv_decode_attention takes no launch at (BH, l_half, D, "
                         f"kv_groups, pos) = ({bh}, {l_half}, {d}, {kv_groups}, {pos})")
    return code


def int4kv_decode_attention_plan(q_i8, k_packed, pos: int, kv_groups: int = 1,
                                 splits: int = 0) -> str:
    """The variant the CUDA launcher takes for one decode step, e.g.
    ``"rows1 splits1 T128 tile64 scores:smem"``: query rows a CTA (the
    query heads that share a KV head), CTAs of a cluster that split the
    valid rows (``splits`` forces them), threads a CTA, packed rows a tile,
    and where the scores are kept (shared memory, or a scratch buffer for
    very long caches)."""
    bh, _, d = q_i8.shape
    code = _decode_plan_code(bh, k_packed.shape[1], d, kv_groups, pos, splits)
    return (f"rows{code & 0xFF} splits{(code >> 8) & 0xFF} "
            f"T{256 if (code >> 17) & 1 else 128} tile{code >> 18} "
            f"scores:{'scratch' if (code >> 16) & 1 else 'smem'}")


@functools.lru_cache(maxsize=None)
def _needs_scratch(bh: int, l_half: int, d: int, kv_groups: int) -> bool:
    # whether the scores may go to scratch at any position and any split: the
    # shared-memory layout grows with the rows a CTA takes and the rows of
    # its chunk, and one rank over the whole cache at the last position
    # holds the most of both (the planned variant itself is not monotone in
    # the position: it may take fewer query rows a CTA at a longer cache)
    return bool((_decode_plan_code(bh, l_half, d, kv_groups, 2 * l_half - 1, 1) >> 16) & 1)


def int4kv_decode_scales(q_scale, k_scale, v_scale, p_scale, head_dim: int,
                         device) -> torch.Tensor:
    """(qk_scale, p_scale, v_scale), the (3,) float32 tensor on ``device``
    that the decode kernel reads; qk_scale in the JAX package's order."""
    return _scales(qk_scale_of(q_scale, k_scale, head_dim, device), p_scale, v_scale,
                   device)


def int4kv_decode_attention(q_i8, k_packed, v_packed, pos: int, q_scale, k_scale,
                            v_scale, p_scale, head_dim: int, p_levels: int = 255,
                            kv_groups: int = 1, return_codes: bool = False):
    """One decode step against an int4-packed KV cache. q (BH, 1, D) int8;
    k/v packed (BH / kv_groups, l_half, D) from :func:`pack_kv_halves` /
    :func:`update_kv_packed`, valid through position ``pos``. Returns
    (BH, 1, D) float32, and with ``return_codes`` the (BH, 1, 2 * l_half)
    uint8 probability codes."""
    if q_i8.device.type == "cpu":
        return int4kv_decode_attention_reference(
            q_i8, k_packed, v_packed, pos, q_scale, k_scale, v_scale, p_scale,
            head_dim, p_levels, kv_groups, return_codes)
    if q_i8.device.type != "cuda":
        raise ValueError(f"int4kv_decode_attention runs on cuda or cpu, not {q_i8.device}")
    scales = int4kv_decode_scales(q_scale, k_scale, v_scale, p_scale, head_dim, q_i8.device)
    result = launch_int4kv_decode_attention(q_i8, k_packed, v_packed, pos, scales, p_levels,
                                            kv_groups, return_codes)
    if q_i8.numel() and k_packed.shape[1]:
        int4kv_decode_attention.launches += 1
    return result


int4kv_decode_attention.launches = 0


def launch_int4kv_decode_attention(q_i8, k_packed, v_packed, pos: int,
                                   scales: torch.Tensor, p_levels: int = 255,
                                   kv_groups: int = 1, return_codes: bool = False,
                                   splits: int = 0):
    """The CUDA launch behind :func:`int4kv_decode_attention`, uncounted, on
    ``scales`` from :func:`int4kv_decode_scales`; ``splits`` forces that
    many CTAs a cluster (0 = the launcher's plan). Only the kernel runs on
    the card, so it also times the kernel alone."""
    if q_i8.device.type != "cuda":
        raise ValueError(f"int4kv_decode_attention runs on cuda or cpu, not {q_i8.device}")
    device = q_i8.device
    for name, t in (("q_i8", q_i8), ("k_packed", k_packed), ("v_packed", v_packed)):
        _check_codes(name, t, device)
    _check_shapes(q_i8, k_packed, v_packed, kv_groups, p_levels)
    if (scales.dtype != torch.float32 or scales.shape != (3,) or scales.device != device
            or not scales.is_contiguous()):
        raise ValueError("scales must be the contiguous (3,) float32 tensor of "
                         f"int4kv_decode_scales on {device}")
    bh, tq, d = q_i8.shape
    l_half = k_packed.shape[1]
    if tq != 1:
        raise ValueError(f"decode takes one query per row, got {tq}")
    if pos < 0:
        raise ValueError(f"pos must be >= 0, got {pos}")
    if 2 * l_half * p_levels * 8 >= 2**31:
        raise ValueError(f"l_half = {l_half} can overflow the int32 PV accumulator")
    out = torch.empty((bh, 1, d), dtype=torch.float32, device=device)
    codes = (torch.zeros((bh, 1, 2 * l_half), dtype=torch.uint8, device=device)
             if return_codes else None)
    if out.numel() and l_half:
        scratch = (torch.empty((bh, 2 * l_half), dtype=torch.float32, device=device)
                   if _needs_scratch(bh, l_half, d, kv_groups) else None)
        args = (q_i8.data_ptr(), k_packed.data_ptr(), v_packed.data_ptr(),
                scales.data_ptr(), out.data_ptr(),
                None if codes is None else codes.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                bh, l_half, d, kv_groups, min(pos, 2 * l_half - 1), p_levels)
        name = (f"int4kv_decode_attention at (BH, l_half, D, pos) = "
                f"({bh}, {l_half}, {d}, {pos})")
        if splits:
            _launch.launch(_decode_splits_launcher(), name, device, *args, splits)
        else:
            _launch.launch(_decode_launcher(), name, device, *args)
    return (out, codes) if return_codes else out
