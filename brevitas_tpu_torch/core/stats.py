"""Statistics ops for scale estimation (port of
``brevitas_tpu/core/stats.py``).

Inputs are viewed as 2-D ``(groups, elems)`` (one group for per-tensor
scaling, one per output channel for per-channel scaling); each op reduces
the last axis and returns ``(groups,)``. Ported: MAX (``abs_max``),
PERCENTILE (``abs_percentile``), MIN_MAX (``abs_min_max``),
PERCENTILE_INTERVAL (``percentile_interval``) and, for zero points, MIN
(``negative_min_or_zero``) and PERCENTILE_LOW
(``negative_percentile_or_zero``). Percentiles take the k-th smallest value
of a sort with ``torch.kthvalue``'s 1-indexed rule, as the JAX package does.
"""

import enum
import math
from functools import partial
from typing import Optional

import torch

DEFAULT_MOMENTUM = 0.1


class StatsOp(str, enum.Enum):
    MAX = "max"
    AVE = "ave"
    MAX_AVE = "max_ave"
    MAX_L2 = "max_l2"
    MEAN_SIGMA_STD = "mean_sigma_std"
    MEAN_LEARN_SIGMA_STD = "mean_learn_sigma_std"
    PERCENTILE = "percentile"
    MIN_MAX = "min_max"
    PERCENTILE_INTERVAL = "percentile_interval"
    MIN = "min"
    PERCENTILE_LOW = "percentile_low"
    MSE = "mse"


def abs_max(x: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(x), dim=-1)


def abs_percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """q-th percentile of |x| with torch.kthvalue's index rule:
    k = floor(q/100 * n + 0.5), 1-indexed, clamped to [1, n]."""
    k = _high_k(q, x.shape[-1])
    return torch.sort(torch.abs(x), dim=-1).values[..., k - 1]


def abs_min_max(x: torch.Tensor) -> torch.Tensor:
    """|max - min|: the range of each group."""
    return torch.abs(torch.amax(x, dim=-1) - torch.amin(x, dim=-1))


def negative_min_or_zero(x: torch.Tensor) -> torch.Tensor:
    """min(x), or 0 where that is positive."""
    return torch.clamp_max(torch.amin(x, dim=-1), 0.0)


def _low_k(q: float, n: int) -> int:
    return max(1, min(n, int(math.ceil(0.01 * q * n))))


def _high_k(q: float, n: int) -> int:
    return max(1, min(n, int(math.floor(0.01 * q * n + 0.5))))


def negative_percentile_or_zero(x: torch.Tensor, q: float) -> torch.Tensor:
    """The low q-th percentile, k = ceil(q/100 * n), or 0 where that is
    positive."""
    k = _low_k(q, x.shape[-1])
    return torch.clamp_max(torch.sort(x, dim=-1).values[..., k - 1], 0.0)


def percentile_interval(x: torch.Tensor, low_q: float, high_q: float) -> torch.Tensor:
    """|high percentile - low percentile|, the low one's k = ceil(q/100 * n)
    and the high one's k = floor(q/100 * n + 0.5)."""
    n = x.shape[-1]
    x_sorted = torch.sort(x, dim=-1).values
    return torch.abs(x_sorted[..., _high_k(high_q, n) - 1] - x_sorted[..., _low_k(low_q, n) - 1])


def stats_fn(op: StatsOp, *, high_percentile_q: Optional[float] = None,
             low_percentile_q: Optional[float] = None):
    """Resolve a StatsOp to a callable ``f(x2d) -> (groups,)``."""
    op = StatsOp(op)
    if op == StatsOp.MAX:
        return abs_max
    if op == StatsOp.MIN_MAX:
        return abs_min_max
    if op == StatsOp.MIN:
        return negative_min_or_zero
    if op in (StatsOp.PERCENTILE, StatsOp.PERCENTILE_INTERVAL) and high_percentile_q is None:
        raise ValueError(f"{op.value} requires high_percentile_q")
    if op in (StatsOp.PERCENTILE_LOW, StatsOp.PERCENTILE_INTERVAL) and low_percentile_q is None:
        raise ValueError(f"{op.value} requires low_percentile_q")
    if op == StatsOp.PERCENTILE:
        return partial(abs_percentile, q=high_percentile_q)
    if op == StatsOp.PERCENTILE_LOW:
        return partial(negative_percentile_or_zero, q=low_percentile_q)
    if op == StatsOp.PERCENTILE_INTERVAL:
        return partial(percentile_interval, low_q=low_percentile_q, high_q=high_percentile_q)
    raise NotImplementedError(f"stats op {op.value} is not ported yet")
