"""Statistics ops for scale estimation (port of
``brevitas_tpu/core/stats.py``).

Inputs are viewed as 2-D ``(groups, elems)`` (one group for per-tensor
scaling, one per output channel for per-channel scaling); each op reduces
the last axis and returns ``(groups,)``. Ported: MAX (``abs_max``) and PERCENTILE
(``abs_percentile``).
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
    n = x.shape[-1]
    k = max(1, min(n, int(math.floor(0.01 * q * n + 0.5))))
    return torch.sort(torch.abs(x), dim=-1).values[..., k - 1]


def stats_fn(op: StatsOp, *, high_percentile_q: Optional[float] = None):
    """Resolve a StatsOp to a callable ``f(x2d) -> (groups,)``."""
    op = StatsOp(op)
    if op == StatsOp.MAX:
        return abs_max
    if op == StatsOp.PERCENTILE:
        if high_percentile_q is None:
            raise ValueError("percentile requires high_percentile_q")
        return partial(abs_percentile, q=high_percentile_q)
    raise NotImplementedError(f"stats op {op.value} is not ported yet")
