"""AWQ, activation-aware weight quantization (arXiv:2306.00978; port of
``brevitas_tpu/graph/awq.py``).

Where SmoothQuant picks one global ``alpha``, AWQ searches a grid of
per-channel scales from the activations for each region and keeps the one
whose quantized sinks best reconstruct their float output on calibration
data:

    s(alpha) = a_max ** alpha          (a_max: per-channel input maxima)
    err(alpha) = sum over sinks of mean((x / s) @ q(W * s)ᵀ - x @ Wᵀ)²

The winning ``s`` migrates as an equalization factor does (source output
channels by 1/s, which a norm's scale absorbs exactly, sink input channels
by s), and each sink's weight quantizer is rebuilt on the scaled weights.
The port's weights are (out, in): a sink's input channels are its columns.
"""

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from brevitas_tpu_torch.graph.base import get_module
from brevitas_tpu_torch.graph.equalize import EPSILON, _is_norm_source, _pow, _scale_region
from brevitas_tpu_torch.nn.conv import full_float32_matmuls
from brevitas_tpu_torch.nn.linear import QuantLinear
from brevitas_tpu_torch.quant.quantizers import ParameterQuantizer

__all__ = ["apply_awq"]

DEFAULT_ALPHAS = tuple(np.linspace(0.0, 1.0, 11))


def _quantize_weight(layer: QuantLinear, w: torch.Tensor) -> torch.Tensor:
    """Candidate weights fake-quantized with the layer's own quantizer
    config: a new scale from their statistics, per output channel on axis
    0."""
    pq = ParameterQuantizer(layer.weight_quant.cfg, w, channel_axis=0).to(w.device)
    return pq(w).value


def apply_awq(model: nn.Module, regions: List[Tuple[Sequence[str], Sequence[str]]],
              calib_batches: Sequence, *, alphas: Sequence[float] = DEFAULT_ALPHAS,
              forward_fn=None, max_tokens: int = 4096) -> Dict[int, Tuple[float, torch.Tensor]]:
    """AWQ over ``regions`` (``[(source paths, sink paths), ...]``, as
    ``apply_act_equalization`` takes them; the sinks are QuantLinears with
    their quantizers in). Returns ``{region_index: (best_alpha, s)}``. Run
    it before calibration, so the activation scales are found on the
    migrated distribution."""
    from brevitas_tpu_torch.graph.calibrate import (
        _restore_modes,
        _set_disable_quant,
        _snapshot_modes,
    )
    from brevitas_tpu_torch.nn.quant_layer import QuantWBIOL
    from brevitas_tpu_torch.quant_tensor import QuantTensor

    # check every path before touching the model's state
    sink_mods: List[List[QuantLinear]] = []
    for src_paths, sink_paths in regions:
        for p in src_paths:
            src = get_module(model, p)
            if _is_norm_source(src) and src.scale is None:
                raise ValueError(f"{p}: norm source cannot absorb 1/s (use_scale=False)")
        mods = []
        for p in sink_paths:
            m = get_module(model, p)
            if not isinstance(m, QuantLinear):
                raise TypeError(f"{p}: AWQ sinks must be QuantLinear")
            if not isinstance(m, QuantWBIOL):
                raise TypeError(f"{p}: put the quantizers in first")
            mods.append(m)
        sink_mods.append(mods)

    # each region's sink input, shared by the region's sinks
    snap = _snapshot_modes(model)
    model.eval()
    _set_disable_quant(model, True)
    captured: List[List[torch.Tensor]] = [[] for _ in regions]
    try:
        for mods in sink_mods:
            mods[0]._capture_input = True
        with torch.no_grad():
            for b in calib_batches:
                forward_fn(model, b) if forward_fn is not None else model(b)
                for i, mods in enumerate(sink_mods):
                    x = mods[0]._bc_last_input
                    if isinstance(x, QuantTensor):
                        x = x.value
                    captured[i].append(x.reshape(-1, x.shape[-1]))
    finally:
        for mods in sink_mods:
            mods[0]._capture_input = False
            if hasattr(mods[0], "_bc_last_input"):
                del mods[0]._bc_last_input
        _set_disable_quant(model, False)
        _restore_modes(snap)

    result: Dict[int, Tuple[float, torch.Tensor]] = {}
    with torch.no_grad(), full_float32_matmuls():
        for i, (src_paths, sink_paths) in enumerate(regions):
            x = torch.cat(captured[i], dim=0)[:max_tokens]
            a_max = torch.clamp_min(torch.amax(torch.abs(x), dim=0), EPSILON)
            a_max = a_max / torch.clamp_min(torch.mean(a_max), EPSILON)  # scale-free
            sinks = sink_mods[i]
            weights = [m.weight.detach() for m in sinks]  # (out, in)
            y_ref = [x @ w.t() for w in weights]
            best = None
            for alpha in alphas:
                s = torch.clamp_min(_pow(a_max, float(alpha)), EPSILON)
                x_s = x / s
                err = 0.0
                for m, w, y in zip(sinks, weights, y_ref):
                    wq = _quantize_weight(m, w * s[None, :])
                    err += float(torch.mean((x_s @ wq.t() - y) ** 2))
                if best is None or err < best[1]:
                    best = (float(alpha), err, s)
            alpha, _, s = best
            _scale_region([get_module(model, p) for p in src_paths], sinks, s)
            # each sink's weight quantizer, rebuilt on the migrated weights
            for m in sinks:
                old = m.weight_quant
                m.weight_quant = ParameterQuantizer(old.cfg, m.weight.detach(), channel_axis=0) \
                    .to(m.weight.device).train(old.training)
            result[i] = (alpha, s)
    return result
