"""Cross-layer and activation equalization (port of
``brevitas_tpu/graph/equalize.py``): cross-layer equalization
(``cross_layer_equalization``, ``equalize``, ``sequential_regions``) and
SmoothQuant (``apply_act_equalization``), with the helpers they share.

Regions are ``([src_path, ...], [sink_path, ...])`` module paths, given by
hand (``models.llama.llama_smoothquant_regions``) or found from a traced
forward (``graph.autograph.extract_act_equalization_regions``). The port's
weights are torch's: a linear's (out, in), a conv's (O, I / groups,
*kernel), so a sink's input channels lie on axis 1 where the JAX package's
(in, out) and HWIO kernels have them on axis -2.

Cross-layer equalization (arXiv:1906.04721, section 4.1) scales each
source's output channels by 1/s and the sinks' input channels by s, with
``s = sqrt(range_src / range_sink)``: the ranges are maxima and minima and
the factors one float32 division and square root, each correctly rounded
(the root taken in float64 and rounded once, ``nn.misc.sqrt32``: torch's
float32 one is not correctly rounded), so the port's factors and weights
are the JAX package's bit for bit (the
per-channel views flatten the other axes in another order, which a range
does not see). ``absorb_bias_by_batch_norm`` and ``split_batch_norm`` are not
ported yet.
"""

from typing import List, Sequence, Tuple

import torch
from torch import nn

from brevitas_tpu_torch.graph.base import get_module
from brevitas_tpu_torch.models.common import LayerNorm, RMSNorm
from brevitas_tpu_torch.nn.conv import _QuantConvNd
from brevitas_tpu_torch.nn.linear import QuantLinear
from brevitas_tpu_torch.nn.misc import sqrt32

EPSILON = 1e-9

_CONVS = (_QuantConvNd, nn.Conv1d, nn.Conv2d, nn.Conv3d)


def _axes(module) -> Tuple[int, int]:
    """(input_axis, output_axis) of the module's weight. A depthwise conv
    (``groups == out_channels``, one input channel a group) maps input
    channel i to output channel i, so both roles are its axis 0. Other
    grouped convs are refused, as in the JAX package."""
    if isinstance(module, (QuantLinear, nn.Linear)):
        return 1, 0
    if isinstance(module, _CONVS):
        w = module.weight
        if module.groups != 1:
            if module.groups == w.shape[0] and w.shape[1] == 1:
                return 0, 0
            raise ValueError("grouped (non-depthwise) convolutions are not "
                             "supported for cross-layer equalization")
        return 1, 0
    raise ValueError(f"unsupported module for equalization: {type(module)}")


def _channel_view(w: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.movedim(w, axis, 0).reshape(w.shape[axis], -1)


def _channel_range(x2d: torch.Tensor) -> torch.Tensor:
    out = torch.amax(x2d, dim=1) - torch.amin(x2d, dim=1)
    # a constant channel takes the mean range, so s stays finite
    return torch.where(out == 0.0, torch.mean(out), out)


def _is_norm_source(m) -> bool:
    """LayerNorm/RMSNorm elementwise affine: it absorbs 1/s into its own
    scale and bias (SmoothQuant's norm -> linear migration)."""
    return isinstance(m, (LayerNorm, RMSNorm))


def _scale_region(srcs: Sequence, sinks: Sequence, s: torch.Tensor) -> None:
    """Source output channels (and biases) by 1/s, sink input channels by s:
    function-preserving for positively homogeneous ops between them."""
    inv_s = 1.0 / torch.clamp_min(s, EPSILON)
    for m in srcs:
        if _is_norm_source(m):
            if m.scale is None:
                raise ValueError(
                    "norm source without an elementwise scale cannot absorb "
                    "equalization factors (use_scale=False)")
            m.scale.mul_(inv_s)
            if getattr(m, "bias", None) is not None:
                m.bias.mul_(inv_s)
            continue
        _, out_ax = _axes(m)
        k = m.weight
        shape = [1] * k.ndim
        shape[out_ax] = k.shape[out_ax]
        k.mul_(inv_s.reshape(shape))
        if getattr(m, "bias", None) is not None:
            m.bias.mul_(inv_s)
    for m in sinks:
        in_ax, _ = _axes(m)
        k = m.weight
        shape = [1] * k.ndim
        shape[in_ax] = k.shape[in_ax]
        k.mul_(s.reshape(shape))


def cross_layer_equalization(srcs: Sequence, sinks: Sequence) -> torch.Tensor:
    """Equalize one region in place; returns the factors."""
    with torch.no_grad():
        src_views = [_channel_view(m.weight, _axes(m)[1]) for m in srcs]
        sink_views = [_channel_view(m.weight, _axes(m)[0]) for m in sinks]
        src_range = _channel_range(torch.cat(src_views, dim=1))
        sink_range = _channel_range(torch.cat(sink_views, dim=1)) + EPSILON
        s = sqrt32(src_range / sink_range)
        _scale_region(srcs, sinks, s)
    return s


def equalize(model: nn.Module, regions: List[Tuple[Sequence[str], Sequence[str]]],
             iterations: int = 10) -> nn.Module:
    """``iterations`` rounds of cross-layer equalization over the regions,
    each ``([src_path, ...], [sink_path, ...])``."""
    for _ in range(iterations):
        for src_paths, sink_paths in regions:
            cross_layer_equalization([get_module(model, p) for p in src_paths],
                                     [get_module(model, p) for p in sink_paths])
    return model


def sequential_regions(layer_paths: Sequence[str]) -> List[Tuple[List[str], List[str]]]:
    """Adjacent-pair regions of a plain sequential stack of layers."""
    return [([a], [b]) for a, b in zip(layer_paths[:-1], layer_paths[1:])]


def _pow(x: torch.Tensor, e: float) -> torch.Tensor:
    """float32 ``x ** e`` formed in float64 and rounded once: torch's float32
    pow gives other last bits on the card and the CPU (and ``** 0.5`` is
    torch's sqrt), XLA's is not correctly rounded (S1)."""
    return torch.pow(x.double(), e).to(x.dtype)


def apply_act_equalization(model: nn.Module,
                           regions: List[Tuple[Sequence[str], Sequence[str]]],
                           calib_batches: Sequence, *, alpha: float = 0.5,
                           forward_fn=None) -> dict:
    """SmoothQuant (arXiv:2211.10438). Per region, the difficulty of
    quantizing the sinks' input moves into their weights: with per-channel
    input maxima ``a_j`` (on the calibration batches, quantization
    bypassed) and sink weight maxima ``w_j``,

        s_j = a_j**alpha / w_j**(1 - alpha)

    and source output channels scale by 1/s, sink input channels by s. Run
    after the quantizers are in place (the first sink of each region, a
    quant layer, captures its input) and before calibration. Returns
    ``{region_index: s}``."""
    from brevitas_tpu_torch.graph.calibrate import (
        _restore_modes,
        _set_disable_quant,
        _snapshot_modes,
    )
    from brevitas_tpu_torch.nn.quant_layer import QuantWBIOL
    from brevitas_tpu_torch.quant_tensor import QuantTensor

    # resolve and check every path before touching the model's state
    probes = []
    for src_paths, sink_paths in regions:
        for p in src_paths:
            src = get_module(model, p)
            if _is_norm_source(src) and src.scale is None:
                raise ValueError(f"{p}: norm source has no elementwise scale to absorb 1/s "
                                 "into (use_scale=False)")
        probe = get_module(model, sink_paths[0])
        if not isinstance(probe, QuantWBIOL):
            raise TypeError(f"{sink_paths[0]}: activation equalization captures sink inputs "
                            "through quant layers; put the quantizers in first")
        probes.append(probe)
    snap = _snapshot_modes(model)
    model.eval()
    _set_disable_quant(model, True)
    act_max = [None] * len(regions)
    try:
        for probe in probes:
            probe._capture_input = True
        with torch.no_grad():
            for b in calib_batches:
                forward_fn(model, b) if forward_fn is not None else model(b)
                for i, probe in enumerate(probes):
                    x = probe._bc_last_input
                    if isinstance(x, QuantTensor):
                        x = x.value
                    if isinstance(probe, _QuantConvNd):
                        x = torch.movedim(x, 1, -1)  # channels last, as the JAX package's
                    m = torch.amax(torch.abs(x.reshape(-1, x.shape[-1])), dim=0)
                    act_max[i] = m if act_max[i] is None else torch.maximum(act_max[i], m)
    finally:
        for probe in probes:
            probe._capture_input = False
            if hasattr(probe, "_bc_last_input"):
                del probe._bc_last_input
        _set_disable_quant(model, False)
        _restore_modes(snap)

    result = {}
    with torch.no_grad():
        for i, (src_paths, sink_paths) in enumerate(regions):
            srcs = [get_module(model, p) for p in src_paths]
            sinks = [get_module(model, p) for p in sink_paths]
            views = []
            for m in sinks:
                in_ax, _ = _axes(m)
                views.append(_channel_view(torch.abs(m.weight), in_ax))
            w_max = torch.amax(torch.cat(views, dim=1), dim=1)
            a = act_max[i]
            s = _pow(a, alpha) / _pow(torch.clamp_min(w_max, EPSILON), 1.0 - alpha)
            # dead channels (no signal, or zero weight) stay unscaled
            s = torch.where((a <= EPSILON) | (w_max <= EPSILON), torch.ones_like(s), s)
            _scale_region(srcs, sinks, s)
            result[i] = s
    return result
