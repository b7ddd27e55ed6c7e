"""Learned weight rounding for PTQ (port of
``brevitas_tpu/graph/learned_round.py``; ported: what GPTQ and GPFQ take from it,
``eligible_for_learned_round``, ``_capture_inputs`` and
``freeze_weight_scale``). AdaRound's optimizer (``apply_learned_round``) is
not ported yet.
"""

from typing import Sequence

import torch
from torch import nn

from brevitas_tpu_torch.nn.conv import _QuantConvNd
from brevitas_tpu_torch.nn.linear import QuantLinear
from brevitas_tpu_torch.nn.quant_layer import QuantWBIOL
from brevitas_tpu_torch.quant.config import QuantType, ZeroPointImplType
from brevitas_tpu_torch.quant.quantizers import (
    ParameterScaling,
    scaling_broadcast_shape,
    stats_view,
)
from brevitas_tpu_torch.quant_tensor import QuantTensor


def eligible_for_learned_round(layer) -> bool:
    """INT weight quant with a zero zero-point on a linear or a conv, and
    not groupwise: an MX weight's group scales bypass ``scaling``, which
    ``freeze_weight_scale`` fixes. (The JAX package also refuses decoupled
    and accumulator-aware weights and transposed convs; the port has none
    of them.)"""
    if not isinstance(layer, (QuantLinear, _QuantConvNd)):
        return False
    cfg = layer.weight_quant.cfg
    return (layer.weight_quant.quant_type == QuantType.INT
            and cfg.scaling_per_group is None
            and ZeroPointImplType(cfg.zero_point_impl) == ZeroPointImplType.ZERO)


def _capture_inputs(model: nn.Module, layer: QuantWBIOL, batches: Sequence,
                    forward_fn) -> torch.Tensor:
    """The tensors entering the layer's product on the calibration batches
    (after its input quantizer, with the layers before it already
    rounded), joined along the batch axis."""
    layer._capture_input = True
    xs = []
    try:
        with torch.no_grad():
            for b in batches:
                forward_fn(model, b) if forward_fn is not None else model(b)
                x = layer._bc_last_input
                if isinstance(x, QuantTensor):
                    x = x.value
                if layer.input_quant.quant_type != QuantType.NONE:
                    x = layer.input_quant(x).value
                xs.append(x)
    finally:
        layer._capture_input = False
        if hasattr(layer, "_bc_last_input"):
            del layer._bc_last_input
    return torch.cat(xs, dim=0)


def freeze_weight_scale(layer: QuantWBIOL) -> None:
    """Replace the weight quantizer's scaling by a learned parameter fixed
    at the current threshold. Weight-rewriting PTQ passes (GPTQ, AdaRound)
    must do this first: a scale from the weight's statistics would move
    once the weights leave their original magnitudes."""
    q = layer.weight_quant
    w = layer.weight
    with torch.no_grad():
        threshold = q.scaling(stats_view(w, q.per_channel, q.channel_axis))
        bshape = scaling_broadcast_shape(w.shape, q.per_channel, q.channel_axis)
        q.scaling = ParameterScaling(q.cfg, threshold, bshape)
