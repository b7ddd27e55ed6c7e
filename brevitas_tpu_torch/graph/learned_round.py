"""Learned weight rounding for PTQ, AdaRound (arXiv:2004.10568) (port of
``brevitas_tpu/graph/learned_round.py``).

Per layer, the rounding of each weight becomes a continuous choice between
floor and ceil through a rectified sigmoid, optimized against the layer's
float output on its calibration inputs with an annealed regularizer that
drives the choice to 0 or 1, then baked into the weights with the scale
frozen. The JAX package runs the whole optimization as one ``lax.scan``
under ``jit`` with optax's Adam; the port runs the steps as a Python loop
with ``torch.optim.Adam``, whose update rounds differently in its last bits
(it divides by ``sqrt(1 - b2^t)`` after the square root, optax before it).
A conv's product is the port's own patch-matrix conv (``nn.conv.conv_nd``)
at full float32 precision, not cuDNN.

Usage (after calibration, before bias correction)::

    with calibration_mode(model):
        for b in batches: model(b)
    apply_learned_round(model, batches)
    with bias_correction_mode(model):
        for b in batches: model(b)
"""

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from brevitas_tpu_torch.graph.base import find_modules
from brevitas_tpu_torch.nn.conv import _QuantConvNd, conv_nd, full_float32_matmuls
from brevitas_tpu_torch.nn.linear import QuantLinear
from brevitas_tpu_torch.nn.quant_layer import QuantWBIOL
from brevitas_tpu_torch.ops import max_int, min_int
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


# rectified-sigmoid stretch (AdaRound eq. 23)
ZETA, GAMMA = 1.1, -0.1


def _rectified_sigmoid(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.sigmoid(v) * (ZETA - GAMMA) + GAMMA, 0.0, 1.0)


def _init_v(residual: torch.Tensor) -> torch.Tensor:
    """The v whose rectified sigmoid is the nearest-rounding residual."""
    r = torch.clamp(residual, GAMMA + 1e-4, ZETA - 1e-4)
    return -torch.log((ZETA - GAMMA) / (r - GAMMA) - 1.0)


def _inner_apply(layer: QuantWBIOL, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The layer's product with an explicit weight, without the bias (it
    cancels in the objective)."""
    if isinstance(layer, QuantLinear):
        with full_float32_matmuls():
            return torch.matmul(x, w.t())
    if isinstance(layer, _QuantConvNd):
        return conv_nd(x, w, layer.stride, layer.pads(x.shape[2:]), layer.dilation,
                       layer.groups)
    raise NotImplementedError(type(layer).__name__)


def _grid(layer: QuantWBIOL, w: torch.Tensor):
    """(scale, lowest code, highest code) of the layer's weight grid."""
    qt = layer.weight_quant(w)
    cfg = layer.weight_quant.cfg
    return (qt.scale, min_int(cfg.signed, cfg.narrow_range, qt.bit_width),
            max_int(cfg.signed, cfg.narrow_range, qt.bit_width))


def _optimize_layer(layer: QuantWBIOL, x: torch.Tensor, *, steps: int, lr: float, lam: float,
                    beta_start: float, beta_end: float,
                    warmup: float) -> Tuple[torch.Tensor, float, float]:
    """(v, output MSE with nearest rounding, output MSE with the learned
    rounding) of the layer on inputs ``x``."""
    with torch.no_grad():
        w = layer.weight.detach()
        scale, nmin, nmax = _grid(layer, w)
        w_s = w / scale
        floor_w = torch.floor(w_s)
        v0 = _init_v(w_s - floor_w)
        fp_out = _inner_apply(layer, x, w)

    def quant_w(h):
        return torch.clamp(floor_w + h, nmin, nmax) * scale

    def mse(wq):
        return torch.mean((_inner_apply(layer, x, wq) - fp_out) ** 2)

    warmup_t = int(steps * warmup)
    v = v0.clone().requires_grad_(True)
    opt = torch.optim.Adam([v], lr=lr)
    for t in range(steps):
        h = _rectified_sigmoid(v)
        loss = mse(quant_w(h))
        if t >= warmup_t:
            # the annealed regularizer, its exponent formed in float32 as in JAX
            frac = torch.clamp((torch.tensor(float(t)) - warmup_t) / max(steps - warmup_t, 1),
                               0.0, 1.0)
            beta = (beta_end + (beta_start - beta_end) * (1.0 - frac)).to(v.device)
            loss = loss + lam * torch.mean(1.0 - torch.abs(2.0 * h - 1.0) ** beta)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    v = v.detach()
    with torch.no_grad():
        mse_nearest = float(mse(quant_w(torch.round(w_s - floor_w))))
        mse_learned = float(mse(quant_w((_rectified_sigmoid(v) >= 0.5).to(w.dtype))))
    return v, mse_nearest, mse_learned


def _bake(layer: QuantWBIOL, v: torch.Tensor) -> None:
    """Write the learned rounding into the weights and freeze the weight
    scale, so that quantizing them again gives the learned codes."""
    with torch.no_grad():
        w = layer.weight.detach()
        scale, nmin, nmax = _grid(layer, w)
        h = (_rectified_sigmoid(v) >= 0.5).to(w.dtype)
        w_int = torch.clamp(torch.floor(w / scale) + h, nmin, nmax)
        freeze_weight_scale(layer)  # before the weights leave the grid's basis
        layer.weight.copy_(w_int * scale)
    layer.clear_quant_weight_cache()


def apply_learned_round(model: nn.Module, calib_batches: Sequence, *, steps: int = 1000,
                        lr: float = 3e-3, lam: float = 0.01, beta_start: float = 20.0,
                        beta_end: float = 2.0, warmup: float = 0.2,
                        forward_fn: Optional[Callable] = None,
                        layer_filter: Optional[Callable[[str], bool]] = None,
                        ) -> Dict[str, Tuple[float, float]]:
    """Learn the weight rounding of every eligible quant layer in turn, in
    definition order; each layer's inputs are captured after the layers
    before it were baked. ``forward_fn(model, batch)`` replaces
    ``model(batch)``. Returns ``{path: (output MSE with nearest rounding,
    with the learned rounding)}``."""
    from brevitas_tpu_torch.graph.calibrate import _restore_modes, _snapshot_modes

    snap = _snapshot_modes(model)
    model.eval()
    report: Dict[str, Tuple[float, float]] = {}
    try:
        targets: List[Tuple[str, QuantWBIOL]] = [
            (p, m) for p, m in find_modules(model, QuantWBIOL)
            if eligible_for_learned_round(m) and (layer_filter is None or layer_filter(p))]
        for path, layer in targets:
            x = _capture_inputs(model, layer, calib_batches, forward_fn)
            v, mse_near, mse_learned = _optimize_layer(
                layer, x, steps=steps, lr=lr, lam=lam, beta_start=beta_start,
                beta_end=beta_end, warmup=warmup)
            _bake(layer, v)
            report[path] = (mse_near, mse_learned)
    finally:
        _restore_modes(snap)
    return report
