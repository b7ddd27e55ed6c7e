"""PTQ calibration and bias correction (port of
``brevitas_tpu/graph/calibrate.py``): ``calibration_mode``,
``finalize_collect_stats``, ``bias_correction_mode``, the inference weight
cache (``cache_inference_quant_weights``,
``clear_inference_quant_weight_cache``), ``clip_float_weights``, and the
train/eval snapshot the PTQ passes restore (``_snapshot_modes`` /
``_restore_modes``).

Inside ``calibration_mode`` the model runs its float forward in training
mode while the activation quantizers collect their statistics; on exit the
collected buffers become the learned scales, quantization is back on, and
each module's previous train/eval state is restored. Inside
``bias_correction_mode`` each quant layer also runs its float twin on the
same input, and the per-channel mean of the float output less the
quantized one accumulates into the bias on exit.
"""

from contextlib import contextmanager
from typing import Dict

import torch
from torch import nn

from brevitas_tpu_torch.graph.base import find_modules
from brevitas_tpu_torch.nn.quant_layer import QuantWBIOL
from brevitas_tpu_torch.quant.quantizers import (
    ActQuantizer,
    BiasQuantizer,
    ParameterFromRuntimeStatsScaling,
    ParameterQuantizer,
)
from brevitas_tpu_torch.quant_tensor import QuantTensor


def finalize_collect_stats(model: nn.Module) -> None:
    """Hand every collected buffer over into its learned parameter and close
    the collection phase, at once instead of at the next training step."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, ParameterFromRuntimeStatsScaling):
                c = int(mod.counter)
                if 0 < c <= mod.steps:
                    mod.value.copy_(mod.rc.preprocess_runtime(mod.buffer))
                mod.counter.fill_(mod.steps + 1)


def _set_disable_quant(model: nn.Module, value: bool) -> None:
    """Bypass (or restore) every quantizer: activations, weights and biases.
    A bias quantizer must follow: with the input quantizer bypassed the
    layer has no accumulator scale to put the bias on."""
    for mod in model.modules():
        if isinstance(mod, (ActQuantizer, ParameterQuantizer, BiasQuantizer)):
            mod.disable_quant = value


def _snapshot_modes(model: nn.Module):
    """Every module's train/eval state (the JAX package's mode attributes are
    torch's one ``training`` flag)."""
    return [(mod, mod.training) for mod in model.modules()]


def _restore_modes(snap) -> None:
    for mod, training in snap:
        mod.training = training


@contextmanager
def calibration_mode(model: nn.Module, enabled: bool = True):
    """Feed calibration batches inside this context: quantization is
    bypassed (the float forward) while the activation quantizers collect
    statistics in training mode; on exit the statistics are finalized into
    parameters, quantization is re-enabled, and every module's previous
    train/eval state is restored."""
    if not enabled:
        yield model
        return
    snap = _snapshot_modes(model)
    _set_disable_quant(model, True)
    model.train()
    try:
        yield model
    finally:
        finalize_collect_stats(model)
        _set_disable_quant(model, False)
        _restore_modes(snap)


def _output_channel_axis(layer, ndim: int) -> int:
    """The channel axis of the layer's output: 1 for a conv's (N, C, ...)
    and a BatchNorm fold over axis 1, else the last."""
    from brevitas_tpu_torch.nn.conv import _QuantConvNd
    from brevitas_tpu_torch.nn.misc import QuantScaleBias

    if isinstance(layer, _QuantConvNd) or (isinstance(layer, QuantScaleBias)
                                           and layer.channel_axis is not None and ndim > 2):
        return 1
    return ndim - 1


@contextmanager
def bias_correction_mode(model: nn.Module, enabled: bool = True):
    """Feed batches inside this context. Each quant layer runs twice a
    call, its float twin (quantization bypassed) and quantized, on the same
    input; the per-channel mean of the float output less the quantized one
    (over every axis but the channel axis) corrects the quantized output at
    once, so the layers after it see corrected activations, and its average
    over the calls is added to the bias on exit (a layer without a bias
    gets one)."""
    if not enabled:
        yield model
        return
    layers = find_modules(model, QuantWBIOL)
    acc: Dict[str, torch.Tensor] = {}
    iters: Dict[str, int] = {}

    def make_hook(path):
        def hook(layer, qt_out: QuantTensor):
            if getattr(layer, "_bc_in_float_pass", False):
                return None
            x = layer._bc_last_input
            layer._bc_in_float_pass = True
            _set_disable_quant(layer, True)
            hook_ref = layer._pre_output_hook
            layer._pre_output_hook = None
            try:
                ref = layer(x)
            finally:
                layer._pre_output_hook = hook_ref
                _set_disable_quant(layer, False)
                layer._bc_in_float_pass = False
            with torch.no_grad():
                ref_v = ref.value if isinstance(ref, QuantTensor) else ref
                axis = _output_channel_axis(layer, ref_v.ndim)
                dims = [d for d in range(ref_v.ndim) if d != axis]
                err = ref_v.mean(dims) - qt_out.value.mean(dims)
                acc[path] = acc[path] + err if path in acc else err
                iters[path] = iters.get(path, 0) + 1
                shape = [1] * ref_v.ndim
                shape[axis] = -1
                value = qt_out.value + err.reshape(shape)
            return QuantTensor(value, qt_out.scale, qt_out.zero_point, qt_out.bit_width,
                               signed=qt_out.signed, training=qt_out.training)

        return hook

    for path, layer in layers:
        layer._capture_input = True
        layer._pre_output_hook = make_hook(path)
    try:
        yield model
    finally:
        with torch.no_grad():
            for path, layer in layers:
                layer._capture_input = False
                layer._pre_output_hook = None
                if hasattr(layer, "_bc_last_input"):
                    del layer._bc_last_input
                n = iters.get(path, 0)
                if n and path in acc:
                    corr = acc[path] / n
                    if getattr(layer, "bias", None) is not None:
                        layer.bias.copy_(layer.bias + corr)
                    else:
                        layer.bias = nn.Parameter(corr)


def cache_inference_quant_weights(model: nn.Module) -> int:
    """Keep the fake-quant weight of every quant layer for eval serving;
    returns the count."""
    n = 0
    for _, layer in find_modules(model, QuantWBIOL):
        layer.cache_quant_weight()
        n += 1
    return n


def clear_inference_quant_weight_cache(model: nn.Module) -> None:
    for _, layer in find_modules(model, QuantWBIOL):
        layer.clear_quant_weight_cache()


def clip_float_weights(model: nn.Module, threshold: float = 15.0) -> None:
    """Clamp every quant layer's float weights to [-threshold, threshold]
    before PTQ (extreme outliers would set the scales)."""
    with torch.no_grad():
        for _, layer in find_modules(model, QuantWBIOL):
            layer.weight.clamp_(-threshold, threshold)
