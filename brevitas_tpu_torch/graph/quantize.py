"""Float -> quant by module surgery (port of ``brevitas_tpu/graph/quantize.py``).

``quantize`` swaps a float model's ``torch.nn.Linear`` and float convs
(``nn.conv.FloatConv1d``/``FloatConv2d``, whose padding is XLA's, and plain
``torch.nn.Conv1d``/``Conv2d``) for ``QuantLinear``/``QuantConv1d``/
``QuantConv2d`` with the trained weights, and, with ``bn_to_scale_bias``,
the standalone BatchNorms (``models.common.BatchNorm``) for
``QuantScaleBias``. ``merge_batchnorms`` folds BatchNorms into the layers
before them, found from a traced forward (``graph.autograph.find_bn_pairs``)
or by declaration order (``discover_bn_pairs``). Run
``graph.calibrate.calibration_mode`` and ``bias_correction_mode`` after.
"""

from typing import Optional

import torch
from torch import nn

from brevitas_tpu_torch.graph.base import (
    _children,
    get_module,
    named_modules,
    replace_modules_by_class,
    set_module,
)
from brevitas_tpu_torch.models.common import BatchNorm
from brevitas_tpu_torch.nn.conv import (
    FloatConv1d,
    FloatConv2d,
    QuantConv1d,
    QuantConv2d,
    _QuantConvNd,
)
from brevitas_tpu_torch.nn.linear import QuantLinear
from brevitas_tpu_torch.nn.misc import FoldedBatchNorm, batch_norm_to_quant_scale_bias, merge_bn
from brevitas_tpu_torch.quant.config import QuantConfig
from brevitas_tpu_torch.quant.presets import (
    Int8ActPerTensorFloat,
    Int8WeightPerTensorFloat,
    Int32Bias,
)
from brevitas_tpu_torch.quant.quantizers import ParameterQuantizer

_FLOAT_CONVS = (FloatConv1d, FloatConv2d, nn.Conv1d, nn.Conv2d)


def _conv_padding(mod):
    """The float conv's padding in ``nn.conv.padding_spec``'s terms."""
    if isinstance(mod, (FloatConv1d, FloatConv2d)):
        return mod.xla_padding
    if isinstance(mod.padding, str):
        if mod.padding == "valid":
            return "VALID"
        # torch's 'same' puts the odd unit on the high side, as XLA's does
        # at stride 1, the only stride torch allows it at
        return "SAME"
    if mod.padding_mode != "zeros":
        raise NotImplementedError(f"padding_mode {mod.padding_mode!r} is not supported by "
                                  "quantize()")
    return tuple((p, p) for p in mod.padding)


def quantize(model: nn.Module, *,
             weight_quant: Optional[QuantConfig] = Int8WeightPerTensorFloat,
             act_quant: Optional[QuantConfig] = Int8ActPerTensorFloat,
             bias_quant: Optional[QuantConfig] = Int32Bias,
             bn_to_scale_bias: bool = False) -> nn.Module:
    """Replace the float linears and convs by quant layers in place, with
    their trained weights; each gets ``act_quant`` as its input quantizer,
    and its bias quantizer takes the accumulator's scale (input scale times
    weight scale). With ``bn_to_scale_bias`` every BatchNorm that
    ``merge_batchnorms`` did not fold becomes an equivalent
    ``QuantScaleBias``."""

    def _finish(new, old):
        with torch.no_grad():
            new.weight.copy_(old.weight)
            if old.bias is not None:
                new.bias.copy_(old.bias)
        if weight_quant is not None:
            # rebuilt against the real weights, so a scale from the weight's
            # statistics sees them
            new.weight_quant = ParameterQuantizer(weight_quant, new.weight.detach(),
                                                  channel_axis=0)
        return new.train(old.training)

    def linear_factory(path, mod):
        new = QuantLinear(mod.in_features, mod.out_features, use_bias=mod.bias is not None,
                          weight_quant=weight_quant, bias_quant=bias_quant,
                          input_quant=act_quant, return_quant_tensor=False,
                          device=mod.weight.device)
        return _finish(new, mod)

    def conv_factory(path, mod):
        if mod.transposed:
            raise NotImplementedError(f"{path}: transposed convs wait for slice 11")
        cls = QuantConv1d if len(mod.kernel_size) == 1 else QuantConv2d
        new = cls(mod.in_channels, mod.out_channels, mod.kernel_size, stride=mod.stride,
                  padding=_conv_padding(mod), dilation=mod.dilation, groups=mod.groups,
                  use_bias=mod.bias is not None, weight_quant=weight_quant,
                  bias_quant=bias_quant, input_quant=act_quant, return_quant_tensor=False,
                  device=mod.weight.device)
        return _finish(new, mod)

    replace_modules_by_class(model, nn.Linear, linear_factory)
    for cls in _FLOAT_CONVS:
        replace_modules_by_class(model, cls, conv_factory)
    if bn_to_scale_bias:
        def bn_factory(path, bn):
            return batch_norm_to_quant_scale_bias(
                bn, weight_quant=weight_quant, bias_quant=bias_quant, input_quant=act_quant,
                return_quant_tensor=False).train(bn.training)

        replace_modules_by_class(model, BatchNorm, bn_factory)
    return model


def _out_channels(mod) -> Optional[int]:
    """Output channels of a float or quant linear or conv (axis 0 of its
    weight), else None."""
    if isinstance(mod, (nn.Linear, QuantLinear, _QuantConvNd) + _FLOAT_CONVS):
        return int(mod.weight.shape[0])
    return None


def discover_bn_pairs(model: nn.Module):
    """(layer, BatchNorm) pairs by declaration order: a BatchNorm declared
    right after a linear or conv of the same container, with as many
    channels, normalizes that layer's output. ``graph.autograph.find_bn_pairs``
    finds them from the dataflow instead."""
    pairs = []
    for parent_path, parent in named_modules(model):
        kids = list(_children(parent))
        for (name_a, a), (name_b, b) in zip(kids[:-1], kids[1:]):
            n = _out_channels(a)
            if n is None or not isinstance(b, BatchNorm) or b.scale.shape[0] != n:
                continue
            prefix = f"{parent_path}." if parent_path else ""
            pairs.append((f"{prefix}{name_a}", f"{prefix}{name_b}"))
    return pairs


def refresh_weight_quantizers(model: nn.Module) -> nn.Module:
    """Rebuild every layer's weight quantizer against its current weights:
    run after a pass that moves the weights of a quantized model (BatchNorm
    folding, equalization), whose scales from the weights' statistics were
    solved on the old ones. Activation quantizers stay."""
    for _, mod in list(named_modules(model)):
        wq = getattr(mod, "weight_quant", None)
        if isinstance(wq, ParameterQuantizer) and hasattr(mod, "weight"):
            mod.weight_quant = ParameterQuantizer(wq.cfg, mod.weight.detach(),
                                                  channel_axis=wq.channel_axis)
    return model


def merge_batchnorms(model: nn.Module, pairs=None) -> nn.Module:
    """Fold each (layer_path, bn_path) BatchNorm into its layer and put a
    ``FoldedBatchNorm`` identity in its place; ``pairs=None`` runs
    ``discover_bn_pairs``."""
    if pairs is None:
        pairs = discover_bn_pairs(model)
    for layer_path, bn_path in pairs:
        layer = get_module(model, layer_path)
        bn = get_module(model, bn_path)
        merge_bn(layer, bn.scale.detach(), bn.bias.detach(), bn.mean, bn.var, bn.eps)
        set_module(model, bn_path, FoldedBatchNorm(bn.scale.shape[0]))
    return model
