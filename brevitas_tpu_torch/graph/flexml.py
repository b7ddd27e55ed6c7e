"""The flexml auto-quantization flow (port of ``brevitas_tpu/graph/flexml.py``):
``preprocess_flexml`` (BatchNorm fusion, cross-layer equalization, weight
clipping) and ``quantize_flexml`` (8-bit fixed-point quantizers: power-of-two
scales, per tensor, an input quantizer on every layer, 32-bit biases).
"""

from typing import List, Optional, Sequence, Tuple

from torch import nn

from brevitas_tpu_torch.graph.calibrate import clip_float_weights
from brevitas_tpu_torch.graph.equalize import equalize
from brevitas_tpu_torch.graph.quantize import merge_batchnorms, quantize
from brevitas_tpu_torch.quant.presets import (
    Int8ActPerTensorFixedPoint,
    Int8WeightPerTensorFixedPoint,
    Int32Bias,
    Uint8ActPerTensorFixedPoint,
)

FLEXML_WEIGHT_QUANT = Int8WeightPerTensorFixedPoint
FLEXML_ACT_QUANT = Int8ActPerTensorFixedPoint
FLEXML_UACT_QUANT = Uint8ActPerTensorFixedPoint
FLEXML_BIAS_QUANT = Int32Bias


def preprocess_flexml(model: nn.Module, sample_input=None,
                      bn_pairs: Optional[Sequence[Tuple[str, str]]] = None,
                      equalize_regions: Optional[List[Tuple[Sequence[str], Sequence[str]]]] = None,
                      equalize_iterations: int = 10,
                      clip_threshold: Optional[float] = None) -> nn.Module:
    """BatchNorm fusion, cross-layer equalization and optional weight
    clipping. Given ``sample_input``, one traced forward finds the fusion
    pairs, and a second one after the fusion the equalization regions
    (``graph.autograph``); explicit ``bn_pairs`` / ``equalize_regions``
    take their place."""
    if sample_input is not None:
        from brevitas_tpu_torch.graph.autograph import extract_regions, find_bn_pairs

        if bn_pairs is None:
            bn_pairs = find_bn_pairs(model, sample_input)
        if bn_pairs:
            merge_batchnorms(model, bn_pairs)
        if equalize_regions is None:
            equalize_regions = extract_regions(model, sample_input)
    elif bn_pairs:
        merge_batchnorms(model, bn_pairs)
    if equalize_regions:
        equalize(model, equalize_regions, iterations=equalize_iterations)
    if clip_threshold is not None:
        clip_float_weights(model, clip_threshold)
    return model


def quantize_flexml(model: nn.Module, *, collect_stats_steps: int = 30) -> nn.Module:
    """Swap the float layers for 8-bit fixed-point quant layers, and every
    BatchNorm left standing for a ``QuantScaleBias``; run
    ``calibration_mode`` after."""
    return quantize(model, weight_quant=FLEXML_WEIGHT_QUANT,
                    act_quant=FLEXML_ACT_QUANT.let(collect_stats_steps=collect_stats_steps),
                    bias_quant=FLEXML_BIAS_QUANT, bn_to_scale_bias=True)
