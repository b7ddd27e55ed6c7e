"""Models (port of ``brevitas_tpu/models``; ported: the FC family, CNV,
MobileNetV1, QuartzNet, QuantLlama, QuantTransformer and the float
ResNet of the PTQ flow)."""

from brevitas_tpu_torch.models.cnv import CNV, cnv
from brevitas_tpu_torch.models.fc import FC, lfc, sfc, tfc
from brevitas_tpu_torch.models.llama import QuantLlama, quant_llama_tiny
from brevitas_tpu_torch.models.mobilenetv1 import MobileNetV1, quant_mobilenet_v1
from brevitas_tpu_torch.models.resnet import FloatResNet, float_resnet
from brevitas_tpu_torch.models.quartznet import QuartzNet, quartznet_15x5, quartznet_15x5_4b
from brevitas_tpu_torch.models.transformer import (
    QuantTransformer,
    QuantTransformerBlock,
    quant_transformer_tiny,
)

__all__ = ["CNV", "cnv", "FC", "lfc", "sfc", "tfc", "MobileNetV1", "quant_mobilenet_v1",
           "QuartzNet", "quartznet_15x5", "quartznet_15x5_4b", "QuantLlama", "quant_llama_tiny",
           "QuantTransformer", "QuantTransformerBlock", "quant_transformer_tiny", "FloatResNet",
           "float_resnet"]
