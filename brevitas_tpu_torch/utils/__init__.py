"""Small shared utilities (port of ``brevitas_tpu/utils``)."""

import torch
from torch import nn


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``cuda`` raises when no card is
    present: the port never falls back to the CPU unless asked to."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


def train_mode(model: nn.Module) -> nn.Module:
    """Training mode: quantizer stats advance, BatchNorm uses batch stats."""
    return model.train()


def eval_mode(model: nn.Module) -> nn.Module:
    """Eval mode: frozen quantizer state, BatchNorm running stats."""
    return model.eval()


def set_compute_dtype(model: nn.Module, dtype) -> nn.Module:
    """Set the matmul operand dtype (``torch.bfloat16``, or None for float32
    operands) on every ``QuantWBIOL`` layer and QuantLSTM layer. Fake-quant
    math, accumulators, parameters and optimizer state stay float32; a
    layer whose quantized operands are exact small integers feeds their
    codes to the product (``nn/quant_layer.py``). The port's attention
    modules have no bf16 branch yet, so a model that holds one raises."""
    from brevitas_tpu_torch.nn.attention import QuantMultiheadAttention
    from brevitas_tpu_torch.nn.quant_layer import QuantWBIOL
    from brevitas_tpu_torch.nn.rnn import _QuantLSTMLayer

    if dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute dtype must be torch.bfloat16 or None, not {dtype}")
    mods = list(model.modules())
    if dtype is not None and any(isinstance(m, QuantMultiheadAttention) for m in mods):
        raise NotImplementedError("set_compute_dtype: the port's attention modules have no "
                                  "bf16 branch yet")
    for mod in mods:
        if isinstance(mod, (QuantWBIOL, _QuantLSTMLayer)):
            mod.compute_dtype = dtype
    return model
