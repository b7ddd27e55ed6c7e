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
