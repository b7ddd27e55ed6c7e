"""Fill a port model from the JAX model's state.

The caller flattens the JAX model's nnx state into numpy arrays keyed by
dot path (``"hidden.0.weight"``, ``"hidden.1.mean"``,
``"hidden.0.input_quant.scaling.counter"``, ...); the port never sees JAX.
The port's modules carry the JAX package's names, so each key walks to the
same tensor here. QuantLinear weights are transposed from the JAX (in, out)
layout to torch's (out, in), and so is an ``nnx.Linear``'s ``kernel``, which
fills a ``torch.nn.Linear``'s ``weight``. Conv weights go from the JAX
package's channels-last HWIO (WIO) to torch's OIHW (OIW), a float
``nnx.Conv``'s ``kernel`` into a float conv's (``torch.nn.Conv1d`` /
``Conv2d``, ``nn.conv.FloatConv2d``) ``weight`` so, and a per-channel
tensor stored (1, ..., 1, O) goes to the port's (O, 1, ..., 1). A module
that the JAX model shares between several places (QuantLSTM's hidden-state
and cell-state quantizers) appears once in its state, at its first path,
and fills the one module the port shares the same way. The JAX model's
random-number state (``rngs``, at the root or inside a module, as a
stochastic-rounding quantizer holds it) has no counterpart and is skipped.
Zero points carry as their ``value``, ``buffer`` and ``counter``, a learned
bit width as its ``offset``, an ``nnx.BatchNorm``'s ``scale``, ``bias``,
``mean`` and ``var`` into ``models.common.BatchNorm``'s of the same names. Lists of modules (``nnx.List``: CNV's
``conv_features``, QuartzNet's ``encoder``/``convs``/``bns``/``acts``,
MobileNet's ``features``) carry by index, a per-channel activation
threshold (C,) and a BatchNorm's running statistics as they are.
"""

from typing import Dict

import numpy as np
import torch
from torch import nn

from brevitas_tpu_torch.nn.conv import _QuantConvNd
from brevitas_tpu_torch.nn.linear import QuantLinear


def _one_channel_axis(shape) -> int:
    """The axis of the one dimension above 1, or -1."""
    big = [i for i, d in enumerate(shape) if d != 1]
    return big[0] if len(big) == 1 else -1


def load_jax_state(model: nn.Module, arrays: Dict[str, np.ndarray]) -> nn.Module:
    """Copy every array into the tensor at its path, in place; raises on a
    path or shape that has no counterpart."""
    for path, array in arrays.items():
        if path.startswith("rngs.") or ".rngs." in path:
            continue
        owner_path, _, name = path.rpartition(".")
        owner = model.get_submodule(owner_path)
        transpose = isinstance(owner, QuantLinear) and name == "weight"
        if isinstance(owner, nn.Linear) and name == "kernel":
            name, transpose = "weight", True
        float_conv = (isinstance(owner, (nn.Conv1d, nn.Conv2d, nn.Conv3d))
                      and name == "kernel")
        if float_conv:
            name = "weight"
        target = getattr(owner, name, None)
        if not isinstance(target, torch.Tensor):
            raise KeyError(f"{path} has no tensor in {type(model).__name__}")
        value = torch.as_tensor(np.array(array))
        if transpose:
            value = value.t()
        if float_conv or (isinstance(owner, _QuantConvNd) and name == "weight"):
            # (*kernel, I, O) -> (O, I, *kernel)
            value = value.permute(value.ndim - 1, value.ndim - 2, *range(value.ndim - 2))
        if (tuple(value.shape) != tuple(target.shape) and value.ndim == target.ndim
                and value.numel() == target.numel()
                and _one_channel_axis(value.shape) == value.ndim - 1
                and _one_channel_axis(target.shape) == 0):
            value = value.reshape(target.shape)
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"{path}: shape {tuple(value.shape)} does not match "
                             f"{tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(value.to(target.dtype))
    return model
