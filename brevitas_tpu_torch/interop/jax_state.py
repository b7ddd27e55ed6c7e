"""Fill a port model from the JAX model's state.

The caller flattens the JAX model's nnx state into numpy arrays keyed by
dot path (``"hidden.0.weight"``, ``"hidden.1.mean"``,
``"hidden.0.input_quant.scaling.counter"``, ...); the port never sees JAX.
The port's modules carry the JAX package's names, so each key walks to the
same tensor here. QuantLinear weights are transposed from the JAX (in, out)
layout to torch's (out, in), and so is an ``nnx.Linear``'s ``kernel``, which
fills a ``torch.nn.Linear``'s ``weight``. A module that the JAX model shares
between several places (QuantLSTM's hidden-state and cell-state quantizers)
appears once in its state, at its first path, and fills the one module the
port shares the same way. The JAX model's random-number state (``rngs.*``)
has no counterpart and is skipped.
"""

from typing import Dict

import numpy as np
import torch
from torch import nn

from brevitas_tpu_torch.nn.linear import QuantLinear


def load_jax_state(model: nn.Module, arrays: Dict[str, np.ndarray]) -> nn.Module:
    """Copy every array into the tensor at its path, in place; raises on a
    path or shape that has no counterpart."""
    for path, array in arrays.items():
        if path.startswith("rngs."):
            continue
        owner_path, _, name = path.rpartition(".")
        owner = model.get_submodule(owner_path)
        transpose = isinstance(owner, QuantLinear) and name == "weight"
        if isinstance(owner, nn.Linear) and name == "kernel":
            name, transpose = "weight", True
        target = getattr(owner, name, None)
        if not isinstance(target, torch.Tensor):
            raise KeyError(f"{path} has no tensor in {type(model).__name__}")
        value = torch.as_tensor(np.array(array))
        if transpose:
            value = value.t()
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"{path}: shape {tuple(value.shape)} does not match "
                             f"{tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(value.to(target.dtype))
    return model
