"""Model standardization passes run before export (port of
``brevitas_tpu/graph/standardize.py``).

- :func:`duplicate_shared_stateless_modules` (reference
  ``DuplicateSharedStatelessModule``): a stateless module that sits at two
  places of the tree is copied, so a later per-site pass does not alias.
- :func:`disable_last_return_quant_tensor` (reference
  ``DisableLastReturnQuantTensor``): the model's last quant layer returns a
  plain tensor.
"""

import copy
from typing import List, Optional

from torch import nn

from brevitas_tpu_torch.graph.base import get_module, set_module


def _is_stateless(module: nn.Module) -> bool:
    """True where no parameter or buffer lives in the subtree: shared
    stateful modules are intended weight sharing and stay shared."""
    return (next(module.parameters(), None) is None
            and next(module.buffers(), None) is None)


def duplicate_shared_stateless_modules(model: nn.Module) -> int:
    """Copy each stateless module that appears at more than one place; the
    first sighting keeps the object. Returns the number of places
    rewritten."""
    seen_ids = {id(model)}
    count = 0

    def visit(module: nn.Module, prefix: str) -> None:
        nonlocal count
        # the registry itself: named_children() yields a shared module once
        for name, child in list(module._modules.items()):
            if child is None:
                continue
            path = f"{prefix}.{name}" if prefix else name
            if id(child) in seen_ids:
                if _is_stateless(child):
                    set_module(model, path, copy.deepcopy(child))
                    count += 1
                continue
            seen_ids.add(id(child))
            visit(child, path)

    visit(model, "")
    return count


def disable_last_return_quant_tensor(
        model: nn.Module, layers: Optional[List[nn.Module]] = None) -> Optional[str]:
    """Turn ``return_quant_tensor`` off on the model's last quant layer so
    the network returns a plain tensor. "Last" follows
    ``model.export_layers()`` where the model has it, else the tree's order;
    ``layers`` overrides both. Returns the changed layer's path, or None."""
    if layers is None and hasattr(model, "export_layers"):
        layers = [m for m in model.export_layers() if isinstance(m, nn.Module)]
    if layers is not None:
        for layer in reversed(layers):
            if getattr(layer, "return_quant_tensor", False):
                layer.return_quant_tensor = False
                for path, mod in model.named_modules(remove_duplicate=False):
                    if mod is layer:
                        return path
                return type(layer).__name__  # the layer is not in the tree
        return None
    last_path = None
    for path, mod in model.named_modules(remove_duplicate=False):
        if path and getattr(mod, "return_quant_tensor", False):
            last_path = path
    if last_path is not None:
        get_module(model, last_path).return_quant_tensor = False
    return last_path
