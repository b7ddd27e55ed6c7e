"""Module-tree surgery (port of ``brevitas_tpu/graph/base.py``; ported:
``named_modules``, ``get_module``, ``set_module`` and ``find_modules``)."""

from typing import Iterator, List, Tuple

from torch import nn


def named_modules(model: nn.Module) -> Iterator[Tuple[str, nn.Module]]:
    """Yield (dot-path, module) pairs, root included (path '')."""
    return model.named_modules()


def get_module(model: nn.Module, path: str) -> nn.Module:
    """The module at a dot path ('' is the model; list items by index)."""
    return model.get_submodule(path)


def set_module(model: nn.Module, path: str, new: nn.Module) -> None:
    parent_path, _, name = path.rpartition(".")
    setattr(model.get_submodule(parent_path), name, new)


def find_modules(model: nn.Module, cls) -> List[Tuple[str, nn.Module]]:
    """(path, module) of every module that is an instance of ``cls``, in
    definition order."""
    return [(p, m) for p, m in named_modules(model) if isinstance(m, cls)]
