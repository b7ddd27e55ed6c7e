"""Module-tree surgery (port of ``brevitas_tpu/graph/base.py``; ported:
``named_modules`` and ``set_module``)."""

from typing import Iterator, Tuple

from torch import nn


def named_modules(model: nn.Module) -> Iterator[Tuple[str, nn.Module]]:
    """Yield (dot-path, module) pairs, root included (path '')."""
    return model.named_modules()


def set_module(model: nn.Module, path: str, new: nn.Module) -> None:
    parent_path, _, name = path.rpartition(".")
    setattr(model.get_submodule(parent_path), name, new)
