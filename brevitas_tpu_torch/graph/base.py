"""Module-tree surgery (port of ``brevitas_tpu/graph/base.py``):
``named_modules``, ``get_module``, ``set_module``, ``find_modules``,
``_children`` and ``replace_modules_by_class``."""

from typing import Callable, Iterator, List, Optional, Tuple, Type

from torch import nn


def named_modules(model: nn.Module) -> Iterator[Tuple[str, nn.Module]]:
    """Yield (dot-path, module) pairs, root included (path '')."""
    return model.named_modules()


def _children(module: nn.Module) -> Iterator[Tuple[str, nn.Module]]:
    """(name, child) of the module's direct children, in definition order
    (list items by index)."""
    return module.named_children()


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


def replace_modules_by_class(model: nn.Module, old_cls: Type[nn.Module],
                             factory: Callable[[str, nn.Module], Optional[nn.Module]]) -> int:
    """Replace every module of exactly the class ``old_cls`` (subclasses
    are left alone) by ``factory(path, old)``, unless the factory gives
    None. Returns the count replaced."""
    count = 0
    for path, mod in find_modules(model, old_cls):
        if type(mod) is not old_cls:
            continue
        new = factory(path, mod)
        if new is not None:
            set_module(model, path, new)
            count += 1
    return count
