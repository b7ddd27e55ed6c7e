"""PTQ calibration (port of ``brevitas_tpu/graph/calibrate.py``; ported:
``calibration_mode``, ``finalize_collect_stats`` and the train/eval
snapshot the PTQ passes restore, ``_snapshot_modes``/``_restore_modes``).

Inside ``calibration_mode`` the model runs its float forward in training
mode while the activation quantizers collect their statistics; on exit the
collected buffers become the learned scales, quantization is back on, and
each module's previous train/eval state is restored.
"""

from contextlib import contextmanager

import torch
from torch import nn

from brevitas_tpu_torch.quant.quantizers import (
    ActQuantizer,
    ParameterFromRuntimeStatsScaling,
    ParameterQuantizer,
)


def finalize_collect_stats(model: nn.Module) -> None:
    """Hand every collected buffer over into its learned parameter and close
    the collection phase, at once instead of at the next training step."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, ParameterFromRuntimeStatsScaling):
                c = int(mod.counter)
                if 0 < c <= mod.steps:
                    mod.value.copy_(mod.rc.preprocess_runtime(mod.buffer))
                mod.counter.fill_(mod.steps + 1)


def _set_disable_quant(model: nn.Module, value: bool) -> None:
    """The port's bias quantizer is NONE only, so it has nothing to bypass."""
    for mod in model.modules():
        if isinstance(mod, (ActQuantizer, ParameterQuantizer)):
            mod.disable_quant = value


def _snapshot_modes(model: nn.Module):
    """Every module's train/eval state (the JAX package's mode attributes are
    torch's one ``training`` flag)."""
    return [(mod, mod.training) for mod in model.modules()]


def _restore_modes(snap) -> None:
    for mod, training in snap:
        mod.training = training


@contextmanager
def calibration_mode(model: nn.Module, enabled: bool = True):
    """Feed calibration batches inside this context: quantization is
    bypassed (the float forward) while the activation quantizers collect
    statistics in training mode; on exit the statistics are finalized into
    parameters, quantization is re-enabled, and every module's previous
    train/eval state is restored."""
    if not enabled:
        yield model
        return
    snap = _snapshot_modes(model)
    _set_disable_quant(model, True)
    model.train()
    try:
        yield model
    finally:
        finalize_collect_stats(model)
        _set_disable_quant(model, False)
        _restore_modes(snap)
