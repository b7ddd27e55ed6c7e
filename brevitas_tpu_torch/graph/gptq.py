"""GPTQ, Hessian-based post-training weight quantization
(arXiv:2210.17323; port of ``brevitas_tpu/graph/gptq.py``).

Per layer, the calibration inputs give a proxy Hessian H = XᵀX over the
layer's reduction dimension; the weights are quantized one input row at a
time and the rows after it absorb the error through the upper Cholesky
factor of H⁻¹. The JAX package runs the row recursion as a jitted
``fori_loop``; the port runs it as a Python loop over the K rows on the
tensors' device, one row's quantization and one rank-1 update of the rows
after it a step. Cholesky and the solve are torch's (LAPACK on the CPU,
cuSOLVER on the card), whose last bits differ from XLA's; the recursion
feeds each rounding error into every later row, so a flipped code moves
the rows after it.

Convolutions take the patch matrix of ``nn.conv`` (feature order channel,
then kernel offset: the flattening of torch's (O, C / groups, *kernel)
weight); a grouped conv solves each group apart.
"""

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from brevitas_tpu_torch.graph.base import find_modules
from brevitas_tpu_torch.graph.learned_round import (
    _capture_inputs,
    eligible_for_learned_round,
    freeze_weight_scale,
)
from brevitas_tpu_torch.nn.conv import _patches, full_float32_matmuls
from brevitas_tpu_torch.nn.linear import QuantLinear
from brevitas_tpu_torch.nn.quant_layer import QuantWBIOL
from brevitas_tpu_torch.ops import max_int, min_int

# GPTQ takes exactly the layers learned rounding takes
eligible_for_gptq = eligible_for_learned_round


def _gptq_solve(W: torch.Tensor, H: torch.Tensor, scale, nmin, nmax,
                damp: float) -> torch.Tensor:
    """The GPTQ recursion on a (K, O) weight with a (K, K) Hessian. Row i
    is fake-quantized against ``scale`` (broadcastable to (O,)); rows
    j >= i absorb ``U[i, j] * (w_i - q_i) / U[i, i]``, U the upper Cholesky
    factor of H⁻¹ (H⁻¹ = UᵀU). Returns the new weight; W is not changed."""
    k = W.shape[0]
    diag = torch.diagonal(H)
    dead = diag == 0.0
    eye = torch.eye(k, dtype=H.dtype, device=H.device)
    H = H + torch.diag(torch.where(dead, 1.0, 0.0).to(H.dtype))
    mean_diag = torch.sum(diag) / torch.full_like(diag[0], k)
    H = H + damp * mean_diag * eye
    W = torch.where(dead[:, None], torch.zeros_like(W), W)

    L = torch.linalg.cholesky(H)
    Hinv = torch.cholesky_solve(eye, L)
    U = torch.linalg.cholesky(Hinv).T  # upper, H⁻¹ = UᵀU

    for i in range(k):
        w_i = W[i]
        q = torch.clamp(torch.round(w_i / scale), nmin, nmax) * scale
        err = (w_i - q) / U[i, i]
        # row i lands on q (U[i, i] * err = w_i - q); the rows after absorb
        W[i:] = W[i:] - torch.outer(U[i, i:], err)
    return W


def _layer_matrix_problems(layer: QuantWBIOL, x: torch.Tensor):
    """The layer as one or more (W (K, O), X (M, K), write-back) problems."""
    if isinstance(layer, QuantLinear):
        W = layer.weight.detach().t().contiguous()
        X = x.reshape(-1, W.shape[0])

        def write(Wn):
            layer.weight.copy_(Wn.t())

        return [(W, X, write)]

    w = layer.weight.detach()
    out, cg = w.shape[0], w.shape[1]
    kshape = tuple(w.shape[2:])
    ksz = 1
    for kk in kshape:
        ksz *= kk
    pads = layer.pads(x.shape[2:])
    if any(p != (0, 0) for p in pads):
        x = nn.functional.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
    cols, _ = _patches(x, kshape, layer.stride, layer.dilation)
    P = cols.transpose(1, 2).reshape(-1, cols.shape[1])  # (M, C * prod(k))
    groups = layer.groups
    og = out // groups
    problems = []
    for g in range(groups):
        Wg = w[g * og:(g + 1) * og].reshape(og, cg * ksz).t().contiguous()
        Xg = P[:, g * cg * ksz:(g + 1) * cg * ksz]

        def write(Wn, g=g):
            layer.weight[g * og:(g + 1) * og] = Wn.t().reshape(og, cg, *kshape)

        problems.append((Wg, Xg, write))
    return problems


def _scale_for_problem(layer: QuantWBIOL, group: int, groups: int):
    """The weight quantizer's (frozen) scale, broadcastable over the
    (K, O)-form rows, and the integer clip bounds."""
    qt = layer.weight_quant(layer.weight)
    cfg = layer.weight_quant.cfg
    nmin = min_int(cfg.signed, cfg.narrow_range, qt.bit_width)
    nmax = max_int(cfg.signed, cfg.narrow_range, qt.bit_width)
    s = qt.scale.detach()
    if s.ndim > 0 and s.numel() > 1:
        s = s.reshape(-1)  # per output channel (O,)
        og = s.shape[0] // groups
        s = s[group * og:(group + 1) * og]
    return s, nmin, nmax


def apply_gptq(model: nn.Module, calib_batches: Sequence, *, damp: float = 0.01,
               forward_fn: Optional[Callable] = None) -> Dict[str, Tuple[float, float]]:
    """GPTQ on every eligible quant layer, one after another in definition
    order (each layer's inputs captured with the layers before it already
    solved, so their error reaches it as at deployment). Returns
    ``{path: (output_mse_nearest, output_mse_gptq)}``, the calibration
    proxy ``tr(ΔWᵀ H ΔW) / M`` per output channel."""
    from brevitas_tpu_torch.graph.calibrate import _restore_modes, _snapshot_modes

    snap = _snapshot_modes(model)
    model.eval()
    report: Dict[str, Tuple[float, float]] = {}
    try:
        targets = [(p, l) for p, l in find_modules(model, QuantWBIOL)
                   if eligible_for_gptq(l)]
        for path, layer in targets:
            x = _capture_inputs(model, layer, calib_batches, forward_fn)
            # freeze the scale first: the recursion moves the rows not yet
            # quantized off their magnitudes, and a scale from the weight's
            # statistics would leave the grid the solve quantized on
            freeze_weight_scale(layer)
            mse_near = mse_gptq = 0.0
            groups = getattr(layer, "groups", 1)
            with torch.no_grad(), full_float32_matmuls():
                for g, (W, X, write) in enumerate(_layer_matrix_problems(layer, x)):
                    scale, nmin, nmax = _scale_for_problem(layer, g, groups)
                    H = X.T @ X
                    m = X.shape[0]
                    Wn = _gptq_solve(W.clone(), H, scale, nmin, nmax, damp)

                    def proxy_mse(Wq):
                        D = Wq - W
                        return float(torch.sum(D * (H @ D)) / m / Wq.shape[1])

                    mse_near += proxy_mse(torch.clamp(torch.round(W / scale), nmin, nmax)
                                          * scale)
                    mse_gptq += proxy_mse(Wn)
                    write(Wn)
            report[path] = (mse_near, mse_gptq)
    finally:
        _restore_modes(snap)
    return report
