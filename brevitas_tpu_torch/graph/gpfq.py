"""GPFQ, greedy path-following post-training weight quantization
(arXiv:2201.11113; port of ``brevitas_tpu/graph/gpfq.py``).

Where GPTQ absorbs each row's error through the Cholesky factor of the
inputs' Hessian, GPFQ carries the running output residual on the
calibration set: the input dimensions are quantized one at a time, each
row's codes chosen to reconstruct the output accumulated so far. For a
(K, O) weight W and calibration inputs X (M, K):

    u_0 = 0
    for t in 0 .. K-1:
        arg_t = <X_t, u_{t-1}> / ||X_t||² + W_t        (O,)
        q_t   = quant(arg_t)
        u_t   = u_{t-1} + outer(X_t, W_t - q_t)         (M, O)

so the last u is X (W - Q), the layer's output error on the calibration
rows. The JAX package runs the recursion as one jitted ``fori_loop``; the
port runs it as a Python loop over the K rows on the tensors' device, as
its GPTQ does (ROADMAP S7), reading row t of a contiguous Xᵀ. The matrix
products' last bits differ from XLA's, and the recursion carries each
rounding into every later row (ROADMAP S15). Convolutions and grouped
convolutions take GPTQ's matrix problems.
"""

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from brevitas_tpu_torch.graph.base import find_modules
from brevitas_tpu_torch.graph.gptq import _layer_matrix_problems, _scale_for_problem
from brevitas_tpu_torch.graph.learned_round import (
    _capture_inputs,
    eligible_for_learned_round,
    freeze_weight_scale,
)
from brevitas_tpu_torch.nn.conv import full_float32_matmuls
from brevitas_tpu_torch.nn.quant_layer import QuantWBIOL

# GPFQ takes exactly the layers GPTQ and learned rounding take
eligible_for_gpfq = eligible_for_learned_round


def _gpfq_solve(W: torch.Tensor, X: torch.Tensor, scale, nmin,
                nmax) -> Tuple[torch.Tensor, torch.Tensor]:
    """The greedy path-following solve of a (K, O) weight on (M, K) inputs.
    Returns ``(Q, out_sqerr)``: the weight on the grid and ``||X (W - Q)||²``
    as the recursion accumulated it."""
    m, k = X.shape
    xt = X.t().contiguous()  # row t is input dimension t over the M rows
    norms = torch.sum(X * X, dim=0)
    live = norms > 0.0
    safe = torch.where(live, norms, torch.ones_like(norms))
    U = torch.zeros((m, W.shape[1]), dtype=W.dtype, device=W.device)
    Q = torch.zeros_like(W)
    for t in range(k):
        x_t, w_t = xt[t], W[t]
        arg = (x_t @ U) / safe[t] + w_t
        # a dead input dimension carries nothing: nearest rounding
        arg = torch.where(live[t], arg, w_t)
        q = torch.clamp(torch.round(arg / scale), nmin, nmax) * scale
        U = U + torch.outer(x_t, w_t - q)
        Q[t] = q
    return Q, torch.sum(U * U)


def apply_gpfq(model: nn.Module, calib_batches: Sequence, *, max_rows: Optional[int] = 4096,
               forward_fn: Optional[Callable] = None) -> Dict[str, Tuple[float, float]]:
    """GPFQ on every eligible quant layer, one after another in definition
    order (each layer's inputs captured with the layers before it already
    solved, as ``apply_gptq`` does). ``max_rows`` caps the calibration rows
    M of the (M, O) residual by taking every ``ceil(M / max_rows)``-th row,
    so every batch keeps rows; None keeps them all. Returns ``{path:
    (output_mse_nearest, output_mse_gpfq)}`` on those rows."""
    from brevitas_tpu_torch.graph.calibrate import _restore_modes, _snapshot_modes

    snap = _snapshot_modes(model)
    model.eval()
    report: Dict[str, Tuple[float, float]] = {}
    try:
        targets = [(p, l) for p, l in find_modules(model, QuantWBIOL) if eligible_for_gpfq(l)]
        for path, layer in targets:
            x = _capture_inputs(model, layer, calib_batches, forward_fn)
            # freeze the scale first: the greedy targets leave the weight's
            # magnitudes, and a scale from its statistics would move the
            # grid under the codes already chosen
            freeze_weight_scale(layer)
            mse_near = mse_gpfq = 0.0
            groups = getattr(layer, "groups", 1)
            with torch.no_grad(), full_float32_matmuls():
                for g, (W, X, write) in enumerate(_layer_matrix_problems(layer, x)):
                    if max_rows is not None and X.shape[0] > max_rows:
                        X = X[::-(-X.shape[0] // max_rows)]
                    scale, nmin, nmax = _scale_for_problem(layer, g, groups)
                    Wq, sqerr = _gpfq_solve(W, X, scale, nmin, nmax)
                    m, o = X.shape[0], W.shape[1]
                    E = X @ (W - torch.clamp(torch.round(W / scale), nmin, nmax) * scale)
                    mse_near += float(torch.sum(E * E) / m / o)
                    mse_gpfq += float(sqerr / m / o)
                    write(Wq)
            report[path] = (mse_near, mse_gpfq)
    finally:
        _restore_modes(snap)
    return report
