"""Rotation-based outlier smoothing, QuaRot-style (port of
``brevitas_tpu/graph/rotate.py``).

A random orthogonal Hadamard rotation R is fused into a linearly connected
(source, sink) weight pair: the source's output channels (and its bias)
rotate by R, the sink's input channels by Rᵀ. The float function is kept,
while the activation between the two spreads its outliers over the
channels, which a per-tensor quantizer handles far better. In a
transformer the exact site is each block's v_proj -> out_proj: attention is
linear in V within a head, so a rotation block-diagonal by head commutes
through it.

The port's weights are torch's (out, in), the JAX package's (in, out), so
each product here is the transpose of the JAX package's. The JAX package
draws R's column signs with ``jax.random.rademacher`` from ``PRNGKey(0)``
folded with the pair index; the port draws them from a ``torch.Generator``
seeded with the pair index. The two sign sets differ (ROADMAP S17); the
parity tests give the port the JAX package's matrices.
"""

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from brevitas_tpu_torch.graph.base import get_module
from brevitas_tpu_torch.nn.conv import full_float32_matmuls


def hadamard_matrix(n: int) -> torch.Tensor:
    """The orthonormal Sylvester-Hadamard matrix of size n, a power of two."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"Hadamard size must be a power of two, got {n}")
    h = torch.ones((1, 1))
    while h.shape[0] < n:
        h = torch.cat([torch.cat([h, h], 1), torch.cat([h, -h], 1)], 0)
    return h / math.sqrt(n)


def random_hadamard(n: int, generator: torch.Generator) -> torch.Tensor:
    """A Hadamard matrix with random column signs, still orthogonal
    ((HD)ᵀ(HD) = D Hᵀ H D = I); the signs come from ``generator``."""
    signs = torch.randint(0, 2, (n,), generator=generator).to(torch.float32) * 2.0 - 1.0
    return hadamard_matrix(n) * signs[None, :]


def apply_rotation(model: nn.Module, pairs: Sequence[Tuple[str, str]], *,
                   block_size: Optional[int] = None) -> List[torch.Tensor]:
    """Rotate each (source, sink) linear pair in place and return the block
    matrices used, one a pair. ``block_size`` makes R block-diagonal with
    blocks of that size (the head dimension where attention lies between
    source and sink); by default one block spans the channels. Pair i's
    signs come from a generator seeded with i."""
    used = []
    with torch.no_grad(), full_float32_matmuls():
        for i, (src_path, sink_path) in enumerate(pairs):
            src, sink = get_module(model, src_path), get_module(model, sink_path)
            w_src, w_sink = src.weight, sink.weight  # (n, in), (out, n)
            n = w_src.shape[0]
            if w_sink.shape[1] != n:
                raise ValueError(f"{src_path}->{sink_path}: source out dim {n} != sink in "
                                 f"dim {w_sink.shape[1]}")
            bs = block_size or n
            if n % bs:
                raise ValueError(f"rotation dim {n} not divisible by block {bs}")
            r = random_hadamard(bs, torch.Generator().manual_seed(i)).to(w_src.device)
            used.append(r)
            # source rows (its output channels) by R: row block b becomes Rᵀ W_b
            blocks = w_src.reshape(n // bs, bs, -1)
            w_src.copy_((r.t() @ blocks).reshape(w_src.shape))
            if getattr(src, "bias", None) is not None:
                src.bias.copy_((src.bias.reshape(n // bs, bs) @ r).reshape(-1))
            # sink columns (its input channels) by Rᵀ
            w_sink.copy_((w_sink.reshape(-1, n // bs, bs) @ r).reshape(w_sink.shape))
    return used


def transformer_rotation_pairs(model) -> Tuple[List[Tuple[str, str]], int]:
    """The exact rotation sites of the quant transformer (and QuantLlama):
    each block's v_proj -> out_proj, block-diagonal by attention head.
    Returns (pairs, block size)."""
    pairs = [(f"blocks.{i}.attn.v_proj", f"blocks.{i}.attn.out_proj")
             for i in range(len(model.blocks))]
    return pairs, model.blocks[0].attn.head_dim
