"""Quantized multi-head attention (port of ``brevitas_tpu/nn/attention.py``;
ported: ``apply_rope`` and the fake-quant forward of QuantMultiheadAttention).

Quantized Q/K/V/O projections, activation quantizers on Q, K and V before
the score product, an unsigned quantizer on the softmax probabilities and
one on the out-projection's input, so that the integer serving twin
(``graph.convert_int.Int8InferenceAttention``) runs QKᵀ and PV on integer
codes. Layout (B, T, E); heads (B, T, H, D).

Not ported: cross-attention (a separate ``kv`` input), arbitrary masks and
the fake-quant layer's own KV-cache decode; decode runs on the converted
model.
"""

import functools
import math
from typing import Optional

import torch
from torch import nn

from brevitas_tpu_torch.nn.linear import QuantLinear
from brevitas_tpu_torch.ops import MASKED_SCORE, causal_mask, softmax
from brevitas_tpu_torch.quant.config import QuantConfig
from brevitas_tpu_torch.quant.presets import (
    Int8ActPerTensorFloat,
    Int8WeightPerTensorFloat,
    NoneActQuant,
    Uint8ActPerTensorFloat,
)
from brevitas_tpu_torch.quant.quantizers import ActQuantizer


@functools.lru_cache(maxsize=None)
def _inv_freq(d: int, theta: float, device: torch.device) -> torch.Tensor:
    exponent = (torch.arange(0, d, 2, dtype=torch.float32) / d).double()
    inv = 1.0 / (theta ** exponent).float().double()
    return inv.float().to(device)


def rope_tables(positions: torch.Tensor, d: int, theta: float = 10000.0):
    """(cos, sin) of shape (T, D/2) for rotary embeddings at ``positions``.

    The frequencies and angles are rounded to float32 at the JAX package's
    steps (the angle's rounding moves cos/sin far more than an ulp at long
    positions); the power, cosines and sines are formed in float64 and
    rounded once, so the tables are the same on the CPU and the card."""
    ang = positions.reshape(-1, 1).float() * _inv_freq(d, theta, positions.device)
    ang = ang.double()
    return torch.cos(ang).float(), torch.sin(ang).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding, Llama's rotate-half convention, on
    (B, T, H, D) with ``positions`` (T,). Applied to Q and K before their
    quantizers, so the serving codes are codes of the rotated values."""
    d = x.shape[-1]
    cos, sin = rope_tables(positions, d, theta)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class QuantMultiheadAttention(nn.Module):

    def __init__(self, embed_dim: int, num_heads: int, *,
                 use_bias: bool = True,
                 weight_quant: Optional[QuantConfig] = Int8WeightPerTensorFloat,
                 in_proj_input_quant: Optional[QuantConfig] = Int8ActPerTensorFloat,
                 q_quant: Optional[QuantConfig] = Int8ActPerTensorFloat,
                 k_quant: Optional[QuantConfig] = Int8ActPerTensorFloat,
                 v_quant: Optional[QuantConfig] = Int8ActPerTensorFloat,
                 attn_probs_quant: Optional[QuantConfig] = Uint8ActPerTensorFloat,
                 out_proj_input_quant: Optional[QuantConfig] = Int8ActPerTensorFloat,
                 use_rope: bool = False, rope_theta: float = 10000.0,
                 num_kv_heads: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be a multiple of num_heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.use_rope = use_rope
        self.rope_theta = rope_theta
        # grouped-query attention: K/V project to fewer heads, each serving
        # num_heads / num_kv_heads query heads
        self.num_kv_heads = num_kv_heads or num_heads
        if num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")
        kv_dim = self.num_kv_heads * self.head_dim

        def lin(out_dim, input_quant):
            return QuantLinear(embed_dim, out_dim, use_bias=use_bias,
                               weight_quant=weight_quant, input_quant=input_quant,
                               generator=generator)

        self.q_proj = lin(embed_dim, in_proj_input_quant)
        self.k_proj = lin(kv_dim, in_proj_input_quant)
        self.v_proj = lin(kv_dim, in_proj_input_quant)
        self.out_proj = lin(embed_dim, out_proj_input_quant)
        self.q_quant = ActQuantizer(q_quant or NoneActQuant)
        self.k_quant = ActQuantizer(k_quant or NoneActQuant)
        self.v_quant = ActQuantizer(v_quant or NoneActQuant)
        self.probs_quant = ActQuantizer(attn_probs_quant or NoneActQuant)
        # set by QuantLlama(kv_bit_width <= 4): the serving twin packs its
        # decode cache even below the head-dim boundary of config.py
        self.kv_pack_requested = False

    def _split_heads(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.reshape(b, t, -1, self.head_dim)

    def _expand_kv(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, KVH, D) -> (B, T, H, D): each KV head repeats for its query
        group, after the K/V quantizers (repeating quantized values is
        exact)."""
        groups = self.num_heads // self.num_kv_heads
        return x.repeat_interleave(groups, dim=2) if groups > 1 else x

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        q_f = self._split_heads(self.q_proj(x))
        k_f = self._split_heads(self.k_proj(x))
        if self.use_rope:
            positions = torch.arange(x.shape[1], device=q_f.device)
            q_f = apply_rope(q_f, positions, self.rope_theta)
            k_f = apply_rope(k_f, positions, self.rope_theta)
        q = self.q_quant(q_f).value
        k = self._expand_kv(self.k_quant(k_f).value)
        v = self._expand_kv(self._split_heads(self.v_quant(self.v_proj(x)).value))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(self.head_dim))
        if causal:
            tq, tk = scores.shape[-2], scores.shape[-1]
            scores = torch.where(causal_mask(tq, tk, scores.device), scores,
                                 MASKED_SCORE)
        probs = self.probs_quant(softmax(scores)).value.to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).to(x.dtype)
        return self.out_proj(out.reshape(*x.shape[:2], self.embed_dim))
