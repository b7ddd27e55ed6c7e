"""Quantized transformer (port of ``brevitas_tpu/models/transformer.py``;
ported: the block, the model with its learned position table and greedy
decoding, ``transformer_smoothquant_regions`` and ``quant_transformer_tiny``).

Pre-norm blocks: LayerNorm -> QuantMHA -> residual, LayerNorm -> QuantLinear
-> QuantReLU -> QuantLinear -> residual, with the residual adds through
shared scale-aligning quantizers. Embedding and output head are quantized.
Module and parameter names follow the JAX package, so ``interop.jax_state``
maps its state across by path. Decoding runs on the model after
``graph.convert_integer_inference``, against an int8 or an int4-packed KV
cache.
"""

from typing import Optional

import torch
from torch import nn

from brevitas_tpu_torch.models.common import LayerNorm
from brevitas_tpu_torch.nn import (
    QuantEmbedding,
    QuantIdentity,
    QuantLinear,
    QuantMultiheadAttention,
    QuantReLU,
)
from brevitas_tpu_torch.quant.config import QuantConfig
from brevitas_tpu_torch.quant.presets import (
    Int8ActPerTensorFloat,
    Int8WeightPerTensorFloat,
    Uint8ActPerTensorFloat,
)
from brevitas_tpu_torch.utils import resolve_device


class QuantTransformerBlock(nn.Module):

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4, *,
                 weight_quant: QuantConfig, act_quant: QuantConfig,
                 uact_quant: QuantConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ln1 = LayerNorm(dim)
        self.attn = QuantMultiheadAttention(
            dim, num_heads, weight_quant=weight_quant,
            in_proj_input_quant=act_quant, q_quant=act_quant, k_quant=act_quant,
            v_quant=act_quant, attn_probs_quant=uact_quant,
            out_proj_input_quant=act_quant, generator=generator)
        self.res1 = QuantIdentity(act_quant)
        self.ln2 = LayerNorm(dim)
        self.fc1 = QuantLinear(dim, dim * mlp_ratio, weight_quant=weight_quant,
                               input_quant=act_quant, generator=generator)
        self.act = QuantReLU(uact_quant)
        self.fc2 = QuantLinear(dim * mlp_ratio, dim, weight_quant=weight_quant,
                               input_quant=act_quant, generator=generator)
        self.res2 = QuantIdentity(act_quant)

    def forward(self, x, causal: bool = False):
        h = self.attn(self.ln1(x), causal=causal)
        x = self.res1(x) + self.res1(h)
        h = self.fc2(self.act(self.fc1(self.ln2(x))))
        return self.res2(x) + self.res2(h)

    def decode_step(self, x_t, k_cache, v_cache, pos: int):
        h, k_cache, v_cache = self.attn.decode_step(self.ln1(x_t), k_cache, v_cache, pos)
        x = self.res1(x_t) + self.res1(h)
        h = self.fc2(self.act(self.fc1(self.ln2(x))))
        return self.res2(x) + self.res2(h), k_cache, v_cache


class QuantTransformer(nn.Module):
    """Token embedding plus a learned position table, pre-norm blocks, a
    final LayerNorm and a quantized head. ``weight_quant``, ``act_quant``
    and ``uact_quant`` override the default ``bit_width`` quantizers."""

    def __init__(self, *, vocab_size: int = 1000, dim: int = 256, depth: int = 4,
                 num_heads: int = 4, max_len: int = 512, bit_width: int = 8,
                 weight_quant: Optional[QuantConfig] = None,
                 act_quant: Optional[QuantConfig] = None,
                 uact_quant: Optional[QuantConfig] = None,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        wq = weight_quant if weight_quant is not None \
            else Int8WeightPerTensorFloat.let(bit_width=float(bit_width))
        aq = act_quant if act_quant is not None \
            else Int8ActPerTensorFloat.let(bit_width=float(bit_width))
        uq = uact_quant if uact_quant is not None \
            else Uint8ActPerTensorFloat.let(bit_width=float(bit_width))
        self.embed = QuantEmbedding(vocab_size, dim, weight_quant=wq, generator=g)
        self.pos = nn.Parameter(0.02 * torch.randn((max_len, dim), generator=g))
        self.blocks = nn.ModuleList([
            QuantTransformerBlock(dim, num_heads, weight_quant=wq, act_quant=aq,
                                  uact_quant=uq, generator=g)
            for _ in range(depth)])
        self.ln_f = LayerNorm(dim)
        self.head = QuantLinear(dim, vocab_size, use_bias=False, weight_quant=wq,
                                input_quant=aq, generator=g)
        self.to(device)

    def forward(self, ids: torch.Tensor, causal: bool = True) -> torch.Tensor:
        x = self.embed(ids) + self.pos[: ids.shape[1]]
        for blk in self.blocks:
            x = blk(x, causal=causal)
        return self.head(self.ln_f(x))

    # -- incremental decoding (on the converted model) -------------------------

    def init_decode_caches(self, batch: int, max_len: int):
        """Per-block (k_cache, v_cache) pairs of int8 codes, or nibble-packed
        codes when the attention twin packs its cache."""
        return [blk.attn.init_decode_cache(batch, max_len) for blk in self.blocks]

    def decode_step(self, id_t: torch.Tensor, caches, pos: int):
        """One token per sequence, (B, 1) ids, at position ``pos``; the
        caches are written in place and returned with the logits (B, 1, V)."""
        x = self.embed(id_t) + self.pos[pos:pos + 1]
        new_caches = []
        for blk, (kc, vc) in zip(self.blocks, caches):
            x, kc, vc = blk.decode_step(x, kc, vc, pos)
            new_caches.append((kc, vc))
        return self.head(self.ln_f(x)), new_caches

    def generate(self, prompt_ids: torch.Tensor, num_tokens: int,
                 max_len: Optional[int] = None) -> torch.Tensor:
        """Greedy decoding: the prompt (B, T0) token by token, then
        ``num_tokens`` new tokens (B, num_tokens)."""
        b, t0 = prompt_ids.shape
        caches = self.init_decode_caches(b, max_len or (t0 + num_tokens))
        logits = None
        for i in range(t0):
            logits, caches = self.decode_step(prompt_ids[:, i:i + 1], caches, i)
        outs = []
        tok = torch.argmax(logits, dim=-1)
        for i in range(num_tokens):
            outs.append(tok[:, 0])
            if i + 1 == num_tokens:
                break
            logits, caches = self.decode_step(tok, caches, t0 + i)
            tok = torch.argmax(logits, dim=-1)
        return torch.stack(outs, dim=1)


def transformer_smoothquant_regions(model) -> list:
    """The SmoothQuant migration sites of a model with ``blocks`` of
    QuantTransformerBlock: each block's ln1 feeds the attention's input
    projections, ln2 the MLP's first linear; the LayerNorm's elementwise
    affine absorbs 1/s."""
    regions = []
    for i in range(len(model.blocks)):
        b = f"blocks.{i}"
        regions.append(([f"{b}.ln1"], [f"{b}.attn.q_proj", f"{b}.attn.k_proj",
                                       f"{b}.attn.v_proj"]))
        regions.append(([f"{b}.ln2"], [f"{b}.fc1"]))
    return regions


def quant_transformer_tiny(bit_width: int = 8, **kw) -> QuantTransformer:
    kw.setdefault("dim", 128)
    kw.setdefault("depth", 2)
    kw.setdefault("num_heads", 4)
    return QuantTransformer(bit_width=bit_width, **kw)
