"""Quantized Llama-style decoder: RMSNorm, RoPE, SwiGLU (port of
``brevitas_tpu/models/llama.py``).

A pre-norm decoder: rotary position embeddings are applied to Q and K
before their activation quantizers, and the SwiGLU MLP quantizes all three
projections. Residual adds run through shared scale-aligning quantizers.
Module and parameter names follow the JAX package, so
``interop.jax_state`` maps its state across by path. After
``graph.convert_integer_inference`` the model serves a causal prefill
(``int8_attention``) and decodes against an int8 or an int4-packed KV
cache (``int4kv_decode_attention``).
"""

from typing import Optional

import torch
from torch import nn

from brevitas_tpu_torch.models.common import RMSNorm
from brevitas_tpu_torch.nn import QuantEmbedding, QuantIdentity, QuantLinear
from brevitas_tpu_torch.nn.attention import QuantMultiheadAttention
from brevitas_tpu_torch.quant.config import QuantConfig
from brevitas_tpu_torch.quant.presets import (
    Int8ActPerTensorFloat,
    Int8WeightPerTensorFloat,
    Uint8ActPerTensorFloat,
)
from brevitas_tpu_torch.utils import resolve_device


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), formed in float64 and rounded once, so that the card
    and a CPU copy agree."""
    x64 = x.double()
    return (x64 * torch.sigmoid(x64)).to(x.dtype)


class QuantSwiGLU(nn.Module):
    """gate/up/down projections with silu(gate) * up, all quantized; the
    product re-quantizes at the down projection's input quantizer."""

    def __init__(self, dim: int, hidden: int, *, weight_quant: QuantConfig,
                 act_quant: QuantConfig, generator: Optional[torch.Generator] = None):
        super().__init__()

        def lin(n_in, n_out):
            return QuantLinear(n_in, n_out, use_bias=False, weight_quant=weight_quant,
                               input_quant=act_quant, generator=generator)

        self.gate_proj = lin(dim, hidden)
        self.up_proj = lin(dim, hidden)
        self.down_proj = lin(hidden, dim)

    def forward(self, x):
        return self.down_proj(silu(self.gate_proj(x)) * self.up_proj(x))


class QuantLlamaBlock(nn.Module):
    """RMSNorm -> rotary QuantMHA -> residual; RMSNorm -> QuantSwiGLU ->
    residual."""

    def __init__(self, dim: int, num_heads: int, hidden: int, *,
                 weight_quant: QuantConfig, act_quant: QuantConfig,
                 uact_quant: QuantConfig, rope_theta: float,
                 num_kv_heads: Optional[int] = None,
                 kv_quant: Optional[QuantConfig] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kv_quant = kv_quant if kv_quant is not None else act_quant
        self.attn_norm = RMSNorm(dim)
        self.attn = QuantMultiheadAttention(
            dim, num_heads, use_bias=False, weight_quant=weight_quant,
            in_proj_input_quant=act_quant, q_quant=act_quant, k_quant=kv_quant,
            v_quant=kv_quant, attn_probs_quant=uact_quant,
            out_proj_input_quant=act_quant, use_rope=True, rope_theta=rope_theta,
            num_kv_heads=num_kv_heads, generator=generator)
        self.res1 = QuantIdentity(act_quant)
        self.mlp_norm = RMSNorm(dim)
        self.mlp = QuantSwiGLU(dim, hidden, weight_quant=weight_quant,
                               act_quant=act_quant, generator=generator)
        self.res2 = QuantIdentity(act_quant)

    def forward(self, x, causal: bool = True):
        h = self.attn(self.attn_norm(x), causal=causal)
        x = self.res1(x) + self.res1(h)
        h = self.mlp(self.mlp_norm(x))
        return self.res2(x) + self.res2(h)

    def decode_step(self, x_t, k_cache, v_cache, pos: int):
        h, k_cache, v_cache = self.attn.decode_step(self.attn_norm(x_t), k_cache,
                                                    v_cache, pos)
        x = self.res1(x_t) + self.res1(h)
        h = self.mlp(self.mlp_norm(x))
        return self.res2(x) + self.res2(h), k_cache, v_cache


class QuantLlama(nn.Module):
    """Decoder-only Llama-style LM. Positions enter through RoPE, so the
    decode cache length is not bounded by a trained table."""

    def __init__(self, *, vocab_size: int = 1000, dim: int = 256, depth: int = 4,
                 num_heads: int = 4, num_kv_heads: Optional[int] = None,
                 hidden: Optional[int] = None, rope_theta: float = 10000.0,
                 bit_width: int = 8, weight_quant: Optional[QuantConfig] = None,
                 act_quant: Optional[QuantConfig] = None,
                 uact_quant: Optional[QuantConfig] = None,
                 kv_bit_width: Optional[int] = None,
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
        # kv_bit_width <= 4 trains a nibble-sized K/V grid, and the serving
        # twin then packs its decode cache two positions per byte
        kvq = aq.let(bit_width=float(kv_bit_width)) if kv_bit_width is not None else None
        if hidden is None:  # Llama-2 sizing: 8/3 * dim up to a multiple of 32
            hidden = -(-(8 * dim // 3) // 32) * 32
        self.embed = QuantEmbedding(vocab_size, dim, weight_quant=wq, generator=g)
        self.blocks = nn.ModuleList([
            QuantLlamaBlock(dim, num_heads, hidden, weight_quant=wq, act_quant=aq,
                            uact_quant=uq, rope_theta=rope_theta,
                            num_kv_heads=num_kv_heads, kv_quant=kvq, generator=g)
            for _ in range(depth)])
        if kv_bit_width is not None and kv_bit_width <= 4:
            for blk in self.blocks:
                blk.attn.kv_pack_requested = True
        self.final_norm = RMSNorm(dim)
        self.head = QuantLinear(dim, vocab_size, use_bias=False, weight_quant=wq,
                                input_quant=aq, generator=g)
        self.to(device)

    def forward(self, ids: torch.Tensor, causal: bool = True) -> torch.Tensor:
        x = self.embed(ids)
        for blk in self.blocks:
            x = blk(x, causal=causal)
        return self.head(self.final_norm(x))

    # -- incremental decoding (on the converted model) -------------------------

    def init_decode_caches(self, batch: int, max_len: int):
        return [blk.attn.init_decode_cache(batch, max_len) for blk in self.blocks]

    def decode_step(self, id_t: torch.Tensor, caches, pos: int):
        """One token per sequence, (B, 1) ids, at position ``pos``; the
        caches are written in place and returned."""
        x = self.embed(id_t)
        new_caches = []
        for blk, (kc, vc) in zip(self.blocks, caches):
            x, kc, vc = blk.decode_step(x, kc, vc, pos)
            new_caches.append((kc, vc))
        return self.head(self.final_norm(x)), new_caches

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


def llama_smoothquant_regions(model: QuantLlama) -> list:
    """SmoothQuant migration sites: each block's attention RMSNorm feeds
    q/k/v; the MLP RMSNorm feeds both the gate and the up projection (they
    share the input, so one scale migrates into both and silu(gate) * up
    stays consistent). The RMSNorm's elementwise scale absorbs 1/s."""
    regions = []
    for i in range(len(model.blocks)):
        b = f"blocks.{i}"
        regions.append(([f"{b}.attn_norm"], [f"{b}.attn.q_proj", f"{b}.attn.k_proj",
                                             f"{b}.attn.v_proj"]))
        regions.append(([f"{b}.mlp_norm"], [f"{b}.mlp.gate_proj", f"{b}.mlp.up_proj"]))
    return regions


def quant_llama_tiny(bit_width: int = 8, **kw) -> QuantLlama:
    kw.setdefault("dim", 128)
    kw.setdefault("depth", 2)
    kw.setdefault("num_heads", 4)
    return QuantLlama(bit_width=bit_width, **kw)
