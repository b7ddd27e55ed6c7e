"""LLM-style post-training quantization entry point (port of
``brevitas_tpu/examples/llm_ptq.py``).

Train a float character LM (the quant architecture with quantization off),
then run the LLM PTQ stack on it, in the JAX package's order:

  8-bit per-channel weights (``--mx``: MX groupwise INT weights, a
  power-of-two scale per ``--weight-group`` inputs) and per-tensor
  activation quantizers in every linear  ->  ``--rotate``: a Hadamard
  rotation of each block's v_proj -> out_proj  ->  SmoothQuant (or
  ``--awq``'s per-region search) on the norm -> linear regions found from
  a traced forward  ->  calibration, or dynamic per-token int8
  activations  ->  ``--gptq`` or ``--gpfq``  ->  integer serving
  (``graph.convert_integer_inference``)

and report bits per character of the float, the fake-quant and the served
model as one JSON line. ``--kv-bits`` quantizes the attention core too (q
and the probabilities at 8 bits, K and V at that width), which then serves
on ``int8_attention``; every converted linear serves on ``int8_matmul``
(``DynamicInt8InferenceLinear`` with ``--dynamic-act``). GPTQ and GPFQ
leave groupwise weights as they are, and their linears stay on the
fake-quant path when served. The port's line adds each stage's host
milliseconds (``stage_ms``, the card synchronized at each stage's end)
and the GPTQ and GPFQ row steps (``gptq_steps``, ``gpfq_steps``).

Run on the card:

    python -m brevitas_tpu_torch.examples.llm_ptq --arch llama --dim 1024 \\
        --depth 6 --heads 16 --gptq --dynamic-act --convert-int

``--device cpu`` runs anywhere.
"""

import argparse
import contextlib
import json
import math
import time
from typing import Optional

import torch
import torch.nn.functional as F

from brevitas_tpu_torch import graph as G
from brevitas_tpu_torch.examples.lm import _CORPUS, _batches
from brevitas_tpu_torch.models.llama import QuantLlama, llama_smoothquant_regions
from brevitas_tpu_torch.models.transformer import (
    QuantTransformer,
    transformer_smoothquant_regions,
)
from brevitas_tpu_torch.nn.attention import QuantMultiheadAttention
from brevitas_tpu_torch.nn.linear import QuantLinear
from brevitas_tpu_torch.quant import presets
from brevitas_tpu_torch.quant.quantizers import ActQuantizer, ParameterQuantizer
from brevitas_tpu_torch.utils import eval_mode, resolve_device

def smoothquant_regions(model, sample_tokens=None):
    """SmoothQuant migration sites: found from a traced forward when
    ``sample_tokens`` is given (``graph.autograph``: any architecture, and
    on the built-in models a superset of the hand lists, with the final
    norm -> head region); else the architecture's hand list."""
    if sample_tokens is not None:
        return G.extract_act_equalization_regions(model, sample_tokens)
    if isinstance(model, QuantLlama):
        return llama_smoothquant_regions(model)
    return transformer_smoothquant_regions(model)


def bits_per_char(model, xs, ys) -> float:
    """Mean cross-entropy of the next character, in bits."""
    total, n = 0.0, 0
    with torch.no_grad():
        for x, y in zip(xs, ys):
            logits = model(x, causal=True)
            total += float(F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                           y.reshape(-1), reduction="sum"))
            n += y.numel()
    return total / n / math.log(2.0)


def _train_float(model, xs, ys, lr):
    """Adam on the mean cross-entropy, one step a batch. torch forms Adam's
    bias correction in float64, optax in float32 (ROADMAP S8)."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    model.train()
    for x, y in zip(xs, ys):
        logits = model(x, causal=True)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), y.reshape(-1))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()


def use_dynamic_act_quant(model, bit_width: int = 8) -> int:
    """Swap every QuantLinear's input quantizer for dynamic per-token int8:
    no calibration state, a scale per token of every request (the LLM
    serving pattern). Returns the number swapped."""
    cfg = presets.Int8DynamicActPerTokenFloat.let(bit_width=float(bit_width))
    n = 0
    for _, mod in G.find_modules(model, QuantLinear):
        mod.input_quant = ActQuantizer(cfg).to(mod.weight.device)
        n += 1
    return n


class _Stages:
    """Host milliseconds of each stage, the card synchronized at its end."""

    def __init__(self, device: torch.device):
        self.device, self.ms = device, {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.ms[name] = (time.perf_counter() - t0) * 1e3


def _forward(m, b):
    return m(b, causal=True)


def quantize(model, args) -> None:
    """Put the PTQ quantizers in, in place: 8-bit (``--bit-width``)
    per-channel weights, or with ``--mx`` MX groupwise ones, and per-tensor
    input quantizers in every linear; with ``--kv-bits``, q and the
    probabilities at 8 bits and K/V at that width in every attention
    core."""
    device = next(model.parameters()).device
    if args.mx:
        wq = presets.MXInt8Weight.let(bit_width=float(args.bit_width),
                                      scaling_per_group=args.weight_group)
    else:
        wq = presets.Int8WeightPerChannelFloat.let(bit_width=float(args.bit_width))
    aq = presets.Int8ActPerTensorFloat.let(bit_width=float(args.bit_width),
                                           collect_stats_steps=max(args.calib_batches, 1))
    for _, mod in G.find_modules(model, QuantLinear):
        mod.weight_quant = ParameterQuantizer(wq, mod.weight.detach(), channel_axis=0).to(device)
        mod.input_quant = ActQuantizer(aq.let()).to(device)
    if args.kv_bits:
        kvq = aq.let(bit_width=float(args.kv_bits))
        uq = presets.Uint8ActPerTensorFloat.let(collect_stats_steps=max(args.calib_batches, 1))
        for _, mha in G.find_modules(model, QuantMultiheadAttention):
            mha.q_quant = ActQuantizer(aq.let()).to(device)
            mha.k_quant = ActQuantizer(kvq.let()).to(device)
            mha.v_quant = ActQuantizer(kvq.let()).to(device)
            mha.probs_quant = ActQuantizer(uq.let()).to(device)


def post_training(model, args, calib, stage=None):
    """With ``--rotate``, the Hadamard rotations; then the regions of a
    traced forward and AWQ (``--awq``) or SmoothQuant (unless
    ``--no-smoothquant``) on them; then calibration or, with
    ``--dynamic-act``, dynamic per-token input quantizers; then GPTQ
    (``--gptq``) or GPFQ (``--gpfq``). Returns the regions and the row
    steps of each, ``{"gptq": n, "gpfq": n}``."""
    stage = stage or _Stages(torch.device("cpu"))
    if args.rotate:
        with stage("rotate"):
            pairs, head_dim = G.transformer_rotation_pairs(model)
            G.apply_rotation(model, pairs, block_size=head_dim)
    with stage("awq" if args.awq else "smoothquant"):
        regions = smoothquant_regions(model, sample_tokens=calib[0][:1])
        if args.awq:
            G.apply_awq(model, regions, calib, forward_fn=_forward)
        elif not args.no_smoothquant:
            G.apply_act_equalization(model, regions, calib, alpha=args.smoothquant_alpha,
                                     forward_fn=_forward)
    with stage("calibration"):
        if args.dynamic_act:
            use_dynamic_act_quant(model, args.bit_width)
        else:
            with torch.no_grad(), G.calibration_mode(model):
                for b in calib:
                    _forward(model, b)
    steps = {"gptq": 0, "gpfq": 0}
    for name, solve in (("gptq", G.apply_gptq), ("gpfq", G.apply_gpfq)):
        if getattr(args, name):
            with stage(name):
                report = solve(model, calib, forward_fn=_forward)
            steps[name] = sum(G.get_module(model, p).reduce_size for p in report)
    return regions, steps


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("brevitas_tpu_torch LLM-style PTQ")
    p.add_argument("--arch", choices=("gpt", "llama"), default="gpt",
                   help="gpt = LayerNorm + ReLU MLP QuantTransformer; "
                        "llama = RMSNorm + RoPE + SwiGLU QuantLlama")
    p.add_argument("--train-steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--bit-width", type=int, default=8)
    p.add_argument("--calib-batches", type=int, default=4)
    p.add_argument("--no-smoothquant", action="store_true")
    p.add_argument("--smoothquant-alpha", type=float, default=0.5)
    p.add_argument("--awq", action="store_true",
                   help="AWQ's per-region alpha search instead of fixed-alpha SmoothQuant")
    p.add_argument("--gptq", action="store_true")
    p.add_argument("--gpfq", action="store_true",
                   help="GPFQ greedy path-following weight quantization (instead of --gptq)")
    p.add_argument("--dynamic-act", action="store_true",
                   help="per-token dynamic act quant instead of calibrated static scales")
    p.add_argument("--rotate", action="store_true",
                   help="QuaRot-style Hadamard rotation, by head, of each block's "
                        "v_proj -> out_proj before the regions are found")
    p.add_argument("--mx", action="store_true",
                   help="MX groupwise INT weights (power-of-two group scales) instead of "
                        "per-channel; GPTQ and GPFQ leave them as they are")
    p.add_argument("--weight-group", type=int, default=32,
                   help="the MX group size along the reduction axis")
    p.add_argument("--convert-int", action="store_true",
                   help="finish with integer-serving conversion")
    p.add_argument("--kv-bits", type=int, default=0,
                   help="quantize attention activations: q/probs at 8 bits, K/V at this "
                        "width; 0 leaves attention unquantized")
    p.add_argument("--text-file", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.gptq and args.gpfq:
        p.error("--gptq and --gpfq are alternatives; pick one")
    return args


def main(argv=None, keep: Optional[dict] = None) -> dict:
    """Run the PTQ flow and print its JSON line. ``keep``, a dict, receives
    the final model (``model``) and the test batches (``test_x``,
    ``test_y``) for a caller that goes on to inspect them."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    stage = _Stages(device)

    text = _CORPUS
    if args.text_file:
        with open(args.text_file) as f:
            text = f.read()
    xs, ys, vocab = _batches(text, args.seq_len, args.batch,
                             args.train_steps + args.calib_batches + 2, args.seed)
    xs, ys = xs.to(device), ys.to(device)
    train_x, train_y = xs[:args.train_steps], ys[:args.train_steps]
    calib = list(xs[args.train_steps:args.train_steps + args.calib_batches])
    test_x = xs[args.train_steps + args.calib_batches:]
    test_y = ys[args.train_steps + args.calib_batches:]

    # the float model: the quant architecture with quantization off
    float_kw = dict(vocab_size=vocab, dim=args.dim, depth=args.depth, num_heads=args.heads,
                    weight_quant=presets.NoneWeightQuant, act_quant=presets.NoneActQuant,
                    uact_quant=presets.NoneActQuant,
                    generator=torch.Generator().manual_seed(args.seed), device=device)
    if args.arch == "llama":
        model = QuantLlama(**float_kw)
    else:
        model = QuantTransformer(max_len=args.seq_len, **float_kw)
    with stage("train_float"):
        _train_float(model, train_x, train_y, args.lr)
    eval_mode(model)
    bpc_float = bits_per_char(model, test_x, test_y)

    quantize(model, args)
    regions, steps = post_training(model, args, calib, stage)
    eval_mode(model)
    bpc_quant = bits_per_char(model, test_x, test_y)

    bpc_served = None
    if args.convert_int:
        with stage("conversion"):
            G.convert_integer_inference(model)
        bpc_served = bits_per_char(model, test_x, test_y)

    result = {"arch": args.arch, "float_bpc": bpc_float, "quant_bpc": bpc_quant,
              "served_bpc": bpc_served, "bit_width": args.bit_width,
              "smoothquant": not args.no_smoothquant and not args.awq,
              "awq": args.awq, "gptq": args.gptq, "gpfq": args.gpfq,
              "dynamic_act": args.dynamic_act, "mx": args.mx, "rotate": args.rotate,
              "kv_bits": args.kv_bits, "vocab": vocab, "regions": len(regions),
              "gptq_steps": steps["gptq"], "gpfq_steps": steps["gpfq"], "stage_ms": stage.ms}
    print(json.dumps(result))
    if keep is not None:
        keep.update(model=model, test_x=test_x, test_y=test_y)
    return result


if __name__ == "__main__":
    main()
