"""Integer-domain serving demo on one card (port of
``brevitas_tpu/examples/serve.py``).

Image mode: LFC INT8 with an input quantizer on every linear, calibrated on
one batch, converted to int8 serving twins; requests accumulate into
fixed-size batches (the tail padded). Prints per-batch latency and
sustained throughput as one JSON line.

Decode mode (``--decode``): greedy token generation on a QuantTransformer
(vocab 256, depth 2, 4 heads) calibrated under ``calibration_mode`` and
converted to integer twins, against an int8 KV cache or, with
``--kv-bits 4``, a nibble-packed one. Prints tokens/s and ms per step.

    python -m brevitas_tpu_torch.examples.serve --requests 512 --batch-size 128
    python -m brevitas_tpu_torch.examples.serve --decode --kv-bits 4

The device mesh (``--data-axis-size``) waits for the port of ``parallel/``.
The JAX package generates under one jitted ``lax.scan``; the port calls
``QuantTransformer.generate``, a Python loop of ``decode_step``. Decoding the fake-quant model (``--decode
--float``) waits for the fake-quant attention's own decode step.
"""

import argparse
import json
import time
from collections import deque
from typing import Iterator, Optional

import numpy as np
import torch

from brevitas_tpu_torch import config
from brevitas_tpu_torch import graph as G
from brevitas_tpu_torch.models import QuantTransformer, lfc
from brevitas_tpu_torch.nn import QuantLinear
from brevitas_tpu_torch.quant import presets
from brevitas_tpu_torch.quant.quantizers import ActQuantizer
from brevitas_tpu_torch.utils import eval_mode, resolve_device


class ContinuousBatcher:
    """Accumulates requests into fixed-size batches; flushes full batches
    at once and pads the final partial batch."""

    def __init__(self, batch_size: int, feature_shape):
        self.batch_size = batch_size
        self.feature_shape = tuple(feature_shape)
        self.queue: deque = deque()

    def submit(self, request: np.ndarray) -> None:
        self.queue.append(request)

    def batches(self) -> Iterator[np.ndarray]:
        while self.queue:
            take = min(self.batch_size, len(self.queue))
            batch = np.stack([self.queue.popleft() for _ in range(take)])
            if take < self.batch_size:
                pad = np.zeros((self.batch_size - take, *self.feature_shape),
                               batch.dtype)
                batch = np.concatenate([batch, pad])
            yield batch, take


def build_int8_model(generator: Optional[torch.Generator] = None, device="cuda"):
    """LFC INT8 with an input quantizer on every linear, so each converts to
    an int8 serving twin; calibrated on one batch, in eval mode."""
    device = resolve_device(device)
    act = presets.Int8ActPerTensorFloat.let(collect_stats_steps=1)
    model = lfc(weight_bit_width=8, act_bit_width=8, in_bit_width=8,
                dropout=0.0, generator=generator, device=device)
    for mod in model.modules():
        if isinstance(mod, QuantLinear):
            mod.input_quant = ActQuantizer(act).to(device)
    # calibrate on representative inputs (zeros would floor the scales at
    # scaling_min_val and saturate the int8 path)
    calib = np.random.default_rng(1).random((64, 28, 28, 1), dtype=np.float32)
    with torch.no_grad():
        model(torch.from_numpy(calib).to(device))
    return eval_mode(model)


def build_decode_model(args, device):
    """decode mode's model: QuantTransformer(vocab 256, --decode-dim, depth 2,
    4 heads) with random weights from seed 0 and K/V grids of --kv-bits,
    calibrated by two passes under ``calibration_mode``, in eval mode and
    converted to integer twins. Returns (model, prompt ids (B, 16), the
    cache length)."""
    max_len = args.decode_tokens + 8
    aq = presets.Int8ActPerTensorFloat.let(collect_stats_steps=2)
    uq = presets.Uint8ActPerTensorFloat.let(collect_stats_steps=2)
    model = QuantTransformer(vocab_size=256, dim=args.decode_dim, depth=2, num_heads=4,
                             max_len=max_len, act_quant=aq, uact_quant=uq,
                             generator=torch.Generator().manual_seed(0), device=device)
    if args.kv_bits:
        kvq = aq.let(bit_width=float(args.kv_bits))
        for blk in model.blocks:
            blk.attn.k_quant = ActQuantizer(kvq).to(device)
            blk.attn.v_quant = ActQuantizer(kvq).to(device)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 256, (args.decode_batch, 16))).to(device)
    with torch.no_grad(), G.calibration_mode(model):
        model(ids)
        model(torch.roll(ids, 1, dims=1))
    eval_mode(model)
    policy = config.INT4_KV_CACHE
    if args.kv_bits and args.kv_bits <= 4:
        # an explicit --kv-bits 4 asks for the packed cache whatever the
        # head dimension; the JAX package sets the policy for the process,
        # the port only for this conversion
        config.INT4_KV_CACHE = "1"
    try:
        G.convert_integer_inference(model)
    finally:
        config.INT4_KV_CACHE = policy
    return model, ids, max_len


def decode_demo(args):
    """Token-generation serving: greedy decoding on the quant transformer's
    integer twins with an int8 or, with ``--kv-bits 4``, an int4-packed KV
    cache. The best of three timed generations, after a warm-up. Returns
    the printed fields, the timed model, its first tokens (B, 1) and its
    cache length."""
    if not args.integer:
        raise NotImplementedError("decoding the fake-quant model is not ported; "
                                  "drop --float to decode the integer twins")
    device = resolve_device(args.device)
    model, ids, max_len = build_decode_model(args, device)
    tok0 = ids[:, :1]
    with torch.no_grad():
        model.generate(tok0, args.decode_tokens, max_len).cpu()  # warm-up
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            model.generate(tok0, args.decode_tokens, max_len).cpu()
            best = min(best, time.perf_counter() - t0)
    n_tok = args.decode_batch * args.decode_tokens
    out = {
        "mode": "decode",
        "tokens": n_tok,
        "tokens_per_sec": n_tok / best,
        "ms_per_token_step": best / args.decode_tokens * 1e3,
        "kv_bits": args.kv_bits,
        "kv_cache_bytes": sum(k.numel() + v.numel() for k, v in
                              model.init_decode_caches(args.decode_batch, max_len)),
        "integer_path": args.integer,
    }
    print(json.dumps(out))
    return out, model, tok0, max_len


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("brevitas_tpu_torch int8 serving demo")
    p.add_argument("--requests", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--float", dest="integer", action="store_false",
                   help="serve the fake-quant path instead of the int8 twins")
    p.add_argument("--decode", action="store_true",
                   help="token-generation serving on the quant transformer "
                        "instead of image classification")
    p.add_argument("--decode-tokens", type=int, default=128)
    p.add_argument("--decode-batch", type=int, default=32)
    p.add_argument("--decode-dim", type=int, default=128)
    p.add_argument("--kv-bits", type=int, default=0,
                   help="decode mode: quantize K/V at this width (<=4 packs "
                        "the cache two positions per byte)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.decode:
        return decode_demo(args)[0]

    device = resolve_device(args.device)
    model = build_int8_model(torch.Generator().manual_seed(0), device)
    if args.integer:
        G.convert_integer_inference(model)

    batcher = ContinuousBatcher(args.batch_size, (28, 28, 1))
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        batcher.submit(rng.random((28, 28, 1), dtype=np.float32))

    def infer(batch: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return model(torch.from_numpy(batch).to(device)).cpu().numpy()

    infer(np.zeros((args.batch_size, 28, 28, 1), np.float32))  # warm-up
    latencies = []
    served = 0
    t0 = time.perf_counter()
    for batch, n_real in batcher.batches():
        tb = time.perf_counter()
        infer(batch)[:n_real]
        latencies.append(time.perf_counter() - tb)
        served += n_real
    dt = time.perf_counter() - t0
    out = {
        "requests": served,
        "batches": len(latencies),
        "throughput_rps": served / dt,
        "p50_batch_ms": float(np.percentile(latencies, 50) * 1e3),
        "p99_batch_ms": float(np.percentile(latencies, 99) * 1e3),
        "devices": 1,
        "integer_path": args.integer,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
