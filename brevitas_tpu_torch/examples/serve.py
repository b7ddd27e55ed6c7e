"""Integer-domain serving demo: continuous batching of image requests on
one card (port of ``brevitas_tpu/examples/serve.py``, image mode).

LFC INT8 with an input quantizer on every linear, calibrated on one batch,
converted to int8 serving twins; requests accumulate into fixed-size batches
(the tail padded). Prints per-batch latency and sustained throughput as one
JSON line.

    python -m brevitas_tpu_torch.examples.serve --requests 512 --batch-size 128

The device mesh (``--data-axis-size``) waits for the port of ``parallel/``,
and ``--decode`` for the Llama slice.
"""

import argparse
import json
import time
from collections import deque
from typing import Iterator, Optional

import numpy as np
import torch

from brevitas_tpu_torch import graph as G
from brevitas_tpu_torch.models import lfc
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


def main(argv=None):
    p = argparse.ArgumentParser("brevitas_tpu_torch int8 serving demo")
    p.add_argument("--requests", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--float", dest="integer", action="store_false",
                   help="serve the fake-quant path instead of the int8 twins")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

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
