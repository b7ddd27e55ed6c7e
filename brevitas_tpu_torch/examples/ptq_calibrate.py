"""Post-training-quantization calibration CLI, the flexml flow (port of
``brevitas_tpu/examples/ptq_calibrate.py``).

Float training (on scikit-learn's digits, upscaled to 28 x 28) -> BatchNorm
fusion -> cross-layer equalization -> quantization -> activation
calibration -> optional AdaRound, GPTQ or GPFQ -> bias correction ->
evaluation -> optional ONNX export (``--export {qcdq,qonnx,qop}`` to
``--export-path``, of the fake-quant model, before any conversion) ->
optional integer serving (``--convert-int``). Prints one JSON line with the
JAX CLI's keys (``exported``: the path written).

Run:  python -m brevitas_tpu_torch.examples.ptq_calibrate --model convnet \\
          --fixed-point --gptq --convert-int
      python -m brevitas_tpu_torch.examples.ptq_calibrate --export qcdq \\
          --export-path ptq_model.onnx
      python -m brevitas_tpu_torch.examples.ptq_calibrate --device cpu

The float models keep the JAX models' names, layouts and semantics:
flax's BatchNorm (``models.common.BatchNorm``: biased variance, momentum
0.99), the convs' XLA 'SAME' padding (at stride 2 on 28 x 28 it pads 0
before and 1 after; ``nn.conv.FloatConv2d``), flax's initializers, and
the convnet's head reads its input in the JAX model's (H, W, C) order.
The float training uses ``torch.optim.Adam`` where JAX uses optax's.
"""

import argparse
import itertools
import json
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from brevitas_tpu_torch import graph as G
from brevitas_tpu_torch.examples.bnn_pynq import load_digits_upscaled
from brevitas_tpu_torch.examples.llm_ptq import _Stages
from brevitas_tpu_torch.graph.equalize import sequential_regions
from brevitas_tpu_torch.graph.flexml import quantize_flexml
from brevitas_tpu_torch.models.common import BatchNorm
from brevitas_tpu_torch.nn.conv import FloatConv2d, lecun_normal_
from brevitas_tpu_torch.quant import presets
from brevitas_tpu_torch.utils import resolve_device


def _linear(in_f: int, out_f: int, generator) -> nn.Linear:
    """``nnx.Linear``'s init: a lecun-normal weight, a zero bias."""
    layer = nn.Linear(in_f, out_f)
    lecun_normal_(layer.weight, in_f, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


class FloatMLP(nn.Module):
    """Float MLP 784-128-64-10, the PTQ target without BatchNorm."""

    EQUALIZE = sequential_regions(["l1", "l2", "l3"])
    BN_PAIRS = ()

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.l1 = _linear(784, 128, generator)
        self.l2 = _linear(128, 64, generator)
        self.l3 = _linear(64, 10, generator)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(self.l1(x))
        x = torch.relu(self.l2(x))
        return self.l3(x)


class FloatConvNet(nn.Module):
    """Conv-BatchNorm-ReLU twice and a linear head: BatchNorm fusion before
    quantization."""

    EQUALIZE = ()
    BN_PAIRS = (("c1", "bn1"), ("c2", "bn2"))

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.c1 = FloatConv2d(1, 16, 3, stride=2, generator=generator)
        self.bn1 = BatchNorm(16, momentum=0.99, eps=1e-5, channel_axis=1)
        self.c2 = FloatConv2d(16, 32, 3, stride=2, generator=generator)
        self.bn2 = BatchNorm(32, momentum=0.99, eps=1e-5, channel_axis=1)
        self.head = _linear(7 * 7 * 32, 10, generator)
        self.eval()  # flax's use_running_average=True

    def forward(self, x):
        x = torch.relu(self.bn1(self.c1(x)))
        x = torch.relu(self.bn2(self.c2(x)))
        # the JAX model flattens its NHWC activations
        return self.head(x.movedim(1, -1).reshape(x.shape[0], -1))


MODELS = {"mlp": FloatMLP, "convnet": FloatConvNet}


def _device(model) -> torch.device:
    return next(itertools.chain(model.parameters(), model.buffers())).device


def _accuracy(model, x: np.ndarray, y: np.ndarray, batch: int = 256) -> float:
    device = _device(model)
    correct = torch.zeros((), dtype=torch.int64, device=device)
    with torch.no_grad():
        for i in range(0, len(x), batch):
            logits = model(torch.from_numpy(x[i:i + batch]).to(device))
            correct += (logits.argmax(-1) == torch.from_numpy(y[i:i + batch]).to(device)).sum()
    return int(correct) / len(x)


def _train_float(model, x: np.ndarray, y: np.ndarray, epochs: int, lr: float,
                 batch: int = 128, bn_stats: bool = False) -> None:
    """Adam on the softmax cross entropy, the batches in order; with
    ``bn_stats`` the BatchNorms normalize with (and update) batch statistics
    while training and go back to their running statistics after."""
    device = _device(model)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)] if bn_stats else []
    for m in bns:
        m.train()
    for _ in range(epochs):
        for i in range(0, len(x) - batch + 1, batch):
            xb = torch.from_numpy(x[i:i + batch]).to(device)
            yb = torch.from_numpy(y[i:i + batch]).to(device).long()
            loss = F.cross_entropy(model(xb), yb)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    for m in bns:
        m.eval()


def _calib_batches(x: np.ndarray, n: int, bs: int, device) -> list:
    """The JAX CLI's calibration windows: batch i starts at
    ``(i * bs) % max(len(x) - bs, 1)``."""
    out = []
    for i in range(n):
        lo = (i * bs) % max(len(x) - bs, 1)
        out.append(torch.from_numpy(x[lo:lo + bs]).to(device))
    return out


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("brevitas_tpu_torch PTQ calibration")
    p.add_argument("--model", default="mlp", choices=list(MODELS))
    p.add_argument("--train-epochs", type=int, default=5)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--calib-batches", type=int, default=4)
    p.add_argument("--bias-correct-batches", type=int, default=2)
    p.add_argument("--learned-round", action="store_true",
                   help="AdaRound learned weight rounding between calibration and bias "
                        "correction")
    p.add_argument("--learned-round-steps", type=int, default=1000)
    p.add_argument("--gptq", action="store_true",
                   help="GPTQ Hessian-based weight quantization between calibration and "
                        "bias correction")
    p.add_argument("--gpfq", action="store_true",
                   help="GPFQ greedy path-following weight quantization (alternative to "
                        "--gptq)")
    p.add_argument("--equalize-iterations", type=int, default=10)
    p.add_argument("--no-equalize", action="store_true")
    p.add_argument("--fixed-point", action="store_true",
                   help="flexml 8-bit power-of-two quantizers instead of float-scale int8")
    p.add_argument("--per-channel", action="store_true",
                   help="per-output-channel weight scales (float-scale mode)")
    p.add_argument("--bit-width", type=int, default=8)
    p.add_argument("--convert-int", action="store_true",
                   help="also convert to integer-serving twins and re-eval")
    p.add_argument("--export", default=None, choices=["qcdq", "qonnx", "qop"],
                   help="write the PTQ model as ONNX in this dialect to --export-path")
    p.add_argument("--export-path", default="ptq_model.onnx")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.gptq and args.gpfq:
        p.error("--gptq and --gpfq are alternatives; pick one")
    return args


def main(argv=None, keep: Optional[dict] = None) -> dict:
    """Run the PTQ flow and print its JSON line. ``keep``, a dict, receives
    the model, the test set, each stage's host milliseconds (``stage_ms``,
    the card synchronized at each stage's end) and AdaRound's per-layer
    output MSE."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    stage = _Stages(device)
    x_train, y_train = load_digits_upscaled("train")
    x_test, y_test = load_digits_upscaled("test")

    with stage("train_float"):
        model = MODELS[args.model](generator=torch.Generator().manual_seed(args.seed)).to(device)
        _train_float(model, x_train, y_train, args.train_epochs, args.lr, args.batch_size,
                     bn_stats=args.model == "convnet")
    float_acc = _accuracy(model, x_test, y_test)

    # BatchNorm fusion and cross-layer equalization, found from one traced
    # forward (graph/autograph.py)
    with stage("preprocess"):
        G.preprocess_flexml(model, torch.from_numpy(x_test[:1]).to(device),
                            equalize_regions=(() if args.no_equalize else None),
                            equalize_iterations=args.equalize_iterations)
    pre_acc = _accuracy(model, x_test, y_test)

    calib_steps = max(args.calib_batches, 1)
    with stage("quantize"):
        if args.fixed_point:
            quantize_flexml(model, collect_stats_steps=calib_steps)
        else:
            wq = (presets.Int8WeightPerChannelFloat if args.per_channel
                  else presets.Int8WeightPerTensorFloat)
            G.quantize(model, weight_quant=wq.let(bit_width=args.bit_width),
                       act_quant=presets.Int8ActPerTensorFloat.let(
                           bit_width=args.bit_width, collect_stats_steps=calib_steps))

    bs = args.batch_size
    with stage("calibrate"), torch.no_grad():
        with G.calibration_mode(model):
            for b in _calib_batches(x_train, args.calib_batches, bs, device):
                model(b)
    model.eval()
    learned_round = {}
    if args.learned_round or args.gptq or args.gpfq:
        calib = _calib_batches(x_train, args.calib_batches, bs, device)
        if args.gptq:
            with stage("gptq"):
                G.apply_gptq(model, calib)
        if args.gpfq:
            with stage("gpfq"):
                G.apply_gpfq(model, calib)
        if args.learned_round:
            with stage("learned_round"):
                learned_round = G.apply_learned_round(model, calib,
                                                      steps=args.learned_round_steps)
    with stage("bias_correction"), torch.no_grad():
        with G.bias_correction_mode(model):
            for b in _calib_batches(x_train, args.bias_correct_batches, bs, device):
                model(b)

    ptq_acc = _accuracy(model, x_test, y_test)
    result = {"model": args.model, "float_acc": float_acc, "preprocessed_acc": pre_acc,
              "ptq_acc": ptq_acc, "bit_width": args.bit_width,
              "fixed_point": args.fixed_point, "learned_round": args.learned_round,
              "gptq": args.gptq, "gpfq": args.gpfq}
    if args.export:
        from brevitas_tpu_torch import export as E

        fn = {"qcdq": E.export_onnx_qcdq, "qonnx": E.export_qonnx,
              "qop": E.export_onnx_qop}[args.export]
        with stage("export"):
            fn(model, torch.from_numpy(x_test[:1]).to(device), args.export_path)
        result["exported"] = args.export_path
    if args.convert_int:
        with stage("convert_int"):
            G.convert_integer_inference(model)
        result["int_acc"] = _accuracy(model, x_test, y_test)
    print(json.dumps(result))
    if keep is not None:
        keep.update(model=model, x_test=x_test, y_test=y_test, stage_ms=stage.ms,
                    learned_round=learned_round)
    return result


if __name__ == "__main__":
    main()
