"""bnn_pynq-style QAT trainer CLI (port of ``brevitas_tpu/examples/bnn_pynq.py``).

Trains the FC family (TFC, SFC, LFC) with the square hinge loss, Adam and
weight clipping to [-1, 1] after every step, on MNIST read from idx files
under ``--data-dir`` or on synthetic data made from a numpy seed. On the
card every per-tensor quantizer of the network runs the ``fake_quant``
CUDA kernel, forward and backward.

Run:  python -m brevitas_tpu_torch.examples.bnn_pynq --network LFC_4W4A \\
        --dataset synthetic --epochs 1

Ported: the 3- to 8-bit networks (``LFC_4W4A``, ``LFC_8W8A``, ...), MNIST
and synthetic data, the per-step loop and evaluation. Left out, each with
an error that says so: the 1- and 2-bit networks (binary quantizers), CNV
and CIFAR-10 (conv layers), ``--dataset digits`` (needs ``sklearn``),
``--cfg`` (every shipped ``.ini`` is 1-2 bit), ``--scan``,
``--native-loader``, ``--resume`` and checkpoint saving.
"""

import argparse
import gzip
import json
import os
import struct
import time
from typing import Iterator, Tuple

import numpy as np
import torch

from brevitas_tpu_torch.models import lfc, sfc, tfc
from brevitas_tpu_torch.utils import resolve_device

NETWORKS = {"TFC": (tfc, "fc"), "SFC": (sfc, "fc"), "LFC": (lfc, "fc")}
# bit widths below this need the binary quantizers, not ported yet
MIN_BITS = 3


def parse_network(name: str):
    """e.g. LFC_4W4A -> (lfc builder, "fc", weight_bits=4, act_bits=4)."""
    arch, bits = name.upper().split("_")
    w_bits = int(bits[0])
    a_bits = int(bits[2])
    if arch == "CNV":
        raise NotImplementedError("CNV is not ported yet (slice 6: conv QAT)")
    if min(w_bits, a_bits) < MIN_BITS:
        raise NotImplementedError(f"{name}: 1- and 2-bit networks are not ported yet "
                                  "(slice 8: binary quantizers)")
    builder, kind = NETWORKS[arch]
    return builder, kind, w_bits, a_bits


def sqr_hinge_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Squared hinge on +-1 one-hot targets (reference SqrHingeLoss,
    bnn_pynq/models/losses.py)."""
    num_classes = logits.shape[-1]
    targets = 2.0 * torch.nn.functional.one_hot(labels.long(), num_classes).to(logits.dtype) - 1.0
    return torch.mean(torch.clamp_min(1.0 - targets * logits, 0.0) ** 2)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.cross_entropy(logits, labels.long())


LOSSES = {"sqr_hinge": sqr_hinge_loss, "ce": cross_entropy_loss}


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        _, _, ndim = struct.unpack(">HBB", f.read(4))
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def load_mnist(data_dir: str, split: str):
    prefix = "train" if split == "train" else "t10k"
    for ext in ("", ".gz"):
        img = os.path.join(data_dir, f"{prefix}-images-idx3-ubyte{ext}")
        lbl = os.path.join(data_dir, f"{prefix}-labels-idx1-ubyte{ext}")
        if os.path.exists(img):
            x = _read_idx(img).astype(np.float32) / 255.0
            y = _read_idx(lbl).astype(np.int32)
            return x.reshape(-1, 28, 28, 1), y
    raise FileNotFoundError(f"MNIST idx files not found under {data_dir}")


def load_synthetic(split: str, kind: str, n: int = 2048, seed: int = 0):
    rng = np.random.default_rng(seed if split == "train" else seed + 1)
    if kind == "cnv":
        x = rng.random((n, 32, 32, 3), dtype=np.float32)
    else:
        x = rng.random((n, 28, 28, 1), dtype=np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, y


def batches(x: np.ndarray, y: np.ndarray, batch_size: int, seed: int,
            drop_last: bool = True) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    n_full = len(x) // batch_size
    for i in range(n_full):
        sel = idx[i * batch_size:(i + 1) * batch_size]
        yield x[sel], y[sel]
    if not drop_last and len(x) % batch_size:
        sel = idx[n_full * batch_size:]
        yield x[sel], y[sel]


# ---------------------------------------------------------------------------
# trainer (reference bnn_pynq/trainer.py Trainer)
# ---------------------------------------------------------------------------

def train_step(model, optimizer, x: torch.Tensor, y: torch.Tensor,
               loss_kind: str = "sqr_hinge") -> torch.Tensor:
    """One step: the loss, its gradients, the optimizer's update, then the
    weights clipped to [-1, 1]. Returns the loss (on the model's device)."""
    optimizer.zero_grad(set_to_none=True)
    loss = LOSSES[loss_kind](model(x), y)
    loss.backward()
    optimizer.step()
    model.clip_weights(-1.0, 1.0)
    return loss.detach()


def evaluate(model, x: np.ndarray, y: np.ndarray, batch_size: int = 256) -> float:
    """Top-1 accuracy over the full set, the tail batch included."""
    device = next(model.parameters()).device
    model.eval()
    correct = torch.zeros((), dtype=torch.int64, device=device)
    with torch.no_grad():
        for i in range(0, len(x), batch_size):
            xb = torch.from_numpy(x[i:i + batch_size]).to(device)
            yb = torch.from_numpy(y[i:i + batch_size]).to(device)
            correct += (model(xb).argmax(-1) == yb).sum()
    model.train()
    return int(correct) / max(len(x), 1)


LEFT_OUT = {  # option -> why it raises
    "cfg": "every shipped .ini config is 1-2 bit (slice 8)",
    "scan": "the port runs each step eagerly; a CUDA graph of the step is later work",
    "native_loader": "the C++ prefetch loader is not ported (slice 11)",
    "resume": "checkpoints are not ported (slice 11)",
}


def main(argv=None):
    p = argparse.ArgumentParser("brevitas_tpu_torch bnn_pynq trainer")
    p.add_argument("--network", default="LFC_4W4A",
                   help="{TFC,SFC,LFC}_{3..8}W{3..8}A, e.g. LFC_4W4A")
    p.add_argument("--cfg", default=None, help="not ported: " + LEFT_OUT["cfg"])
    p.add_argument("--dataset", default="synthetic",
                   choices=["mnist", "cifar10", "digits", "synthetic"])
    p.add_argument("--data-dir", default=os.environ.get("DATA_DIR", "./data"))
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--loss", default="sqr_hinge", choices=sorted(LOSSES))
    p.add_argument("--seed", type=int, default=123456)
    p.add_argument("--resume", default=None, help="not ported: " + LEFT_OUT["resume"])
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--scan", action="store_true", help="not ported: " + LEFT_OUT["scan"])
    p.add_argument("--native-loader", action="store_true",
                   help="not ported: " + LEFT_OUT["native_loader"])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    for opt, why in LEFT_OUT.items():
        if getattr(args, opt):
            raise NotImplementedError(f"--{opt.replace('_', '-')}: {why}")
    if args.dataset == "digits":
        raise NotImplementedError("--dataset digits needs sklearn; use mnist (idx files under "
                                  "--data-dir) or synthetic")
    if args.dataset == "cifar10":
        raise NotImplementedError("cifar10 trains CNV, which is not ported yet (slice 6)")
    device = resolve_device(args.device)
    builder, kind, w_bits, a_bits = parse_network(args.network)
    # reference cfgs set IN_BIT_WIDTH equal to the ACT bit width
    model = builder(weight_bit_width=w_bits, act_bit_width=a_bits, in_bit_width=a_bits,
                    generator=torch.Generator().manual_seed(args.seed), device=device)

    if args.dataset == "mnist":
        x_train, y_train = load_mnist(args.data_dir, "train")
        x_test, y_test = load_mnist(args.data_dir, "test")
    else:
        x_train, y_train = load_synthetic("train", kind)
        x_test, y_test = load_synthetic("test", kind, n=512)

    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr)
    model.train()
    best_acc = 0.0
    for epoch in range(args.epochs):
        t0 = time.time()
        losses = []
        for bi, (xb, yb) in enumerate(batches(x_train, y_train, args.batch_size,
                                              args.seed + epoch)):
            loss = train_step(model, optimizer, torch.from_numpy(xb).to(device),
                              torch.from_numpy(yb).to(device), loss_kind=args.loss)
            losses.append(loss)
            if bi % args.log_every == 0:
                print(f"epoch {epoch} batch {bi}: loss {float(loss):.4f}")
        losses = [float(v) for v in losses]
        acc = evaluate(model, x_test, y_test)
        dt = time.time() - t0
        imgs_per_sec = len(losses) * args.batch_size / dt
        print(f"epoch {epoch}: mean loss {np.mean(losses):.4f} "
              f"val acc {acc:.4f} ({imgs_per_sec:.0f} img/s)")
        best_acc = max(best_acc, acc)
    print(json.dumps({"best_val_acc": best_acc}))
    return best_acc


if __name__ == "__main__":
    main()
