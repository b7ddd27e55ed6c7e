"""ResNet (port of ``brevitas_tpu/models/resnet.py``; ported: the float
model the PTQ flow takes, ``FloatResNet`` and ``float_resnet``, basic-block
depths 18 and 34, with the CIFAR stem (3 x 3, stride 1) or the ImageNet
one (7 x 7, stride 2, then a 3 x 3 max pool)). ``QuantResNet`` waits for
slice 11.

NCHW activations, OIHW weights; the module names are the JAX model's
(``stem.conv``, ``blocks.3.conv1.bn``, ``blocks.2.downsample.conv``,
``output``), so the paths a traced forward finds are the same letter for
letter. The BatchNorms are flax's (``models.common.BatchNorm`` over axis 1,
momentum 0.99, eps 1e-5), the convs keep XLA's padding
(``nn.conv.FloatConv2d``), and weights are drawn with flax's initializers
from a ``torch.Generator``.
"""

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from brevitas_tpu_torch.models.common import BatchNorm
from brevitas_tpu_torch.nn.conv import FloatConv2d, lecun_normal_, resolve_pads

_DEPTH_CFG = {18: ("basic", (2, 2, 2, 2)), 34: ("basic", (3, 4, 6, 3))}
_STAGE_CH = (64, 128, 256, 512)


class _FloatConvBN(nn.Module):
    def __init__(self, in_ch, out_ch, kernel, stride, generator=None):
        super().__init__()
        pad = ((kernel // 2, kernel // 2),) * 2 if kernel > 1 else "VALID"
        self.conv = FloatConv2d(in_ch, out_ch, kernel, stride=stride, padding=pad, bias=False,
                                generator=generator)
        self.bn = BatchNorm(out_ch, momentum=0.99, eps=1e-5, channel_axis=1)

    def forward(self, x):
        return self.bn(self.conv(x))


class _FloatBasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch, ch, stride, generator=None):
        super().__init__()
        self.conv1 = _FloatConvBN(in_ch, ch, 3, stride, generator)
        self.conv2 = _FloatConvBN(ch, ch, 3, 1, generator)
        out_ch = ch * self.expansion
        self.downsample = (_FloatConvBN(in_ch, out_ch, 1, stride, generator)
                           if stride != 1 or in_ch != out_ch else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.conv2(torch.relu(self.conv1(x)))
        return torch.relu(y + identity)


class FloatResNet(nn.Module):
    """Float ResNet of basic blocks, the PTQ flow's input; ``bn_pairs()``
    and ``equalize_regions()`` give the hand lists the traced forward
    finds by itself."""

    def __init__(self, *, depth: int = 18, num_classes: int = 10, in_channels: int = 3,
                 cifar_stem: bool = True, width_mult: float = 1.0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if depth not in _DEPTH_CFG:
            raise NotImplementedError("FloatResNet covers the basic-block depths 18 and 34")
        _, stage_layers = _DEPTH_CFG[depth]
        stem_ch = int(64 * width_mult)
        self.stem = _FloatConvBN(in_channels, stem_ch, 3 if cifar_stem else 7,
                                 1 if cifar_stem else 2, generator)
        self.cifar_stem = cifar_stem
        blocks = []
        in_ch = stem_ch
        for stage, n_layers in enumerate(stage_layers):
            ch = int(_STAGE_CH[stage] * width_mult)
            for j in range(n_layers):
                stride = 2 if (j == 0 and stage != 0) else 1
                blocks.append(_FloatBasicBlock(in_ch, ch, stride, generator))
                in_ch = ch
        self.blocks = nn.ModuleList(blocks)
        self.output = nn.Linear(in_ch, num_classes)
        lecun_normal_(self.output.weight, in_ch, generator)
        with torch.no_grad():
            self.output.bias.zero_()
        self.eval()  # flax's use_running_average=True
        if device is not None:
            self.to(device)

    def forward(self, x):
        x = torch.relu(self.stem(x))
        if not self.cifar_stem:
            pads = resolve_pads("SAME", x.shape[2:], (3, 3), (2, 2), (1, 1))
            x = F.max_pool2d(F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi],
                                   value=float("-inf")), 3, 2)
        for blk in self.blocks:
            x = blk(x)
        x = x.mean((2, 3))
        return self.output(x)

    def bn_pairs(self) -> Sequence[Tuple[str, str]]:
        """(conv, bn) fusion pairs."""
        pairs = [("stem.conv", "stem.bn")]
        for i, blk in enumerate(self.blocks):
            pairs.append((f"blocks.{i}.conv1.conv", f"blocks.{i}.conv1.bn"))
            pairs.append((f"blocks.{i}.conv2.conv", f"blocks.{i}.conv2.bn"))
            if blk.downsample is not None:
                pairs.append((f"blocks.{i}.downsample.conv", f"blocks.{i}.downsample.bn"))
        return pairs

    def equalize_regions(self):
        """conv1 -> conv2 of each block, the JAX model's hand list."""
        return [([f"blocks.{i}.conv1.conv"], [f"blocks.{i}.conv2.conv"])
                for i in range(len(self.blocks))]


def float_resnet(depth: int = 18, **kw) -> FloatResNet:
    return FloatResNet(depth=depth, **kw)
