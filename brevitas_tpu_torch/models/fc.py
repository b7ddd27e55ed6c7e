"""FC model family: TFC / SFC / LFC quantized MLPs for MNIST (port of
``brevitas_tpu/models/fc.py``).

Input QuantIdentity -> [QuantLinear(no bias) -> BatchNorm ->
QuantIdentity(act) -> Dropout]* -> QuantLinear -> TensorNorm, with inputs
mapped from [0, 1] to [-1, 1]. Module and parameter names follow the JAX
package, so ``interop.jax_state`` maps its state across by path.
"""

from typing import Optional, Sequence

import torch
from torch import nn

from brevitas_tpu_torch.models.common import (
    BatchNorm,
    TensorNorm,
    common_act_quant,
    common_weight_quant,
)
from brevitas_tpu_torch.nn import QuantIdentity, QuantLinear
from brevitas_tpu_torch.quant_tensor import QuantTensor
from brevitas_tpu_torch.utils import resolve_device

DROPOUT = 0.2


class FC(nn.Module):

    def __init__(self, *, num_classes: int = 10, weight_bit_width: int = 1,
                 act_bit_width: int = 1, in_bit_width: int = 1,
                 in_features: int = 28 * 28,
                 out_features: Sequence[int] = (64, 64, 64),
                 dropout: float = DROPOUT,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.in_features = in_features
        self.input_quant = QuantIdentity(common_act_quant(in_bit_width),
                                         return_quant_tensor=True)
        self.dropout_rate = dropout
        layers = []
        feat_in = in_features
        for feat_out in out_features:
            layers.append(QuantLinear(
                feat_in, feat_out, use_bias=False,
                weight_quant=common_weight_quant(weight_bit_width), generator=g))
            layers.append(BatchNorm(feat_out, momentum=0.9))
            layers.append(QuantIdentity(common_act_quant(act_bit_width),
                                        return_quant_tensor=True))
            feat_in = feat_out
        self.hidden = nn.ModuleList(layers)
        self.head = QuantLinear(
            feat_in, num_classes, use_bias=False,
            weight_quant=common_weight_quant(weight_bit_width), generator=g)
        self.norm = TensorNorm()
        # weights start uniform(-1, 1), as in the reference's FC.py
        with torch.no_grad():
            for lyr in [*layers, self.head]:
                if isinstance(lyr, QuantLinear):
                    lyr.weight.copy_(torch.rand(lyr.weight.shape, generator=g) * 2.0 - 1.0)
        self._dropout_seed = int(torch.randint(0, 2**62, (), generator=g))
        self._dropout_gen = None
        self.to(device)

    def clip_weights(self, min_val: float = -1.0, max_val: float = 1.0) -> None:
        """Post-step weight clipping, in place (reference trainer.py:245)."""
        with torch.no_grad():
            for lyr in [*self.hidden, self.head]:
                if isinstance(lyr, QuantLinear):
                    lyr.weight.clamp_(min_val, max_val)

    def dropout_generator_state(self) -> Optional[torch.Tensor]:
        """The dropout generator's state (None before its first draw): a
        checkpoint keeps it so that a resumed run draws the masks a straight
        run draws."""
        return None if self._dropout_gen is None else self._dropout_gen.get_state()

    def load_dropout_generator_state(self, state: torch.Tensor) -> None:
        device = next(self.parameters()).device
        self._dropout_gen = torch.Generator(device)
        self._dropout_gen.set_state(state.cpu())

    def _dropout(self, x):
        if not (self.training and self.dropout_rate > 0):
            return x
        v = x.value if isinstance(x, QuantTensor) else x
        if self._dropout_gen is None or self._dropout_gen.device != v.device:
            self._dropout_gen = torch.Generator(v.device).manual_seed(self._dropout_seed)
        keep = 1.0 - self.dropout_rate
        mask = torch.rand(v.shape, generator=self._dropout_gen, device=v.device) < keep
        out = torch.where(mask, v / keep, 0.0)
        if isinstance(x, QuantTensor):
            # zeros are code 0 and the 1/keep rescale moves into the scale,
            # so the integer codes are unchanged (a binary value +-s becomes
            # +-s/keep on the scale s/keep: still code +-1)
            return QuantTensor(out, None if x.scale is None else x.scale / keep,
                               x.zero_point, x.bit_width, signed=x.signed,
                               training=x.training)
        return out

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        x = 2.0 * x - 1.0
        x = self._dropout(self.input_quant(x))
        for i in range(0, len(self.hidden), 3):
            x = self.hidden[i](x)        # QuantLinear
            x = self.hidden[i + 1](x)    # BatchNorm
            x = self.hidden[i + 2](x)    # QuantIdentity
            x = self._dropout(x)
        return self.norm(self.head(x))


def tfc(weight_bit_width=1, act_bit_width=1, in_bit_width=1, **kw) -> FC:
    return FC(out_features=(64, 64, 64), weight_bit_width=weight_bit_width,
              act_bit_width=act_bit_width, in_bit_width=in_bit_width, **kw)


def sfc(weight_bit_width=1, act_bit_width=1, in_bit_width=1, **kw) -> FC:
    return FC(out_features=(256, 256, 256), weight_bit_width=weight_bit_width,
              act_bit_width=act_bit_width, in_bit_width=in_bit_width, **kw)


def lfc(weight_bit_width=1, act_bit_width=1, in_bit_width=1, **kw) -> FC:
    return FC(out_features=(1024, 1024, 1024), weight_bit_width=weight_bit_width,
              act_bit_width=act_bit_width, in_bit_width=in_bit_width, **kw)
