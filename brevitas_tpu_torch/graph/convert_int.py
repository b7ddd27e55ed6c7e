"""QAT -> integer-domain serving conversion (port of
``brevitas_tpu/graph/convert_int.py``; ported: the QuantLinear twins and
``convert_integer_inference`` restricted to QuantLinear).

Freeze the trained quantizer state, cache the integer weights and scales,
and serve with the integer GEMM kernels, dequant in the epilogue. With
x_q = x/s_x + zp_x, y = s_x s_w (x_q @ w_q - zp_x * colsum(w_q)), so the
zero-point correction folds into the bias.

The JAX package sends small shapes to XLA's plain path (``_prefer_pallas_gemm``
and the M >= 16 gate, measured on a TPU v5e). No such gate carries over:
on the card every serving call launches the hand-written kernel.
"""

from typing import Optional

import torch
from torch import nn

from brevitas_tpu_torch.graph.base import named_modules, set_module
from brevitas_tpu_torch.kernels import int4_weight_only_matmul, int8_matmul, pack_int4_rows
from brevitas_tpu_torch.nn.linear import QuantLinear
from brevitas_tpu_torch.ops import max_int, min_int
from brevitas_tpu_torch.quant.config import QuantType
from brevitas_tpu_torch.quant_tensor import QuantTensor


def _freeze_act_quant(act_quantizer):
    """(scale, zero_point, lo, hi) of a trained INT activation quantizer —
    after training they no longer depend on the input."""
    if act_quantizer.quant_type != QuantType.INT:
        raise ValueError(f"integer serving supports INT input quantizers, got "
                         f"{act_quantizer.quant_type}")
    act_quantizer.eval()
    scaling = act_quantizer.scaling
    device = next(scaling.buffers()).device
    qt = act_quantizer(torch.zeros((1, 1), device=device))
    cfg = act_quantizer.cfg
    lo = float(min_int(cfg.signed, cfg.narrow_range, qt.bit_width))
    hi = float(max_int(cfg.signed, cfg.narrow_range, qt.bit_width))
    return qt.scale.detach(), qt.zero_point, lo, hi


def _freeze_output_quant(act_quantizer):
    """Frozen output requant params as floats, or None when no output
    quantizer is set."""
    if act_quantizer is None or act_quantizer.quant_type == QuantType.NONE:
        return None
    s, zp, lo, hi = _freeze_act_quant(act_quantizer)
    return float(s), float(zp), lo, hi


def _apply_output_quant(y: torch.Tensor, frozen) -> torch.Tensor:
    if frozen is None:
        return y
    s, zp, lo, hi = frozen
    q = torch.clamp(torch.round(y / s + zp), lo, hi)
    return (q - zp) * s


def _val(x):
    """Serving twins consume plain tensors; an upstream quant layer may hand
    over a QuantTensor — take its value."""
    return x.value if isinstance(x, QuantTensor) else x


def _carried_codes(x):
    """(codes_int8, scale, shift) from a CARRIED input grid, or None.

    bnn_pynq-style models give their linears no ``input_quant``: the grid
    arrives as QuantTensor metadata from the preceding activation quantizer.
    The values are exact multiples of the carried scale, so
    ``round(value/scale)`` recovers the codes; unsigned grids re-centre by
    128 into int8 and the shift folds into the bias through the weight
    column sums. Symmetric grids only."""
    if not isinstance(x, QuantTensor) or x.scale is None:
        return None
    signed = bool(x.signed) if x.signed is not None else True
    shift = 0.0 if signed else 128.0
    codes = torch.round(x.value / x.scale) - shift
    codes = torch.clamp(codes, -128.0, 127.0).to(torch.int8)
    return codes, x.scale.to(torch.float32).reshape(()), shift


class Int8InferenceLinear(nn.Module):
    """Serving twin of a trained QuantLinear: cached int8 weight (K, N) and
    the int8 GEMM kernel.

    Weights of 4 bits or fewer with an INT input quantizer are stored here
    as unpacked int8 codes and go through ``int8_matmul``: the JAX package
    packs them for ``int4_matmul``, whose int32 accumulation and epilogue
    are the same, so the output is identical. Packing waits for the port
    of ``int4_matmul``."""

    def __init__(self, qlinear: QuantLinear, act: Optional[str] = None):
        super().__init__()
        with torch.no_grad():
            qw = qlinear.quant_weight()
            if float(qw.bit_width) > 8.0:
                raise ValueError("the int8 path needs bit_width <= 8")
            w_int = qw.int().t().contiguous()  # (in, out) int8
            w_scale = qw.scale.reshape(-1).to(torch.float32)
            colsum = w_int.to(torch.int32).sum(0).to(torch.float32)
            bias = (qlinear.bias.detach().to(torch.float32) if qlinear.bias is not None
                    else torch.zeros(w_int.shape[1], device=w_int.device))
            self.register_buffer("w_int", w_int)
            self.register_buffer("w_scale", w_scale)
            self.register_buffer("colsum", colsum)
            if qlinear.input_quant.quant_type == QuantType.NONE:
                # carried-grid mode: the grid arrives with the input
                self.x_scale = None
            else:
                x_scale, x_zp, self.x_lo, self.x_hi = _freeze_act_quant(
                    qlinear.input_quant)
                self.register_buffer("x_scale", x_scale.reshape(()))
                self.x_zp = float(x_zp)
                self.x_signed = qlinear.input_quant.cfg.signed
                # unsigned (uint8) inputs re-centre into int8 by -128; with
                # the zero point this folds into the bias through
                # (x_q - zp) = (x_q - shift) + (shift - zp)
                self.x_shift = 0.0 if self.x_signed else 128.0
                bias = bias + (self.x_shift - self.x_zp) * colsum \
                    * self.x_scale * w_scale
            self.register_buffer("bias", bias)
        self.act = act
        self.output_quant = _freeze_output_quant(getattr(qlinear, "output_quant", None))
        self.out_features = w_int.shape[1]

    def forward(self, x) -> torch.Tensor:
        if self.x_scale is None:
            carried = _carried_codes(x)
            if carried is None:
                # no grid for this input: the dequantized-weight float path
                # keeps the function right
                y = _val(x) @ (self.w_int.to(torch.float32) * self.w_scale) + self.bias
                y = torch.clamp_min(y, 0.0) if self.act == "relu" else y
                return _apply_output_quant(y, self.output_quant)
            x_int, x_scale, shift = carried
            bias = self.bias + shift * self.colsum * x_scale * self.w_scale
            x = _val(x)
        else:
            x = _val(x)
            x_scale, bias = self.x_scale, self.bias
            x_int = torch.clamp(torch.round(x / x_scale + self.x_zp), self.x_lo, self.x_hi)
            x_int = (x_int - self.x_shift).to(torch.int8)
        flat = x_int.reshape(-1, x_int.shape[-1])
        y = int8_matmul(flat, self.w_int, x_scale, self.w_scale, bias, act=self.act)
        y = y.reshape(*x.shape[:-1], self.out_features)
        return _apply_output_quant(y, self.output_quant)


class WeightOnlyInt4InferenceLinear(nn.Module):
    """w4a16 serving twin: activations stay float, weights are stored as
    split-halves packed int4 and unpacked inside the GEMM kernel."""

    def __init__(self, qlinear: QuantLinear):
        super().__init__()
        if qlinear.input_quant.quant_type != QuantType.NONE:
            raise ValueError("weight-only serving wants NO input quantizer")
        with torch.no_grad():
            qw = qlinear.quant_weight()
            if float(qw.bit_width) > 4.0:
                raise ValueError("the weight-only int4 path needs bit_width <= 4")
            w_int = qw.int().t()  # (in, out)
            k, n = w_int.shape
            if k % 2:
                raise ValueError("in_features must be even to pack int4")
            self.register_buffer("w_packed", pack_int4_rows(w_int).contiguous())
            self.register_buffer("w_scale", qw.scale.reshape(-1).to(torch.float32))
            self.register_buffer("bias", qlinear.bias.detach().to(torch.float32)
                                 if qlinear.bias is not None else None)
        self.out_features = n
        self.in_features = k
        self.output_quant = _freeze_output_quant(getattr(qlinear, "output_quant", None))

    def forward(self, x) -> torch.Tensor:
        x = _val(x)
        flat = x.reshape(-1, self.in_features)
        y = int4_weight_only_matmul(flat, self.w_packed, self.w_scale, self.bias)
        y = y.reshape(*x.shape[:-1], self.out_features).to(x.dtype)
        return _apply_output_quant(y, self.output_quant)


def convert_integer_inference(model: nn.Module) -> nn.Module:
    """Swap every eligible trained QuantLinear for its integer serving twin,
    in place: weight-only int4 when it has no input quantizer and weights
    of 4 bits or fewer, else int8 (frozen input grid, or the carried grid
    when it has no input quantizer). Other layers stay on the fake-quant
    path."""
    for path, mod in list(named_modules(model)):
        if not (isinstance(mod, QuantLinear)
                and mod.weight_quant.quant_type == QuantType.INT):
            continue
        try:
            if (mod.input_quant.quant_type == QuantType.NONE
                    and float(mod.quant_weight().bit_width) <= 4.0):
                set_module(model, path, WeightOnlyInt4InferenceLinear(mod))
            else:
                set_module(model, path, Int8InferenceLinear(mod))
        except (ValueError, NotImplementedError):
            continue
    return model
