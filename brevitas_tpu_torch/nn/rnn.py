"""QuantLSTM (port of ``brevitas_tpu/nn/rnn.py``; ported: ``QuantLSTM``
with ``num_layers``, ``bidirectional`` and ``use_bias``, the default
quantizer sharing, its layer ``_QuantLSTMLayer`` and the cell's quantizers).

Layout: batch-first (B, T, F). Each layer keeps its gate matrices packed in
the JAX package's layout, w_ih (I, 4H) and w_hh (H, 4H) with gates (i, f, g,
o), so the input projection is one GEMM hoisted out of the time loop and a
carried state needs no transpose. The weights are quantized per gate block
through four quantizers per matrix, once per forward.

The loop over time is a Python loop over ``x_proj.unbind(1)`` (the JAX
package scans it; the backward of ``unbind`` stacks the steps' gradients
once, where indexing a step would add a full-size gradient per step). Two
paths run a step:

- the module cell calls the cell's eleven activation quantizers, which
  advance their state in place (runtime statistics while they collect). It
  runs while any quantizer's grid depends on the data, or when the layer's
  ``fused_cell`` is False;
- the fused step, once every grid is data-independent (CONST or learned
  scales, e.g. after ``convert_runtime_stats_to_parameter``): batched
  fake-quants with no quantizer state. Where all six stages are INT with a
  constant bit width, round-to-nearest and the zeroing clamp in float32 (the
  configurations the JAX package sends to its Pallas cell), the step calls
  ``kernels.quant_lstm_cell``: the CUDA forward and backward kernels on the
  card, their plain version on the CPU. The kernel takes the step's input
  projection and recurrent product as two addends and forms their sum
  itself, and reads the stages after sigmoid and tanh from tables built
  once per layer forward (``kernels.quant_lstm_cell_tables``) where the
  scales and bit widths allow. Other configurations run the plain fused
  step. The choice is made from the configuration, never from a failure.

sigmoid and tanh are formed in float64 and rounded once on every path
(``ops.sigmoid_f64``, ``ops.tanh_f64``), so the paths agree with each other
and with the CUDA kernels on the card. The kernel's autograd saves only
``gates`` and ``c`` per step and its backward recomputes the rest (the JAX
package's ``jax.checkpoint`` has no counterpart).

Left out, still to port: CIFG (``coupled_input_forget_gates``),
``shared_input_hidden_weights``, ``shared_intra_layer_weight_quant``,
``shared_intra_layer_gate_acc_quant``, ``cat_output_cell_states=False``,
QuantRNN and the ONNX export of the fake-quant LSTM.

``compute_dtype`` (``utils.set_compute_dtype``) stores the fused step's
input projection and recurrent weights in bf16, as the JAX package does;
the per-step product takes a bf16-rounded ``h`` and returns float32
(``nn.linear.compute_dtype_matmul``), and the cell stays float32.
"""

from typing import Optional, Tuple

import torch
from torch import nn

from brevitas_tpu_torch.core import quant as Qf
from brevitas_tpu_torch.kernels.lstm_cell import (
    cell_step,
    gate_columns,
    quant_lstm_cell,
    quant_lstm_cell_tables,
)
from brevitas_tpu_torch.nn.linear import compute_dtype_matmul
from brevitas_tpu_torch.ops import round_ste, sigmoid_f64, tanh_f64, tensor_clamp, tensor_clamp_ste
from brevitas_tpu_torch.ops.numeric import max_int, min_int
from brevitas_tpu_torch.quant.config import QuantConfig
from brevitas_tpu_torch.quant.presets import (
    Int8ActPerTensorFloat,
    Int8WeightPerTensorFloat,
    NoneActQuant,
    NoneBiasQuant,
    NoneWeightQuant,
    Uint8ActPerTensorFloat,
)
from brevitas_tpu_torch.quant.quantizers import ActQuantizer, BiasQuantizer, ParameterQuantizer
from brevitas_tpu_torch.utils import resolve_device

# the six stages of the fused cell, in the kernel's order
STAGES = ("acc", "sig", "tanh_g", "cell", "tanh_h", "hidden")


class _FusedUnsupported(Exception):
    """A cell quantizer needs its stateful per-call path: run the module cell."""


def _acfg(q: Optional[QuantConfig]) -> QuantConfig:
    return NoneActQuant if q is None else q


class _QuantLSTMCellQuant(nn.Module):
    """The activation quantizers of one LSTM cell. ``shared_cell_state`` and
    ``shared_io`` take an existing quantizer to share across layers (the
    first layer's hidden-state quantizer always; its cell-state quantizer
    with ``shared_cell_state_quant``)."""

    def __init__(self, act_quant, sigmoid_quant, tanh_quant, cell_quant, io_quant, *,
                 shared_cell_state: Optional[ActQuantizer] = None,
                 shared_io: Optional[ActQuantizer] = None):
        super().__init__()
        self.gate_acc = ActQuantizer(_acfg(act_quant))  # input gate
        self.cell_acc = ActQuantizer(_acfg(act_quant))
        self.out_acc = ActQuantizer(_acfg(act_quant))
        self.forget_acc = ActQuantizer(_acfg(act_quant))
        self.in_sigmoid = ActQuantizer(_acfg(sigmoid_quant))
        self.forget_sigmoid = ActQuantizer(_acfg(sigmoid_quant))
        self.out_sigmoid = ActQuantizer(_acfg(sigmoid_quant))
        self.cell_tanh = ActQuantizer(_acfg(tanh_quant))
        self.hidden_tanh = ActQuantizer(_acfg(tanh_quant))
        self.cell_state = (shared_cell_state if shared_cell_state is not None
                           else ActQuantizer(_acfg(cell_quant)))
        self.hidden_state = shared_io if shared_io is not None else ActQuantizer(_acfg(io_quant))


def _int_bounds(cfg: QuantConfig) -> Tuple[float, float]:
    bw = float(cfg.bit_width)
    return (min_int(cfg.signed, cfg.narrow_range, bw), max_int(cfg.signed, cfg.narrow_range, bw))


class _QuantLSTMLayer(nn.Module):
    """One direction of one LSTM layer."""

    def __init__(self, input_size: int, hidden_size: int, *, weight_quant, bias_quant,
                 io_quant, gate_acc_quant, sigmoid_quant, tanh_quant, cell_state_quant,
                 use_bias: bool = True, reverse: bool = False,
                 shared_cell_state: Optional[ActQuantizer] = None,
                 shared_io: Optional[ActQuantizer] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.reverse = reverse
        self.fused_cell = True  # the fused step when the grids allow; False: module cell
        h = hidden_size
        k = 1.0 / h ** 0.5

        def uniform(shape):
            # uniform(-k, k), drawn on the CPU so a seed gives the same
            # weights on every device
            return torch.rand(shape, generator=generator) * (2 * k) - k

        self.w_ih = nn.Parameter(uniform((input_size, 4 * h)))
        self.w_hh = nn.Parameter(uniform((h, 4 * h)))
        self.bias = nn.Parameter(torch.zeros(4 * h)) if use_bias else None
        self.bias_quant = BiasQuantizer(bias_quant if bias_quant is not None else NoneBiasQuant)
        wcfg = NoneWeightQuant if weight_quant is None else weight_quant
        self.w_ih_quants = nn.ModuleList([
            ParameterQuantizer(wcfg, self.w_ih.detach()[:, g * h:(g + 1) * h], channel_axis=1)
            for g in range(4)])
        self.w_hh_quants = nn.ModuleList([
            ParameterQuantizer(wcfg, self.w_hh.detach()[:, g * h:(g + 1) * h], channel_axis=1)
            for g in range(4)])
        self.input_quant = ActQuantizer(_acfg(io_quant))
        self.quants = _QuantLSTMCellQuant(gate_acc_quant, sigmoid_quant, tanh_quant,
                                          cell_state_quant, io_quant,
                                          shared_cell_state=shared_cell_state,
                                          shared_io=shared_io)

    # the fused step's operand dtype (torch.bfloat16) or None for float32:
    # see utils.set_compute_dtype
    compute_dtype = None

    def _quant_packed(self, w: torch.Tensor, quants) -> torch.Tensor:
        """Quantize a packed (X, 4H) gate matrix gate block by gate block."""
        h = self.hidden_size
        return torch.cat([q(w[:, g * h:(g + 1) * h]).value for g, q in enumerate(quants)],
                         dim=1)

    def _fused_stage(self, quants):
        """Static quant parameters of one packed stage: ``(scale, bit_width,
        quantizer)``, the scale a scalar when every quantizer is one shared
        instance, else an (n,) vector of the n per-tensor scales (one per
        gate block; ``kernels.lstm_cell.gate_columns`` spreads it over the
        block's columns) or an (n H,) vector of per-channel ones, through
        which gradients reach each learned scale; None for an all-NONE
        stage. Raises ``_FusedUnsupported`` when a quantizer carries
        per-call state."""
        params = [q.static_int_params() for q in quants]
        if any(p is None for p in params):
            raise _FusedUnsupported
        idents = [isinstance(p, str) for p in params]
        if all(idents):
            return None
        if any(idents):
            raise _FusedUnsupported  # a block mixing NONE and INT stages
        q0 = quants[0]
        if any(q.cfg != q0.cfg for q in quants[1:]):
            raise _FusedUnsupported
        if all(q is q0 for q in quants[1:]):
            return params[0][0], params[0][1], q0
        if all(p[0].numel() == 1 for p in params):
            return torch.stack([p[0].reshape(()) for p in params]), params[0][1], q0
        h = self.hidden_size
        scale = torch.cat([p[0].reshape(-1).expand(h) for p in params])
        return scale, params[0][1], q0

    def _fused_cell_params(self):
        """The six stages' static parameters, or None when any quantizer
        needs its stateful path (then the module cell runs)."""
        q = self.quants
        try:
            return {
                "acc": self._fused_stage([q.gate_acc, q.forget_acc, q.cell_acc, q.out_acc]),
                "sig": self._fused_stage([q.in_sigmoid, q.forget_sigmoid, q.out_sigmoid]),
                "tanh_g": self._fused_stage([q.cell_tanh]),
                "cell": self._fused_stage([q.cell_state]),
                "tanh_h": self._fused_stage([q.hidden_tanh]),
                "hidden": self._fused_stage([q.hidden_state]),
            }
        except _FusedUnsupported:
            return None

    @staticmethod
    def _fused_quant(x: torch.Tensor, stage) -> torch.Tensor:
        if stage is None:
            return x
        scale, bit_width, q = stage
        return Qf.int_quant(x, scale, 0.0, bit_width, signed=q.cfg.signed,
                            narrow_range=q.cfg.narrow_range, float_to_int=q._float_to_int,
                            clamp_fn=tensor_clamp_ste if q.cfg.clamp_ste else tensor_clamp)

    def _kernel_cell_args(self, stages, dtype):
        """Scales and bounds for ``quant_lstm_cell``, or None when the plain
        fused step must run (a NONE stage, round other than to nearest, the
        straight-through clamp, or not float32). Bit widths are CONST: the
        port has no other."""
        if dtype != torch.float32 or any(stages[k] is None for k in STAGES):
            return None
        for k in STAGES:
            cfg = stages[k][2].cfg
            if cfg.clamp_ste or stages[k][2]._float_to_int is not round_ste:
                return None
        # sa and ss as the stages hold them (one, n or n H values): the
        # kernels read them through strides
        sa = stages["acc"][0].reshape(-1)
        ss = stages["sig"][0].reshape(-1)
        scalars = [stages[k][0].reshape(()) for k in ("tanh_g", "cell", "tanh_h", "hidden")]
        return sa, ss, scalars, tuple(_int_bounds(stages[k][2].cfg) for k in STAGES)

    def _fused_scan(self, x_proj, h, c, qw_hh, stages):
        """The time loop with data-independent grids: no quantizer state,
        batched gate fake-quants."""
        kernel_args = self._kernel_cell_args(stages, c.dtype)
        if kernel_args is not None:
            sa, ss, (st, sc, sth, sh), bounds = kernel_args
            # the stage tables once a layer forward (the scales move only
            # between optimizer steps); None where the direct chain serves
            # and on the CPU
            tables = quant_lstm_cell_tables(sa, ss, st, sc, sth, bounds)

            def step(xp_t, p, c):
                # the kernel forms xp_t + p itself (no add or cast launch)
                return quant_lstm_cell(xp_t, c, sa, ss, st, sc, sth, sh, bounds, recurrent=p,
                                       tables=tables)
        else:
            h_dim = self.hidden_size
            plain = dict(stages)
            for k, n in (("acc", 4), ("sig", 3)):
                if plain[k] is not None:
                    plain[k] = (gate_columns(plain[k][0], n, h_dim), *plain[k][1:])

            def step(xp_t, p, c):
                return cell_step(xp_t.to(c.dtype) + p, c,
                                 lambda x, k: self._fused_quant(x, plain[STAGES[k]]))
        if qw_hh.dtype == c.dtype:
            def gemm(h):
                return h @ qw_hh
        else:  # compute_dtype: bf16 operands, a float32 product
            def gemm(h):
                return compute_dtype_matmul(h, qw_hh, qw_hh.dtype)
        ys = []
        for xp_t in x_proj.unbind(1):
            h, c = step(xp_t, gemm(h), c)
            ys.append(h)
        return torch.stack(ys, dim=1), (h, c)

    def _module_scan(self, x_proj, h, c, qw_hh):
        """The time loop through the cell's quantizer modules, which advance
        their state in place on each call."""
        q = self.quants
        ys = []
        for xp_t in x_proj.unbind(1):
            gates = xp_t + h @ qw_hh
            i_g, f_g, g_g, o_g = torch.split(gates, self.hidden_size, dim=-1)
            i_t = q.in_sigmoid(sigmoid_f64(q.gate_acc(i_g).value)).value
            f_t = q.forget_sigmoid(sigmoid_f64(q.forget_acc(f_g).value)).value
            g_t = q.cell_tanh(tanh_f64(q.cell_acc(g_g).value)).value
            o_t = q.out_sigmoid(sigmoid_f64(q.out_acc(o_g).value)).value
            c = q.cell_state(f_t * c + i_t * g_t).value
            h = q.hidden_state(o_t * q.hidden_tanh(tanh_f64(c)).value).value
            ys.append(h)
        return torch.stack(ys, dim=1), (h, c)

    def forward(self, x: torch.Tensor, h0: Optional[torch.Tensor] = None,
                c0: Optional[torch.Tensor] = None):
        b = x.shape[0]
        hd = self.hidden_size
        h0 = torch.zeros((b, hd), dtype=x.dtype, device=x.device) if h0 is None else h0
        c0 = torch.zeros((b, hd), dtype=x.dtype, device=x.device) if c0 is None else c0
        x = self.input_quant(x).value
        qw_ih = self._quant_packed(self.w_ih, self.w_ih_quants)
        qw_hh = self._quant_packed(self.w_hh, self.w_hh_quants)
        x_proj = torch.matmul(x, qw_ih)
        if self.bias is not None:
            x_proj = x_proj + self.bias_quant(self.bias).value
        if self.reverse:
            x_proj = torch.flip(x_proj, dims=(1,))
        stages = self._fused_cell_params() if self.fused_cell else None
        if stages is not None:
            if self.compute_dtype is not None:
                # store the streamed input projection and the recurrent
                # weights in bf16; the per-step product returns float32 and
                # the cell's math stays float32
                x_proj = x_proj.to(self.compute_dtype)
                qw_hh = qw_hh.to(self.compute_dtype)
            ys, state = self._fused_scan(x_proj, h0, c0, qw_hh, stages)
        else:
            ys, state = self._module_scan(x_proj, h0, c0, qw_hh)
        if self.reverse:
            ys = torch.flip(ys, dims=(1,))
        return ys, state


class QuantLSTM(nn.Module):
    """Stacked, optionally bidirectional, quantized LSTM. The first
    direction's hidden-state (io) quantizer is shared by every layer and
    direction, and so is its cell-state quantizer with
    ``shared_cell_state_quant`` (the default). The options of the JAX
    package that are not ported raise ``NotImplementedError``."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1, *,
                 bidirectional: bool = False, use_bias: bool = True,
                 weight_quant: Optional[QuantConfig] = Int8WeightPerTensorFloat,
                 bias_quant: Optional[QuantConfig] = None,
                 io_quant: Optional[QuantConfig] = Int8ActPerTensorFloat,
                 gate_acc_quant: Optional[QuantConfig] = Int8ActPerTensorFloat,
                 sigmoid_quant: Optional[QuantConfig] = Uint8ActPerTensorFloat,
                 tanh_quant: Optional[QuantConfig] = Int8ActPerTensorFloat,
                 cell_state_quant: Optional[QuantConfig] = Int8ActPerTensorFloat,
                 coupled_input_forget_gates: bool = False,
                 cat_output_cell_states: bool = True,
                 shared_input_hidden_weights: bool = False,
                 shared_intra_layer_weight_quant: bool = False,
                 shared_intra_layer_gate_acc_quant: bool = False,
                 shared_cell_state_quant: bool = True,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        left_out = {"coupled_input_forget_gates": coupled_input_forget_gates,
                    "shared_input_hidden_weights": shared_input_hidden_weights,
                    "shared_intra_layer_weight_quant": shared_intra_layer_weight_quant,
                    "shared_intra_layer_gate_acc_quant": shared_intra_layer_gate_acc_quant,
                    "cat_output_cell_states=False": not cat_output_cell_states}
        for name, asked in left_out.items():
            if asked:
                raise NotImplementedError(f"QuantLSTM {name} is not ported yet")
        if cell_state_quant is not None and not shared_cell_state_quant:
            raise ValueError("Concatenating cell states requires shared cell quantizers.")
        device = resolve_device(device)
        self.hidden_size = hidden_size
        self.bidirectional = bidirectional
        layers = []
        shared_io = shared_cell = None
        for i in range(num_layers):
            in_size = input_size if i == 0 else hidden_size * (2 if bidirectional else 1)
            kw = dict(weight_quant=weight_quant, bias_quant=bias_quant, io_quant=io_quant,
                      gate_acc_quant=gate_acc_quant, sigmoid_quant=sigmoid_quant,
                      tanh_quant=tanh_quant, cell_state_quant=cell_state_quant,
                      use_bias=use_bias, generator=generator)
            fwd = _QuantLSTMLayer(in_size, hidden_size, shared_io=shared_io,
                                  shared_cell_state=shared_cell, **kw)
            if shared_io is None:
                shared_io = fwd.quants.hidden_state
            if shared_cell is None and shared_cell_state_quant:
                shared_cell = fwd.quants.cell_state
            layers.append(fwd)
            if bidirectional:
                layers.append(_QuantLSTMLayer(in_size, hidden_size, reverse=True,
                                              shared_io=shared_io,
                                              shared_cell_state=shared_cell, **kw))
        self.layers = nn.ModuleList(layers)
        self.to(device)

    def forward(self, x: torch.Tensor, h0: Optional[torch.Tensor] = None,
                c0: Optional[torch.Tensor] = None):
        """``h0``/``c0``: (num_layers * num_directions, B, H) initial states.
        Returns the last layer's outputs (B, T, H or 2H) and (h_n, c_n)."""
        step = 2 if self.bidirectional else 1
        finals = []
        for idx in range(0, len(self.layers), step):
            states = [(None if h0 is None else h0[idx + d], None if c0 is None else c0[idx + d])
                      for d in range(step)]
            outs = [self.layers[idx + d](x, *states[d]) for d in range(step)]
            x = torch.cat([y for y, _ in outs], dim=-1) if self.bidirectional else outs[0][0]
            finals.extend(s for _, s in outs)
        return x, (torch.stack([s[0] for s in finals]), torch.stack([s[1] for s in finals]))
