"""Export items derived from one traced forward (port of
``brevitas_tpu/export/derive.py``).

``graph.autograph.trace_module_graph(..., per_call=True)`` records each
module call as a node and each torch call between modules (relu, residual
adds, channel concatenations, reshapes, functional pools, scalar affines)
as a call node. :func:`derive_export_items` compiles that graph into the
item list ``export/qcdq.py``'s ``export_model`` walks: the modules, and the
glue ``("relu",)``, ``("relu6",)``, ``("save"/"load"/"add_saved", n)``,
``("concat", ns)``, ``("flatten",)``, ``("flatten_hwc",)``, ``("maxpool",
k, s, pad)``, ``("avgpool", k, s)``, ``("gap",)``, ``("expand_hw", h,
w)``, ``("unflatten2d",)`` and ``("affine", mul, add)``. A call it cannot
map raises :class:`DeriveError`, and ``export_model`` falls back to the
children in order, checked against the model.

The JAX package reads jaxpr primitives; the port reads torch calls, so each
rule names the calls that lower to JAX's primitive. Layout: the port's
activations are channels-first, as the ONNX graph is, so no transposes go
in. A permute to channels-last (``x.movedim(1, -1)``, ``x.permute(0, 2, 3,
1)``) adds no node; it marks the tensor, and the flatten that reads it is
``("flatten_hwc",)``, JAX's channels-last flatten (a Transpose and a
Flatten in ONNX). A flatten of a channels-first (N, 1, H, W) tensor is also
``("flatten_hwc",)``: with one channel both orders agree, and JAX flattens
the same (N, H, W, 1) tensor so. A flatten of (N, C, H, W) with C and H * W
above 1 is ONNX's Flatten, a layout JAX's models cannot give.

A call whose output is a scalar is threaded to its source only where it has
exactly one source that is not a constant; otherwise it raises. The JAX
package threads any scalar to its first predecessor, or to the model's
input where it has none (ROADMAP S5).
"""

from typing import Dict, List

import numpy as np

from brevitas_tpu_torch.graph.autograph import MODEL_INPUT

__all__ = ["derive_export_items", "DeriveError"]


class DeriveError(ValueError):
    """The traced graph holds structure the deriver cannot map."""


_TRANSPARENT = {"to", "float", "contiguous", "detach", "clone", "type_as", "squeeze",
                "unsqueeze"}
_PERMUTES = {"movedim", "moveaxis", "permute"}
_RESHAPES = {"reshape", "view", "flatten"}
_RELUS = {"relu", "relu_"}
_CLAMPS = {"clamp", "clamp_", "clip", "clamp_min", "clamp_min_", "hardtanh", "relu6"}
_MULS = {"mul", "__mul__", "__rmul__", "mul_", "__imul__"}
_DIVS = {"div", "__truediv__", "true_divide", "div_", "__itruediv__"}
_ADDS = {"add", "__add__", "__radd__", "add_", "__iadd__"}
_SUBS = {"sub", "__sub__", "sub_", "__isub__", "subtract"}
_MAXPOOLS = {"max_pool2d", "_max_pool2d", "max_pool2d_with_indices"}
_CONCATS = {"cat", "concat", "concatenate"}
_EXPANDS = {"expand", "expand_as", "broadcast_to"}


class _Emit:
    """One scheduled export step: a module call or a glue op."""

    def __init__(self, kind: str, module=None, glue=None, inputs=None, onnx_rank: int = 0):
        self.kind = kind      # 'module' | 'glue'
        self.module = module
        self.glue = glue      # the glue tuple, before save/load scheduling
        self.inputs: List = inputs or []   # _Emit | _INPUT
        self.onnx_rank = onnx_rank

    def __repr__(self):
        return (f"_Emit({type(self.module).__name__})" if self.module is not None
                else f"_Emit{self.glue}")


_INPUT = object()  # the model input as an emit source


class _ChannelsLast:
    """A channels-last view (a permute) of an emit's output: the ONNX
    tensor is the emit's, unpermuted."""

    def __init__(self, src):
        self.src = src


def _arg(node, i: int, name: str, default=None):
    if len(node.args) > i:
        return node.args[i]
    return node.kwargs.get(name, default)


def _number(v):
    """A Python number as JAX's float32 literal, else None (a tensor
    operand is traced, not a literal)."""
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(np.float32(v))
    return None


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def derive_export_items(model, example_input, output_rank=None) -> list:
    """Derive the exporter's item list from one traced forward.

    ``output_rank`` is the rank of the model's output (from a forward the
    caller ran): a walk that ends at rank 4 where the model returns rank 2
    gets a trailing flatten."""
    from brevitas_tpu_torch.graph.autograph import trace_module_graph
    from brevitas_tpu_torch.models.common import TensorNorm
    from brevitas_tpu_torch.nn.linear import QuantLinear
    from torch import nn

    g = trace_module_graph(model, example_input, per_call=True, extra_classes=(TensorNorm,))
    input_rank = len(tuple(example_input.shape))

    src_of: Dict[int, object] = {}   # id(node) -> _Emit | _INPUT | _ChannelsLast
    emits: List[_Emit] = []

    def resolve(source):
        if source is MODEL_INPUT:
            return _INPUT
        if source is None:
            return None
        got = src_of.get(id(source))
        if got is None:
            raise DeriveError(f"unresolved producer {source}")
        return got

    def rank_of(src) -> int:
        return src.onnx_rank if isinstance(src, _Emit) else input_rank

    def plain(src, what: str):
        if isinstance(src, _ChannelsLast):
            raise DeriveError(f"a channels-last view feeds {what}")
        return src

    def emit(node, glue, inputs, rank) -> _Emit:
        e = _Emit("glue", glue=glue, inputs=inputs, onnx_rank=rank)
        src_of[id(node)] = e
        emits.append(e)
        return e

    for node in g.nodes:
        if node.kind == "module":
            src = plain(resolve(node.data_source), type(node.module).__name__)
            if src is None:
                raise DeriveError(f"module {node.path} reads a constant")
            rank_in = rank_of(src)
            if isinstance(node.module, (QuantLinear, nn.Linear)):
                if rank_in == 4:
                    # the ONNX side still holds (B, C, 1, 1) (after a global
                    # pool) where the model flattened: flatten before the product
                    fl = _Emit("glue", glue=("flatten",), inputs=[src], onnx_rank=2)
                    emits.append(fl)
                    src = fl
                e = _Emit("module", module=node.module, inputs=[src], onnx_rank=2)
            else:
                e = _Emit("module", module=node.module, inputs=[src], onnx_rank=rank_in or 4)
            src_of[id(node)] = e
            emits.append(e)
            continue

        name = node.prim
        sources = [resolve(s) for s in node.sources]
        live = [s for s in sources if s is not None]
        first = live[0] if live else None
        out_shape = node.out_shape or ()

        if len(out_shape) == 0:
            # a scalar (metadata arithmetic): threaded only to its one source
            distinct = {id(s): s for s in live}
            if len(distinct) != 1:
                raise DeriveError(f"scalar {name} of {len(distinct)} non-constant sources")
            src_of[id(node)] = first
            continue
        if first is None:
            raise DeriveError(f"{name} of constants only")
        if name in _TRANSPARENT:
            src_of[id(node)] = first
            continue
        in_shape = tuple(node.args[0].shape) if node.args and hasattr(node.args[0], "shape") \
            else ()
        if name in _PERMUTES:
            src = plain(first, name)
            dims = node.args[1:] if name == "permute" else node.args[1:3]
            if name == "permute" and len(dims) == 1:
                dims = tuple(dims[0])
            nhwc = ((name == "permute" and tuple(d % 4 for d in dims) == (0, 2, 3, 1))
                    or (name != "permute" and len(dims) == 2
                        and (dims[0] % 4, dims[1] % 4) == (1, 3)))
            if len(in_shape) != 4 or not nhwc or rank_of(src) != 4:
                raise DeriveError(f"unmapped {name} {tuple(dims)}")
            src_of[id(node)] = _ChannelsLast(src)
            continue
        if name in _RESHAPES:
            if in_shape == out_shape:
                src_of[id(node)] = first
                continue
            if len(out_shape) == 2 and len(in_shape) == 4:
                if isinstance(first, _ChannelsLast):
                    src = first.src
                    hw = in_shape[1] * in_shape[2]
                    glue = ("flatten",) if hw == 1 else ("flatten_hwc",)
                else:
                    src = first
                    if rank_of(src) == 2:
                        src_of[id(node)] = src  # the ONNX side is flat already
                        continue
                    c, hw = in_shape[1], in_shape[2] * in_shape[3]
                    glue = ("flatten_hwc",) if c == 1 and hw > 1 else ("flatten",)
                emit(node, glue, [src], 2)
                continue
            src = plain(first, name)
            if (len(in_shape) == 2 and len(out_shape) == 4 and out_shape[2:] == (1, 1)
                    and int(np.prod(in_shape)) == int(np.prod(out_shape))):
                # (B, C) -> (B, C, 1, 1)
                if rank_of(src) == 4:
                    src_of[id(node)] = src  # the ONNX side is (B, C, 1, 1) already
                    continue
                emit(node, ("unflatten2d",), [src], 4)
                continue
            raise DeriveError(f"unmapped {name} {in_shape}->{out_shape}")
        src = plain(first, name)
        if name in _RELUS:
            emit(node, ("relu",), [src], rank_of(src))
            continue
        if name in _CLAMPS:
            if name == "relu6":
                lo, hi = 0.0, 6.0
            elif name == "hardtanh":
                lo, hi = _arg(node, 1, "min_val", -1.0), _arg(node, 2, "max_val", 1.0)
            elif name.startswith("clamp_min"):
                lo, hi = _arg(node, 1, "min"), None
            else:
                lo, hi = _arg(node, 1, "min"), _arg(node, 2, "max")
            if lo == 0 and hi is None:
                emit(node, ("relu",), [src], rank_of(src))
                continue
            if lo == 0 and hi == 6:
                emit(node, ("relu6",), [src], rank_of(src))
                continue
            if lo is None and hi == 6 and isinstance(src, _Emit) and src.glue == ("relu",):
                # relu then min(., 6): one Clip(0, 6), as JAX folds max -> min
                src.glue = ("relu6",)
                src_of[id(node)] = src
                continue
            raise DeriveError(f"unmapped {name}({lo}, {hi})")
        if name in _MULS | _DIVS | _ADDS | _SUBS:
            numbers = [_number(a) for a in node.args]
            tensor_first = len(node.args) > 0 and hasattr(node.args[0], "shape")
            scalar = next((v for v in numbers if v is not None), None)
            if scalar is not None and len(live) == 1:
                if name in _MULS:
                    m_, a_ = scalar, 0.0
                elif name in _DIVS:
                    if not tensor_first:
                        raise DeriveError("scalar / tensor")
                    m_, a_ = 1.0 / scalar, 0.0
                elif name in _SUBS:
                    if not tensor_first:
                        raise DeriveError("scalar - tensor")
                    m_, a_ = 1.0, -scalar
                else:
                    m_, a_ = 1.0, scalar
                if isinstance(src, _Emit) and src.glue and src.glue[0] == "affine":
                    _, pm, pa = src.glue
                    src.glue = ("affine", m_ * pm, m_ * pa + a_)
                    src_of[id(node)] = src
                    continue
                emit(node, ("affine", m_, a_), [src], rank_of(src))
                continue
            if name in _ADDS:
                shapes = [tuple(a.shape) for a in node.args if hasattr(a, "shape")]
                if (len(shapes) == 2 and shapes[0] == shapes[1] == out_shape
                        and int(np.prod(out_shape)) > 1 and len(live) == 2):
                    emit(node, ("residual_add",), [plain(s, name) for s in live],
                         len(out_shape))
                    continue
                raise DeriveError(f"unmapped add shapes {shapes}")
            raise DeriveError(f"unmapped {name}")
        if name in _CONCATS:
            tensors = node.args[0]
            dim = _arg(node, 1, "dim", 0)
            if dim % len(out_shape) != 1:
                raise DeriveError("non-channel concatenate")
            ins = [plain(s, name) for s in live]
            if len(ins) != len(tensors) or len({id(s) for s in ins}) != len(ins):
                raise DeriveError("concat operands share a producer")
            emit(node, ("concat_list",), ins, len(out_shape))
            continue
        if name in _MAXPOOLS | {"avg_pool2d"}:
            k = _pair(_arg(node, 1, "kernel_size"))
            s = _arg(node, 2, "stride", None)
            s = k if s in (None, [], ()) else _pair(s)
            pad = _pair(_arg(node, 3, "padding", 0))
            if k[0] != k[1] or s[0] != s[1] or pad != (0, 0):
                raise DeriveError(f"unmapped {name} window {k} stride {s} padding {pad}")
            if name == "avg_pool2d":
                if _arg(node, 6, "divisor_override") is not None:
                    raise DeriveError("avg_pool2d with a divisor")
                emit(node, ("avgpool", int(k[0]), int(s[0])), [src], 4)
            else:
                emit(node, ("maxpool", int(k[0]), int(s[0]), "VALID"), [src], 4)
            continue
        if name in ("mean", "adaptive_avg_pool2d"):
            if name == "mean":
                dims = _arg(node, 1, "dim")
                dims = (dims,) if isinstance(dims, int) else tuple(dims or ())
                ok = len(in_shape) == 4 and {d % 4 for d in dims} == {2, 3}
            else:
                ok = len(in_shape) == 4 and _pair(_arg(node, 1, "output_size")) == (1, 1)
            if not ok:
                raise DeriveError(f"non-spatial {name}")
            emit(node, ("gap",), [src], 4)
            continue
        if name in _EXPANDS:
            if in_shape == out_shape:
                src_of[id(node)] = src
                continue
            if (len(in_shape) == 4 and len(out_shape) == 4 and in_shape[2:] == (1, 1)
                    and in_shape[1] == out_shape[1]):
                emit(node, ("expand_hw", out_shape[2], out_shape[3]), [src], 4)
                continue
            raise DeriveError(f"unmapped broadcast {in_shape}->{out_shape}")
        raise DeriveError(f"unmapped call {name}")

    if not emits:
        raise DeriveError("traced graph produced no exportable steps")
    if output_rank == 2 and emits[-1].onnx_rank == 4:
        emits.append(_Emit("glue", glue=("flatten",), inputs=[emits[-1]], onnx_rank=2))
    return _schedule(emits)


def _schedule(emits: List[_Emit]) -> list:
    """Linearize the emit graph into the exporter's item vocabulary (JAX's
    schedule, step for step)."""
    sym: Dict[int, str] = {}

    def name_of(src) -> str:
        if src is _INPUT:
            return "g_input"
        s = sym.get(id(src))
        if s is None:
            s = f"t{len(sym)}"
            sym[id(src)] = s
        return s

    need_save = set()    # ids of emits (or _INPUT) whose output must be saved
    prev = _INPUT
    for e in emits:
        for src in e.inputs:
            if src is not prev or e.inputs.count(src) > 1:
                need_save.add(id(src))
        prev = e

    items: list = []
    if id(_INPUT) in need_save:
        items.append(("save", name_of(_INPUT)))
    prev = _INPUT
    for e in emits:
        main = e.inputs[0] if e.inputs else _INPUT
        if e.kind == "glue" and e.glue[0] == "residual_add":
            a, b = e.inputs
            if prev is b:
                main, other = b, a
            else:
                main, other = a, b
            if main is not prev:
                items.append(("load", name_of(main)))
            items.append(("add_saved", name_of(other)))
        elif e.kind == "glue" and e.glue[0] == "concat_list":
            names = []
            used_at = None
            for k, src in enumerate(e.inputs):
                if src is prev and used_at is None:
                    names.append("@")
                    used_at = k
                else:
                    names.append(name_of(src))
            if used_at is None:
                items.append(("load", names[0]))
                names[0] = "@"
            items.append(("concat", names))
        else:
            if main is not prev:
                items.append(("load", name_of(main)))
            items.append(e.module if e.kind == "module" else e.glue)
        if id(e) in need_save:
            items.append(("save", name_of(e)))
        prev = e
    return items
