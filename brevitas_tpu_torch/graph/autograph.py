"""Automatic module-graph discovery from one traced forward (port of
``brevitas_tpu/graph/autograph.py``): ``trace_module_graph``, ``GraphNode``,
``ModuleGraph``, the call classes (``_classify_prim``), and on the graph the
BatchNorm fusion pairs (``find_bn_pairs``), the cross-layer equalization
regions (``extract_regions``) and SmoothQuant's regions
(``extract_act_equalization_regions``).

The JAX package traces one concrete forward into a jaxpr whose equations
carry the path of the module that emitted them. The port traces one
concrete forward too, eagerly: forward hooks on every module of a node
class (norms, linears, convs, activations, pools, dropout) mark where its
call begins and ends, and a ``TorchFunctionMode`` records every torch
function called outside such a call, with the tensors it took and gave.
Tensors are followed by identity, and the trace holds each one until it
ends so that no identity is reused. A call is one node: the analogue of a
primitive equation between modules (``reshape``, ``__getitem__``, ``add``,
...). A module that gives back its own input (a quantizer set to NONE) adds
no node, as it emits no equation in JAX.

``torch.fx`` was not taken: its symbolic trace cannot follow Python control
flow on tensor values, and its nodes would be torch calls, not the
primitives JAX records; the concrete trace sees exactly the calls the
forward makes on this input, as ``jax.make_jaxpr`` does. Shape and dtype
reads give no tensor and add no node, as they add no equation in JAX.

``per_call=True`` (the export derivation, ``export/derive.py``) makes
each call of a module its own node, as JAX's ``per_call`` does: a shared
quantizer called three times gives three nodes, numbered by
``call_index``. In that mode every node also records where each of its
tensor inputs came from (``sources``: the producing node, ``MODEL_INPUT``,
or None for a constant), a module call the source of its data input
(``data_source``: the value of its first argument), and every node its
output's shape (``out_shape``). JAX picks a module's data input as the
largest tensor crossing into it; the port knows it from the call.

The trace runs on a deep copy of the model under ``torch.no_grad()``, so
the statistics a training-mode forward collects never reach the model; the
graph's nodes hold the model's own modules.

The channel axis. The JAX package's activations are channels-last, so its
channel-sensitive rules (a reduction keeps the channel scaling when it
leaves the last axis alone; a concatenation along it joins different
channels) read the last axis. The port's convs put channels on axis 1. So
the trace follows each tensor's layout: the output of a conv, a pool or a
BatchNorm over axis 1 is channels-first, an output of a linear or a norm
over the last axis channels-last, a call that permutes axes (``permute``,
``movedim``, ``transpose``, ...) gives channels-last, and every other call
and module passes its first input's layout on; the model's input is
channels-first from 3 dimensions up (the port's NCHW / NCL images). A
call's channel axis is 1 on a channels-first input and the last axis
otherwise (the two agree on (N, C)). A spatial mean ``x.mean((2, 3))`` is
then scale-invariant and a channel concatenation ``torch.cat(..., 1)``
stops, as their channels-last counterparts do in JAX.
"""

import copy
import itertools
from typing import Dict, List, Optional, Set, Tuple

import torch
from torch import nn
from torch.overrides import TorchFunctionMode

__all__ = ["trace_module_graph", "find_bn_pairs", "extract_regions",
           "extract_act_equalization_regions", "ModuleGraph", "GraphNode", "MODEL_INPUT"]


def _node_classes():
    from brevitas_tpu_torch.models.common import BatchNorm, LayerNorm, RMSNorm
    from brevitas_tpu_torch.nn.activation import QuantNonLinearActLayer
    from brevitas_tpu_torch.nn.conv import _QuantConvNd
    from brevitas_tpu_torch.nn.linear import QuantLinear
    from brevitas_tpu_torch.nn.misc import QuantScaleBias
    from brevitas_tpu_torch.nn.pool import QuantAvgPool2d, _QuantMaxPoolNd

    return (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.modules.batchnorm._BatchNorm,
            nn.Dropout, BatchNorm, LayerNorm, RMSNorm, QuantLinear, _QuantConvNd,
            QuantNonLinearActLayer, QuantScaleBias, QuantAvgPool2d, _QuantMaxPoolNd)


def _output_layout(mod) -> Optional[bool]:
    """True where the module's output is channels-first, False where it is
    channels-last, None where it keeps its input's layout."""
    from brevitas_tpu_torch.models.common import BatchNorm, LayerNorm, RMSNorm
    from brevitas_tpu_torch.nn.conv import _QuantConvNd
    from brevitas_tpu_torch.nn.linear import QuantLinear
    from brevitas_tpu_torch.nn.misc import QuantScaleBias
    from brevitas_tpu_torch.nn.pool import QuantAvgPool2d, _QuantMaxPoolNd

    if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Conv3d, _QuantConvNd, QuantAvgPool2d,
                        _QuantMaxPoolNd, nn.modules.batchnorm._BatchNorm)):
        return True
    if isinstance(mod, (BatchNorm, QuantScaleBias)):
        return mod.channel_axis is not None
    if isinstance(mod, (nn.Linear, QuantLinear, LayerNorm, RMSNorm)):
        return False
    return None


def _is_scale_invariant_module(mod) -> bool:
    """Modules that commute with a positive per-channel scale: dropout, max
    and average pools, and a ReLU whose quantizer is off (a quantizer's
    clamp grid is not scale-invariant). A folded BatchNorm's identity gives
    back its input and so is no node, as in JAX."""
    from brevitas_tpu_torch.nn.activation import QuantReLU
    from brevitas_tpu_torch.nn.pool import QuantAvgPool2d, _QuantMaxPoolNd
    from brevitas_tpu_torch.quant.config import QuantType

    if isinstance(mod, (nn.Dropout, QuantAvgPool2d, _QuantMaxPoolNd)):
        return True
    if isinstance(mod, QuantReLU):
        return mod.act_quant.quant_type == QuantType.NONE
    return False


def _is_batchnorm(mod) -> bool:
    from brevitas_tpu_torch.models.common import BatchNorm

    return isinstance(mod, (BatchNorm, nn.modules.batchnorm._BatchNorm))


def _is_supported(mod) -> bool:
    """Equalization source and sink kinds: linears, ungrouped convs, and
    depthwise convs (``groups == out_channels``: channel i maps to channel
    i, so equalization scales pass straight through). The port has no
    transposed quant conv yet."""
    from brevitas_tpu_torch.nn.conv import _QuantConvNd
    from brevitas_tpu_torch.nn.linear import QuantLinear

    if isinstance(mod, (nn.Linear, QuantLinear)):
        return True
    if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Conv3d, _QuantConvNd)):
        if mod.groups == 1:
            return True
        w = mod.weight
        return mod.groups == w.shape[0] and w.shape[1] == 1
    return False


class GraphNode:
    """One node of the module-level dataflow graph."""

    def __init__(self, kind: str, path: Optional[str] = None, module=None,
                 prim: Optional[str] = None, args=(), kwargs=None,
                 channel_axis: Optional[int] = None, call_index: int = 0):
        self.kind = kind          # 'module' | 'prim'
        self.path = path
        self.module = module
        self.prim = prim          # the torch function's name
        self.args = args          # its positional arguments
        self.kwargs = kwargs or {}
        self.channel_axis = channel_axis  # of the call's first tensor input
        self.call_index = call_index  # nth call of this module (per_call)
        self.sources: list = []   # per tensor input (per_call)
        self.data_source = None   # a module call's data input (per_call)
        self.out_shape: Optional[Tuple[int, ...]] = None
        self.preds: List["GraphNode"] = []
        self.succs: List["GraphNode"] = []

    def __repr__(self):
        return (f"GraphNode(module {self.path})" if self.kind == "module"
                else f"GraphNode(prim {self.prim})")


# the model's input as a source (per_call)
MODEL_INPUT = GraphNode("input")


class ModuleGraph:
    def __init__(self, nodes: List[GraphNode], modules: Dict[str, GraphNode]):
        self.nodes = nodes
        self.modules = modules  # path -> node


def _tensors(obj):
    """The tensors in a call's arguments or result, QuantTensor fields and
    nested lists, tuples and dicts included."""
    from brevitas_tpu_torch.quant_tensor import QuantTensor

    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, QuantTensor):
        for v in (obj.value, obj.scale, obj.zero_point, obj.bit_width):
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)


class _Tracer(TorchFunctionMode):
    """Records torch calls outside node-class modules, and the modules'
    calls through their hooks."""

    def __init__(self, paths: Dict[int, str], originals: Dict[str, nn.Module],
                 per_call: bool = False):
        super().__init__()
        self.paths, self.originals, self.per_call = paths, originals, per_call
        self.calls: Dict[str, int] = {}
        self.depth = 0
        self.keep = []            # every tensor seen, alive until the trace ends
        self.producer: Dict[int, GraphNode] = {}
        self.channels_first: Dict[int, bool] = {}
        self.nodes: List[GraphNode] = []
        self.modules: Dict[str, GraphNode] = {}
        self.pending: List[list] = []

    def _connect(self, node: GraphNode, inputs) -> None:
        for t in inputs:
            src = self.producer.get(id(t))
            if (src is not None and src is not node and src is not MODEL_INPUT
                    and node not in src.succs):
                src.succs.append(node)
                node.preds.append(src)

    def _produce(self, node: GraphNode, outputs, channels_first: bool) -> None:
        for t in outputs:
            self.keep.append(t)
            self.producer[id(t)] = node
            self.channels_first[id(t)] = channels_first
        if outputs:
            node.out_shape = tuple(outputs[0].shape)

    def _layout(self, inputs) -> bool:
        return bool(inputs) and self.channels_first.get(id(inputs[0]), False)

    def _channel_axis(self, inputs) -> Optional[int]:
        if not inputs:
            return None
        ndim = inputs[0].ndim
        return 1 if self._layout(inputs) and ndim >= 2 else ndim - 1

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.depth:
            return out
        outputs = list(_tensors(out))
        if not outputs:
            return out  # a shape or dtype read: no equation in JAX either
        inputs = list(_tensors(args)) + list(_tensors(kwargs))
        self.keep.extend(inputs)
        name = getattr(func, "__name__", None) or str(func)
        node = GraphNode("prim", prim=name, args=args, kwargs=kwargs,
                         channel_axis=self._channel_axis(inputs))
        node.sources = [self.producer.get(id(t)) for t in inputs]
        self.nodes.append(node)
        self._connect(node, inputs)
        self._produce(node, outputs, self._layout(inputs) and name not in _PERMUTING)
        return out

    def pre_hook(self, mod, args, kwargs):
        if self.depth == 0:
            inputs = list(_tensors(args)) + list(_tensors(kwargs))
            self.keep.extend(inputs)
            self.pending.append(inputs)
        self.depth += 1

    def post_hook(self, mod, args, kwargs, out):
        self.depth -= 1
        if self.depth:
            return
        inputs = self.pending.pop()
        seen = {id(t) for t in inputs}
        outputs = [t for t in _tensors(out) if id(t) not in seen]
        if not outputs:
            return  # gave back its input: no node, as no equation in JAX
        path = self.paths[id(mod)]
        node = self.modules.get(path)
        if node is None or self.per_call:
            # all of a module's calls are one node, or (per_call) one each
            index = self.calls.get(path, 0)
            self.calls[path] = index + 1
            node = GraphNode("module", path=path, module=self.originals[path],
                             call_index=index)
            self.modules.setdefault(path, node)
            self.nodes.append(node)
            data = next(_tensors(args[0] if args else list(kwargs.values())[:1]), None)
            node.data_source = None if data is None else self.producer.get(id(data))
        self._connect(node, inputs)
        layout = _output_layout(mod)
        self._produce(node, outputs, self._layout(inputs) if layout is None else layout)


def trace_module_graph(model: nn.Module, sample_input, *, per_call: bool = False,
                       extra_classes: Tuple[type, ...] = ()) -> ModuleGraph:
    """Trace ``model(sample_input)`` once and return the module-level
    dataflow graph, all of a module's calls merged into one node, or with
    ``per_call`` one node a call (``ModuleGraph.modules`` then holds each
    module's first call). ``extra_classes`` are node classes besides the
    default ones."""
    classes = _node_classes() + tuple(extra_classes)
    originals = {path: mod for path, mod in model.named_modules()
                 if path and isinstance(mod, classes)}
    traced = copy.deepcopy(model)
    paths = {id(mod): path for path, mod in traced.named_modules() if path in originals}
    tracer = _Tracer(paths, originals, per_call)
    handles = []
    for path, mod in traced.named_modules():
        if path in originals:
            handles.append(mod.register_forward_pre_hook(tracer.pre_hook, with_kwargs=True))
            handles.append(mod.register_forward_hook(tracer.post_hook, with_kwargs=True))
    device = next(itertools.chain(model.parameters(), model.buffers())).device
    x = torch.as_tensor(sample_input, device=device)
    tracer.keep.append(x)
    tracer.channels_first[id(x)] = x.ndim >= 3
    if per_call:
        tracer.producer[id(x)] = MODEL_INPUT
    try:
        with torch.no_grad(), tracer:
            traced(x)
    finally:
        for h in handles:
            h.remove()
    return ModuleGraph(tracer.nodes, tracer.modules)


# ---------------------------------------------------------------------------
# call classification: the torch calls of the JAX package's primitive table
# ---------------------------------------------------------------------------

_RESHAPING = {
    "reshape", "view", "view_as", "flatten", "unflatten", "squeeze", "unsqueeze",
    "transpose", "t", "permute", "movedim", "moveaxis", "swapaxes", "swapdims",
    "contiguous", "to", "float", "double", "half", "bfloat16", "type", "type_as",
    "detach", "clone", "expand", "expand_as", "broadcast_to", "repeat_interleave",
    "narrow",
}

# calls that move the channel axis: their output is channels-last
_PERMUTING = {"transpose", "t", "permute", "movedim", "moveaxis", "swapaxes", "swapdims"}

# channelwise-linear or monotone spatial calls (JAX's reduce_window_max /
# reduce_window_sum, pad, rev), and relu, JAX's max(x, 0)
_INVARIANT = {
    "pad", "flip", "max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d", "avg_pool2d",
    "avg_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_max_pool1d",
    "adaptive_max_pool2d", "relu", "relu_",
}
_CLAMPS = {"clamp", "clamp_min", "clip", "clamp_", "clamp_min_"}
_MULS = {"mul", "__mul__", "__rmul__", "mul_", "__imul__"}
_DIVS = {"div", "__truediv__", "true_divide", "div_", "__itruediv__"}
_REDUCTIONS = {"mean", "sum", "amax", "amin", "max", "min", "nanmean"}
_CONCATS = {"cat", "concat", "concatenate"}
_ADDS = {"add", "__add__", "__radd__", "__iadd__", "add_", "sub", "__sub__", "__rsub__",
         "__isub__", "sub_", "subtract"}


def _basic_index(index) -> bool:
    """Slices, integers, None and Ellipsis only (JAX's slice/squeeze);
    a tensor or list index is a gather."""
    items = index if isinstance(index, tuple) else (index,)
    return all(isinstance(i, (slice, int, type(None), type(Ellipsis))) for i in items)


def _positive_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) and v > 0


def _arg(node: GraphNode, i: int, name: str, default=None):
    if len(node.args) > i:
        return node.args[i]
    return node.kwargs.get(name, default)


def _classify_prim(node: GraphNode) -> str:
    """'reshaping' | 'invariant' | 'residual' | 'stop', the JAX package's
    classes of its primitives: reshaping calls; calls that commute with a
    positive per-channel scale (relu and ``clamp(x, 0)``, pools, padding,
    scaling by a positive number, a reduction or a concatenation that
    leaves the channel axis alone); adds and subtractions of two tensors
    (residual joins); everything else stops a region."""
    name = node.prim
    if name == "__getitem__":
        return "reshaping" if _basic_index(node.args[1]) else "stop"
    if name in _RESHAPING:
        return "reshaping"
    if name in _INVARIANT:
        return "invariant"
    if name in _CLAMPS:
        lo, hi = _arg(node, 1, "min"), _arg(node, 2, "max")
        return "invariant" if lo == 0 and hi is None else "stop"
    if name in _MULS or name in _DIVS:
        # a multiplication by a positive number, or a division by one
        factors = node.args if name in _MULS else node.args[1:]
        return "invariant" if any(_positive_number(v) for v in factors) else "stop"
    if name in _REDUCTIONS:
        x = node.args[0]
        dims = _arg(node, 1, "dim")
        if dims is None or isinstance(dims, torch.Tensor) or node.channel_axis is None:
            return "stop"  # over every axis, the channel one included
        dims = (dims,) if isinstance(dims, int) else tuple(dims)
        return "invariant" if node.channel_axis not in {d % x.ndim for d in dims} else "stop"
    if name in _CONCATS:
        first = node.args[0][0]
        dim = _arg(node, 1, "dim", 0)
        return "invariant" if dim % first.ndim != node.channel_axis else "stop"
    if name in _ADDS:
        tensors = [a for a in node.args if isinstance(a, torch.Tensor)]
        if len(tensors) >= 2 and all(t.numel() > 1 for t in tensors):
            return "residual"
        return "stop"
    return "stop"


# ---------------------------------------------------------------------------
# BatchNorm pairs and equalization regions
# ---------------------------------------------------------------------------


def find_bn_pairs(model: nn.Module, sample_input,
                  graph: Optional[ModuleGraph] = None) -> List[Tuple[str, str]]:
    """(layer_path, bn_path) fusion sites found from the traced graph: a
    linear or conv whose output, through reshaping calls only, has one
    consumer, and that consumer a BatchNorm (a branched output, such as a
    residual tap, never folds)."""
    from brevitas_tpu_torch.nn.conv import _QuantConvNd
    from brevitas_tpu_torch.nn.linear import QuantLinear

    foldable = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d, QuantLinear, _QuantConvNd)
    g = graph or trace_module_graph(model, sample_input)
    pairs = []
    for path, node in g.modules.items():
        if not isinstance(node.module, foldable):
            continue
        cur, nxt = node, None
        while len(cur.succs) == 1:
            nxt = cur.succs[0]
            if nxt.kind == "module" or _classify_prim(nxt) != "reshaping":
                break
            cur, nxt = nxt, None
        else:
            nxt = None
        if nxt is not None and nxt.kind == "module" and _is_batchnorm(nxt.module):
            pairs.append((path, nxt.path))
    return pairs


def extract_regions(model: nn.Module, sample_input,
                    graph: Optional[ModuleGraph] = None) -> List[Tuple[List[str], List[str]]]:
    """Cross-layer equalization regions ([src_paths], [sink_paths]) from the
    traced graph, by the JAX package's walk: from each linear or conv,
    forward through reshaping and scale-invariant calls and modules to the
    sinks; a residual join walks both ways, and a sink reached backwards is
    a source whose outputs are walked too. A region whose sources' output
    channels and sinks' input channels differ in number (a flatten between
    a conv and a linear) is dropped."""
    from brevitas_tpu_torch.graph.equalize import _axes

    g = graph or trace_module_graph(model, sample_input)

    def walk(node: GraphNode, history: Set[Tuple[int, int]], srcs: Set[str],
             sinks: Set[str], forward: bool):
        for nxt in (node.succs if forward else node.preds):
            key = (id(node), id(nxt)) if forward else (id(nxt), id(node))
            if key in history:
                continue
            history.add(key)
            if nxt.kind == "module":
                mod = nxt.module
                if _is_supported(mod):
                    if forward:
                        sinks.add(nxt.path)
                    else:
                        srcs.add(nxt.path)
                        walk(nxt, history, srcs, sinks, True)
                elif _is_scale_invariant_module(mod):
                    walk(nxt, history, srcs, sinks, True)
                    if not forward:
                        walk(nxt, history, srcs, sinks, False)
                continue  # BatchNorms, quantized activations, other modules stop
            cls = _classify_prim(nxt)
            if cls == "reshaping":
                walk(nxt, history, srcs, sinks, forward)
            elif cls == "invariant":
                walk(nxt, history, srcs, sinks, True)
                if not forward:
                    walk(nxt, history, srcs, sinks, False)
            elif cls == "residual":
                walk(nxt, history, srcs, sinks, True)
                walk(nxt, history, srcs, sinks, False)

    def sizes_match(srcs: Set[str], sinks: Set[str]) -> bool:
        sizes = set()
        for p in srcs:
            mod = g.modules[p].module
            sizes.add(int(mod.weight.shape[_axes(mod)[1]]))
        for p in sinks:
            mod = g.modules[p].module
            sizes.add(int(mod.weight.shape[_axes(mod)[0]]))
        return len(sizes) == 1

    regions: Set[Tuple[Tuple[str, ...], Tuple[str, ...]]] = set()
    for path, node in g.modules.items():
        if not _is_supported(node.module):
            continue
        srcs: Set[str] = {path}
        sinks: Set[str] = set()
        walk(node, set(), srcs, sinks, True)
        if sinks and not (srcs & sinks) and sizes_match(srcs, sinks):
            regions.add((tuple(sorted(srcs)), tuple(sorted(sinks))))
    return [(list(s), list(k)) for s, k in sorted(regions, key=lambda r: r[0][0])]


def extract_act_equalization_regions(model: nn.Module, sample_input,
                                     graph: Optional[ModuleGraph] = None,
                                     ) -> List[Tuple[List[str], List[str]]]:
    """SmoothQuant migration sites found from the traced graph: each
    LayerNorm/RMSNorm-style source with the linear sinks its output feeds
    directly (through reshaping-only calls), such as a block's norm and its
    q/k/v projections, or the final norm and the head."""
    from brevitas_tpu_torch.graph.equalize import _is_norm_source

    g = graph or trace_module_graph(model, sample_input)

    def linear_sinks(node: GraphNode) -> Set[str]:
        sinks: Set[str] = set()
        seen: Set[int] = set()

        def walk(n: GraphNode):
            for nxt in n.succs:
                if id(nxt) in seen:
                    continue
                seen.add(id(nxt))
                if nxt.kind == "module":
                    if _is_supported(nxt.module):
                        sinks.add(nxt.path)
                    continue  # any other module ends the branch
                if _classify_prim(nxt) == "reshaping":
                    walk(nxt)
                # other glue ends the branch: the migration is exact only
                # straight into a sink

        walk(node)
        return sinks

    regions: List[Tuple[List[str], List[str]]] = []
    for path, node in g.modules.items():
        if not _is_norm_source(node.module):
            continue
        sinks = linear_sinks(node)
        if sinks:
            regions.append(([path], sorted(sinks)))
    regions.sort(key=lambda r: r[0][0])
    return regions
