"""Automatic module-graph discovery from one traced forward (port of
``brevitas_tpu/graph/autograph.py``; ported: ``trace_module_graph``,
``GraphNode``, ``ModuleGraph``, ``_is_supported``, ``_classify_prim`` and
``extract_act_equalization_regions``).

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

The trace runs on a deep copy of the model under ``torch.no_grad()``, so
the statistics a training-mode forward collects never reach the model; the
graph's nodes hold the model's own modules.

Not ported yet: ``find_bn_pairs`` and ``extract_regions`` (cross-layer
equalization), with ``_classify_prim``'s scale-invariant and residual
classes that only they read. Their channel-sensitive rules (reductions,
concatenation) take the JAX package's last axis as the channel axis; the
port's convs put channels on axis 1.
"""

import copy
import itertools
from typing import Dict, List, Optional, Set, Tuple

import torch
from torch import nn
from torch.overrides import TorchFunctionMode

__all__ = ["trace_module_graph", "extract_act_equalization_regions", "ModuleGraph",
           "GraphNode"]


def _node_classes():
    from brevitas_tpu_torch.models.common import BatchNorm, LayerNorm, RMSNorm
    from brevitas_tpu_torch.nn.activation import QuantNonLinearActLayer
    from brevitas_tpu_torch.nn.conv import _QuantConvNd
    from brevitas_tpu_torch.nn.linear import QuantLinear
    from brevitas_tpu_torch.nn.pool import QuantAvgPool2d, _QuantMaxPoolNd

    return (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.modules.batchnorm._BatchNorm,
            nn.Dropout, BatchNorm, LayerNorm, RMSNorm, QuantLinear, _QuantConvNd,
            QuantNonLinearActLayer, QuantAvgPool2d, _QuantMaxPoolNd)


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
                 prim: Optional[str] = None, args=()):
        self.kind = kind          # 'module' | 'prim'
        self.path = path
        self.module = module
        self.prim = prim          # the torch function's name
        self.args = args          # its positional arguments
        self.succs: List["GraphNode"] = []

    def __repr__(self):
        return (f"GraphNode(module {self.path})" if self.kind == "module"
                else f"GraphNode(prim {self.prim})")


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

    def __init__(self, paths: Dict[int, str], originals: Dict[str, nn.Module]):
        super().__init__()
        self.paths, self.originals = paths, originals
        self.depth = 0
        self.keep = []            # every tensor seen, alive until the trace ends
        self.producer: Dict[int, GraphNode] = {}
        self.nodes: List[GraphNode] = []
        self.modules: Dict[str, GraphNode] = {}
        self.pending: List[list] = []

    def _connect(self, node: GraphNode, inputs) -> None:
        for t in inputs:
            src = self.producer.get(id(t))
            if src is not None and src is not node and node not in src.succs:
                src.succs.append(node)

    def _produce(self, node: GraphNode, outputs) -> None:
        for t in outputs:
            self.keep.append(t)
            self.producer[id(t)] = node

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
        node = GraphNode("prim", prim=name, args=args)
        self.nodes.append(node)
        self._connect(node, inputs)
        self._produce(node, outputs)
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
        node = self.modules.get(path)  # all of a module's calls are one node
        if node is None:
            node = self.modules[path] = GraphNode("module", path=path,
                                                  module=self.originals[path])
            self.nodes.append(node)
        self._connect(node, inputs)
        self._produce(node, outputs)


def trace_module_graph(model: nn.Module, sample_input) -> ModuleGraph:
    """Trace ``model(sample_input)`` once and return the module-level
    dataflow graph, all of a module's calls merged into one node."""
    classes = _node_classes()
    originals = {path: mod for path, mod in model.named_modules()
                 if path and isinstance(mod, classes)}
    traced = copy.deepcopy(model)
    paths = {id(mod): path for path, mod in traced.named_modules() if path in originals}
    tracer = _Tracer(paths, originals)
    handles = []
    for path, mod in traced.named_modules():
        if path in originals:
            handles.append(mod.register_forward_pre_hook(tracer.pre_hook, with_kwargs=True))
            handles.append(mod.register_forward_hook(tracer.post_hook, with_kwargs=True))
    device = next(itertools.chain(model.parameters(), model.buffers())).device
    x = torch.as_tensor(sample_input, device=device)
    try:
        with torch.no_grad(), tracer:
            traced(x)
    finally:
        for h in handles:
            h.remove()
    return ModuleGraph(tracer.nodes, tracer.modules)


# ---------------------------------------------------------------------------
# call classification: the torch calls of the JAX package's reshaping table
# ---------------------------------------------------------------------------

_RESHAPING = {
    "reshape", "view", "view_as", "flatten", "unflatten", "squeeze", "unsqueeze",
    "transpose", "t", "permute", "movedim", "moveaxis", "swapaxes", "swapdims",
    "contiguous", "to", "float", "double", "half", "bfloat16", "type", "type_as",
    "detach", "clone", "expand", "expand_as", "broadcast_to", "repeat_interleave",
    "narrow",
}


def _basic_index(index) -> bool:
    """Slices, integers, None and Ellipsis only (JAX's slice/squeeze);
    a tensor or list index is a gather."""
    items = index if isinstance(index, tuple) else (index,)
    return all(isinstance(i, (slice, int, type(None), type(Ellipsis))) for i in items)


def _classify_prim(node: GraphNode) -> str:
    """'reshaping' | 'stop': the one distinction SmoothQuant's regions
    read. The JAX package's 'invariant' and 'residual' classes serve
    cross-layer equalization, not ported yet."""
    if node.prim == "__getitem__":
        return "reshaping" if _basic_index(node.args[1]) else "stop"
    return "reshaping" if node.prim in _RESHAPING else "stop"


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
