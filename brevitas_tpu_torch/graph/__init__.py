"""Module-tree surgery and integer-serving conversion (port of
``brevitas_tpu/graph``)."""

from brevitas_tpu_torch.graph.base import named_modules, set_module
from brevitas_tpu_torch.graph.convert_int import convert_integer_inference

__all__ = ["named_modules", "set_module", "convert_integer_inference"]
