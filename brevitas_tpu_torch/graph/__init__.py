"""Module-tree surgery, calibration, PTQ passes and integer-serving
conversion (port of ``brevitas_tpu/graph``)."""

from brevitas_tpu_torch.graph.autograph import (
    extract_act_equalization_regions,
    trace_module_graph,
)
from brevitas_tpu_torch.graph.awq import apply_awq
from brevitas_tpu_torch.graph.base import find_modules, get_module, named_modules, set_module
from brevitas_tpu_torch.graph.calibrate import calibration_mode, finalize_collect_stats
from brevitas_tpu_torch.graph.convert_int import convert_integer_inference
from brevitas_tpu_torch.graph.equalize import apply_act_equalization
from brevitas_tpu_torch.graph.gpfq import apply_gpfq
from brevitas_tpu_torch.graph.gptq import apply_gptq
from brevitas_tpu_torch.graph.rotate import (
    apply_rotation,
    hadamard_matrix,
    random_hadamard,
    transformer_rotation_pairs,
)

__all__ = ["named_modules", "get_module", "set_module", "find_modules", "calibration_mode",
           "finalize_collect_stats", "convert_integer_inference", "apply_act_equalization",
           "apply_gptq", "apply_gpfq", "apply_awq", "apply_rotation", "hadamard_matrix",
           "random_hadamard", "transformer_rotation_pairs", "trace_module_graph",
           "extract_act_equalization_regions"]
