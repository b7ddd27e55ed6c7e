"""Module-tree surgery, calibration, PTQ passes and integer-serving
conversion (port of ``brevitas_tpu/graph``)."""

from brevitas_tpu_torch.graph.autograph import (
    extract_act_equalization_regions,
    extract_regions,
    find_bn_pairs,
    trace_module_graph,
)
from brevitas_tpu_torch.graph.awq import apply_awq
from brevitas_tpu_torch.graph.base import (
    find_modules,
    get_module,
    named_modules,
    replace_modules_by_class,
    set_module,
)
from brevitas_tpu_torch.graph.calibrate import (
    bias_correction_mode,
    cache_inference_quant_weights,
    calibration_mode,
    clear_inference_quant_weight_cache,
    clip_float_weights,
    finalize_collect_stats,
)
from brevitas_tpu_torch.graph.convert_int import convert_integer_inference
from brevitas_tpu_torch.graph.equalize import (
    apply_act_equalization,
    cross_layer_equalization,
    equalize,
    sequential_regions,
)
from brevitas_tpu_torch.graph.flexml import preprocess_flexml, quantize_flexml
from brevitas_tpu_torch.graph.gpfq import apply_gpfq
from brevitas_tpu_torch.graph.gptq import apply_gptq
from brevitas_tpu_torch.graph.learned_round import apply_learned_round
from brevitas_tpu_torch.graph.quantize import (
    discover_bn_pairs,
    merge_batchnorms,
    quantize,
    refresh_weight_quantizers,
)
from brevitas_tpu_torch.graph.rotate import (
    apply_rotation,
    hadamard_matrix,
    random_hadamard,
    transformer_rotation_pairs,
)
from brevitas_tpu_torch.graph.standardize import (
    disable_last_return_quant_tensor,
    duplicate_shared_stateless_modules,
)

__all__ = ["named_modules", "get_module", "set_module", "find_modules",
           "replace_modules_by_class", "calibration_mode", "finalize_collect_stats",
           "bias_correction_mode", "cache_inference_quant_weights",
           "clear_inference_quant_weight_cache", "clip_float_weights",
           "convert_integer_inference", "apply_act_equalization", "cross_layer_equalization",
           "equalize", "sequential_regions", "preprocess_flexml", "quantize_flexml",
           "apply_gptq", "apply_gpfq", "apply_awq", "apply_learned_round", "quantize",
           "discover_bn_pairs", "merge_batchnorms", "refresh_weight_quantizers",
           "apply_rotation", "hadamard_matrix", "random_hadamard",
           "transformer_rotation_pairs", "trace_module_graph", "find_bn_pairs",
           "extract_regions", "extract_act_equalization_regions",
           "duplicate_shared_stateless_modules", "disable_last_return_quant_tensor"]
