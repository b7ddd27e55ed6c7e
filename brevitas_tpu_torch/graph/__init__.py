"""Module-tree surgery, calibration and integer-serving conversion (port of
``brevitas_tpu/graph``)."""

from brevitas_tpu_torch.graph.base import named_modules, set_module
from brevitas_tpu_torch.graph.calibrate import calibration_mode, finalize_collect_stats
from brevitas_tpu_torch.graph.convert_int import convert_integer_inference

__all__ = ["named_modules", "set_module", "calibration_mode", "finalize_collect_stats",
           "convert_integer_inference"]
