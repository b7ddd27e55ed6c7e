"""Export (port of ``brevitas_tpu/export/``): the same public names.

- :func:`export_onnx_qcdq`: QuantizeLinear/Clip/DequantizeLinear graphs.
- :func:`export_qonnx`: QONNX ``Quant``-op graphs for the FINN flow.
- :func:`export_onnx_qop`: QLinearConv/QLinearMatMul graphs.
- :func:`export_finn_onnx`: the FINN dialect (MultiThreshold activations,
  integer weights with ``finn_datatype`` annotations).
- :func:`export_torch_qcdq` / :func:`export_torch_qop`: TorchScript.
- :func:`export_native` / :func:`load_native`: the integer serving
  artifact, in the JAX package's layout.

The bytes are written by the port's own protobuf emitter and checked by its
own schema validator (:func:`validate_onnx`) and numpy interpreter
(:func:`run_onnx`), the test oracle; no onnx package is needed.
"""

from brevitas_tpu_torch.export.interp import run_onnx
from brevitas_tpu_torch.export.native import export_native, load_native
from brevitas_tpu_torch.export.qcdq import debug_probe_names, export_model
from brevitas_tpu_torch.export.validate import OnnxValidationError, validate_onnx


def export_brevitas_onnx(model, example_input, path=None, **kw) -> bytes:
    """The reference's deprecated alias of QONNX export."""
    return export_model(model, example_input, path, style="qonnx", **kw)


def export_onnx_qcdq(model, example_input, path=None, **kw) -> bytes:
    return export_model(model, example_input, path, style="qcdq", **kw)


def export_qonnx(model, example_input, path=None, **kw) -> bytes:
    return export_model(model, example_input, path, style="qonnx", **kw)


def export_onnx_qop(model, example_input, path=None, **kw) -> bytes:
    """QOperator dialect: the WBIOL layers become integer QLinearConv /
    QLinearMatMul nodes with an int32 bias; other layers keep QCDQ form."""
    return export_model(model, example_input, path, style="qop", **kw)


def export_finn_onnx(model, example_input, path=None, **kw) -> bytes:
    """FINN dialect (reference export_finn_onnx -> FINNManager)."""
    from brevitas_tpu_torch.export.finn import export_finn_onnx as fn

    return fn(model, example_input, path, **kw)


def export_torch_qcdq(model, example_input, path=None):
    """TorchScript QCDQ, traced on the model's device."""
    from brevitas_tpu_torch.export.torch_backend import export_torch_qcdq as fn

    return fn(model, example_input, path)


def export_torch_qop(model, example_input, path=None):
    """TorchScript on ``torch.ao.nn.quantized`` modules, traced on the host."""
    from brevitas_tpu_torch.export.torch_backend import export_torch_qop as fn

    return fn(model, example_input, path)


__all__ = ["export_onnx_qcdq", "export_onnx_qop", "export_qonnx",
           "export_finn_onnx", "export_torch_qcdq", "export_torch_qop",
           "export_native", "load_native", "run_onnx", "export_model",
           "export_brevitas_onnx", "debug_probe_names",
           "validate_onnx", "OnnxValidationError"]
