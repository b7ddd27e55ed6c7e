"""Self-contained ONNX protobuf emitter (no ``onnx`` dependency): the port's
own copy of ``brevitas_tpu/export/onnx_proto.py``, byte for byte the same
wire format.

The port needs no onnx/onnxruntime packages, so this module serializes
ONNX ModelProto directly in protobuf wire format (varint tags +
length-delimited submessages) using the public onnx.proto field numbers. Only
the subset needed for QCDQ/QONNX graphs is implemented, plus a matching
reader used by tests as a numerical oracle (the role onnxruntime plays in the
reference's tests/brevitas_ort).
"""

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# protobuf wire-format primitives
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def f_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def f_bytes(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def f_string(field: int, value: str) -> bytes:
    return f_bytes(field, value.encode())


def f_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


# ---------------------------------------------------------------------------
# ONNX data types (onnx.proto TensorProto.DataType)
# ---------------------------------------------------------------------------

FLOAT, UINT8, INT8, INT32, INT64, BOOL, FLOAT16, DOUBLE = 1, 2, 3, 6, 7, 9, 10, 11

_NP_TO_ONNX = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.uint8): UINT8,
    np.dtype(np.int8): INT8,
    np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64,
    np.dtype(np.bool_): BOOL,
    np.dtype(np.float64): DOUBLE,
}
_ONNX_TO_NP = {v: k for k, v in _NP_TO_ONNX.items()}


def tensor_proto(name: str, array: np.ndarray) -> bytes:
    """TensorProto{dims=1, data_type=2, name=8, raw_data=9}."""
    array = np.ascontiguousarray(array)
    dt = _NP_TO_ONNX[array.dtype]
    msg = b""
    for d in array.shape:
        msg += f_varint(1, d)
    msg += f_varint(2, dt)
    msg += f_string(8, name)
    msg += f_bytes(9, array.tobytes())
    return msg


def _type_proto(elem_type: int, shape: Sequence[Optional[int]]) -> bytes:
    dims = b""
    for d in shape:
        if d is None:
            dims += f_bytes(1, f_string(2, "N"))  # Dim{dim_param=2}
        else:
            dims += f_bytes(1, f_varint(1, int(d)))  # Dim{dim_value=1}
    shape_msg = dims  # TensorShapeProto{dim=1}
    tensor_type = f_varint(1, elem_type) + f_bytes(2, shape_msg)
    return f_bytes(1, tensor_type)  # TypeProto{tensor_type=1}


def value_info(name: str, elem_type: int, shape: Sequence[Optional[int]]) -> bytes:
    """ValueInfoProto{name=1, type=2}."""
    return f_string(1, name) + f_bytes(2, _type_proto(elem_type, shape))


# AttributeProto.AttributeType
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR = 1, 2, 3, 4
ATTR_FLOATS, ATTR_INTS = 6, 7


def attribute(name: str, value) -> bytes:
    """AttributeProto{name=1, f=2, i=3, s=4, t=5, floats=7, ints=8, type=20}."""
    msg = f_string(1, name)
    if isinstance(value, bool):
        msg += f_varint(3, int(value)) + f_varint(20, ATTR_INT)
    elif isinstance(value, int):
        msg += f_varint(3, value) + f_varint(20, ATTR_INT)
    elif isinstance(value, float):
        msg += f_float(2, value) + f_varint(20, ATTR_FLOAT)
    elif isinstance(value, str):
        msg += f_bytes(4, value.encode()) + f_varint(20, ATTR_STRING)
    elif isinstance(value, np.ndarray):
        msg += f_bytes(5, tensor_proto(name + "_value", value))
        msg += f_varint(20, ATTR_TENSOR)
    elif isinstance(value, (list, tuple)) and value and isinstance(value[0], float):
        for v in value:
            msg += f_float(7, v)
        msg += f_varint(20, ATTR_FLOATS)
    elif isinstance(value, (list, tuple)):
        for v in value:
            msg += f_varint(8, int(v))
        msg += f_varint(20, ATTR_INTS)
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return msg


def node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
         name: str = "", domain: str = "", **attrs) -> bytes:
    """NodeProto{input=1, output=2, name=3, op_type=4, attribute=5, domain=7}."""
    msg = b""
    for i in inputs:
        msg += f_string(1, i)
    for o in outputs:
        msg += f_string(2, o)
    msg += f_string(3, name or outputs[0])
    msg += f_string(4, op_type)
    for k, v in attrs.items():
        msg += f_bytes(5, attribute(k, v))
    if domain:
        msg += f_string(7, domain)
    return msg


def graph(nodes: Sequence[bytes], name: str, inputs: Sequence[bytes],
          outputs: Sequence[bytes], initializers: Sequence[bytes]) -> bytes:
    """GraphProto{node=1, name=2, initializer=5, input=11, output=12}."""
    msg = b""
    for n in nodes:
        msg += f_bytes(1, n)
    msg += f_string(2, name)
    for ini in initializers:
        msg += f_bytes(5, ini)
    for i in inputs:
        msg += f_bytes(11, i)
    for o in outputs:
        msg += f_bytes(12, o)
    return msg


def model(graph_msg: bytes, opset: int = 13,
          custom_domains: Sequence[Tuple[str, int]] = (),
          producer: str = "brevitas_tpu") -> bytes:
    """ModelProto{ir_version=1, producer_name=2, graph=7, opset_import=8}.
    The producer name is the JAX package's, so both packages write the same
    bytes for the same graph."""
    msg = f_varint(1, 8)  # IR version 8
    msg += f_string(2, producer)
    msg += f_bytes(7, graph_msg)
    msg += f_bytes(8, f_varint(2, opset))  # OperatorSetIdProto{domain=1,version=2}
    for dom, ver in custom_domains:
        msg += f_bytes(8, f_string(1, dom) + f_varint(2, ver))
    return msg


# ---------------------------------------------------------------------------
# minimal reader (test oracle)
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _read_fields(buf: bytes):
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        elif wire == 1:
            val = struct.unpack("<d", buf[pos:pos + 8])[0]
            pos += 8
        else:
            raise ValueError(f"wire type {wire}")
        yield field, wire, val


def parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims, dtype, name, raw = [], FLOAT, "", b""
    for field, wire, val in _read_fields(buf):
        if field == 1:
            dims.append(val)
        elif field == 2:
            dtype = val
        elif field == 8:
            name = val.decode()
        elif field == 9:
            raw = val
    arr = np.frombuffer(raw, dtype=_ONNX_TO_NP[dtype]).reshape(dims)
    return name, arr


def parse_attribute(buf: bytes):
    name, value = "", None
    fields = list(_read_fields(buf))
    atype = next((v for f, _, v in fields if f == 20), None)
    for field, wire, val in fields:
        if field == 1:
            name = val.decode()
        elif field == 2 and atype == ATTR_FLOAT:
            value = val
        elif field == 3 and atype == ATTR_INT:
            # sign-extend 64-bit two's-complement varints
            value = val - (1 << 64) if val >= (1 << 63) else val
        elif field == 4 and atype == ATTR_STRING:
            value = val.decode()
        elif field == 5 and atype == ATTR_TENSOR:
            value = parse_tensor(val)[1]
        elif field == 7 and atype == ATTR_FLOATS:
            value = (value or []) + [val]
        elif field == 8 and atype == ATTR_INTS:
            value = (value or []) + [val]
    return name, value


class OnnxNode:
    def __init__(self):
        self.op_type = ""
        self.name = ""
        self.domain = ""
        self.inputs: List[str] = []
        self.outputs: List[str] = []
        self.attrs: Dict[str, object] = {}


class OnnxGraph:
    def __init__(self):
        self.name = ""
        self.nodes: List[OnnxNode] = []
        self.initializers: Dict[str, np.ndarray] = {}
        self.inputs: List[str] = []
        self.outputs: List[str] = []


def parse_model(buf: bytes) -> OnnxGraph:
    graph_buf = None
    for field, wire, val in _read_fields(buf):
        if field == 7:
            graph_buf = val
    assert graph_buf is not None, "no graph in model"
    g = OnnxGraph()
    for field, wire, val in _read_fields(graph_buf):
        if field == 1:
            n = OnnxNode()
            for f2, w2, v2 in _read_fields(val):
                if f2 == 1:
                    n.inputs.append(v2.decode())
                elif f2 == 2:
                    n.outputs.append(v2.decode())
                elif f2 == 3:
                    n.name = v2.decode()
                elif f2 == 4:
                    n.op_type = v2.decode()
                elif f2 == 5:
                    k, v = parse_attribute(v2)
                    n.attrs[k] = v
                elif f2 == 7:
                    n.domain = v2.decode()
            g.nodes.append(n)
        elif field == 2:
            g.name = val.decode()
        elif field == 5:
            name, arr = parse_tensor(val)
            g.initializers[name] = arr
        elif field == 11:
            for f2, w2, v2 in _read_fields(val):
                if f2 == 1:
                    g.inputs.append(v2.decode())
        elif field == 12:
            for f2, w2, v2 in _read_fields(val):
                if f2 == 1:
                    g.outputs.append(v2.decode())
    return g
