"""Structural validation of emitted ONNX ModelProto bytes (the port's own
copy of ``brevitas_tpu/export/validate.py``).

The reference's export tier uses onnxruntime as an external oracle
(``tests/brevitas_ort/common.py:37``): a malformed protobuf
would fail to load there. The port depends on neither onnx nor onnxruntime, so this
module is a clean-room, WRITER-INDEPENDENT decoder that checks the raw bytes
against the onnx.proto schema (field numbers, wire types, message nesting,
enum ranges, tensor payload sizes) plus graph-level semantics (dangling node
inputs, duplicate value names, missing opset imports). It deliberately
shares no code with the emitter (`onnx_proto.py`) — it walks the wire
format with its own varint reader, so a wrong tag, truncated length or
mistyped field the interpreter would shrug at fails here.

Schema source: the public onnx.proto3 definition (onnx IR version 8).
"""

from typing import List, Optional, Tuple

__all__ = ["validate_onnx", "OnnxValidationError"]


class OnnxValidationError(ValueError):
    pass


def _fail(msg: str):
    raise OnnxValidationError(msg)


# wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5

# TensorProto.DataType → element byte-size (None = unchecked/packed)
_DTYPE_SIZES = {
    1: 4,   # FLOAT
    2: 1,   # UINT8
    3: 1,   # INT8
    4: 2,   # UINT16
    5: 2,   # INT16
    6: 4,   # INT32
    7: 8,   # INT64
    9: 1,   # BOOL
    10: 2,  # FLOAT16
    11: 8,  # DOUBLE
    12: 4,  # UINT32
    13: 8,  # UINT64
    16: 2,  # BFLOAT16
}

# AttributeProto.AttributeType values
_ATTR_TYPES = {1: "FLOAT", 2: "INT", 3: "STRING", 4: "TENSOR", 5: "GRAPH",
               6: "FLOATS", 7: "INTS", 8: "STRINGS", 9: "TENSORS",
               10: "GRAPHS", 11: "SPARSE_TENSOR", 13: "TYPE_PROTO"}

# attribute type → the payload field(s) that must be present
_ATTR_PAYLOAD = {1: {2}, 2: {3}, 3: {4}, 4: {5}, 5: {6},
                 6: {7}, 7: {8}, 8: {9}, 9: {10}, 10: {11}}


def _read_varint(buf: memoryview, pos: int, what: str) -> Tuple[int, int]:
    result = shift = 0
    start = pos
    while True:
        if pos >= len(buf):
            _fail(f"truncated varint in {what} at byte {start}")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            _fail(f"varint overflow in {what} at byte {start}")


def _fields(buf: memoryview, what: str):
    """Yield (field_number, wire_type, payload) with length/format checks."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos, what)
        field, wire = key >> 3, key & 7
        if field == 0:
            _fail(f"field number 0 in {what}")
        if wire == _VARINT:
            val, pos = _read_varint(buf, pos, f"{what}.{field}")
        elif wire == _I64:
            if pos + 8 > len(buf):
                _fail(f"truncated fixed64 in {what}.{field}")
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wire == _LEN:
            ln, pos = _read_varint(buf, pos, f"{what}.{field} length")
            if pos + ln > len(buf):
                _fail(f"length-delimited field {what}.{field} overruns "
                      f"buffer ({ln} bytes at {pos}, have {len(buf)})")
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == _I32:
            if pos + 4 > len(buf):
                _fail(f"truncated fixed32 in {what}.{field}")
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            _fail(f"illegal wire type {wire} in {what} (field {field})")
        yield field, wire, val


def _expect(wire: int, want: int, what: str):
    if wire != want:
        _fail(f"{what}: wire type {wire}, schema says {want}")


def _utf8(val, what: str) -> str:
    try:
        return bytes(val).decode("utf-8")
    except UnicodeDecodeError:
        _fail(f"{what}: invalid UTF-8")


def _check_tensor(buf: memoryview, what: str) -> Optional[str]:
    """TensorProto{name=8, dims=1, data_type=2, raw_data=9, float_data=4,
    int32_data=5, int64_data=7, ...}. Returns the tensor name."""
    name = None
    dims: List[int] = []
    data_type = None
    raw_len = None
    packed = 0
    for field, wire, val in _fields(buf, what):
        if field == 1:
            if wire == _LEN:  # packed repeated
                p = 0
                while p < len(val):
                    d, p = _read_varint(val, p, f"{what}.dims")
                    dims.append(d)
            else:
                _expect(wire, _VARINT, f"{what}.dims")
                dims.append(val)
        elif field == 2:
            _expect(wire, _VARINT, f"{what}.data_type")
            data_type = val
        elif field == 8:
            _expect(wire, _LEN, f"{what}.name")
            name = _utf8(val, f"{what}.name")
        elif field == 9:
            _expect(wire, _LEN, f"{what}.raw_data")
            raw_len = len(val)
        elif field in (4, 5, 6, 7, 10, 11):  # typed repeated payloads
            packed += len(val) if wire == _LEN else 1
        elif field in (12, 13, 14, 16):  # extern/string/double/location
            pass
        else:
            _fail(f"{what}: unknown TensorProto field {field}")
    if data_type is None:
        _fail(f"{what}: missing data_type")
    if data_type not in _DTYPE_SIZES and data_type not in (8, 14, 15, 17, 18):
        _fail(f"{what}: invalid data_type {data_type}")
    n_elems = 1
    for d in dims:
        if d < 0:
            _fail(f"{what}: negative dim {d}")
        n_elems *= d
    if raw_len is not None:
        size = _DTYPE_SIZES.get(data_type)
        if size is not None and raw_len != n_elems * size:
            _fail(f"{what} ({name}): raw_data is {raw_len} bytes but "
                  f"dims {dims} × {size}-byte dtype {data_type} need "
                  f"{n_elems * size}")
    return name


def _check_attribute(buf: memoryview, what: str) -> str:
    name = None
    atype = None
    payload_fields = set()
    for field, wire, val in _fields(buf, what):
        if field == 1:
            _expect(wire, _LEN, f"{what}.name")
            name = _utf8(val, f"{what}.name")
        elif field == 20:
            _expect(wire, _VARINT, f"{what}.type")
            atype = val
        elif field == 2:
            _expect(wire, _I32, f"{what}.f")
            payload_fields.add(2)
        elif field == 3:
            _expect(wire, _VARINT, f"{what}.i")
            payload_fields.add(3)
        elif field == 4:
            _expect(wire, _LEN, f"{what}.s")
            payload_fields.add(4)
        elif field == 5:
            _expect(wire, _LEN, f"{what}.t")
            _check_tensor(val, f"{what}.t")
            payload_fields.add(5)
        elif field == 6:
            _expect(wire, _LEN, f"{what}.g")
            payload_fields.add(6)
        elif field == 7:
            payload_fields.add(7)  # repeated float (packed or not)
        elif field == 8:
            payload_fields.add(8)  # repeated int
        elif field == 9:
            _expect(wire, _LEN, f"{what}.strings")
            payload_fields.add(9)
        elif field in (10, 11, 13, 21, 23):
            payload_fields.add(field)
        else:
            _fail(f"{what}: unknown AttributeProto field {field}")
    if name is None:
        _fail(f"{what}: attribute without name")
    if atype is None:
        _fail(f"{what} ({name}): attribute without type tag")
    if atype not in _ATTR_TYPES:
        _fail(f"{what} ({name}): invalid attribute type {atype}")
    want = _ATTR_PAYLOAD.get(atype)
    if want and not (payload_fields & want):
        _fail(f"{what} ({name}): type {_ATTR_TYPES[atype]} but payload "
              f"fields {sorted(payload_fields)} lack {sorted(want)}")
    return name


def _check_value_info(buf: memoryview, what: str) -> str:
    name = None
    has_type = False
    for field, wire, val in _fields(buf, what):
        if field == 1:
            _expect(wire, _LEN, f"{what}.name")
            name = _utf8(val, f"{what}.name")
        elif field == 2:
            _expect(wire, _LEN, f"{what}.type")
            has_type = True
            for f2, w2, v2 in _fields(val, f"{what}.type"):
                if f2 == 1:  # tensor_type
                    elem = None
                    for f3, w3, v3 in _fields(v2, f"{what}.tensor_type"):
                        if f3 == 1:
                            _expect(w3, _VARINT, f"{what}.elem_type")
                            elem = v3
                        elif f3 == 2:
                            pass  # shape
                        else:
                            _fail(f"{what}: unknown TypeProto.Tensor "
                                  f"field {f3}")
                    if elem is None:
                        _fail(f"{what}: tensor type without elem_type")
                elif f2 in (4, 5, 6, 8, 9):
                    pass  # sequence/map/opt/sparse/denotation
                else:
                    _fail(f"{what}: unknown TypeProto field {f2}")
        elif field == 3:
            pass  # doc_string
        else:
            _fail(f"{what}: unknown ValueInfoProto field {field}")
    if name is None:
        _fail(f"{what}: value_info without name")
    if not has_type:
        _fail(f"{what} ({name}): value_info without type")
    return name


def _check_node(buf: memoryview, what: str):
    op_type = None
    inputs: List[str] = []
    outputs: List[str] = []
    for field, wire, val in _fields(buf, what):
        if field == 1:
            _expect(wire, _LEN, f"{what}.input")
            inputs.append(_utf8(val, f"{what}.input"))
        elif field == 2:
            _expect(wire, _LEN, f"{what}.output")
            outputs.append(_utf8(val, f"{what}.output"))
        elif field == 3:
            _expect(wire, _LEN, f"{what}.name")
        elif field == 4:
            _expect(wire, _LEN, f"{what}.op_type")
            op_type = _utf8(val, f"{what}.op_type")
        elif field == 5:
            _expect(wire, _LEN, f"{what}.attribute")
            _check_attribute(val, f"{what}.attr")
        elif field == 6:
            pass  # doc_string
        elif field == 7:
            _expect(wire, _LEN, f"{what}.domain")
        else:
            _fail(f"{what}: unknown NodeProto field {field}")
    if op_type is None:
        _fail(f"{what}: node without op_type")
    if not outputs:
        _fail(f"{what} ({op_type}): node without outputs")
    return op_type, inputs, outputs


def _check_graph(buf: memoryview, what: str):
    nodes = []
    initializer_names: List[str] = []
    input_names: List[str] = []
    output_names: List[str] = []
    for field, wire, val in _fields(buf, what):
        if field == 1:
            _expect(wire, _LEN, f"{what}.node")
            nodes.append(_check_node(val, f"{what}.node[{len(nodes)}]"))
        elif field == 2:
            _expect(wire, _LEN, f"{what}.name")
        elif field == 5:
            _expect(wire, _LEN, f"{what}.initializer")
            name = _check_tensor(val, f"{what}.initializer")
            if name is None:
                _fail(f"{what}: initializer without name")
            initializer_names.append(name)
        elif field == 10:
            pass  # doc_string
        elif field == 11:
            _expect(wire, _LEN, f"{what}.input")
            input_names.append(_check_value_info(val, f"{what}.input"))
        elif field == 12:
            _expect(wire, _LEN, f"{what}.output")
            output_names.append(_check_value_info(val, f"{what}.output"))
        elif field == 13:
            _check_value_info(val, f"{what}.value_info")
        elif field == 14:  # quantization_annotation (TensorAnnotation)
            _expect(wire, _LEN, f"{what}.quantization_annotation")
            saw_name = False
            for f2, w2, v2 in _fields(val, f"{what}.annotation"):
                if f2 == 1:
                    saw_name = True
                elif f2 == 2:
                    for f3, w3, v3 in _fields(v2, f"{what}.annotation.kv"):
                        if f3 not in (1, 2):
                            _fail(f"{what}: StringStringEntry field {f3}")
                else:
                    _fail(f"{what}: unknown TensorAnnotation field {f2}")
            if not saw_name:
                _fail(f"{what}: annotation without tensor_name")
        elif field == 15:
            pass  # sparse_initializer
        else:
            _fail(f"{what}: unknown GraphProto field {field}")

    # -- graph semantics ----------------------------------------------------
    if not output_names:
        _fail(f"{what}: graph without outputs")
    dupes = {n for n in initializer_names
             if initializer_names.count(n) > 1}
    if dupes:
        _fail(f"{what}: duplicate initializer names {sorted(dupes)[:3]}")
    known = set(initializer_names) | set(input_names)
    for idx, (op, ins, outs) in enumerate(nodes):
        for name in ins:
            if name and name not in known:
                _fail(f"{what}.node[{idx}] ({op}): input '{name}' is not a "
                      "graph input, initializer or earlier node output")
        for name in outs:
            known.add(name)
    for name in output_names:
        if name not in known:
            _fail(f"{what}: graph output '{name}' is never produced")


def validate_onnx(model_bytes: bytes) -> None:
    """Validate a serialized ModelProto; raises OnnxValidationError."""
    buf = memoryview(model_bytes)
    saw_graph = False
    saw_ir = False
    opset_domains: List[str] = []
    for field, wire, val in _fields(buf, "model"):
        if field == 1:
            _expect(wire, _VARINT, "model.ir_version")
            if not 3 <= val <= 12:
                _fail(f"model.ir_version {val} out of the known range")
            saw_ir = True
        elif field in (2, 3, 5, 6):  # producer_name/version, domain, doc
            _expect(wire, _LEN if field != 5 else wire, f"model.{field}")
        elif field == 4:
            _expect(wire, _VARINT, "model.model_version")
        elif field == 7:
            _expect(wire, _LEN, "model.graph")
            _check_graph(val, "graph")
            saw_graph = True
        elif field == 8:
            _expect(wire, _LEN, "model.opset_import")
            domain = ""
            version = None
            for f2, w2, v2 in _fields(val, "model.opset_import"):
                if f2 == 1:
                    domain = _utf8(v2, "opset.domain")
                elif f2 == 2:
                    _expect(w2, _VARINT, "opset.version")
                    version = v2
                else:
                    _fail(f"unknown OperatorSetId field {f2}")
            if version is None:
                _fail("opset_import without version")
            opset_domains.append(domain)
        elif field == 14:
            pass  # metadata_props
        else:
            _fail(f"unknown ModelProto field {field}")
    if not saw_ir:
        _fail("model missing ir_version")
    if not saw_graph:
        _fail("model missing graph")
    if "" not in opset_domains:
        _fail("model missing the default-domain opset import")
