"""Minimal, dependency-free ONNX protobuf codec.

The reference delegates ONNX parsing to the external `tract-onnx` crate
(upstream infera/src/engine.rs:49-55). We instead parse the protobuf
wire format directly: a small varint/length-delimited reader plus hand-written
message mappers for the subset of onnx.proto this framework consumes
(ModelProto / GraphProto / NodeProto / AttributeProto / TensorProto /
ValueInfoProto and friends). A matching writer lets the test suite and the
benchmark harness synthesize ONNX files without any external tooling.

Field numbers follow the public ONNX spec (onnx/onnx.proto3).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# ---------------------------------------------------------------------------
# Wire-format primitives
# ---------------------------------------------------------------------------

_WIRE_VARINT = 0
_WIRE_64BIT = 1
_WIRE_LEN = 2
_WIRE_32BIT = 5


class WireError(ValueError):
    pass


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise WireError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise WireError("varint too long")


def _zigzag_to_signed(v: int) -> int:
    # ONNX int64 fields use plain (two's complement) varints, not zigzag;
    # negative values arrive as 10-byte varints. Interpret as signed 64-bit.
    if v >= 1 << 63:
        v -= 1 << 64
    return v


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value, value_bytes) tuples.

    For _WIRE_LEN the value is the raw bytes; for varint it's the signed int;
    for fixed32/fixed64 the raw 4/8 bytes.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum = key >> 3
        wtype = key & 7
        if wtype == _WIRE_VARINT:
            v, pos = _read_varint(buf, pos)
            yield fnum, wtype, _zigzag_to_signed(v)
        elif wtype == _WIRE_LEN:
            ln, pos = _read_varint(buf, pos)
            if pos + ln > n:
                raise WireError("truncated length-delimited field")
            yield fnum, wtype, buf[pos : pos + ln]
            pos += ln
        elif wtype == _WIRE_32BIT:
            if pos + 4 > n:
                raise WireError("truncated fixed32")
            yield fnum, wtype, buf[pos : pos + 4]
            pos += 4
        elif wtype == _WIRE_64BIT:
            if pos + 8 > n:
                raise WireError("truncated fixed64")
            yield fnum, wtype, buf[pos : pos + 8]
            pos += 8
        else:
            raise WireError(f"unsupported wire type {wtype}")


def _packed_varints(data: bytes) -> list[int]:
    out = []
    pos = 0
    while pos < len(data):
        v, pos = _read_varint(data, pos)
        out.append(_zigzag_to_signed(v))
    return out


# --- writer primitives ---


def _w_varint(out: bytearray, v: int) -> None:
    if v < 0:
        v += 1 << 64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _w_key(out: bytearray, fnum: int, wtype: int) -> None:
    _w_varint(out, (fnum << 3) | wtype)


def _w_len_field(out: bytearray, fnum: int, data: bytes) -> None:
    _w_key(out, fnum, _WIRE_LEN)
    _w_varint(out, len(data))
    out.extend(data)


def _w_int_field(out: bytearray, fnum: int, v: int) -> None:
    _w_key(out, fnum, _WIRE_VARINT)
    _w_varint(out, v)


def _w_float_field(out: bytearray, fnum: int, v: float) -> None:
    _w_key(out, fnum, _WIRE_32BIT)
    out.extend(struct.pack("<f", v))


def _w_str_field(out: bytearray, fnum: int, s: str) -> None:
    _w_len_field(out, fnum, s.encode("utf-8"))


# ---------------------------------------------------------------------------
# ONNX data types
# ---------------------------------------------------------------------------

class DataType:
    UNDEFINED = 0
    FLOAT = 1
    UINT8 = 2
    INT8 = 3
    UINT16 = 4
    INT16 = 5
    INT32 = 6
    INT64 = 7
    STRING = 8
    BOOL = 9
    FLOAT16 = 10
    DOUBLE = 11
    UINT32 = 12
    UINT64 = 13
    BFLOAT16 = 16


_NP_DTYPES = {
    DataType.FLOAT: np.float32,
    DataType.UINT8: np.uint8,
    DataType.INT8: np.int8,
    DataType.UINT16: np.uint16,
    DataType.INT16: np.int16,
    DataType.INT32: np.int32,
    DataType.INT64: np.int64,
    DataType.BOOL: np.bool_,
    DataType.FLOAT16: np.float16,
    DataType.DOUBLE: np.float64,
    DataType.UINT32: np.uint32,
    DataType.UINT64: np.uint64,
}

_DT_FROM_NP = {np.dtype(v): k for k, v in _NP_DTYPES.items()}


def np_dtype_for(data_type: int):
    try:
        return _NP_DTYPES[data_type]
    except KeyError:
        raise WireError(f"unsupported ONNX tensor data_type {data_type}")


# ---------------------------------------------------------------------------
# Message classes
# ---------------------------------------------------------------------------

class AttrType:
    UNDEFINED = 0
    FLOAT = 1
    INT = 2
    STRING = 3
    TENSOR = 4
    GRAPH = 5
    FLOATS = 6
    INTS = 7
    STRINGS = 8
    TENSORS = 9
    GRAPHS = 10


@dataclass
class Tensor:
    name: str = ""
    dims: list = field(default_factory=list)
    data_type: int = DataType.FLOAT
    array: np.ndarray | None = None  # decoded payload

    @staticmethod
    def parse(buf: bytes) -> "Tensor":
        t = Tensor()
        float_data: list[float] = []
        int_data: list[int] = []
        double_data: list[float] = []
        raw: bytes | None = None
        for fnum, wtype, val in _iter_fields(buf):
            if fnum == 1:  # dims
                if wtype == _WIRE_VARINT:
                    t.dims.append(val)
                else:
                    t.dims.extend(_packed_varints(val))
            elif fnum == 2 and wtype == _WIRE_VARINT:
                t.data_type = val
            elif fnum == 4:  # float_data
                if wtype == _WIRE_32BIT:
                    float_data.append(struct.unpack("<f", val)[0])
                else:
                    float_data.extend(
                        struct.unpack(f"<{len(val) // 4}f", val)
                    )
            elif fnum in (5, 7):  # int32_data / int64_data
                if wtype == _WIRE_VARINT:
                    int_data.append(val)
                else:
                    int_data.extend(_packed_varints(val))
            elif fnum == 8 and wtype == _WIRE_LEN:
                t.name = val.decode("utf-8")
            elif fnum == 9 and wtype == _WIRE_LEN:
                raw = bytes(val)
            elif fnum == 10:  # double_data
                if wtype == _WIRE_64BIT:
                    double_data.append(struct.unpack("<d", val)[0])
                else:
                    double_data.extend(struct.unpack(f"<{len(val) // 8}d", val))
            # segment/external_data/string_data unsupported; ignored
        dtype = np_dtype_for(t.data_type)
        shape = tuple(t.dims)
        if raw is not None:
            arr = np.frombuffer(raw, dtype=dtype)
        elif float_data:
            arr = np.asarray(float_data, dtype=dtype)
        elif double_data:
            arr = np.asarray(double_data, dtype=dtype)
        elif int_data:
            arr = np.asarray(int_data, dtype=dtype)
        else:
            arr = np.zeros(int(np.prod(shape)) if shape else 0, dtype=dtype)
        t.array = arr.reshape(shape) if shape else arr.reshape(())
        return t

    @staticmethod
    def from_array(name: str, arr: np.ndarray) -> "Tensor":
        arr = np.asarray(arr)
        dt = _DT_FROM_NP.get(arr.dtype)
        if dt is None:
            raise WireError(f"unsupported numpy dtype {arr.dtype}")
        return Tensor(name=name, dims=list(arr.shape), data_type=dt, array=arr)

    def serialize(self) -> bytes:
        out = bytearray()
        for d in self.dims:
            _w_int_field(out, 1, d)
        _w_int_field(out, 2, self.data_type)
        _w_str_field(out, 8, self.name)
        assert self.array is not None
        _w_len_field(out, 9, np.ascontiguousarray(self.array).tobytes())
        return bytes(out)


@dataclass
class Attribute:
    name: str = ""
    type: int = AttrType.UNDEFINED
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: Tensor | None = None
    g: "Graph | None" = None  # subgraph (If branches, Loop/Scan bodies)
    floats: list = field(default_factory=list)
    ints: list = field(default_factory=list)
    strings: list = field(default_factory=list)
    graphs: list = field(default_factory=list)

    @property
    def value(self):
        if self.type == AttrType.FLOAT:
            return self.f
        if self.type == AttrType.INT:
            return self.i
        if self.type == AttrType.STRING:
            return self.s.decode("utf-8")
        if self.type == AttrType.TENSOR:
            return self.t
        if self.type == AttrType.GRAPH:
            return self.g
        if self.type == AttrType.FLOATS:
            return list(self.floats)
        if self.type == AttrType.INTS:
            return list(self.ints)
        if self.type == AttrType.STRINGS:
            return [s.decode("utf-8") for s in self.strings]
        if self.type == AttrType.GRAPHS:
            return list(self.graphs)
        return None

    @staticmethod
    def parse(buf: bytes) -> "Attribute":
        a = Attribute()
        for fnum, wtype, val in _iter_fields(buf):
            if fnum == 1 and wtype == _WIRE_LEN:
                a.name = val.decode("utf-8")
            elif fnum == 2 and wtype == _WIRE_32BIT:
                a.f = struct.unpack("<f", val)[0]
                if a.type == AttrType.UNDEFINED:
                    a.type = AttrType.FLOAT
            elif fnum == 3 and wtype == _WIRE_VARINT:
                a.i = val
                if a.type == AttrType.UNDEFINED:
                    a.type = AttrType.INT
            elif fnum == 4 and wtype == _WIRE_LEN:
                a.s = bytes(val)
                if a.type == AttrType.UNDEFINED:
                    a.type = AttrType.STRING
            elif fnum == 5 and wtype == _WIRE_LEN:
                a.t = Tensor.parse(val)
                if a.type == AttrType.UNDEFINED:
                    a.type = AttrType.TENSOR
            elif fnum == 6 and wtype == _WIRE_LEN:  # g (subgraph)
                a.g = Graph.parse(val)
                if a.type == AttrType.UNDEFINED:
                    a.type = AttrType.GRAPH
            elif fnum == 11 and wtype == _WIRE_LEN:  # graphs
                a.graphs.append(Graph.parse(val))
                a.type = AttrType.GRAPHS
            elif fnum == 7:  # floats
                if wtype == _WIRE_32BIT:
                    a.floats.append(struct.unpack("<f", val)[0])
                else:
                    a.floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
                a.type = AttrType.FLOATS
            elif fnum == 8:  # ints
                if wtype == _WIRE_VARINT:
                    a.ints.append(val)
                else:
                    a.ints.extend(_packed_varints(val))
                a.type = AttrType.INTS
            elif fnum == 9 and wtype == _WIRE_LEN:
                a.strings.append(bytes(val))
                a.type = AttrType.STRINGS
            elif fnum == 20 and wtype == _WIRE_VARINT:
                a.type = val
        return a

    def serialize(self) -> bytes:
        out = bytearray()
        _w_str_field(out, 1, self.name)
        if self.type == AttrType.FLOAT:
            _w_float_field(out, 2, self.f)
        elif self.type == AttrType.INT:
            _w_int_field(out, 3, self.i)
        elif self.type == AttrType.STRING:
            _w_len_field(out, 4, self.s)
        elif self.type == AttrType.TENSOR:
            assert self.t is not None
            _w_len_field(out, 5, self.t.serialize())
        elif self.type == AttrType.GRAPH:
            assert self.g is not None
            _w_len_field(out, 6, self.g.serialize())
        elif self.type == AttrType.GRAPHS:
            for g in self.graphs:
                _w_len_field(out, 11, g.serialize())
        elif self.type == AttrType.FLOATS:
            for v in self.floats:
                _w_float_field(out, 7, v)
        elif self.type == AttrType.INTS:
            for v in self.ints:
                _w_int_field(out, 8, v)
        elif self.type == AttrType.STRINGS:
            for s in self.strings:
                _w_len_field(out, 9, s)
        _w_int_field(out, 20, self.type)
        return bytes(out)

    @staticmethod
    def make(name: str, value) -> "Attribute":
        a = Attribute(name=name)
        if isinstance(value, float):
            a.type, a.f = AttrType.FLOAT, value
        elif isinstance(value, bool):
            a.type, a.i = AttrType.INT, int(value)
        elif isinstance(value, int):
            a.type, a.i = AttrType.INT, value
        elif isinstance(value, str):
            a.type, a.s = AttrType.STRING, value.encode("utf-8")
        elif isinstance(value, bytes):
            a.type, a.s = AttrType.STRING, value
        elif isinstance(value, Tensor):
            a.type, a.t = AttrType.TENSOR, value
        elif isinstance(value, Graph):
            a.type, a.g = AttrType.GRAPH, value
        elif isinstance(value, np.ndarray):
            a.type, a.t = AttrType.TENSOR, Tensor.from_array(name, value)
        elif isinstance(value, (list, tuple)):
            if all(isinstance(v, int) for v in value):
                a.type, a.ints = AttrType.INTS, list(value)
            elif all(isinstance(v, (int, float)) for v in value):
                a.type, a.floats = AttrType.FLOATS, [float(v) for v in value]
            elif all(isinstance(v, str) for v in value):
                a.type, a.strings = AttrType.STRINGS, [v.encode() for v in value]
            else:
                raise WireError(f"unsupported attribute list for {name}")
        else:
            raise WireError(f"unsupported attribute value {type(value)} for {name}")
        return a


@dataclass
class Node:
    op_type: str = ""
    inputs: list = field(default_factory=list)
    outputs: list = field(default_factory=list)
    name: str = ""
    domain: str = ""
    attributes: dict = field(default_factory=dict)

    @staticmethod
    def parse(buf: bytes) -> "Node":
        n = Node()
        for fnum, wtype, val in _iter_fields(buf):
            if fnum == 1 and wtype == _WIRE_LEN:
                n.inputs.append(val.decode("utf-8"))
            elif fnum == 2 and wtype == _WIRE_LEN:
                n.outputs.append(val.decode("utf-8"))
            elif fnum == 3 and wtype == _WIRE_LEN:
                n.name = val.decode("utf-8")
            elif fnum == 4 and wtype == _WIRE_LEN:
                n.op_type = val.decode("utf-8")
            elif fnum == 5 and wtype == _WIRE_LEN:
                a = Attribute.parse(val)
                n.attributes[a.name] = a
            elif fnum == 7 and wtype == _WIRE_LEN:
                n.domain = val.decode("utf-8")
        return n

    def attr(self, name: str, default=None):
        a = self.attributes.get(name)
        return default if a is None else a.value

    def serialize(self) -> bytes:
        out = bytearray()
        for s in self.inputs:
            _w_str_field(out, 1, s)
        for s in self.outputs:
            _w_str_field(out, 2, s)
        if self.name:
            _w_str_field(out, 3, self.name)
        _w_str_field(out, 4, self.op_type)
        for a in self.attributes.values():
            _w_len_field(out, 5, a.serialize())
        if self.domain:
            _w_str_field(out, 7, self.domain)
        return bytes(out)


@dataclass
class ValueInfo:
    name: str = ""
    elem_type: int = DataType.FLOAT
    # dims: int for fixed, -1 for symbolic/unknown (engine.rs:64-73 semantics)
    shape: list = field(default_factory=list)
    has_shape: bool = True

    @staticmethod
    def parse(buf: bytes) -> "ValueInfo":
        v = ValueInfo()
        for fnum, wtype, val in _iter_fields(buf):
            if fnum == 1 and wtype == _WIRE_LEN:
                v.name = val.decode("utf-8")
            elif fnum == 2 and wtype == _WIRE_LEN:
                v.elem_type, v.shape, v.has_shape = _parse_type_proto(val)
        return v

    def serialize(self) -> bytes:
        out = bytearray()
        _w_str_field(out, 1, self.name)
        _w_len_field(out, 2, _serialize_type_proto(self.elem_type, self.shape))
        return bytes(out)


def _parse_type_proto(buf: bytes) -> tuple[int, list, bool]:
    elem_type = DataType.FLOAT
    shape: list = []
    has_shape = False
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1 and wtype == _WIRE_LEN:  # tensor_type
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == _WIRE_VARINT:
                    elem_type = v2
                elif f2 == 2 and w2 == _WIRE_LEN:  # shape
                    has_shape = True
                    for f3, w3, v3 in _iter_fields(v2):
                        if f3 == 1 and w3 == _WIRE_LEN:  # dim
                            dim_val = -1
                            for f4, w4, v4 in _iter_fields(v3):
                                if f4 == 1 and w4 == _WIRE_VARINT:
                                    dim_val = v4
                                # dim_param (f4==2) stays -1 (dynamic)
                            shape.append(dim_val)
    return elem_type, shape, has_shape


def _serialize_type_proto(elem_type: int, shape: list) -> bytes:
    shape_buf = bytearray()
    for d in shape:
        dim_buf = bytearray()
        if d is None or d < 0:
            _w_str_field(dim_buf, 2, "batch")  # dim_param
        else:
            _w_int_field(dim_buf, 1, d)
        _w_len_field(shape_buf, 1, bytes(dim_buf))
    tt = bytearray()
    _w_int_field(tt, 1, elem_type)
    _w_len_field(tt, 2, bytes(shape_buf))
    out = bytearray()
    _w_len_field(out, 1, bytes(tt))
    return bytes(out)


@dataclass
class Graph:
    name: str = ""
    nodes: list = field(default_factory=list)
    initializers: dict = field(default_factory=dict)  # name -> Tensor
    inputs: list = field(default_factory=list)  # ValueInfo
    outputs: list = field(default_factory=list)  # ValueInfo

    @staticmethod
    def parse(buf: bytes) -> "Graph":
        g = Graph()
        for fnum, wtype, val in _iter_fields(buf):
            if fnum == 1 and wtype == _WIRE_LEN:
                g.nodes.append(Node.parse(val))
            elif fnum == 2 and wtype == _WIRE_LEN:
                g.name = val.decode("utf-8")
            elif fnum == 5 and wtype == _WIRE_LEN:
                t = Tensor.parse(val)
                g.initializers[t.name] = t
            elif fnum == 11 and wtype == _WIRE_LEN:
                g.inputs.append(ValueInfo.parse(val))
            elif fnum == 12 and wtype == _WIRE_LEN:
                g.outputs.append(ValueInfo.parse(val))
        return g

    def serialize(self) -> bytes:
        out = bytearray()
        for n in self.nodes:
            _w_len_field(out, 1, n.serialize())
        _w_str_field(out, 2, self.name)
        for t in self.initializers.values():
            _w_len_field(out, 5, t.serialize())
        for v in self.inputs:
            _w_len_field(out, 11, v.serialize())
        for v in self.outputs:
            _w_len_field(out, 12, v.serialize())
        return bytes(out)


@dataclass
class Model:
    ir_version: int = 8
    opset_imports: list = field(default_factory=lambda: [("", 17)])
    producer_name: str = "infera_tpu"
    graph: Graph = field(default_factory=Graph)

    @staticmethod
    def parse(buf: bytes) -> "Model":
        m = Model()
        m.opset_imports = []
        for fnum, wtype, val in _iter_fields(buf):
            if fnum == 1 and wtype == _WIRE_VARINT:
                m.ir_version = val
            elif fnum == 2 and wtype == _WIRE_LEN:
                m.producer_name = val.decode("utf-8", "replace")
            elif fnum == 7 and wtype == _WIRE_LEN:
                m.graph = Graph.parse(val)
            elif fnum == 8 and wtype == _WIRE_LEN:
                domain, version = "", 1
                for f2, w2, v2 in _iter_fields(val):
                    if f2 == 1 and w2 == _WIRE_LEN:
                        domain = v2.decode("utf-8")
                    elif f2 == 2 and w2 == _WIRE_VARINT:
                        version = v2
                m.opset_imports.append((domain, version))
        if not m.opset_imports:
            m.opset_imports = [("", 17)]
        return m

    def serialize(self) -> bytes:
        out = bytearray()
        _w_int_field(out, 1, self.ir_version)
        _w_str_field(out, 2, self.producer_name)
        _w_len_field(out, 7, self.graph.serialize())
        for domain, version in self.opset_imports:
            op = bytearray()
            if domain:
                _w_str_field(op, 1, domain)
            _w_int_field(op, 2, version)
            _w_len_field(out, 8, bytes(op))
        return bytes(out)


def load_model_bytes(data: bytes) -> Model:
    try:
        return Model.parse(data)
    except WireError as e:
        raise WireError(f"invalid ONNX protobuf: {e}")


def load_model_file(path) -> Model:
    with open(path, "rb") as f:
        return load_model_bytes(f.read())


def save_model_file(model: Model, path) -> None:
    with open(path, "wb") as f:
        f.write(model.serialize())
