"""A frozen, minimal ONNX protobuf writer: the benchmark writes its model
files itself, so the program under test never makes its own inputs.

Copied in substance from ``infera_tpu_torch/onnx/proto.py``'s writer (the
wire primitives, TensorProto, AttributeProto, NodeProto, ValueInfoProto,
GraphProto, ModelProto), cut to what the benchmark's models use. Field
numbers follow the public ONNX spec (onnx/onnx.proto3).
"""

from __future__ import annotations

import struct

import numpy as np

_VARINT, _LEN, _F32 = 0, 2, 5
FLOAT, INT64 = 1, 7                      # TensorProto.DataType
# AttributeProto.AttributeType
_A_FLOAT, _A_INT, _A_STRING, _A_FLOATS, _A_INTS, _A_STRINGS = 1, 2, 3, 6, 7, 8


def _varint(out: bytearray, v: int) -> None:
    if v < 0:
        v += 1 << 64
    while True:
        b = v & 0x7F
        v >>= 7
        if not v:
            out.append(b)
            return
        out.append(b | 0x80)


def _key(out: bytearray, fnum: int, wtype: int) -> None:
    _varint(out, (fnum << 3) | wtype)


def _len_field(out: bytearray, fnum: int, data: bytes) -> None:
    _key(out, fnum, _LEN)
    _varint(out, len(data))
    out.extend(data)


def _int_field(out: bytearray, fnum: int, v: int) -> None:
    _key(out, fnum, _VARINT)
    _varint(out, v)


def _str_field(out: bytearray, fnum: int, s: str) -> None:
    _len_field(out, fnum, s.encode("utf-8"))


def tensor(name: str, arr: np.ndarray) -> bytes:
    """A TensorProto of an f32 array, its payload as raw_data."""
    arr = np.ascontiguousarray(arr, np.float32)
    out = bytearray()
    for d in arr.shape:
        _int_field(out, 1, d)
    _int_field(out, 2, FLOAT)
    _str_field(out, 8, name)
    _len_field(out, 9, arr.tobytes())
    return bytes(out)


def attribute(name: str, value) -> bytes:
    """An AttributeProto of a float, int, string, or list of ints, floats or
    strings."""
    out = bytearray()
    _str_field(out, 1, name)
    if isinstance(value, float):
        kind = _A_FLOAT
        _key(out, 2, _F32)
        out.extend(struct.pack("<f", value))
    elif isinstance(value, int):
        kind = _A_INT
        _int_field(out, 3, value)
    elif isinstance(value, str):
        kind = _A_STRING
        _len_field(out, 4, value.encode("utf-8"))
    elif all(isinstance(v, str) for v in value):
        kind = _A_STRINGS
        for v in value:
            _len_field(out, 9, v.encode("utf-8"))
    elif all(isinstance(v, int) for v in value):
        kind = _A_INTS
        for v in value:
            _int_field(out, 8, v)
    else:
        kind = _A_FLOATS
        for v in value:
            _key(out, 7, _F32)
            out.extend(struct.pack("<f", float(v)))
    _int_field(out, 20, kind)
    return bytes(out)


def node(op_type: str, inputs: list, outputs: list, domain: str = "", **attrs) -> bytes:
    out = bytearray()
    for s in inputs:
        _str_field(out, 1, s)
    for s in outputs:
        _str_field(out, 2, s)
    _str_field(out, 4, op_type)
    for k, v in attrs.items():
        _len_field(out, 5, attribute(k, v))
    if domain:
        _str_field(out, 7, domain)
    return bytes(out)


def value_info(name: str, elem_type: int, shape: list) -> bytes:
    """A ValueInfoProto; a dimension below 0 is the symbolic batch."""
    dims = bytearray()
    for d in shape:
        dim = bytearray()
        if d < 0:
            _str_field(dim, 2, "batch")
        else:
            _int_field(dim, 1, d)
        _len_field(dims, 1, bytes(dim))
    tt = bytearray()
    _int_field(tt, 1, elem_type)
    _len_field(tt, 2, bytes(dims))
    typ = bytearray()
    _len_field(typ, 1, bytes(tt))
    out = bytearray()
    _str_field(out, 1, name)
    _len_field(out, 2, bytes(typ))
    return bytes(out)


def model(name: str, nodes: list, initializers: list, inputs: list, outputs: list,
          opsets: list) -> bytes:
    """A ModelProto (IR version 8) of one graph; ``opsets`` is a list of
    (domain, version)."""
    g = bytearray()
    for n in nodes:
        _len_field(g, 1, n)
    _str_field(g, 2, name)
    for t in initializers:
        _len_field(g, 5, t)
    for v in inputs:
        _len_field(g, 11, v)
    for v in outputs:
        _len_field(g, 12, v)
    out = bytearray()
    _int_field(out, 1, 8)
    _str_field(out, 2, "perfbench")
    _len_field(out, 7, bytes(g))
    for domain, version in opsets:
        op = bytearray()
        if domain:
            _str_field(op, 1, domain)
        _int_field(op, 2, version)
        _len_field(out, 8, bytes(op))
    return bytes(out)
