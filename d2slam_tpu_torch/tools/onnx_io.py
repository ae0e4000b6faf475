"""Minimal pure-Python ONNX reader and writer (protobuf wire format).

The port's own copy of ``d2slam_tpu/tools/onnx_io.py`` (numpy only):
bytes written by either copy are read by both.

The reference consumes ONNX models through TensorRT / ONNXRuntime
(reference: d2frontend/src/CNN/superpoint_tensorrt.cpp:49-54,
d2frontend/include/d2frontend/CNN/onnx_generic.h:30-66,
quadcam_depth_est/include/hitnet.hpp). The equivalent here is to
load the same .onnx files directly and execute them on the device
(see tools/onnx_torch.py). This module decodes just enough of the ONNX
protobuf schema — graph nodes, attributes, initializers, and I/O value
infos — without requiring the `onnx` package (not available in this
environment).

No code is taken from the reference; the ONNX wire format is a public
protobuf schema (github.com/onnx/onnx, onnx/onnx.proto).
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# protobuf wire-format primitives
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message.

    value is: int for varint (0) / 64-bit (1) / 32-bit (5); bytes for
    length-delimited (2).
    """
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field = tag >> 3
        wire = tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:  # groups (3, 4) do not appear in ONNX
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _varints(buf: bytes) -> List[int]:
    out, pos = [], 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(v)
    return out


def _zigzag64(v: int) -> int:
    # ONNX int64 fields are plain (non-zigzag) varints; keep two's complement.
    return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------------------
# ONNX message decoding
# ---------------------------------------------------------------------------

# TensorProto.DataType
_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}


@dataclasses.dataclass
class OnnxAttr:
    name: str
    f: Optional[float] = None
    i: Optional[int] = None
    s: Optional[bytes] = None
    t: Optional[np.ndarray] = None
    floats: Tuple[float, ...] = ()
    ints: Tuple[int, ...] = ()
    strings: Tuple[bytes, ...] = ()

    @property
    def value(self):
        for v in (self.t, self.s, self.f, self.i):
            if v is not None:
                return v
        if self.floats:
            return self.floats
        if self.ints:
            return self.ints
        if self.strings:
            return self.strings
        # AttributeProto distinguishes empty list kinds by `type`; for our
        # use (Conv pads/strides etc.) an unset list means "default".
        return None


@dataclasses.dataclass
class OnnxNode:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    name: str = ""
    attrs: Dict[str, OnnxAttr] = dataclasses.field(default_factory=dict)

    def attr(self, name, default=None):
        a = self.attrs.get(name)
        return default if a is None else a.value


@dataclasses.dataclass
class OnnxGraph:
    nodes: List[OnnxNode]
    initializers: Dict[str, np.ndarray]
    inputs: List[Tuple[str, Tuple[int, ...]]]   # (name, shape) non-initializer
    outputs: List[str]
    name: str = ""


def _decode_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    data_type = 1
    name = ""
    raw = None
    float_data: List[float] = []
    int32_data: List[int] = []
    int64_data: List[int] = []
    double_data: List[float] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1:  # dims
            if wire == 2:
                dims.extend(_zigzag64(v) for v in _varints(val))
            else:
                dims.append(_zigzag64(val))
        elif field == 2:
            data_type = val
        elif field == 4:  # float_data
            if wire == 2:
                float_data.extend(
                    struct.unpack(f"<{len(val)//4}f", val)
                )
            else:
                float_data.append(struct.unpack("<f", struct.pack("<I", val))[0])
        elif field == 5:  # int32_data (also holds int8/16, uint8/16,
            # bool, and float16 bit patterns per the ONNX spec)
            if wire == 2:
                int32_data.extend(_zigzag64(v) for v in _varints(val))
            else:
                int32_data.append(_zigzag64(val))
        elif field == 7:  # int64_data
            if wire == 2:
                int64_data.extend(_zigzag64(v) for v in _varints(val))
            else:
                int64_data.append(_zigzag64(val))
        elif field == 8:
            name = val.decode()
        elif field == 9:
            raw = val
        elif field == 11:  # double_data
            if wire == 2:
                double_data.extend(struct.unpack(f"<{len(val)//8}d", val))
            else:
                double_data.append(struct.unpack("<d", struct.pack("<Q", val))[0])
    dtype = _DTYPES.get(data_type)
    if dtype is None:
        raise ValueError(f"unsupported ONNX tensor dtype {data_type} for {name}")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif float_data:
        arr = np.asarray(float_data, dtype=np.float32).astype(dtype)
    elif int64_data:
        arr = np.asarray(int64_data, dtype=np.int64).astype(dtype)
    elif int32_data:
        if dtype == np.float16:  # stored as raw bit patterns
            arr = np.asarray(int32_data, np.int64).astype(
                np.uint16).view(np.float16)
        else:
            arr = np.asarray(int32_data, dtype=np.int64).astype(dtype)
    elif double_data:
        arr = np.asarray(double_data, dtype=np.float64).astype(dtype)
    else:
        arr = np.zeros(0, dtype=dtype)
    if dims:
        arr = arr.reshape(dims)
    else:
        arr = arr.reshape(()) if arr.size == 1 else arr
    return name, arr


def _decode_attr(buf: bytes) -> OnnxAttr:
    a = OnnxAttr(name="")
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            a.name = val.decode()
        elif field == 2:
            a.f = struct.unpack("<f", struct.pack("<I", val))[0]
        elif field == 3:
            a.i = _zigzag64(val)
        elif field == 4:
            a.s = val
        elif field == 5:
            _, a.t = _decode_tensor(val)
        elif field == 7:
            if wire == 2:
                floats.extend(struct.unpack(f"<{len(val)//4}f", val))
            else:
                floats.append(struct.unpack("<f", struct.pack("<I", val))[0])
        elif field == 8:
            if wire == 2:
                ints.extend(_zigzag64(v) for v in _varints(val))
            else:
                ints.append(_zigzag64(val))
        elif field == 9:
            strings.append(val)
    a.floats = tuple(floats)
    a.ints = tuple(ints)
    a.strings = tuple(strings)
    return a


def _decode_node(buf: bytes) -> OnnxNode:
    node = OnnxNode(op_type="", inputs=[], outputs=[])
    for field, _, val in _iter_fields(buf):
        if field == 1:
            node.inputs.append(val.decode())
        elif field == 2:
            node.outputs.append(val.decode())
        elif field == 3:
            node.name = val.decode()
        elif field == 4:
            node.op_type = val.decode()
        elif field == 5:
            attr = _decode_attr(val)
            node.attrs[attr.name] = attr
    return node


def _decode_value_info(buf: bytes) -> Tuple[str, Tuple[int, ...]]:
    name = ""
    shape: Tuple[int, ...] = ()
    for field, _, val in _iter_fields(buf):
        if field == 1:
            name = val.decode()
        elif field == 2:  # TypeProto
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _, v3 in _iter_fields(v2):
                        if f3 == 2:  # shape
                            dims = []
                            for f4, _, v4 in _iter_fields(v3):
                                if f4 == 1:  # Dimension
                                    dv = 0
                                    for f5, _, v5 in _iter_fields(v4):
                                        if f5 == 1:
                                            dv = _zigzag64(v5)
                                    dims.append(dv)
                            shape = tuple(dims)
    return name, shape


def _decode_graph(buf: bytes) -> OnnxGraph:
    nodes: List[OnnxNode] = []
    inits: Dict[str, np.ndarray] = {}
    inputs: List[Tuple[str, Tuple[int, ...]]] = []
    outputs: List[str] = []
    gname = ""
    for field, _, val in _iter_fields(buf):
        if field == 1:
            nodes.append(_decode_node(val))
        elif field == 2:
            gname = val.decode()
        elif field == 5:
            n, arr = _decode_tensor(val)
            inits[n] = arr
        elif field == 11:
            inputs.append(_decode_value_info(val))
        elif field == 12:
            n, _ = _decode_value_info(val)
            outputs.append(n)
    # graph inputs include initializers in some exporters; filter them
    inputs = [(n, s) for n, s in inputs if n not in inits]
    return OnnxGraph(nodes=nodes, initializers=inits, inputs=inputs,
                     outputs=outputs, name=gname)


# ---------------------------------------------------------------------------
# encoding (subset) — lets tests round-trip graphs and tools export models
# ---------------------------------------------------------------------------

_NP_TO_ONNX = {np.dtype(v): k for k, v in _DTYPES.items()}


def _enc_varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _enc_field(field: int, wire: int, payload) -> bytes:
    tag = _enc_varint((field << 3) | wire)
    if wire == 0:
        return tag + _enc_varint(payload)
    if wire == 2:
        return tag + _enc_varint(len(payload)) + payload
    if wire == 5:
        return tag + struct.pack("<I", payload)
    raise ValueError(wire)


def _enc_tensor(name: str, arr: np.ndarray) -> bytes:
    out = b""
    for d in arr.shape:
        out += _enc_field(1, 0, d)
    out += _enc_field(2, 0, _NP_TO_ONNX[arr.dtype])
    out += _enc_field(8, 2, name.encode())
    out += _enc_field(9, 2, np.ascontiguousarray(arr).tobytes())
    return out


def _enc_attr(a: OnnxAttr) -> bytes:
    out = _enc_field(1, 2, a.name.encode())
    if a.f is not None:
        out += _enc_field(2, 5, struct.unpack("<I", struct.pack("<f", a.f))[0])
        out += _enc_field(20, 0, 1)  # type FLOAT
    elif a.i is not None:
        out += _enc_field(3, 0, a.i)
        out += _enc_field(20, 0, 2)  # INT
    elif a.s is not None:
        out += _enc_field(4, 2, a.s)
        out += _enc_field(20, 0, 3)  # STRING
    elif a.t is not None:
        out += _enc_field(5, 2, _enc_tensor("", np.asarray(a.t)))
        out += _enc_field(20, 0, 4)  # TENSOR
    elif a.floats:
        for f in a.floats:
            out += _enc_field(7, 5, struct.unpack("<I", struct.pack("<f", f))[0])
        out += _enc_field(20, 0, 6)
    elif a.ints:
        for i in a.ints:
            out += _enc_field(8, 0, i)
        out += _enc_field(20, 0, 7)
    elif a.strings:
        for s in a.strings:
            out += _enc_field(9, 2, s)
        out += _enc_field(20, 0, 8)
    return out


def _enc_node(n: OnnxNode) -> bytes:
    out = b""
    for i in n.inputs:
        out += _enc_field(1, 2, i.encode())
    for o in n.outputs:
        out += _enc_field(2, 2, o.encode())
    if n.name:
        out += _enc_field(3, 2, n.name.encode())
    out += _enc_field(4, 2, n.op_type.encode())
    for a in n.attrs.values():
        out += _enc_field(5, 2, _enc_attr(a))
    return out


def _enc_value_info(name: str, shape, elem_type=1) -> bytes:
    dims = b""
    for d in shape:
        dims += _enc_field(1, 2, _enc_field(1, 0, int(d)))
    shp = _enc_field(2, 2, dims)
    tensor_type = _enc_field(1, 0, elem_type) + shp
    tp = _enc_field(1, 2, tensor_type)
    return _enc_field(1, 2, name.encode()) + _enc_field(2, 2, tp)


def save_onnx(graph: OnnxGraph, path: str) -> None:
    """Serialize an OnnxGraph to a .onnx file (raw_data tensors)."""
    g = b""
    for n in graph.nodes:
        g += _enc_field(1, 2, _enc_node(n))
    if graph.name:
        g += _enc_field(2, 2, graph.name.encode())
    for name, arr in graph.initializers.items():
        g += _enc_field(5, 2, _enc_tensor(name, np.asarray(arr)))
    for name, shape in graph.inputs:
        g += _enc_field(11, 2, _enc_value_info(name, shape))
    for name in graph.outputs:
        g += _enc_field(12, 2, _enc_value_info(name, ()))
    model = _enc_field(1, 0, 8)  # ir_version
    model += _enc_field(7, 2, g)
    # opset_import { version = 13 }
    model += _enc_field(8, 2, _enc_field(2, 0, 13))
    with open(path, "wb") as f:
        f.write(model)


def load_onnx(path: str) -> OnnxGraph:
    """Load an ONNX model file and return its (flat) graph."""
    with open(path, "rb") as f:
        buf = f.read()
    graph = None
    for field, _, val in _iter_fields(buf):
        if field == 7:  # ModelProto.graph
            graph = _decode_graph(val)
    if graph is None:
        raise ValueError(f"{path}: no graph found (not an ONNX model?)")
    return graph
