"""Minimal pure-Python ONNX protobuf reader (and, for synthetic exports,
``encode_model``) — the port's copy of ``k2transducerasr_tpu/convert/
onnx_proto.py``.

The environment ships neither ``onnx`` nor ``onnxruntime``, and the importer
only needs three things from an ONNX export: the custom metadata map (the
reference's model-config source of truth, ``OnlineModel.cs:32-183``), the
initializer tensors (weights), and the node list (to resolve QDQ int8
dequantization).  Protobuf wire format is simple enough to read directly.

Wire format: each field = varint key (field_number << 3 | wire_type);
wire types: 0 varint, 1 fixed64, 2 length-delimited, 5 fixed32.

ONNX schema subset (field numbers from onnx.proto3):
  ModelProto:  graph=7 (GraphProto), metadata_props=14 (StringStringEntry)
  StringStringEntryProto: key=1, value=2
  GraphProto:  node=1 (NodeProto), initializer=5 (TensorProto),
               input=11, output=12 (ValueInfoProto)
  NodeProto:   input=1 (str*), output=2 (str*), name=3, op_type=4
  TensorProto: dims=1 (int64*), data_type=2, float_data=4, int32_data=5,
               string_data=6, int64_data=7, name=8, raw_data=9,
               double_data=10, uint64_data=11
  ValueInfoProto: name=1
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

# ONNX TensorProto.DataType -> numpy dtype
DTYPES = {
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


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def parse_message(buf: bytes) -> dict[int, list]:
    """Parse one protobuf message into {field_number: [raw values]}.
    Length-delimited values stay as bytes; varints as ints."""
    fields: dict[int, list] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = struct.unpack("<Q", buf[pos : pos + 8])[0]
            pos += 8
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            val = buf[pos : pos + length]
            pos += length
        elif wire == 5:
            val = struct.unpack("<I", buf[pos : pos + 4])[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field, []).append(val)
    return fields


def _packed_varints(raw_list) -> list[int]:
    out = []
    for raw in raw_list:
        if isinstance(raw, int):
            out.append(raw)
        else:
            pos = 0
            while pos < len(raw):
                v, pos = _read_varint(raw, pos)
                out.append(v)
    return out


def _zigzag_ok(v: int, bits: int = 64) -> int:
    """Interpret a varint as a signed two's-complement int64."""
    if v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


@dataclasses.dataclass
class OnnxTensor:
    name: str
    dims: tuple
    dtype: object
    array: np.ndarray


def parse_tensor(buf: bytes) -> OnnxTensor:
    f = parse_message(buf)
    dims = tuple(_zigzag_ok(v) for v in _packed_varints(f.get(1, [])))
    data_type = f.get(2, [1])[0]
    name = f.get(8, [b""])[0].decode("utf-8")
    np_dtype = DTYPES.get(data_type)
    if np_dtype is None:
        raise ValueError(f"tensor {name!r}: unsupported ONNX data_type {data_type}")

    if 9 in f:  # raw_data
        raw = b"".join(f[9])
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif 4 in f and data_type == 1:  # packed float_data
        floats = []
        for raw in f[4]:
            if isinstance(raw, int):  # single fixed32
                floats.append(struct.unpack("<f", struct.pack("<I", raw))[0])
            else:
                floats.extend(struct.unpack(f"<{len(raw) // 4}f", raw))
        arr = np.asarray(floats, dtype=np.float32)
    elif 7 in f and data_type == 7:  # int64_data
        arr = np.asarray(
            [_zigzag_ok(v) for v in _packed_varints(f[7])], dtype=np.int64
        )
    elif 5 in f:  # int32_data (also carries int8/uint8/int16/fp16)
        vals = [_zigzag_ok(v, 32) for v in _packed_varints(f[5])]
        if data_type == 10:
            arr = np.asarray(vals, dtype=np.uint16).view(np.float16)
        else:
            arr = np.asarray(vals).astype(np_dtype)
    else:
        arr = np.zeros(0, dtype=np_dtype)
    if dims:
        arr = arr.reshape(dims)
    return OnnxTensor(name=name, dims=dims, dtype=np_dtype, array=arr)


@dataclasses.dataclass
class OnnxNode:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    name: str


@dataclasses.dataclass
class OnnxModel:
    metadata: dict[str, str]
    initializers: dict[str, np.ndarray]
    nodes: list[OnnxNode]
    graph_inputs: list[str]
    graph_outputs: list[str]

    def dequantized(self) -> dict[str, np.ndarray]:
        """Resolve QDQ int8 weights: for every DequantizeLinear node whose
        x/scale/zero_point are initializers, emit the float array under the
        node's OUTPUT name (scale/zp per-tensor or per-axis)."""
        out = dict(self.initializers)
        for node in self.nodes:
            if node.op_type != "DequantizeLinear" or len(node.inputs) < 2:
                continue
            names = node.inputs
            if not all(n in self.initializers for n in names if n):
                continue
            x = self.initializers[names[0]]
            scale = self.initializers[names[1]].astype(np.float32)
            zp = (
                self.initializers[names[2]].astype(np.int32)
                if len(names) > 2 and names[2]
                else np.zeros_like(scale, dtype=np.int32)
            )
            if scale.ndim > 0 and scale.size > 1:
                # per-axis: broadcast along the first axis matching size
                axis = next(
                    (a for a, d in enumerate(x.shape) if d == scale.size), 0
                )
                shape = [1] * x.ndim
                shape[axis] = scale.size
                scale = scale.reshape(shape)
                zp = zp.reshape(shape)
            out[node.outputs[0]] = (x.astype(np.int32) - zp).astype(np.float32) * scale
        return out


def parse_model(data: bytes) -> OnnxModel:
    model = parse_message(data)
    metadata = {}
    for entry in model.get(14, []):
        f = parse_message(entry)
        key = f.get(1, [b""])[0].decode("utf-8")
        val = f.get(2, [b""])[0].decode("utf-8")
        metadata[key] = val

    graph_bufs = model.get(7, [])
    initializers: dict[str, np.ndarray] = {}
    nodes: list[OnnxNode] = []
    g_in: list[str] = []
    g_out: list[str] = []
    for gb in graph_bufs:
        g = parse_message(gb)
        for tb in g.get(5, []):
            t = parse_tensor(tb)
            initializers[t.name] = t.array
        for nb in g.get(1, []):
            nf = parse_message(nb)
            nodes.append(
                OnnxNode(
                    op_type=nf.get(4, [b""])[0].decode("utf-8"),
                    inputs=[v.decode("utf-8") for v in nf.get(1, [])],
                    outputs=[v.decode("utf-8") for v in nf.get(2, [])],
                    name=nf.get(3, [b""])[0].decode("utf-8"),
                )
            )
        for vb in g.get(11, []):
            g_in.append(parse_message(vb).get(1, [b""])[0].decode("utf-8"))
        for vb in g.get(12, []):
            g_out.append(parse_message(vb).get(1, [b""])[0].decode("utf-8"))
    return OnnxModel(metadata, initializers, nodes, g_in, g_out)


def load(path: str) -> OnnxModel:
    with open(path, "rb") as f:
        return parse_model(f.read())


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if not v:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _ld(num: int, data: bytes) -> bytes:  # a length-delimited field
    return _varint((num << 3) | 2) + _varint(len(data)) + data


def encode_model(metadata: dict[str, str], initializers: dict[str, np.ndarray]) -> bytes:
    """A ModelProto holding only ``metadata`` and ``initializers`` (raw
    little-endian data), which ``parse_model`` reads back exactly: the input
    of synthetic conversions (``importer.export_model_dir``)."""
    codes = {np.dtype(v): k for k, v in DTYPES.items()}
    tensors = []
    for name, a in initializers.items():
        a = np.ascontiguousarray(a)
        t = b"".join(_varint(1 << 3) + _varint(d) for d in a.shape)
        t += _varint(2 << 3) + _varint(codes[a.dtype]) + _ld(8, name.encode())
        tensors.append(t + _ld(9, a.astype(a.dtype.newbyteorder("<")).tobytes()))
    msg = _ld(7, b"".join(_ld(5, t) for t in tensors))
    for k, v in metadata.items():
        msg += _ld(14, _ld(1, k.encode()) + _ld(2, v.encode()))
    return msg
