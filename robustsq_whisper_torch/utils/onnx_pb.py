"""Minimal ONNX initializer reader, with no ``onnx`` package.

The port's copy of the JAX package's ``utils/onnx_pb.py``. The recipe's
speaker embeddings come from ``voxceleb_resnet34_LM.onnx``; an ONNX file is
plain protobuf, and this module decodes just enough of the wire format to
pull the graph's initializer tensors (``{name: np.ndarray}``), which is all
a weight import needs. Pure stdlib and numpy, local files only.

Wire-format subset implemented (protobuf encoding spec):
- varint keys ``(field_number << 3) | wire_type``; wire types 0 (varint),
  1 (fixed64), 2 (length-delimited), 5 (fixed32).
- ModelProto.graph = field 7 (GraphProto).
- GraphProto.initializer = field 5 (repeated TensorProto).
- TensorProto: dims=1 (packed/unpacked varints), data_type=2, float_data=4,
  int32_data=5, int64_data=7, name=8, raw_data=9, double_data=10.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple, Union

import numpy as np

# TensorProto.DataType -> numpy dtype (subset that appears in real exports)
_DTYPES = {
    1: np.float32,  # FLOAT
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


def _read_varint(buf: Union[bytes, memoryview], i: int) -> Tuple[int, int]:
    val = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not (b & 0x80):
            return val, i
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _iter_fields(
    buf: Union[bytes, memoryview],
) -> Iterator[Tuple[int, int, Union[int, memoryview]]]:
    """Yield (field_number, wire_type, value) over one message's bytes."""
    view = memoryview(buf)
    i, n = 0, len(view)
    while i < n:
        key, i = _read_varint(view, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, i = _read_varint(view, i)
        elif wt == 1:
            val = view[i : i + 8]
            i += 8
        elif wt == 2:
            ln, i = _read_varint(view, i)
            val = view[i : i + ln]
            i += ln
        elif wt == 5:
            val = view[i : i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield field, wt, val


def _packed_varints(buf: Union[bytes, memoryview]) -> List[int]:
    out = []
    i, n = 0, len(buf)
    while i < n:
        v, i = _read_varint(buf, i)
        out.append(v)
    return out


def _parse_tensor(buf: Union[bytes, memoryview]) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype_code = 1
    name = ""
    raw = None
    floats: List[float] = []
    doubles: List[float] = []
    int32s: List[int] = []
    int64s: List[int] = []
    for field, wt, val in _iter_fields(buf):
        if field == 1:  # dims
            if wt == 0:
                dims.append(int(val))
            else:
                dims.extend(_packed_varints(val))
        elif field == 2 and wt == 0:  # data_type
            dtype_code = int(val)
        elif field == 4:  # float_data
            if wt == 2:
                floats.extend(np.frombuffer(bytes(val), "<f4").tolist())
            else:
                floats.append(struct.unpack("<f", bytes(val))[0])
        elif field == 5:  # int32_data
            if wt == 2:
                int32s.extend(_packed_varints(val))
            else:
                int32s.append(int(val))
        elif field == 7:  # int64_data
            if wt == 2:
                int64s.extend(_packed_varints(val))
            else:
                int64s.append(int(val))
        elif field == 8 and wt == 2:  # name
            name = bytes(val).decode("utf-8")
        elif field == 9 and wt == 2:  # raw_data
            raw = bytes(val)
        elif field == 10:  # double_data
            if wt == 2:
                doubles.extend(np.frombuffer(bytes(val), "<f8").tolist())
            else:
                doubles.append(struct.unpack("<d", bytes(val))[0])
        # other fields (segment, string_data, external data) ignored
    np_dtype = _DTYPES.get(dtype_code)
    if np_dtype is None:
        raise ValueError(f"tensor {name!r}: unsupported data_type {dtype_code}")
    if raw is not None:
        arr = np.frombuffer(raw, np.dtype(np_dtype).newbyteorder("<"))
    elif floats:
        arr = np.asarray(floats, np.float32).astype(np_dtype)
    elif doubles:
        arr = np.asarray(doubles, np.float64).astype(np_dtype)
    elif int64s:
        # protobuf varints are two's-complement encoded as uint64
        arr = np.asarray(int64s, np.uint64).astype(np.int64).astype(np_dtype)
    elif int32s:
        arr = np.asarray(int32s, np.uint64).astype(np.int64).astype(np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    return name, arr.reshape(dims) if dims else arr


def read_onnx_initializers(path_or_bytes: Union[str, bytes]) -> Dict[str, np.ndarray]:
    """Decode an ONNX model's graph initializers ({name: array}).

    Accepts a file path or the serialized ModelProto bytes. Raises
    ValueError on a file that does not parse as an ONNX ModelProto.
    """
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    graph = None
    for field, wt, val in _iter_fields(data):
        if field == 7 and wt == 2:  # ModelProto.graph
            graph = val
            break
    if graph is None:
        raise ValueError("not an ONNX ModelProto: no graph field")
    out: Dict[str, np.ndarray] = {}
    for field, wt, val in _iter_fields(graph):
        if field == 5 and wt == 2:  # GraphProto.initializer
            name, arr = _parse_tensor(val)
            out[name] = arr
    return out
