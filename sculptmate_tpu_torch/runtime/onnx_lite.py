"""Minimal ONNX initializer reader (no ``onnx`` package needed).

The port's own copy of ``sculptmate_tpu/runtime/onnx_lite.py``. The
reference loads u2net.onnx through onnxruntime (``rembg/sessions/base.py:
34-42``); the port reads the same file's weights into a state dict
(``runtime/checkpoint.py:try_load_u2net_state_dict``). Extracting weights
needs only the protobuf wire format of three messages:

    ModelProto.graph = 7            (onnx.proto)
    GraphProto.initializer = 5      (repeated TensorProto)
    TensorProto: dims=1, data_type=2, float_data=4, int32_data=5,
                 int64_data=7, name=8, raw_data=9, double_data=10,
                 uint64_data=11, external_data=13, data_location=14

so this module implements exactly that: a ~150-line protobuf scanner that
returns ``{initializer name: np.ndarray}``. raw_data is little-endian per the
ONNX spec; packed and unpacked repeated varints are both accepted.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

# TensorProto.DataType -> numpy dtype (spec: onnx/onnx.proto3)
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
_BF16 = 16  # stored as uint16 raw bits; widened to f32 on read


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) over one message.

    wire 0 -> int varint; wire 1 -> 8 raw bytes; wire 2 -> bytes span;
    wire 5 -> 4 raw bytes. Groups (3/4) are rejected (absent from ONNX).
    """
    i, n = 0, len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            val = buf[i : i + ln]
            if len(val) != ln:
                raise ValueError("truncated length-delimited field")
            i += ln
        elif wire == 5:
            val = buf[i : i + 4]
            i += 4
        elif wire == 1:
            val = buf[i : i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _repeated_varints(wire: int, val: Any) -> List[int]:
    """A repeated varint field arrives packed (one wire-2 blob) or as
    individual wire-0 entries; normalize both to a list."""
    if wire == 0:
        return [val]
    out = []
    i = 0
    while i < len(val):
        v, i = _read_varint(val, i)
        out.append(v)
    return out


def _zigzag64(vals: List[int]) -> List[int]:
    # ONNX dims/int64_data are plain int64 varints (two's complement, NOT
    # zigzag); negative values occupy 10 bytes. Fold back to signed.
    return [v - (1 << 64) if v >= (1 << 63) else v for v in vals]


def _parse_tensor(buf: bytes) -> Tuple[Optional[str], Optional[np.ndarray]]:
    dims: List[int] = []
    data_type = 0
    name = None
    raw = None
    f32: List[bytes] = []
    f64: List[bytes] = []
    i32: List[int] = []
    i64: List[int] = []
    u64: List[int] = []
    external = False
    for field, wire, val in _fields(buf):
        if field == 1:
            dims += _repeated_varints(wire, val)
        elif field == 2:
            data_type = val
        elif field == 4:  # packed floats (wire 2) or single f32 (wire 5)
            f32.append(val)
        elif field == 5:
            i32 += _repeated_varints(wire, val)
        elif field == 7:
            i64 += _repeated_varints(wire, val)
        elif field == 8:
            name = val.decode("utf-8")
        elif field == 9:
            raw = val
        elif field == 10:
            f64.append(val)
        elif field == 11:
            u64 += _repeated_varints(wire, val)
        elif field in (13, 14):
            external = True
    if external:
        raise ValueError(
            f"initializer {name!r} uses external data files, which this reader "
            "does not support"
        )

    dims = _zigzag64(dims)
    shape = tuple(int(d) for d in dims)
    if data_type == _BF16:
        if raw is None:
            raise ValueError(f"bfloat16 initializer {name!r} without raw_data")
        bits = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
        return name, bits.view(np.float32).reshape(shape)
    dt = _DTYPES.get(int(data_type))
    if dt is None:
        raise ValueError(f"initializer {name!r}: unsupported data_type {data_type}")
    if raw is not None:
        arr = np.frombuffer(raw, np.dtype(dt).newbyteorder("<"))
    elif f32 and dt == np.float32:
        arr = np.frombuffer(b"".join(f32), "<f4")
    elif f64 and dt == np.float64:
        arr = np.frombuffer(b"".join(f64), "<f8")
    elif dt == np.int64:
        arr = np.asarray(_zigzag64(i64), np.int64)
    elif dt == np.uint64:
        arr = np.asarray(u64, np.uint64)
    elif dt in (np.int32, np.int16, np.int8, np.uint8, np.uint16, np.bool_,
                np.float16):
        # small ints (and f16) ride the int32_data field as varints;
        # negatives are encoded as 64-bit two's complement (protobuf int32
        # semantics), so fold at 2^63 and let astype wrap to the final width
        vals = np.asarray(
            [v - (1 << 64) if v >= (1 << 63) else v for v in i32], np.int64
        )
        if dt == np.float16:
            arr = vals.astype(np.uint16).view(np.float16)
        else:
            arr = vals.astype(dt)
    else:
        arr = np.zeros(0, dt)
    return name, arr.reshape(shape).copy()


def read_initializers(path: str) -> Dict[str, np.ndarray]:
    """Read ``{name: array}`` for every graph initializer in an .onnx file."""
    with open(path, "rb") as fh:
        buf = fh.read()
    graph = None
    for field, wire, val in _fields(buf):
        if field == 7 and wire == 2:
            graph = val
            break
    if graph is None:
        raise ValueError(f"{path}: no GraphProto (field 7) - not an ONNX model?")
    out: Dict[str, np.ndarray] = {}
    for field, wire, val in _fields(graph):
        if field == 5 and wire == 2:
            name, arr = _parse_tensor(val)
            if name is not None and arr is not None:
                out[name] = arr
    return out
