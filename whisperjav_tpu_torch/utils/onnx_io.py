"""Minimal pure-Python ONNX file reader/writer (no onnx/onnxruntime dep).

The port's copy of ``whisperjav_tpu/utils/onnx_io.py`` (numpy only).
The reference binds vendor models shipped as ONNX graphs — TEN VAD
(reference: whisperjav/modules/speech_segmentation/backends/ten.py —
hop-256 frame VAD, ~300 KB model) and ZipEnhancer's ONNX edition
(reference: whisperjav/modules/speech_enhancement/backends/
zipenhancer.py:208-258, "manyeyes/ZipEnhancer-se-16k-base-onnx") —
through ``onnxruntime``. The port wants the *tensors*, to bind into its
PyTorch modules, so this module implements the minimal protobuf
wire-format codec needed to:

  * read a ModelProto: graph name, initializer tensors (as numpy
    arrays), node topology (op_type / inputs / outputs / attributes),
    and graph input/output names — enough for name-mapped *and*
    structural (shape/topology-based) weight binding;
  * write one back, so converter tests can synthesize vendor-layout
    files (e.g. an ONNX ``LSTM`` op with its ``iofc`` gate order) and
    prove the binding round-trips without network access.

bfloat16 initialisers (ONNX data type 16) are read as float32 by
shifting their 16 bits into the high half of a float32 word, which is
exact; numpy has no bfloat16 type of its own and ``ml_dtypes`` is not
needed.

Only the fields the ONNX schema marks for these messages are decoded;
unknown fields are skipped per protobuf rules, so files produced by any
exporter parse. torch.onnx.export preserves ``state_dict`` parameter
names as initializer names, which is what makes name-mapped binding of
vendor checkpoints possible offline.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

# TensorProto.DataType -> numpy dtype
_DTYPES: Dict[int, Any] = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}
_BF16 = 16             # TensorProto.BFLOAT16: read as float32


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 bit patterns -> float32, exactly (the bits are the
    high half of the float32 word)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


# ---------------------------------------------------------------------------
# protobuf wire format
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
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
            raise ValueError("varint too long (corrupt file)")


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's bytes.

    value is an int for wire types 0/1/5 and a memoryview for type 2.
    """
    pos, end = 0, len(buf)
    view = memoryview(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val = view[pos:pos + ln]
            pos += ln
        elif wt == 5:
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fno, wt, val


def _zigzag_i64(v: int) -> int:
    """Two's-complement interpretation of a varint-decoded int64."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _packed_varints(data) -> List[int]:
    buf = bytes(data)
    out, pos = [], 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(_zigzag_i64(v))
    return out


# ---------------------------------------------------------------------------
# message decoding
# ---------------------------------------------------------------------------

@dataclass
class OnnxNode:
    op_type: str
    name: str = ""
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    attrs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class OnnxGraph:
    name: str = ""
    initializers: Dict[str, np.ndarray] = field(default_factory=dict)
    nodes: List[OnnxNode] = field(default_factory=list)
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)

    def node_by_op(self, op_type: str) -> List[OnnxNode]:
        return [n for n in self.nodes if n.op_type == op_type]


@dataclass
class OnnxModel:
    ir_version: int = 0
    producer: str = ""
    opset: int = 0
    graph: OnnxGraph = field(default_factory=OnnxGraph)


def _decode_tensor(data) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype_code = 1
    name = ""
    raw: Optional[bytes] = None
    f32: List[float] = []
    i32: List[int] = []
    i64: List[int] = []
    f64: List[float] = []
    for fno, wt, val in _iter_fields(bytes(data)):
        if fno == 1:                                    # dims
            dims.extend(_packed_varints(val) if wt == 2
                        else [_zigzag_i64(val)])
        elif fno == 2:                                  # data_type
            dtype_code = val
        elif fno == 4:                                  # float_data
            if wt == 2:
                f32.extend(np.frombuffer(bytes(val), "<f4").tolist())
            else:
                f32.append(struct.unpack("<f", struct.pack("<I", val))[0])
        elif fno == 5:                                  # int32_data
            i32.extend(_packed_varints(val) if wt == 2 else [val])
        elif fno == 7:                                  # int64_data
            i64.extend(_packed_varints(val) if wt == 2
                       else [_zigzag_i64(val)])
        elif fno == 8:                                  # name
            name = bytes(val).decode("utf-8")
        elif fno == 9:                                  # raw_data
            raw = bytes(val)
        elif fno == 10:                                 # double_data
            if wt == 2:
                f64.extend(np.frombuffer(bytes(val), "<f8").tolist())
            else:
                f64.append(struct.unpack("<d", struct.pack("<Q", val))[0])
    if dtype_code == _BF16:
        if raw is not None:
            bits = np.frombuffer(raw, "<u2")
        else:                               # int32_data holds the bits
            bits = np.asarray(i32, np.int64).astype(np.uint16)
        arr = _bf16_to_f32(bits)
        return name, arr.reshape(dims) if dims else arr.reshape(())
    dtype = _DTYPES.get(dtype_code)
    if dtype is None:
        raise ValueError(f"tensor {name!r}: unsupported dtype {dtype_code}")
    if raw is not None:
        arr = np.frombuffer(raw, np.dtype(dtype).newbyteorder("<")).copy()
    elif f32:
        arr = np.asarray(f32, np.float32).astype(dtype)
    elif f64:
        arr = np.asarray(f64, np.float64).astype(dtype)
    elif i64:
        arr = np.asarray(i64, np.int64).astype(dtype)
    elif i32:
        # int32_data also carries (u)int8/16, bool, float16 payloads
        arr = np.asarray(i32, np.int64)
        if np.dtype(dtype) == np.float16:
            arr = arr.astype(np.uint16).view(np.float16)
        else:
            arr = arr.astype(dtype)
    else:
        arr = np.zeros(0, dtype)
    return name, arr.reshape(dims) if dims else arr.reshape(())


def _decode_attr(data) -> Tuple[str, Any]:
    name = ""
    val: Any = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for fno, wt, v in _iter_fields(bytes(data)):
        if fno == 1:
            name = bytes(v).decode("utf-8")
        elif fno == 2:                                  # f
            val = struct.unpack("<f", struct.pack("<I", v))[0]
        elif fno == 3:                                  # i
            val = _zigzag_i64(v)
        elif fno == 4:                                  # s
            val = bytes(v).decode("utf-8", "replace")
        elif fno == 5:                                  # t
            val = _decode_tensor(v)[1]
        elif fno == 7:                                  # floats
            if wt == 2:
                floats.extend(np.frombuffer(bytes(v), "<f4").tolist())
            else:
                floats.append(
                    struct.unpack("<f", struct.pack("<I", v))[0])
        elif fno == 8:                                  # ints
            ints.extend(_packed_varints(v) if wt == 2
                        else [_zigzag_i64(v)])
        elif fno == 9:                                  # strings
            strings.append(bytes(v))
    if val is None:
        if floats:
            val = floats
        elif ints:
            val = ints
        elif strings:
            val = [s.decode("utf-8", "replace") for s in strings]
    return name, val


def _decode_node(data) -> OnnxNode:
    node = OnnxNode(op_type="")
    for fno, _wt, val in _iter_fields(bytes(data)):
        if fno == 1:
            node.inputs.append(bytes(val).decode("utf-8"))
        elif fno == 2:
            node.outputs.append(bytes(val).decode("utf-8"))
        elif fno == 3:
            node.name = bytes(val).decode("utf-8")
        elif fno == 4:
            node.op_type = bytes(val).decode("utf-8")
        elif fno == 5:
            k, v = _decode_attr(val)
            node.attrs[k] = v
    return node


def _value_info_name(data) -> str:
    for fno, _wt, val in _iter_fields(bytes(data)):
        if fno == 1:
            return bytes(val).decode("utf-8")
    return ""


def _decode_graph(data) -> OnnxGraph:
    g = OnnxGraph()
    for fno, _wt, val in _iter_fields(bytes(data)):
        if fno == 1:
            g.nodes.append(_decode_node(val))
        elif fno == 2:
            g.name = bytes(val).decode("utf-8")
        elif fno == 5:
            name, arr = _decode_tensor(val)
            g.initializers[name] = arr
        elif fno == 11:
            g.inputs.append(_value_info_name(val))
        elif fno == 12:
            g.outputs.append(_value_info_name(val))
    # graph inputs include initializer names in some exporters; keep the
    # true runtime inputs first for convenience
    g.inputs = [n for n in g.inputs if n not in g.initializers] + \
               [n for n in g.inputs if n in g.initializers]
    return g


def read_onnx(src: Union[str, bytes]) -> OnnxModel:
    """Parse an ONNX file (path or bytes) into an :class:`OnnxModel`."""
    if isinstance(src, (str,)) or hasattr(src, "__fspath__"):
        with open(src, "rb") as f:
            buf = f.read()
    else:
        buf = bytes(src)
    model = OnnxModel()
    for fno, _wt, val in _iter_fields(buf):
        if fno == 1:
            model.ir_version = val
        elif fno == 2:
            model.producer = bytes(val).decode("utf-8", "replace")
        elif fno == 7:
            model.graph = _decode_graph(val)
        elif fno == 8:                                  # opset_import
            for f2, _w2, v2 in _iter_fields(bytes(val)):
                if f2 == 2:
                    model.opset = max(model.opset, v2)
    return model


def read_initializers(src: Union[str, bytes]) -> Dict[str, np.ndarray]:
    """Shortcut: the file's named weight tensors (a ``state_dict``).

    torch.onnx.export writes initializers under their ``state_dict``
    names, so for torch-exported vendor files this IS the torch state
    dict and feeds ``params_from_torch_state_dict`` converters directly.
    """
    return read_onnx(src).graph.initializers


# ---------------------------------------------------------------------------
# encoding (tests synthesize vendor-layout files with this)
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(fno: int, wt: int) -> bytes:
    return _varint((fno << 3) | wt)


def _len_field(fno: int, payload: bytes) -> bytes:
    return _tag(fno, 2) + _varint(len(payload)) + payload


def _encode_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    shape = arr.shape                  # ascontiguousarray promotes 0-d
    arr = np.ascontiguousarray(arr)
    code = _DTYPE_CODES.get(arr.dtype)
    if code is None:
        arr = arr.astype(np.float32)
        code = 1
    out = bytearray()
    for d in shape:
        out += _tag(1, 0) + _varint(d)
    out += _tag(2, 0) + _varint(code)
    out += _len_field(8, name.encode("utf-8"))
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    out += _len_field(9, arr.tobytes())
    return bytes(out)


def _encode_attr(name: str, val: Any) -> bytes:
    out = bytearray(_len_field(1, name.encode("utf-8")))
    if isinstance(val, bool) or isinstance(val, (int, np.integer)):
        out += _tag(3, 0) + _varint(int(val))
        out += _tag(20, 0) + _varint(2)                 # INT
    elif isinstance(val, float):
        out += _tag(2, 5) + struct.pack("<f", val)
        out += _tag(20, 0) + _varint(1)                 # FLOAT
    elif isinstance(val, str):
        out += _len_field(4, val.encode("utf-8"))
        out += _tag(20, 0) + _varint(3)                 # STRING
    elif isinstance(val, np.ndarray):
        out += _len_field(5, _encode_tensor("", val))
        out += _tag(20, 0) + _varint(4)                 # TENSOR
    elif isinstance(val, (list, tuple)) and val and \
            isinstance(val[0], (int, np.integer)):
        for v in val:
            out += _tag(8, 0) + _varint(int(v))
        out += _tag(20, 0) + _varint(7)                 # INTS
    elif isinstance(val, (list, tuple)):
        for v in val:
            out += _tag(7, 5) + struct.pack("<f", float(v))
        out += _tag(20, 0) + _varint(6)                 # FLOATS
    else:
        raise TypeError(f"attribute {name!r}: {type(val)}")
    return bytes(out)


def _encode_node(node: OnnxNode) -> bytes:
    out = bytearray()
    for i in node.inputs:
        out += _len_field(1, i.encode("utf-8"))
    for o in node.outputs:
        out += _len_field(2, o.encode("utf-8"))
    if node.name:
        out += _len_field(3, node.name.encode("utf-8"))
    out += _len_field(4, node.op_type.encode("utf-8"))
    for k, v in node.attrs.items():
        out += _len_field(5, _encode_attr(k, v))
    return bytes(out)


def write_onnx(path: str, graph: OnnxGraph, producer: str =
               "whisperjav-tpu") -> None:
    """Serialize a graph as a valid minimal ModelProto file."""
    g = bytearray()
    for node in graph.nodes:
        g += _len_field(1, _encode_node(node))
    if graph.name:
        g += _len_field(2, graph.name.encode("utf-8"))
    for name, arr in graph.initializers.items():
        g += _len_field(5, _encode_tensor(name, np.asarray(arr)))
    for name in graph.inputs:
        g += _len_field(11, _len_field(1, name.encode("utf-8")))
    for name in graph.outputs:
        g += _len_field(12, _len_field(1, name.encode("utf-8")))
    model = bytearray()
    model += _tag(1, 0) + _varint(8)                    # ir_version
    model += _len_field(2, producer.encode("utf-8"))
    model += _len_field(7, bytes(g))
    opset = _tag(2, 0) + _varint(17)
    model += _len_field(8, opset)
    with open(path, "wb") as f:
        f.write(bytes(model))


# ---------------------------------------------------------------------------
# structural helpers for weight binding
# ---------------------------------------------------------------------------

# ONNX LSTM gate order is i,o,f,c; torch (and our pytrees) use i,f,g,o
# with g = c.  Permutation of 4H-blocks: torch[j] = onnx[_IOFC_TO_IFGO[j]].
IOFC_TO_IFGO = (0, 2, 3, 1)


def lstm_reorder_gates(w: np.ndarray, hidden: int) -> np.ndarray:
    """(4H, ...) ONNX iofc rows -> torch ifgo rows."""
    blocks = [w[i * hidden:(i + 1) * hidden] for i in range(4)]
    return np.concatenate([blocks[i] for i in IOFC_TO_IFGO], axis=0)


def topo_order(graph: OnnxGraph) -> List[OnnxNode]:
    """Nodes in dependency order (exports are usually already sorted)."""
    produced = set(graph.inputs) | set(graph.initializers)
    remaining = list(graph.nodes)
    out: List[OnnxNode] = []
    while remaining:
        for i, n in enumerate(remaining):
            if all(x in produced or x == "" for x in n.inputs):
                out.append(n)
                produced.update(n.outputs)
                del remaining[i]
                break
        else:  # cycle or dangling input: keep original order for the rest
            out.extend(remaining)
            break
    return out
