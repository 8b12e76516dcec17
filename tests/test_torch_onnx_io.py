"""The port's ONNX reader/writer (``whisperjav_tpu_torch/utils/onnx_io.py``)
against the JAX package's: the same bytes written, the same tensors,
nodes and attributes read, bfloat16 initialisers read as float32 without
``ml_dtypes``, and the LSTM gate reorder and topological sort equal."""

import struct

import numpy as np
import pytest

from whisperjav_tpu.utils import onnx_io as jio
from whisperjav_tpu_torch.utils import onnx_io as tio


def _tensors():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "f16": rng.standard_normal((2, 2, 2)).astype(np.float16),
        "f64": rng.standard_normal((5,)).astype(np.float64),
        "i64": np.array([-3, 0, 7, 2 ** 40], np.int64),
        "i32": np.array([[1, -2], [3, 4]], np.int32),
        "i8": np.arange(-4, 4, dtype=np.int8),
        "u8": np.arange(8, dtype=np.uint8).reshape(2, 4),
        "bool": np.array([True, False, True]),
        "scalar": np.float32(2.5),
    }


def _graph(mod):
    node = mod.OnnxNode(
        op_type="LSTM", name="lstm0", inputs=["x", "W", "R", "B"],
        outputs=["y", "yh", "yc"],
        attrs={"hidden_size": 64, "alpha": 0.5, "direction": "forward",
               "kernel_shape": [3, 3], "scales": [1.0, 2.0],
               "blob": np.arange(6, dtype=np.float32).reshape(2, 3)})
    return mod.OnnxGraph(name="g", nodes=[node], initializers={
        k: np.asarray(v) for k, v in _tensors().items()},
        inputs=["x"], outputs=["y"])


def test_written_files_are_identical(tmp_path):
    jio.write_onnx(str(tmp_path / "j.onnx"), _graph(jio))
    tio.write_onnx(str(tmp_path / "t.onnx"), _graph(tio))
    assert (tmp_path / "t.onnx").read_bytes() == \
        (tmp_path / "j.onnx").read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_read_matches_the_jax_reader(tmp_path, writer):
    path = str(tmp_path / "g.onnx")
    (jio if writer == "jax" else tio).write_onnx(
        path, _graph(jio if writer == "jax" else tio))
    want, got = jio.read_onnx(path), tio.read_onnx(path)
    assert (got.ir_version, got.producer, got.opset) == \
        (want.ir_version, want.producer, want.opset)
    assert (got.graph.name, got.graph.inputs, got.graph.outputs) == \
        (want.graph.name, want.graph.inputs, want.graph.outputs)
    assert sorted(got.graph.initializers) == sorted(want.graph.initializers)
    for k, w in want.graph.initializers.items():
        g = got.graph.initializers[k]
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        np.testing.assert_array_equal(g, w, err_msg=k)
    (gn,), (wn,) = got.graph.nodes, want.graph.nodes
    assert (gn.op_type, gn.name, gn.inputs, gn.outputs) == \
        (wn.op_type, wn.name, wn.inputs, wn.outputs)
    assert sorted(gn.attrs) == sorted(wn.attrs)
    for k in wn.attrs:
        np.testing.assert_array_equal(np.asarray(gn.attrs[k]),
                                      np.asarray(wn.attrs[k]), err_msg=k)


def _lf(fno, payload):
    return tio._tag(fno, 2) + tio._varint(len(payload)) + payload


@pytest.mark.parametrize("field", ["raw", "int32"])
def test_bfloat16_initialisers_read_as_float32(field):
    """Data type 16 in raw_data or int32_data: the port shifts the bits
    into float32 (exact). From raw_data the JAX reader (with ml_dtypes)
    gives the same values; from int32_data it casts the bit patterns as
    numbers (16256.0 for 1.0), which the ONNX spec does not mean, so that
    case is held to the values alone."""
    values = np.array([1.0, -2.5, 3.140625, 0.0, -0.0078125, 65280.0],
                      np.float32)
    bits = (values.view(np.uint32) >> 16).astype(np.uint16)
    body = (_lf(9, bits.astype("<u2").tobytes()) if field == "raw"
            else _lf(5, b"".join(tio._varint(int(b)) for b in bits)))
    t = (tio._tag(1, 0) + tio._varint(2) + tio._tag(1, 0) + tio._varint(3)
         + tio._tag(2, 0) + tio._varint(16) + body + _lf(8, b"bf"))
    name, arr = tio._decode_tensor(t)
    assert name == "bf" and arr.dtype == np.float32 and arr.shape == (2, 3)
    np.testing.assert_array_equal(arr.reshape(-1), values)
    if field == "raw":
        _, ref = jio._decode_tensor(t)
        np.testing.assert_array_equal(arr, ref.astype(np.float32))


def test_typed_fields_match():
    h = np.array([0.5, -1.25], np.float16).view(np.uint16)
    cases = [
        tio._tag(1, 0) + tio._varint(2) + tio._tag(2, 0) + tio._varint(1)
        + _lf(4, struct.pack("<2f", 1.5, -2.0)) + _lf(8, b"fd"),
        tio._tag(1, 0) + tio._varint(2) + tio._tag(2, 0) + tio._varint(10)
        + _lf(5, b"".join(tio._varint(int(v)) for v in h)) + _lf(8, b"hf"),
        tio._tag(1, 0) + tio._varint(2) + tio._tag(2, 0) + tio._varint(7)
        + _lf(7, b"".join(tio._varint(v) for v in (1, 2 ** 63 + 5)))
        + _lf(8, b"i64"),
    ]
    for t in cases:
        (gn, ga), (wn, wa) = tio._decode_tensor(t), jio._decode_tensor(t)
        assert gn == wn and ga.dtype == wa.dtype and ga.shape == wa.shape
        np.testing.assert_array_equal(ga, wa)


def test_structural_helpers_match():
    w = np.arange(4 * 3 * 2, dtype=np.float32).reshape(12, 2)
    np.testing.assert_array_equal(tio.lstm_reorder_gates(w, 3),
                                  jio.lstm_reorder_gates(w, 3))
    assert tio.IOFC_TO_IFGO == jio.IOFC_TO_IFGO
    for mod in (jio, tio):
        nodes = [mod.OnnxNode(op_type="Add", inputs=["b", "c"],
                              outputs=["d"]),
                 mod.OnnxNode(op_type="Relu", inputs=["a"], outputs=["b"]),
                 mod.OnnxNode(op_type="Mul", inputs=["a", "w"],
                              outputs=["c"])]
        g = mod.OnnxGraph(nodes=nodes, inputs=["a"],
                          initializers={"w": np.zeros(1, np.float32)})
        order = [n.op_type for n in mod.topo_order(g)]
        assert order.index("Add") > max(order.index("Relu"),
                                        order.index("Mul"))


def test_corrupt_input_raises_like_the_jax_reader():
    bad = bytes([0x08] + [0xFF] * 11)            # varint never ends
    for mod in (jio, tio):
        with pytest.raises((ValueError, IndexError)):
            mod.read_onnx(bad)
