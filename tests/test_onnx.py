"""ONNX model loading: io/onnx.py parser + JAX interpreter vs an
independent numpy forward pass; onnxobjectdetector element surface.

The test serializes real ONNX protobuf bytes with its own encoder
(independent of the parser under test)."""

import struct

import numpy as np
import jax.numpy as jnp
import pytest

import gstbad as gt
from gstbad.core.frame import FrameBatch
from gstbad.core.pipeline import Pipeline
from gstbad.core.spec import MediaSpec
from gstbad.io import onnx as onnxio


# -- minimal protobuf writer (wire format spec, not the parser code) --------

def _vint(v):
    out = b""
    while True:
        b7 = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _tag(fnum, wtype):
    return _vint((fnum << 3) | wtype)


def _ld(fnum, payload: bytes):
    return _tag(fnum, 2) + _vint(len(payload)) + payload


def _vi(fnum, v):
    return _tag(fnum, 0) + _vint(v & ((1 << 64) - 1))


def _tensor(name, arr):
    arr = np.asarray(arr)
    dt = {np.dtype("float32"): 1, np.dtype("int64"): 7}[arr.dtype]
    out = b"".join(_vi(1, d) for d in arr.shape)
    out += _vi(2, dt)
    out += _ld(8, name.encode())
    out += _ld(9, arr.tobytes())
    return out


def _attr_ints(name, vals):
    return _ld(1, name.encode()) + b"".join(_vi(8, v) for v in vals)


def _attr_int(name, v):
    return _ld(1, name.encode()) + _vi(3, v)


def _attr_float(name, v):
    return _ld(1, name.encode()) + _tag(2, 5) + struct.pack("<f", v)


def _node(op, inputs, outputs, attrs=()):
    out = b"".join(_ld(1, i.encode()) for i in inputs)
    out += b"".join(_ld(2, o.encode()) for o in outputs)
    out += _ld(4, op.encode())
    out += b"".join(_ld(5, a) for a in attrs)
    return out


def _vinfo(name, shape):
    dims = b"".join(_ld(1, _vi(1, d)) for d in shape)
    ttype = _ld(1, _vi(1, 1) + _ld(2, dims))
    return _ld(1, name.encode()) + _ld(2, ttype)


def _model(nodes, initializers, inputs, outputs):
    g = b"".join(_ld(1, n) for n in nodes)
    g += b"".join(_ld(5, t) for t in initializers)
    g += b"".join(_ld(11, _vinfo(n, s)) for n, s in inputs)
    g += b"".join(_ld(12, _vinfo(n, s)) for n, s in outputs)
    return _ld(7, g)


def _make_convnet(tmp_path, rng):
    """Conv(3->4, 3x3, pad 1) -> Relu -> MaxPool 2 -> Flatten -> Gemm."""
    w = rng.standard_normal((4, 3, 3, 3)).astype(np.float32) * 0.1
    bconv = rng.standard_normal(4).astype(np.float32) * 0.1
    wfc = rng.standard_normal((10, 4 * 8 * 8)).astype(np.float32) * 0.01
    bfc = rng.standard_normal(10).astype(np.float32) * 0.1
    nodes = [
        _node("Conv", ["x", "w", "bconv"], ["c1"],
              [_attr_ints("pads", [1, 1, 1, 1]),
               _attr_ints("strides", [1, 1]),
               _attr_ints("kernel_shape", [3, 3])]),
        _node("Relu", ["c1"], ["r1"]),
        _node("MaxPool", ["r1"], ["p1"],
              [_attr_ints("kernel_shape", [2, 2]),
               _attr_ints("strides", [2, 2])]),
        _node("Flatten", ["p1"], ["f1"], [_attr_int("axis", 1)]),
        _node("Gemm", ["f1", "wfc", "bfc"], ["y"],
              [_attr_int("transB", 1), _attr_float("alpha", 1.0)]),
    ]
    inits = [_tensor("w", w), _tensor("bconv", bconv),
             _tensor("wfc", wfc), _tensor("bfc", bfc)]
    blob = _model(nodes, inits, [("x", [1, 3, 16, 16])], [("y", [1, 10])])
    path = tmp_path / "net.onnx"
    path.write_bytes(blob)

    def numpy_forward(x):   # independent reference
        xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)))
        c = np.zeros((1, 4, 16, 16), np.float64)
        for o in range(4):
            for i in range(3):
                for dy in range(3):
                    for dx in range(3):
                        c[0, o] += (xp[0, i, dy:dy + 16, dx:dx + 16]
                                    * w[o, i, dy, dx])
            c[0, o] += bconv[o]
        r = np.maximum(c, 0)
        p = r.reshape(1, 4, 8, 2, 8, 2).max(axis=(3, 5))
        f = p.reshape(1, -1)
        return f @ wfc.T + bfc
    return str(path), numpy_forward


def test_onnx_loader_matches_numpy(tmp_path, rng):
    path, ref = _make_convnet(tmp_path, rng)
    graph = onnxio.load_model(path)
    fn, ins, outs = onnxio.to_jax(graph)
    assert ins == ["x"] and outs == ["y"]
    x = rng.standard_normal((1, 3, 16, 16)).astype(np.float32)
    got = np.asarray(fn(jnp.asarray(x))[0])
    np.testing.assert_allclose(got, ref(x.astype(np.float64)),
                               rtol=2e-4, atol=2e-4)


def test_onnx_unsupported_op_raises(tmp_path):
    nodes = [_node("Einsum", ["x"], ["y"])]
    blob = _model(nodes, [], [("x", [1, 4])], [("y", [1, 4])])
    p = tmp_path / "bad.onnx"
    p.write_bytes(blob)
    g = onnxio.load_model(str(p))
    fn, _, _ = onnxio.to_jax(g)
    with pytest.raises(ValueError, match="unsupported op"):
        fn(jnp.zeros((1, 4)))


def test_onnxobjectdetector_element(tmp_path, rng):
    """A toy 'detector': Conv -> GlobalAveragePool -> two Gemm heads
    (scores via Sigmoid, boxes raw); the element posts per-frame
    object-detector messages with thresholded detections."""
    w = rng.standard_normal((8, 3, 3, 3)).astype(np.float32) * 0.1
    wscore = rng.standard_normal((5, 8)).astype(np.float32)
    wbox = rng.standard_normal((20, 8)).astype(np.float32)
    nodes = [
        _node("Conv", ["x", "w"], ["c"],
              [_attr_ints("pads", [1, 1, 1, 1]),
               _attr_ints("kernel_shape", [3, 3])]),
        _node("GlobalAveragePool", ["c"], ["g"]),
        _node("Flatten", ["g"], ["f"], [_attr_int("axis", 1)]),
        _node("Gemm", ["f", "wscore"], ["logits"], [_attr_int("transB", 1)]),
        _node("Sigmoid", ["logits"], ["scores"]),
        _node("Gemm", ["f", "wbox"], ["boxes"], [_attr_int("transB", 1)]),
    ]
    inits = [_tensor("w", w), _tensor("wscore", wscore),
             _tensor("wbox", wbox)]
    blob = _model(nodes, inits, [("x", [1, 3, 32, 32])],
                  [("scores", [1, 5]), ("boxes", [1, 20])])
    mp = tmp_path / "det.onnx"
    mp.write_bytes(blob)
    labels = tmp_path / "labels.txt"
    labels.write_text("cat\ndog\nbird\ncar\ntree\n")

    el = gt.make("onnxobjectdetector", **{
        "model-file": str(mp), "label-file": str(labels),
        "input-image-format": "chw", "score-node-index": 0,
        "box-node-index": 1, "score-threshold": 0.5})
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="RGBx", width=64, height=48))
    img = rng.integers(0, 256, (2, 48, 64, 4), dtype=np.uint8)
    p.run(inputs=FrameBatch.make(jnp.asarray(img)))
    msgs = p.bus.pop(element="onnxobjectdetector")
    assert len(msgs) == 2
    m = msgs[0]
    assert m["scores"].shape == (5,)
    assert m["boxes"].shape == (5, 4)
    assert 0 <= m["count"] <= 5
    assert (np.asarray(m["scores"])[np.asarray(m["scores"]) > 0]
            > 0.5).all()
    assert el.labels == ["cat", "dog", "bird", "car", "tree"]
