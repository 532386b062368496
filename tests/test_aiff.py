"""AIFF container io (gst/aiff/) — io/aiff.py + aifffilesrc/sink."""

import math
import struct

import numpy as np

import gstbad as gt
from gstbad.core.pipeline import parse_launch
from gstbad.core.spec import MediaSpec
from gstbad.io import aiff


def test_ieee80_roundtrip():
    for rate in (8000, 11025, 22050, 44100, 48000, 96000, 192000):
        buf = aiff.write_ieee80(float(rate))
        assert len(buf) == 10
        assert aiff.read_ieee80(buf) == rate
    # reference quirk: e == 32767 -> HUGE_VAL (aiffparse.c:680-689)
    assert aiff.read_ieee80(b"\x7f\xff\x80" + b"\x00" * 7) == math.inf
    assert aiff.read_ieee80(b"\xff\xff\x00" + b"\x00" * 7) == -math.inf


def test_write_read_roundtrip_all_formats(tmp_path):
    rng = np.random.default_rng(0)
    cases = [
        ("S16", rng.integers(-32768, 32767, (500, 2)).astype(np.int16)),
        ("S32", rng.integers(-2**31, 2**31 - 1, (300, 1)).astype(np.int32)),
        ("F32", rng.standard_normal((400, 3)).astype(np.float32)),
        ("F64", rng.standard_normal((200, 2))),
    ]
    for fmt, samples in cases:
        p = tmp_path / f"t_{fmt}.aiff"
        spec = MediaSpec(kind="audio", format=fmt, rate=44100,
                         channels=samples.shape[1])
        aiff.write_aiff(p, spec, samples)
        spec2, got = aiff.read_aiff(p)
        assert spec2.format == fmt
        assert spec2.rate == 44100 and spec2.channels == samples.shape[1]
        np.testing.assert_array_equal(got, samples)


def _chunk(tag, payload):
    pad = b"\x00" if len(payload) & 1 else b""
    return tag + struct.pack(">I", len(payload)) + payload + pad


def test_read_s24_and_sowt():
    # hand-built AIFC with sowt (little-endian S16)
    data = np.array([[1000, -2000], [32767, -32768]], np.int16)
    comm = (struct.pack(">HIH", 2, 2, 16) + aiff.write_ieee80(22050.0)
            + b"sowt")
    ssnd = struct.pack(">II", 0, 0) + data.astype("<i2").tobytes()
    body = b"AIFC" + _chunk(b"COMM", comm) + _chunk(b"SSND", ssnd)
    form = b"FORM" + struct.pack(">I", len(body)) + body
    spec, got = aiff.read_aiff(form)
    assert spec.format == "S16" and spec.rate == 22050
    np.testing.assert_array_equal(got, data)

    # S24 big-endian widens to sign-extended S32
    vals = np.array([[-(1 << 23)], [(1 << 23) - 1], [-1]], np.int32)
    raw = b"".join(int(v).to_bytes(3, "big", signed=True)
                   for v in vals[:, 0])
    comm = struct.pack(">HIH", 1, 3, 24) + aiff.write_ieee80(48000.0)
    ssnd = struct.pack(">II", 0, 0) + raw
    body = b"AIFF" + _chunk(b"COMM", comm) + _chunk(b"SSND", ssnd)
    form = b"FORM" + struct.pack(">I", len(body)) + body
    spec, got = aiff.read_aiff(form)
    assert spec.format == "S32"
    np.testing.assert_array_equal(got[:, 0], vals[:, 0])


def test_aiff_pipeline_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    samples = rng.integers(-30000, 30000, (2048, 2)).astype(np.int16)
    src = tmp_path / "in.aiff"
    dst = tmp_path / "out.aiff"
    aiff.write_aiff(src, MediaSpec(kind="audio", format="S16", rate=48000,
                                   channels=2), samples)
    p = parse_launch(f"aifffilesrc location={src} samplesperbuffer=256 "
                     f"! identity ! aifffilesink location={dst}")
    p.run(window=4)
    p.close()
    spec, got = aiff.read_aiff(dst)
    assert spec.rate == 48000 and spec.channels == 2
    np.testing.assert_array_equal(got, samples)
