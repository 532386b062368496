"""x265enc / libde265dec (ext/x265, ext/libde265) over the real
libraries — encode/decode round trips."""

import numpy as np
import pytest

import gstbad as gt
from gstbad.core.pipeline import Pipeline, parse_launch
from gstbad.io import h265

pytestmark = pytest.mark.skipif(not h265.available(),
                                reason="libx265/libde265 not present")


def _frames(n, W=64, H=48):
    out = []
    for i in range(n):
        yy, xx = np.mgrid[0:H, 0:W]
        y = ((xx * 3 + yy * 2 + i * 16) % 256).astype(np.uint8)
        u = np.full((H // 2, W // 2), (100 + 7 * i) % 256, np.uint8)
        v = np.full((H // 2, W // 2), (200 - 5 * i) % 256, np.uint8)
        out.append((y, u, v))
    return out


def test_binding_lossless_roundtrip_bit_exact():
    frames = _frames(5)
    enc = h265.H265Encoder(64, 48, lossless=True,
                           speed_preset="ultrafast",
                           tune="zerolatency")
    stream = b""
    for i, (y, u, v) in enumerate(frames):
        stream += enc.encode(y, u, v, pts=i)
    for chunk in enc.flush():
        stream += chunk
    assert stream[:4] == b"\x00\x00\x00\x01"      # annex-B
    dec = h265.H265Decoder()
    dec.push(stream)
    dec.flush()
    out = dec.decode()
    assert len(out) == 5
    for i, (y, u, v) in enumerate(frames):
        assert np.array_equal(out[i]["y"], y), i
        assert np.array_equal(out[i]["u"], u), i
        assert np.array_equal(out[i]["v"], v), i


def test_binding_lossy_quality():
    frames = _frames(4)
    enc = h265.H265Encoder(64, 48, qp=20, speed_preset="ultrafast",
                           tune="zerolatency")
    stream = b""
    for i, (y, u, v) in enumerate(frames):
        stream += enc.encode(y, u, v, pts=i)
    for chunk in enc.flush():
        stream += chunk
    out = h265.H265Decoder()
    out.push(stream)
    out.flush()
    decoded = out.decode()
    assert len(decoded) == 4
    # qp=20 on smooth gradients: close but not exact
    err = np.abs(decoded[0]["y"].astype(int)
                 - frames[0][0].astype(int))
    assert err.mean() < 8


def test_elements_roundtrip_through_pipeline():
    pipe = parse_launch(
        "videotestsrc pattern=bars width=64 height=48 format=I420 "
        "! x265enc lossless=true speed-preset=ultrafast "
        "tune=zerolatency ! fakesink")
    pipe.negotiate()
    pipe.run(n_frames=4)
    enc = pipe.elements[1]
    pipe.close()
    stream = b"".join(d for _p, d in enc.packets)
    assert stream

    # reference source frames for comparison
    ref = parse_launch(
        "videotestsrc pattern=bars width=64 height=48 format=I420 "
        "! fakesink")
    ref.negotiate()
    ref_frames = ref.run(n_frames=4)
    ry = np.concatenate([np.asarray(o.data["y"]) for o in ref_frames])

    dec = gt.make("libde265dec")
    dec.push_packet(stream)
    p2 = Pipeline([dec, gt.make("fakesink")])
    p2.negotiate(None)
    assert dec.out_spec.format == "I420"
    outs = p2.run(n_frames=4)
    dy = np.concatenate([np.asarray(o.data["y"]) for o in outs])[:4]
    assert np.array_equal(dy, ry[:4])


def test_decoded_feeds_filter_graph():
    frames = _frames(2)
    enc = h265.H265Encoder(64, 48, lossless=True,
                           speed_preset="ultrafast",
                           tune="zerolatency")
    stream = b"".join(enc.encode(y, u, v, pts=i)
                      for i, (y, u, v) in enumerate(frames))
    stream += b"".join(enc.flush())
    dec = gt.make("libde265dec")
    dec.push_packet(stream)
    pipe = Pipeline([dec, gt.make("zebrastripe", threshold=50),
                     gt.make("fakesink")])
    pipe.negotiate(None)
    outs = pipe.run(n_frames=2)
    y = np.concatenate([np.asarray(o.data["y"]) for o in outs])
    assert y.shape[1:] == (48, 64)


def test_x265enc_rejects_non_i420():
    pipe = parse_launch(
        "videotestsrc width=64 height=48 format=BGRx "
        "! x265enc ! fakesink")
    with pytest.raises(Exception):
        pipe.negotiate()
