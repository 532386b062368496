"""typefind + decodebin analog (io/typefind.py) and the Play
from_uri fallback."""

import struct

import numpy as np
import pytest

import gstbad as gt
from gstbad.core.pipeline import Pipeline
from gstbad.io import typefind


def test_magics():
    ft = typefind.find_type
    assert ft(b"YUV4MPEG2 W64 H48 F30:1\n" + b"\0" * 8) \
        == "video/x-yuv4mpeg"
    assert ft(b"DKIF" + b"\0\0" + b"\x20\0" + b"AV01" + b"\0" * 20) \
        == "video/x-av1-ivf"
    assert ft(b"RIFF\x10\0\0\0WEBPVP8 ") == "image/webp"
    assert ft(bytes.fromhex("0000000c6a502020") + b"\0" * 8) \
        == "image/jp2"
    assert ft(bytes.fromhex("ff4fff51") + b"\0" * 12) == "image/x-j2c"
    # H.265 VPS NAL
    assert ft(b"\x00\x00\x00\x01\x40\x01" + b"\0" * 8) \
        == "video/x-h265"
    assert ft(b"Vgm " + b"\0" * 12) == "audio/x-vgm"
    assert ft(b"FORM\0\0\0\x20AIFF" + b"\0" * 4) == "audio/x-aiff"
    assert ft(b"MThd" + b"\0" * 12) == "audio/midi"
    assert ft(b"P5\n64 48\n255\n" + b"\0" * 4) == "image/pnm"
    assert ft(b"BZh9" + b"\0" * 12) == "application/x-bzip"
    mod = bytearray(2048)
    mod[1080:1084] = b"M.K."
    assert ft(bytes(mod)) == "audio/x-mod"
    assert ft(b"garbage here....") is None


def test_make_source_webp():
    from gstbad.io import webp
    if not webp.available():
        pytest.skip("no libwebp")
    img = np.zeros((24, 32, 3), np.uint8)
    img[..., 0] = 200
    data = webp.encode(img, lossless=True)
    mtype, el = typefind.make_source(data)
    assert mtype == "image/webp"
    pipe = Pipeline([el, gt.make("fakesink")])
    pipe.negotiate(None)
    outs = pipe.run(n_frames=1)
    got = np.concatenate([np.asarray(o.data) for o in outs])[0]
    assert np.array_equal(got, img)


def test_make_source_h265_and_play(tmp_path):
    from gstbad.io import h265
    if not h265.available():
        pytest.skip("no libx265/libde265")
    enc = h265.H265Encoder(64, 48, lossless=True,
                           speed_preset="ultrafast",
                           tune="zerolatency")
    y = np.full((48, 64), 120, np.uint8)
    u = np.full((24, 32), 90, np.uint8)
    v = np.full((24, 32), 170, np.uint8)
    stream = enc.encode(y, u, v) + b"".join(enc.flush())
    mtype, el = typefind.make_source(stream)
    assert mtype == "video/x-h265"
    pipe = Pipeline([el, gt.make("fakesink")])
    pipe.negotiate(None)
    assert el.out_spec.width == 64

    # Play.from_uri picks it up from a file
    p = tmp_path / "clip.h265"
    p.write_bytes(stream)
    from gstbad.session import Play
    player = Play.from_uri(str(p), realtime=False)
    assert player is not None


def test_make_source_av1_ivf():
    from gstbad.io import av1
    if not av1.available():
        pytest.skip("no libaom")
    from gstbad.io.ivf import write_ivf
    import tempfile, os
    enc = av1.AV1Encoder(64, 48, target_bitrate_kbps=500, cpu_used=8)
    y = np.full((48, 64), 100, np.uint8)
    u = np.full((24, 32), 110, np.uint8)
    v = np.full((24, 32), 150, np.uint8)
    packets = [enc.encode(y, u, v)]
    packets += enc.flush()
    packets = [p for p in packets if p]
    fd, path = tempfile.mkstemp(suffix=".ivf")
    os.close(fd)
    write_ivf(path, b"AV01", 64, 48, 30, 1,
              [(i, p) for i, p in enumerate(packets)])
    data = open(path, "rb").read()
    os.unlink(path)
    mtype, el = typefind.make_source(data)
    assert mtype == "video/x-av1-ivf"
    pipe = Pipeline([el, gt.make("fakesink")])
    pipe.negotiate(None)
    assert el.out_spec.format == "I420"
