"""uvch264mjpgdemux (sys/uvch264) — byte-exact against the upstream
binary fixtures (tests/data/uvch264, from uvch264demux_data)."""

import os

import pytest

import gstbad as gt
from gstbad.io import uvch264

DATA = os.path.join(os.path.dirname(__file__), "data", "uvch264")


def _read(name):
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


@pytest.mark.skipif(not os.path.isdir(DATA), reason="fixtures missing")
def test_valid_h264_jpg():
    """The jpg-preview sample: APP4 H264 extracted, jpeg byte-exact."""
    jpeg, auxes = uvch264.demux_mjpg(_read("valid_h264_jpg.mjpg"))
    assert jpeg == _read("valid_h264_jpg.jpg")
    (h,) = auxes
    assert h.fourcc == "H264"
    assert (h.width, h.height) == (640, 480)
    assert h.data == _read("valid_h264_jpg.h264")


@pytest.mark.skipif(not os.path.isdir(DATA), reason="fixtures missing")
def test_valid_h264_yuy2():
    """The yuy2-preview sample: H264 + YUY2 both extracted."""
    jpeg, auxes = uvch264.demux_mjpg(_read("valid_h264_yuy2.mjpg"))
    h = b"".join(a.data for a in auxes if a.fourcc == "H264")
    y = b"".join(a.data for a in auxes if a.fourcc == "YUY2")
    assert h == _read("valid_h264_yuy2.h264")
    assert y == _read("valid_h264_yuy2.yuy2")
    yuy2 = [a for a in auxes if a.fourcc == "YUY2"][0]
    assert (yuy2.width, yuy2.height) == (160, 90)


@pytest.mark.skipif(not os.path.isdir(DATA), reason="fixtures missing")
def test_element():
    el = gt.make("uvch264mjpgdemux")
    out = el.chain(_read("valid_h264_jpg.mjpg"), pts_ns=10 ** 9)
    assert out["jpeg"] == _read("valid_h264_jpg.jpg")
    assert out["aux"][0]["fourcc"] == "H264"
    assert out["aux"][0]["pts"] == 10 ** 9
    assert out["aux"][0]["dts"] <= 10 ** 9
    assert out["aux"][0]["duration"] > 0


def test_passthrough_plain_jpeg():
    """A jpeg without APP4 markers passes through untouched."""
    plain = b"\xff\xd8\xff\xe0\x00\x10" + b"J" * 16 + b"\xff\xda" \
        + b"scan-data" + b"\xff\xd9"
    jpeg, auxes = uvch264.demux_mjpg(plain)
    assert jpeg == plain
    assert auxes == []
