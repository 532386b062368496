"""jpeg2000parse (gst/videoparsers) over the upstream OpenJPEG
vectors (tests/data/jpeg2000_frames.bin)."""

import json
import os

import gstbad as gt

DATA = os.path.dirname(__file__) + "/data"


def _vec(name):
    blob = open(os.path.join(DATA, "jpeg2000_frames.bin"), "rb").read()
    idx = json.load(open(os.path.join(DATA, "jpeg2000_frames.json")))
    off, ln = idx[name]
    return blob[off:off + ln]


def test_caps_rgb():
    """Sink template expectations (jpeg2000parse.c:54-66): 32x32,
    sampling RGB, profile 0, colorspace sRGB."""
    el = gt.make("jpeg2000parse")
    outs = el.push(_vec("rgb_32_32_j2k"))
    assert len(outs) == 1
    caps = el.src_caps
    assert (caps["width"], caps["height"]) == (32, 32)
    assert caps["sampling"] == "RGB"
    assert caps["colorspace"] == "sRGB"
    assert caps["profile"] == 0


def test_caps_mono():
    el = gt.make("jpeg2000parse")
    el.push(_vec("mono_32_32_j2k"))
    caps = el.src_caps
    assert caps["sampling"] == "GRAYSCALE"
    assert caps["colorspace"] == "GRAY"
    assert (caps["width"], caps["height"]) == (32, 32)


def test_framing_and_unwrap():
    """j2c box / jp2 wrappers contain the same codestream; framing
    extracts it; chunking invariant (gst_parser_test_normal)."""
    j2k = _vec("rgb_32_32_j2k")
    for wrapped in ("rgb_32_32_j2c", "rgb_32_32_jp2"):
        el = gt.make("jpeg2000parse")
        outs = el.push(_vec(wrapped))
        assert len(outs) == 1
        assert outs[0]["data"] == j2k
    stream = j2k * 3
    el = gt.make("jpeg2000parse")
    whole = el.push(stream) + el.finish()
    assert [o["data"] for o in whole] == [j2k] * 3
    for step in (1, 17):
        el = gt.make("jpeg2000parse")
        got = []
        for i in range(0, len(stream), step):
            got += el.push(stream[i:i + step])
        got += el.finish()
        assert [o["data"] for o in got] == [j2k] * 3
