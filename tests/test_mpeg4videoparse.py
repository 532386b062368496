"""mpeg4videoparse (gst/videoparsers) — upstream unit-test
transcription (tests/check/elements/mpeg4videoparse.c canned config +
VOP)."""

import gstbad as gt
from gstbad.io import mpeg4video as m4

# mpeg4videoparse.c:47-60
MPEG4_CONFIG = bytes([
    0x00, 0x00, 0x01, 0xb0, 0x01, 0x00, 0x00, 0x01,
    0xb5, 0x89, 0x13, 0x00, 0x00, 0x01, 0x00, 0x00,
    0x00, 0x01, 0x20, 0x00, 0xc4, 0x8d, 0x88, 0x00,
    0xf5, 0x01, 0x04, 0x03, 0x14, 0x63, 0x00, 0x00,
    0x01, 0xb3, 0x00, 0x10, 0x07,
])
MPEG4_IFRAME = bytes([
    0x00, 0x00, 0x01, 0xb6, 0x10, 0x60, 0x91, 0x82,
    0x3d, 0xb7, 0xf1, 0xb6, 0xdf, 0xc6, 0xdb, 0x7f,
    0x1b, 0x6d, 0xfb,
])


def test_vol_golden():
    """mpeg4videoparse.c:131-133: 32x24 mpegversion 4."""
    vol = m4.Vol()
    m4.parse_vos(MPEG4_CONFIG[4:5], vol)
    assert (vol.profile, vol.level) == ("simple", "1")
    off = MPEG4_CONFIG.find(b"\x00\x00\x01\x20") + 4
    m4.parse_vol(MPEG4_CONFIG[off:], vol)
    assert (vol.width, vol.height) == (32, 24)
    assert (vol.par_n, vol.par_d) == (1, 1)


def test_detect_stream():
    el = gt.make("mpeg4videoparse")
    el.push(MPEG4_CONFIG + MPEG4_IFRAME)
    el.finish()
    caps = el.src_caps
    assert caps["mpegversion"] == 4
    assert caps["width"] == 32 and caps["height"] == 24
    assert caps["profile"] == "simple"
    assert caps["codec_data"] == MPEG4_CONFIG


def test_parse_normal_split():
    """First frame = config + VOP merged; invariant to chunking."""
    stream = MPEG4_CONFIG + MPEG4_IFRAME * 3
    el = gt.make("mpeg4videoparse")
    whole = el.push(stream) + el.finish()
    assert [o["data"] for o in whole] == [
        MPEG4_CONFIG + MPEG4_IFRAME, MPEG4_IFRAME, MPEG4_IFRAME]
    assert all(o["keyframe"] for o in whole)
    for step in (1, 7):
        el = gt.make("mpeg4videoparse")
        got = []
        for i in range(0, len(stream), step):
            got += el.push(stream[i:i + step])
        got += el.finish()
        assert [o["data"] for o in got] == [o["data"] for o in whole]


def test_config_interval():
    """config-interval=-1 re-inserts the config before every I-VOP."""
    el = gt.make("mpeg4videoparse", **{"config-interval": -1})
    outs = el.push(MPEG4_CONFIG + MPEG4_IFRAME * 2)
    outs += el.finish(pts_ns=0)
    assert outs[0]["data"] == MPEG4_CONFIG + MPEG4_IFRAME
    assert outs[1]["data"] == MPEG4_CONFIG + MPEG4_IFRAME
