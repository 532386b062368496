"""mpegvideoparse (gst/videoparsers) — upstream unit-test
transcription (tests/check/elements/mpegvideoparse.c canned streams +
the real CEA-708 sample file)."""

import os

import pytest

import gstbad as gt
from gstbad.io import mpegvideo as mpv

# mpegvideoparse.c:46-77 vectors
MPEG2_SEQ = bytes([
    0x00, 0x00, 0x01, 0xb3, 0x02, 0x00, 0x18, 0x15,
    0xff, 0xff, 0xe0, 0x28, 0x00, 0x00, 0x01, 0xb5,
    0x14, 0x8a, 0x00, 0x01, 0x00, 0x00, 0x00, 0x00,
    0x01, 0xb8, 0x00, 0x08, 0x00, 0x00,
])
MPEG1_SEQ = bytes([
    0x00, 0x00, 0x01, 0xb3, 0x02, 0x00, 0x18, 0x15,
    0xff, 0xff, 0xe0, 0x28, 0x00, 0x00, 0x01, 0xb8,
    0x00, 0x08, 0x00, 0x00,
])
MPEG2_IFRAME = bytes([
    0x00, 0x00, 0x01, 0x00, 0x00, 0x0f, 0xff, 0xf8,
    0x00, 0x00, 0x01, 0xb5, 0x8f, 0xff, 0xf3, 0x41,
    0x80, 0x00, 0x00, 0x01, 0x01, 0x23, 0xf8, 0x7d,
    0x29, 0x48, 0x8b, 0x94, 0xa5, 0x22, 0x20, 0x00,
    0x00, 0x01, 0x02, 0x23, 0xf8, 0x7d, 0x29, 0x48,
    0x8b, 0x94, 0xa5, 0x22, 0x20,
])
MPEG1_IFRAME = bytes([
    0x00, 0x00, 0x01, 0x00, 0x00, 0x0f, 0xff, 0xf8,
    0x00, 0x00, 0x01, 0x01, 0x23, 0xf8, 0x7d,
    0x29, 0x48, 0x8b, 0x94, 0xa5, 0x22, 0x20, 0x00,
    0x00, 0x01, 0x02, 0x23, 0xf8, 0x7d, 0x29, 0x48,
    0x8b, 0x94, 0xa5, 0x22, 0x20,
])

CC_FILE = os.path.join(os.path.dirname(__file__), "data",
                       "mpeg2-es-with-cea708-cc.dat")


def test_sequence_header_golden():
    """mpegvideoparse.c:192-193: 32x24."""
    hdr = mpv.parse_sequence_header(MPEG2_SEQ[4:])
    assert (hdr.width, hdr.height) == (32, 24)
    assert hdr.fps_code == 5 and (hdr.fps_n, hdr.fps_d) == (30, 1)
    assert hdr.aspect_code == 1
    mpv.parse_sequence_extension(MPEG2_SEQ[16:], hdr)
    assert hdr.mpeg2
    assert mpv.par_from_aspect(hdr) == (1, 1)


def test_detect_stream_mpeg2():
    """test_parse_detect_stream_mpeg2: caps from seq (+ext)."""
    el = gt.make("mpegvideoparse")
    el.push(MPEG2_SEQ + MPEG2_IFRAME)
    el.finish()
    caps = el.src_caps
    assert caps["mpegversion"] == 2
    assert caps["width"] == 32 and caps["height"] == 24
    assert caps["systemstream"] is False


def test_detect_stream_mpeg1():
    el = gt.make("mpegvideoparse")
    el.push(MPEG1_SEQ + MPEG1_IFRAME)
    el.finish()
    assert el.src_caps["mpegversion"] == 1
    assert el.src_caps["width"] == 32


def test_parse_normal_and_split():
    """First frame = seq+gop+iframe merged (verify_buffer's merged
    branch, mpegvideoparse.c:90-108); later frames bare; invariant to
    chunking."""
    stream = MPEG2_SEQ + MPEG2_IFRAME * 3
    el = gt.make("mpegvideoparse")
    whole = el.push(stream) + el.finish()
    assert len(whole) == 3
    assert whole[0]["data"] == MPEG2_SEQ + MPEG2_IFRAME
    assert whole[1]["data"] == MPEG2_IFRAME
    for step in (1, 7):
        el = gt.make("mpegvideoparse")
        got = []
        for i in range(0, len(stream), step):
            got += el.push(stream[i:i + step])
        got += el.finish()
        assert [o["data"] for o in got] == [o["data"] for o in whole]


def test_gop_split():
    """gop-split=true separates the config from the gop+frame
    (the GOP starts a frame even after a sequence,
    gstmpegvideoparse.c:519-523)."""
    el = gt.make("mpegvideoparse", **{"gop-split": True})
    outs = el.push(MPEG2_SEQ + MPEG2_IFRAME) + el.finish()
    assert len(outs) == 2
    # header ends before the GOP start code (the last 8 bytes)
    assert outs[0]["data"] == MPEG2_SEQ[:-8]
    assert outs[1]["data"] == MPEG2_SEQ[-8:] + MPEG2_IFRAME


def test_picture_type():
    assert mpv.picture_type(MPEG2_IFRAME[4:]) == mpv.PICTURE_I


@pytest.mark.skipif(not os.path.exists(CC_FILE),
                    reason="cc sample not present")
def test_parse_cea708_captions():
    """test_parse_cea708_captions (mpegvideoparse.c:237-290): every
    frame of the sample carries 60 bytes of cc triplets; the first two
    are CEA-608 field 2/1, the rest CCP data."""
    el = gt.make("mpegvideoparse")
    with open(CC_FILE, "rb") as f:
        data = f.read()
    outs = el.push(data) + el.finish()
    frames = [o for o in outs if o["captions"]]
    assert len(frames) >= 50
    for o in frames[:50]:
        cc = b"".join(o["captions"])
        assert len(cc) == 60
        for j in range(20):
            cc_type = cc[3 * j] & 0x03
            if j == 0:
                assert cc_type == 1
            elif j == 1:
                assert cc_type == 0
            elif j > 2:
                assert cc_type in (2, 3)
