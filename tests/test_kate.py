"""Kate stream codec (ext/kate/) — upstream unit-test transcription.

The canned packets come verbatim from
/root/reference/tests/check/elements/kate.c:30-73 (the only in-tree
Kate bitstream spec, since libkate itself is absent); each test below
mirrors one upstream GST_START_TEST case.
"""

import numpy as np
import pytest

from gstbad.elements.kate import KateDec, KateEnc, KateParse, KateTag
from gstbad.io import kate as kate_io
from gstbad.io.typefind import find_type

NSEC = 1_000_000_000

# kate.c:30-35
KATE_HEADER_0x80 = bytes([
    0x80, 0x6b, 0x61, 0x74, 0x65, 0x00, 0x00, 0x00, 0x00, 0x00, 0x01,
    0x09, 0x00, 0x00, 0x00, 0x20,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0xe8, 0x03, 0x00,
    0x00, 0x01, 0x00, 0x00, 0x00,
    0x65, 0x6e, 0x5f, 0x47, 0x42, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00,
    0x6e, 0x6f, 0x6e, 0x65, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00,
])

# kate.c:37-42
KATE_HEADER_0x81 = bytes([
    0x81, 0x6b, 0x61, 0x74, 0x65, 0x00, 0x00, 0x00, 0x00, 0x15, 0x00,
    0x00, 0x00, 0x6c, 0x69, 0x62,
    0x6b, 0x61, 0x74, 0x65, 0x20, 0x30, 0x2e, 0x31, 0x2e, 0x30, 0x20,
    0x28, 0x54, 0x69, 0x67, 0x65,
    0x72, 0x29, 0x01, 0x00, 0x00, 0x00, 0x0b, 0x00, 0x00, 0x00, 0x54,
    0x49, 0x54, 0x4c, 0x45, 0x3d,
    0x54, 0x69, 0x67, 0x65, 0x72,
])

# kate.c:44-46 (truncated aux header the parser must tolerate)
KATE_HEADER_0x8X = bytes([0x80, 0x6b, 0x61, 0x74, 0x65, 0, 0, 0, 0, 0])
# kate.c:48-49
KATE_HEADER_0x88 = bytes([0x88, 0x6b, 0x61, 0x74, 0x65, 0, 0, 0, 0, 0, 0])

# kate.c:51-56 (text data packet)
KATE_HEADER_0x00 = bytes([
    0x00, 0xe8, 0x03, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0xd0, 0x07,
    0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x0e, 0x00,
    0x00, 0x00, 0x70, 0x6c, 0x61,
    0x69, 0x6e, 0x20, 0x6f, 0x6c, 0x64, 0x20, 0x74, 0x65, 0x78, 0x74,
    0x08, 0x00,
])

KATE_HEADER_0x7F = bytes([0x7f])

# kate.c:62-73 (3x1 -> 4x2 SPU, colours 0/1 over 3/2)
KATE_SPU = bytes([
    0x00, 0x1b, 0x00, 0x06, 0x45, 0x76, 0x00, 0x00, 0x00, 0x06,
    0x06, 0x00, 0x04, 0x00, 0x05,
    0x05, 0x00, 0x30, 0x04, 0x00, 0x10, 0x02,
    0x04, 0x0f, 0xff,
    0x01, 0xff,
])


def _send_headers(el):
    """test_kate_send_headers (kate.c:647-685)."""
    out = []
    out += el.chain(KATE_HEADER_0x80)
    out += el.chain(KATE_HEADER_0x81)
    for i in range(2, 8):
        out += el.chain(bytes([0x80 | i]) + KATE_HEADER_0x8X[1:])
    out += el.chain(KATE_HEADER_0x88)
    return out


def _check_buffers(packets, expected, num_headers=9):
    """check_buffers (kate.c:225-264): 9 headers, data, final EOS."""
    assert len(packets) >= num_headers + expected
    for i, pkt in enumerate(packets):
        data = pkt["data"]
        assert len(data) > 0
        if i < num_headers:
            assert data[0] == (0x80 | i)
        elif i == len(packets) - 1:
            assert data[0] == 0x7F
        else:
            assert 0 <= data[0] < 0x7F


# ---------------------------------------------------------------- golden

def test_id_header_roundtrip():
    """The 0x80 vector parses to the documented fields and re-serializes
    byte-exact."""
    ki = kate_io.parse_id_header(KATE_HEADER_0x80)
    assert ki.bitstream_version_major == 0
    assert ki.bitstream_version_minor == 1
    assert ki.num_headers == 9
    assert ki.granule_shift == 32
    assert ki.gps_numerator == 1000 and ki.gps_denominator == 1
    assert ki.language == "en_GB" and ki.category == "none"
    assert ki.original_canvas_width == 0
    assert kate_io.serialize_id_header(ki) == KATE_HEADER_0x80


def test_comment_header_roundtrip():
    vendor, comments = kate_io.parse_comment_header(KATE_HEADER_0x81)
    assert vendor == "libkate 0.1.0 (Tiger)"
    assert comments == ["TITLE=Tiger"]
    assert kate_io.serialize_comment_header(vendor, comments) \
        == KATE_HEADER_0x81


def test_text_packet_golden():
    """The 0x00 vector decodes to 'plain old text' at 1s..3s and
    re-serializes byte-exact."""
    ki = kate_io.parse_id_header(KATE_HEADER_0x80)
    ev = kate_io.parse_text_packet(ki, KATE_HEADER_0x00)
    assert ev.text == "plain old text"
    assert ev.start_time == pytest.approx(1.0)
    assert ev.end_time == pytest.approx(3.0)
    assert ev.text_markup_type == kate_io.MARKUP_NONE
    assert kate_io.serialize_text_packet(
        ki, 1.0, 3.0, b"plain old text") == KATE_HEADER_0x00


def test_canvas_size_packing():
    """gstkatetag.c:240-261 encode_canvas_size quirks."""
    assert kate_io.encode_canvas_size(0) == 0
    assert kate_io.encode_canvas_size(640) == 640 << 4
    assert kate_io.decode_canvas_size(kate_io.encode_canvas_size(640)) \
        == 640
    # representable only with a shift
    v = kate_io.encode_canvas_size(8192)
    assert kate_io.decode_canvas_size(v) == 8192
    # low bit set with a high bit that must shift -> unrepresentable, 0
    assert kate_io.encode_canvas_size(4097) == 0


# ------------------------------------------------------------- typefind

def test_kate_typefind():
    """test_kate_typefind (kate.c:266-292)."""
    assert find_type(KATE_HEADER_0x80) == "application/x-kate"


# --------------------------------------------------------------- katedec

def test_kate_empty_identification_header():
    """kate.c:294-326: a zero-size packet is a flow error."""
    dec = KateDec()
    with pytest.raises(kate_io.KateError):
        dec.chain(b"")


def test_kate_identification_header():
    """kate.c:330-410: headers consume silently; the tag event after the
    comment header carries language 'en' (from en_GB) and title Tiger."""
    dec = KateDec()
    assert dec.chain(KATE_HEADER_0x80) == []
    assert dec.chain(KATE_HEADER_0x81) == []
    assert len(dec.tag_events) == 1
    tags = dec.tag_events[0]
    assert tags["language-code"] == "en"
    assert tags["title"] == "Tiger"
    assert tags["encoder"] == "libkate 0.1.0 (Tiger)"
    assert tags["subtitle-codec"] == "Kate"
    # stream properties mirror the ID header (gstkateutil.c:373-377)
    assert dec.language == "en_GB" and dec.category == "none"
    assert dec.src_caps == "text/x-raw, format=utf8"


def test_katedec_decodes_text():
    """Feeding all 9 headers + the text vector yields the decoded text
    buffer with the packet's times (gstkatedec.c:276-295)."""
    dec = KateDec()
    dec.chain(KATE_HEADER_0x80)
    dec.chain(KATE_HEADER_0x81)
    for i in range(2, 9):
        dec.chain(kate_io.serialize_aux_header(0x80 | i))
    out = dec.chain(KATE_HEADER_0x00)
    assert len(out) == 1
    assert out[0]["kind"] == "text"
    assert out[0]["text"] == "plain old text"
    assert out[0]["pts"] == 1 * NSEC
    assert out[0]["duration"] == 2 * NSEC
    assert dec.chain(KATE_HEADER_0x7F) == []


def test_katedec_remove_markup():
    dec = KateDec(**{"remove-markup": True})
    enc = kate_io.KateEncoder(kate_io.KateInfo(category="subtitles"))
    for h in enc.encode_headers():
        dec.chain(h)
    pkt = enc.encode_text(0.0, 1.0, b"<span>hi</span> there",
                          kate_io.MARKUP_SIMPLE)
    out = dec.chain(pkt)
    assert out[0]["text"] == "hi there"
    assert out[0]["format"] == "utf8"


# --------------------------------------------------------------- kateenc

def test_kate_encode_nothing():
    """kate.c:412-431: EOS before any caps/data is fine... but with no
    category the header flush fails; the reference never initializes
    kate without a category and the EOS handler swallows the failure.
    Here: uninitialized EOS emits nothing."""
    enc = KateEnc()
    with pytest.raises(kate_io.KateError):
        enc.event_eos()


def test_kate_encode_empty():
    """kate.c:433-477: a buffer without category set -> flow error."""
    enc = KateEnc()
    enc.set_caps("text/x-raw, format=utf8")
    with pytest.raises(kate_io.KateError):
        enc.chain(b"", 1 * NSEC, 5 * NSEC)


def test_kate_encode_simple():
    """kate.c:479-529: one NUL byte of text -> 9 headers + 1 data packet
    + EOS."""
    enc = KateEnc(category="subtitles")
    enc.set_caps("text/x-raw, format=utf8")
    packets = enc.chain(b"\x00", 1 * NSEC, 5 * NSEC)
    packets += enc.event_eos()
    _check_buffers(packets, 1 + 1)
    assert enc.src_caps == "subtitle/x-kate"
    # the data packet round-trips
    ki = kate_io.parse_id_header(packets[0]["data"])
    ev = kate_io.parse_text_packet(ki, packets[9]["data"])
    assert ev.start_time == pytest.approx(1.0)
    assert ev.end_time == pytest.approx(6.0)


def test_kate_encode_spu():
    """kate.c:531-581: an SPU buffer encodes to a data packet."""
    enc = KateEnc(category="spu-subtitles")
    enc.set_caps("subpicture/x-dvd")
    packets = enc.push_spu(KATE_SPU, 1 * NSEC)
    # this SPU has no hide time in a second sequence?  It does: the
    # command sequence carries SHOW at date 0 only, so hide <= show and
    # the packet is delayed until EOS (gstkateenc.c:884-895)
    packets += enc.event_eos()
    _check_buffers(packets, 1 + 1)


def test_kate_encode_keepalives():
    """kate.c:583-645: keepalive cadence vs keepalive-min-time."""
    n_keepalives = 1000
    for ka_time, expected in ((0.5, n_keepalives),
                              (2.0, n_keepalives // 2),
                              (5.0, n_keepalives // 5)):
        enc = KateEnc(category="subtitles",
                      **{"keepalive-min-time": ka_time})
        packets = []
        for i in range(1, n_keepalives + 1):
            packets += enc.event_segment(i * NSEC)
        packets += enc.event_eos()
        _check_buffers(packets, expected + 1)
        # exactly `expected` keepalives
        data_packets = [p for p in packets[9:-1]]
        assert len(data_packets) == expected


# ------------------------------------------------------------- kateparse

def test_kate_parse():
    """kate.c:687-739: 9 headers buffered then flushed, data + EOS
    packets forwarded, headers exposed as streamheaders."""
    parse = KateParse()
    out = _send_headers(parse)
    assert len(out) == 9  # all flushed once the 9th arrived
    assert len(parse.streamheaders) == 9
    out += parse.chain(KATE_HEADER_0x00, granulepos=(1 * NSEC) << 32,
                       pts_ns=1 * NSEC, dur_ns=5 * NSEC)
    out += parse.chain(KATE_HEADER_0x7F, granulepos=(6 * NSEC) << 32,
                       pts_ns=6 * NSEC)
    _check_buffers(out, 2)
    # passthrough is byte-exact
    assert out[0]["data"] == KATE_HEADER_0x80
    assert out[1]["data"] == KATE_HEADER_0x81
    assert out[9]["data"] == KATE_HEADER_0x00


def test_kateparse_timestamps_from_granulepos():
    """gstkateparse.c:249-266: output timestamp = granule_time."""
    parse = KateParse()
    _send_headers(parse)
    # granulepos base 5000 at 1000/1 -> 5 s
    out = parse.chain(KATE_HEADER_0x00, granulepos=5000 << 32)
    assert out[0]["pts"] == 5 * NSEC
    assert out[0]["granulepos"] == 5000 << 32


# --------------------------------------------------------------- katetag

def test_kate_tag_passthrough():
    """kate.c:741-805: no properties set -> ID and comment headers come
    out byte-identical."""
    tag = KateTag()
    out = _send_headers(tag)
    out += tag.event_eos()
    assert len(out) >= 2
    assert out[0]["data"] == KATE_HEADER_0x80
    assert out[1]["data"] == KATE_HEADER_0x81
    _check_buffers(out, 0)


def test_kate_tag():
    """kate.c:807-860: language 'cy' + category 'subtitles' land at
    offsets 32 and 48 of the ID header."""
    tag = KateTag(language="cy", category="subtitles")
    out = _send_headers(tag)
    out += tag.event_eos()
    data = out[0]["data"]
    assert len(data) == 64
    assert data[32:].split(b"\x00")[0] == b"cy"
    assert data[48:].split(b"\x00")[0] == b"subtitles"
    _check_buffers(out, 0)


def test_kate_tag_canvas_size():
    """gstkatetag.c:301-312: canvas sizes rewritten with the packed
    encoding."""
    tag = KateTag(**{"original-canvas-width": 640,
                     "original-canvas-height": 480})
    out = _send_headers(tag)
    data = out[0]["data"]
    assert int.from_bytes(data[16:18], "little") \
        == kate_io.encode_canvas_size(640)
    assert int.from_bytes(data[18:20], "little") \
        == kate_io.encode_canvas_size(480)


# ------------------------------------------------------------ SPU bridge

def test_spu_decode_golden():
    """The kate.c:62-73 SPU: area 3x1 -> 4x2, pixels [[0,1],[3,2]]."""
    region, bitmap, palette, show, hide = kate_io.spu_decode(
        KATE_SPU, kate_io.DEFAULT_CLUT)
    assert (bitmap.width, bitmap.height) == (2, 2)
    np.testing.assert_array_equal(bitmap.pixels, [[0, 1], [3, 2]])
    assert region.metric == kate_io.METRIC_PIXEL
    assert (region.x, region.y) == (3, 1)
    # alpha nibbles 0x0f 0xff -> a[0..3] = 15,15,15,0 scaled by 17
    assert list(palette.colors[:, 3]) == [255, 255, 255, 0]
    assert show == 0 and hide == 0


def test_spu_roundtrip_through_kate():
    """SPU -> kateenc -> packet -> katedec -> SPU: the re-decoded SPU
    carries the same bitmap."""
    enc = KateEnc(category="spu-subtitles")
    enc.set_caps("subpicture/x-dvd")
    packets = enc.push_spu(KATE_SPU, 0)
    packets += enc.event_eos()  # flushes the delayed SPU
    data_pkts = [p for p in packets
                 if p["data"][0] == 0x00]
    assert len(data_pkts) == 1

    dec = KateDec()
    for p in packets:
        if p["data"][0] & 0x80:
            dec.chain(p["data"])
    out = dec.chain(data_pkts[0]["data"])
    spu_out = [o for o in out if o["kind"] == "spu"]
    assert len(spu_out) == 1
    # decode the re-encoded SPU again: same pixels
    clut = [spu_out[0]["clut_event"][f"clut{i:02d}"] for i in range(16)]
    _, bitmap2, _, _, _ = kate_io.spu_decode(spu_out[0]["data"], clut)
    np.testing.assert_array_equal(bitmap2.pixels, [[0, 1], [3, 2]])


def test_spu_delayed_flush_on_segment():
    """A no-hide-time SPU flushes on a segment event past
    default-spu-duration (gstkateenc.c:1270-1281) and emits trailing
    keepalives (gstkateenc.c:768-778)."""
    enc = KateEnc(category="spu-subtitles",
                  **{"keepalive-min-time": 1.0,
                     "default-spu-duration": 1.5})
    enc.set_caps("subpicture/x-dvd")
    packets = enc.push_spu(KATE_SPU, 0)
    assert [p for p in packets if not p["header"]] == []
    out = enc.event_segment(5 * NSEC)
    kinds = [p["data"][0] for p in out]
    assert kinds[0] == 0x00            # the flushed SPU event
    assert all(k == kate_io.KEEPALIVE_TYPE for k in kinds[1:])
    # trailing keepalives at 1,2,3,4 s (gstkateenc.c:768-778) plus the
    # segment's own keepalive at 5 s (gstkateenc.c:1286-1292)
    assert len(kinds[1:]) == 5


# ------------------------------------------------------------ full loop

def test_text_pipeline_roundtrip():
    """kateenc -> kateparse -> katedec end to end."""
    enc = KateEnc(category="SUB", language="en_GB")
    enc.set_caps("text/x-raw, format=utf8")
    stream = []
    stream += enc.chain(b"hello", 0, 1 * NSEC)
    stream += enc.chain(b"world", 2 * NSEC, 1 * NSEC)
    stream += enc.event_eos()

    parse = KateParse()
    parsed = []
    for p in stream:
        parsed += parse.chain(p["data"], granulepos=p["granulepos"],
                              pts_ns=p["pts"], dur_ns=p["duration"])

    dec = KateDec()
    texts = []
    for p in parsed:
        texts += [o for o in dec.chain(p["data"]) if o["kind"] == "text"]
    assert [t["text"] for t in texts] == ["hello", "world"]
    assert texts[0]["pts"] == 0
    assert texts[1]["pts"] == 2 * NSEC
    assert dec.tag_events[0]["language-code"] == "en"
