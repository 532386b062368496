"""opusparse (ext/opus) — from-spec RFC 6716 framing cross-validated
against the REAL libopus, header rules from gstopusheader.c."""

import struct

import numpy as np
import pytest

import gstbad as gt
from gstbad.io import opus as op

need_libopus = pytest.mark.skipif(not op.libopus_available(),
                                  reason="libopus not available")


def _size_bytes(n):
    if n < 252:
        return bytes([n])
    assert n <= op.MAX_FRAME_BYTES
    rem = n - 252
    return bytes([252 + (rem & 3), rem >> 2])


def code0(toc_cfg, payload):
    return bytes([toc_cfg << 3 | 0]) + payload


def code1(toc_cfg, f1, f2):
    assert len(f1) == len(f2)
    return bytes([toc_cfg << 3 | 1]) + f1 + f2


def code2(toc_cfg, f1, f2):
    return bytes([toc_cfg << 3 | 2]) + _size_bytes(len(f1)) + f1 + f2


def code3(toc_cfg, frames, vbr=False, padding=0):
    ch = len(frames) | (0x80 if vbr else 0) | (0x40 if padding else 0)
    out = bytes([toc_cfg << 3 | 3, ch])
    if padding:
        p = padding
        while p >= 255:
            out += bytes([255])
            p -= 254
        out += bytes([p])
    if vbr:
        for f in frames[:-1]:
            out += _size_bytes(len(f))
    else:
        assert len({len(f) for f in frames}) == 1
    out += b"".join(frames)
    out += b"\x00" * padding
    return out


# --------------------------------------------------------- packet parse

def test_packet_parse_codes():
    toc, frames, off = op.packet_parse(code0(1, b"abc"))
    assert toc >> 3 == 1 and frames == [b"abc"] and off == 1
    toc, frames, off = op.packet_parse(code1(5, b"xx", b"yy"))
    assert frames == [b"xx", b"yy"] and off == 1
    toc, frames, off = op.packet_parse(code2(9, b"a", b"defg"))
    assert frames == [b"a", b"defg"] and off == 2
    toc, frames, off = op.packet_parse(
        code3(16, [b"aa", b"bb", b"cc"]))
    assert frames == [b"aa", b"bb", b"cc"] and off == 2
    toc, frames, off = op.packet_parse(
        code3(16, [b"a", b"bcd", b"ef"], vbr=True, padding=3))
    assert frames == [b"a", b"bcd", b"ef"]


def test_packet_parse_errors():
    with pytest.raises(op.OpusError):
        op.packet_parse(b"")                      # empty
    with pytest.raises(op.OpusError):
        op.packet_parse(bytes([1 << 3 | 1]) + b"abc")  # odd code 1
    with pytest.raises(op.OpusError):
        op.packet_parse(bytes([3]))               # code 3 too short
    with pytest.raises(op.OpusError):
        op.packet_parse(bytes([3, 0]))            # zero frames
    with pytest.raises(op.OpusError):
        # 7 x 60ms SILK frames > 120ms
        op.packet_parse(code3(3, [b"x"] * 7))
    with pytest.raises(op.OpusError):
        # CBR remainder not divisible
        op.packet_parse(bytes([16 << 3 | 3, 3]) + b"abcd")


@need_libopus
def test_packet_parse_matches_libopus_structured():
    packets = [
        code0(0, b""), code0(31, b"q" * 100),
        code1(14, b"aa", b"bb"),
        code2(17, b"", b"zzz"), code2(2, b"k" * 252, b"m" * 10),
        code3(16, [b"ab"] * 48), code3(20, [b"x", b"yy"], vbr=True),
        code3(24, [b"q" * 3] * 4, padding=7),
        code3(28, [b"", b"a", b"bb"], vbr=True, padding=260),
    ]
    for pkt in packets:
        toc1, frames1, off1 = op.packet_parse(pkt)
        toc2, frames2, off2 = op.packet_parse_libopus(pkt)
        assert (toc1, frames1, off1) == (toc2, frames2, off2), pkt


@need_libopus
def test_packet_parse_matches_libopus_fuzz():
    """Random byte blobs: accept/reject and framing must agree with
    the real library byte-for-byte."""
    rng = np.random.default_rng(11)
    agree_ok = 0
    for _ in range(2000):
        n = int(rng.integers(0, 40))
        pkt = rng.integers(0, 256, n, np.uint8).tobytes()
        try:
            ours = op.packet_parse(pkt)
            ours_err = None
        except op.OpusError:
            ours = ours_err = "err"
        try:
            theirs = op.packet_parse_libopus(pkt)
            theirs_err = None
        except op.OpusError:
            theirs = theirs_err = "err"
        assert (ours_err is None) == (theirs_err is None), pkt.hex()
        if ours_err is None:
            assert ours == theirs, pkt.hex()
            agree_ok += 1
    assert agree_ok > 100  # sanity: plenty of valid packets seen


def test_packet_duration_table():
    """gstopusparse.c:271-280."""
    assert op.packet_duration_opus(code0(0, b"x")) == 10_000_000
    assert op.packet_duration_opus(code0(3, b"x")) == 60_000_000
    assert op.packet_duration_opus(code0(16, b"x")) == 2_500_000
    assert op.packet_duration_opus(code1(16, b"a", b"b")) == 5_000_000
    assert op.packet_duration_opus(
        code3(16, [b"x"] * 10)) == 25_000_000
    # > 120 ms -> 0 (gstopusparse.c:316-319)
    assert op.packet_duration_opus(code3(3, [b"x"] * 7)) == 0
    assert op.packet_duration_opus(b"") == 0


# --------------------------------------------------------------- header

def test_id_header_roundtrip():
    hdr = op.build_id_header(44100, 2, 0, 1, 1, (0, 1),
                             pre_skip=312, gain=-256)
    assert op.is_id_header(hdr)
    h = op.parse_id_header(hdr)
    assert h.sample_rate == 44100
    assert h.channels == 2
    assert h.pre_skip == 312
    assert h.output_gain == -256
    assert h.channel_mapping_family == 0


def test_id_header_multistream():
    hdr = op.build_id_header(48000, 6, 1, 4, 2, (0, 4, 1, 2, 3, 5))
    assert op.is_id_header(hdr)
    h = op.parse_id_header(hdr)
    assert h.channels == 6
    assert h.n_streams == 4 and h.n_stereo_streams == 2
    assert h.channel_mapping == (0, 4, 1, 2, 3, 5)


def test_id_header_validation_rules():
    """gstopusheader.c:36-86."""
    good = op.build_id_header()
    assert op.is_id_header(good)
    assert not op.is_id_header(good[:18])            # too short
    bad = bytearray(good)
    bad[8] = 0x0F                                    # version >= 0x0f
    assert not op.is_id_header(bytes(bad))
    bad = bytearray(good)
    bad[9] = 0                                       # zero channels
    assert not op.is_id_header(bytes(bad))
    bad = bytearray(good)
    bad[9] = 3                                       # family 0, > 2 ch
    assert not op.is_id_header(bytes(bad))
    multi = bytearray(op.build_id_header(48000, 4, 1, 2, 2,
                                         (0, 1, 2, 3)))
    assert op.is_id_header(bytes(multi))
    multi[19] = 0                                    # zero streams
    assert not op.is_id_header(bytes(multi))
    multi[19] = 1                                    # stereo > streams
    assert not op.is_id_header(bytes(multi))


def test_caps_from_header():
    hdr = op.build_id_header(24000, 2, 0, 1, 1, (0, 1), pre_skip=100)
    caps = op.caps_from_header(hdr)
    assert caps["media"] == "audio/x-opus"
    assert caps["framed"] is True
    assert caps["rate"] == 48000  # always 48000 on caps
    assert caps["channels"] == 2
    assert caps["stream-count"] == 1
    assert caps["coupled-count"] == 1
    assert caps["streamheader"] == [hdr]


# -------------------------------------------------------------- element

def _tv(packet, final_range=0):
    """libopus test-vector framing (gstopusparse.c:182-210)."""
    return struct.pack(">II", len(packet), final_range) + packet


def test_element_test_vector_framing():
    """Like the reference, raw opus_packet_parse is tried first on the
    buffered bytes; a test-vector stream only hits the test-vector
    branch while the buffer is too large to pass as a single code-0
    packet (> 1276 bytes) — exactly the in-practice condition with
    filesrc-sized buffers.  Large packets keep that invariant at every
    step."""
    pkts = [code3(16, [bytes([i]) * 320] * 4) for i in range(5)]
    stream = b"".join(_tv(p) for p in pkts)
    el = gt.make("opusparse")
    out = el.chain(stream)
    assert [o["data"] for o in out] == pkts
    # accumulated pts from the duration table (4 x 2.5 ms CELT frames)
    assert [o["pts"] for o in out] == \
        [i * 10_000_000 for i in range(5)]
    assert out[0]["duration"] == 10_000_000
    assert out[-1]["offset_end"] == 5 * 10_000_000 * 48000 \
        // 1_000_000_000
    caps = out[0]["caps"]
    assert caps["channels"] == 2  # blind canonical stereo
    assert caps["rate"] == 48000


def test_element_headers_become_caps():
    hdr = op.build_id_header(48000, 1, 0, 1, 0, (0,), pre_skip=312)
    tags = b"OpusTags" + struct.pack("<I", 4) + b"none" \
        + struct.pack("<I", 0)
    el = gt.make("opusparse")
    assert el.chain(hdr, packetized=True) == []    # held, not output
    assert el.chain(tags, packetized=True) == []
    out = el.chain(code0(1, b"data"), packetized=True)
    assert len(out) == 1
    caps = out[0]["caps"]
    assert caps["channels"] == 1
    assert caps["streamheader"][0][:8] == b"OpusHead"
    assert struct.unpack_from("<H", caps["streamheader"][0], 10)[0] \
        == 312  # pre-skip preserved
    assert caps["streamheader"][1] == tags


def test_element_skips_garbage():
    """0xFF bytes never parse (code-3 frame count over 120 ms) so the
    parser skips them one at a time (gstopusparse.c:233-238)."""
    pkt = code3(16, [b"p" * 320] * 4)
    stream = b"\xff\xff\xff\xff\xff" + _tv(pkt)
    el = gt.make("opusparse")
    out = el.chain(stream)
    assert [o["data"] for o in out] == [pkt]


def test_element_oversized_test_vector_rejected():
    """packet_size > MAX_PAYLOAD_BYTES is not treated as framing
    (gstopusparse.c:189-192); the bogus header is skipped away."""
    el = gt.make("opusparse")
    pkt = code3(16, [b"x" * 320] * 4)
    bogus = b"\xff\xff" + struct.pack(">H", 50000) + b"\xff" * 4
    out = el.chain(bogus + _tv(pkt))
    assert len(out) == 1 and out[0]["data"] == pkt
