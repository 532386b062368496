"""ID3v1/v2 tag rendering (gst/id3tag/) — layout vs the spec and the
reference's quirks."""

import struct

from gstbad.io import id3

TAGS = {"title": "Test Title", "artist": "Ärtist", "album": "Album",
        "track-number": 3, "track-count": 12, "date": 2020,
        "genre": "Jazz", "comment": "hello world", "bpm": 128.4}


def _frames(tag: bytes, version: int):
    assert tag[:3] == b"ID3" and tag[3] == version
    size = ((tag[6] << 21) | (tag[7] << 14) | (tag[8] << 7) | tag[9])
    assert len(tag) == 10 + size
    assert (10 + size) % 1024 == 0          # GST_ROUND_UP_1024
    out = {}
    pos = 10
    while pos + 10 <= len(tag) and tag[pos] != 0:
        fid = tag[pos:pos + 4].decode()
        if version == 3:
            (flen,) = struct.unpack(">I", tag[pos + 4:pos + 8])
        else:
            flen = ((tag[pos + 4] << 21) | (tag[pos + 5] << 14)
                    | (tag[pos + 6] << 7) | tag[pos + 7])
        out[fid] = tag[pos + 10:pos + 10 + flen]
        pos += 10 + flen
    return out


def test_v2_3_layout():
    frames = _frames(id3.render_id3v2(TAGS, 3), 3)
    assert frames["TIT2"] == b"\x00Test Title"          # ASCII -> Latin-1
    # non-ASCII artist -> UTF-16LE with BOM (encoding 1)
    assert frames["TPE1"][0] == 1
    assert frames["TPE1"][1:3] == b"\xff\xfe"
    assert frames["TPE1"][3:] == "Ärtist".encode("utf-16-le")
    assert frames["TRCK"] == b"\x003/12"
    assert frames["TYER"] == b"\x002020"
    assert frames["TBPM"] == b"\x00128"
    assert frames["COMM"] == b"\x00XXXComment\x00hello world"
    assert "TDRC" not in frames


def test_v2_4_layout():
    frames = _frames(id3.render_id3v2(TAGS, 4), 4)
    assert frames["TPE1"] == b"\x03" + "Ärtist".encode("utf-8")  # UTF-8
    assert frames["TDRC"] == b"\x032020"
    assert "TYER" not in frames


def test_v1_footer():
    v1 = id3.render_id3v1(TAGS)
    assert len(v1) == 128 and v1[:3] == b"TAG"
    assert v1[3:3 + 10] == b"Test Title"
    assert v1[93:97] == b"2020"
    assert v1[126] == 3
    assert v1[127] == id3.ID3V1_GENRES.index("Jazz")
    # no tags -> no footer (id3tag.c:1412-1416)
    assert id3.render_id3v1({}) == b""
    # unknown genre leaves the 255 init byte
    v1b = id3.render_id3v1({"title": "x", "genre": "Nonexistent"})
    assert v1b[127] == 255


def test_mux_stream():
    payload = b"FAKEAUDIO" * 10
    out = id3.mux_stream(payload, TAGS)
    assert out.startswith(b"ID3")
    assert out.endswith(id3.render_id3v1(TAGS))
    assert payload in out
