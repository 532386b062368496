"""pngparse + diracparse (gst/videoparsers/gstpngparse.c,
gstdiracparse.c) and intersubsink/src (gst/inter/gstintersub*.c)."""

import io as _io
import struct
import zlib

import numpy as np
import pytest

import gstbad as gt
from gstbad.io import dirac


# ---------------------------------------------------------------- png

def make_png(width: int, height: int, extra_chunks=()) -> bytes:
    """Minimal well-formed PNG (signature + IHDR + IDAT + IEND)."""
    def chunk(code: bytes, payload: bytes) -> bytes:
        crc = zlib.crc32(code + payload) & 0xFFFFFFFF
        return (struct.pack(">I", len(payload)) + code + payload
                + struct.pack(">I", crc))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, 0, 0, 0, 0)
    raw = b"".join(b"\x00" + bytes(width) for _ in range(height))
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
    for code, payload in extra_chunks:
        out += chunk(code, payload)
    out += chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")
    return out


def test_pngparse_frames_and_caps():
    el = gt.make("pngparse")
    png = make_png(64, 48)
    frames = el.push(png + make_png(64, 48))
    assert len(frames) == 2
    assert frames[0]["data"] == png
    assert el.src_caps == {"media": "image/png", "parsed": True,
                           "width": 64, "height": 48}


def test_pngparse_incremental_and_resync():
    el = gt.make("pngparse")
    png = make_png(16, 8)
    # garbage with a decoy prefix, then the real file, split mid-chunk
    stream = b"junk\x89PNGnope garbage" + png
    out = []
    for i in range(0, len(stream), 7):
        out += el.push(stream[i:i + 7])
    assert len(out) == 1 and out[0]["data"] == png
    assert el.width == 16 and el.height == 8


def test_pngparse_caps_change_and_framerate():
    el = gt.make("pngparse")
    el.set_caps(framerate=(30, 1))
    el.push(make_png(10, 10))
    caps1 = el.src_caps
    assert caps1["framerate"] == (30, 1) and caps1["width"] == 10
    el.push(make_png(20, 5))
    assert el.src_caps["width"] == 20 and el.src_caps["height"] == 5
    # validate our synthetic PNG is a real PNG (cross-check the fixture)
    try:
        import PIL.Image  # noqa
        img = PIL.Image.open(_io.BytesIO(make_png(10, 10)))
        assert img.size == (10, 10)
    except ImportError:
        pass


def test_pngparse_ancillary_chunks_inside_frame():
    el = gt.make("pngparse")
    png = make_png(4, 4, extra_chunks=((b"tEXt", b"Comment\x00hi"),))
    out = el.push(png)
    assert len(out) == 1 and out[0]["data"] == png


# ---------------------------------------------------------------- dirac

def make_seq_header(**kw) -> dirac.SequenceHeader:
    h = dirac.SequenceHeader(
        major_version=2, minor_version=2, profile=8, level=0,
        index=0, width=352, height=288, chroma_format=2, interlaced=0,
        frame_rate_numerator=25, frame_rate_denominator=1,
        aspect_ratio_numerator=1, aspect_ratio_denominator=1,
        clean_width=352, clean_height=288,
        luma_offset=0, luma_excursion=255,
        chroma_offset=128, chroma_excursion=255)
    for k, v in kw.items():
        setattr(h, k, v)
    return h


def test_dirac_unpack_interleaved_expgolomb_roundtrip():
    # schro_unpack_decode_uint (dirac_parse.c:477-492)
    for v in [0, 1, 2, 3, 4, 7, 8, 100, 255, 256, 1000, 65535]:
        data = dirac.Pack().put_uint(v).bytes()
        assert dirac.Unpack(data).decode_uint() == v
    # guard bit: reading past the end yields 1s -> decode_uint 0
    u = dirac.Unpack(b"")
    assert u.decode_bit() == 1
    assert u.decode_uint() == 0


def test_dirac_sequence_header_roundtrip():
    h = make_seq_header()
    payload = dirac.build_sequence_header_payload(h)
    got = dirac.parse_sequence_header(payload)
    assert got == h


def test_dirac_std_video_format():
    # index 9 = HD720P-60 (dirac_parse.c:238-246)
    payload = dirac.Pack() \
        .put_uint(2).put_uint(2).put_uint(2).put_uint(1) \
        .put_uint(9) \
        .put_bit(0).put_bit(0).put_bit(0).put_bit(0).put_bit(0) \
        .put_bit(0).put_bit(0).put_bit(0) \
        .put_uint(0).bytes()
    h = dirac.parse_sequence_header(payload)
    assert (h.width, h.height) == (1280, 720)
    assert (h.frame_rate_numerator, h.frame_rate_denominator) == (60000,
                                                                  1001)
    assert (h.aspect_ratio_numerator, h.aspect_ratio_denominator) == (1, 1)
    assert h.chroma_format == 1 and h.profile == 2
    assert (h.luma_offset, h.luma_excursion) == (64, 876)


def test_diracparse_framing_and_caps():
    el = gt.make("diracparse")
    seq = dirac.build_parse_unit(
        dirac.PARSE_CODE_SEQUENCE_HEADER,
        dirac.build_sequence_header_payload(make_seq_header()))
    aux = dirac.build_parse_unit(dirac.PARSE_CODE_AUXILIARY_DATA,
                                 b"x" * 7)
    pic1 = dirac.build_parse_unit(0x0C, b"picturedata")   # intra ref
    pic2 = dirac.build_parse_unit(0x08, b"p2")
    stream = seq + aux + pic1 + pic2
    out = []
    for i in range(0, len(stream), 11):                   # odd-size pushes
        out += el.push(stream[i:i + 11])
    assert len(out) == 2
    assert out[0]["data"] == seq + aux + pic1             # frame ends at pic
    assert out[1]["data"] == pic2
    caps = el.src_caps
    assert caps["media"] == "video/x-dirac"
    assert caps["width"] == 352 and caps["height"] == 288
    assert caps["framerate"] == (25, 1)
    assert caps["profile"] == "main" and caps["level"] == "0"
    assert caps["interlace-mode"] == "progressive"


def test_diracparse_resync():
    el = gt.make("diracparse")
    pic = dirac.build_parse_unit(0x0C, b"d" * 5)
    out = el.push(b"garbage-without-sync" + pic)
    assert len(out) == 1 and out[0]["data"] == pic


def test_dirac_parse_code_predicates():
    # SCHRO_PARSE_CODE_* macros (dirac_parse.h:44-56)
    assert dirac.is_picture(0x0C) and dirac.is_picture(0x08)
    assert not dirac.is_picture(0x00) and not dirac.is_picture(0x10)
    assert dirac.num_refs(0x0D) == 1 and dirac.num_refs(0x0E) == 2
    assert dirac.is_reference(0x0C) and not dirac.is_reference(0x08)


# ---------------------------------------------------------------- intersub

def test_intersub_latch_semantics():
    sink = gt.make("intersubsink", channel="subtest1")
    src = gt.make("intersubsrc", channel="subtest1")
    # empty latch -> 1-byte zero buffer (gstintersubsrc.c:247-253)
    assert src.create() == b"\x00"
    sink.render("hello")
    sink.render("world")                   # replaces, never queues
    assert src.create() == b"world"
    assert src.create() == b"\x00"         # take clears the latch
    assert src.n_frames == 3


def test_intersub_channel_isolation():
    sink_a = gt.make("intersubsink", channel="subA")
    src_b = gt.make("intersubsrc", channel="subB")
    sink_a.render("only-a")
    assert src_b.create() == b"\x00"
    src_a = gt.make("intersubsrc", channel="subA")
    assert src_a.create() == b"only-a"
