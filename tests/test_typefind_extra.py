"""typefind additions: adaptive manifests, BMFF, opus, VC-1."""

import struct

import pytest

from gstbad.io import vc1
from gstbad.io.opus import build_id_header
from gstbad.io.typefind import find_type


def test_typefind_opus():
    assert find_type(build_id_header() + b"\x00" * 8) == "audio/x-opus"


def test_typefind_bmff():
    ftyp = struct.pack(">I", 16) + b"ftyp" + b"isom" + b"\x00" * 4
    assert find_type(ftyp) == "video/quicktime"
    moof = struct.pack(">I", 24) + b"moof" + b"\x00" * 16
    assert find_type(moof) == "video/iso-fragmented"


def test_typefind_manifests():
    assert find_type(b"#EXTM3U\n#EXT-X-TARGETDURATION:2\n") \
        == "application/x-hls"
    assert find_type(b'<?xml version="1.0"?>\n<MPD xmlns="urn:mpeg'
                     b':dash:schema:mpd:2011"></MPD>') \
        == "application/dash+xml"
    assert find_type(b'<SmoothStreamingMedia TimeScale="10000000">'
                     b"</SmoothStreamingMedia>") \
        == "application/vnd.ms-sstr+xml"


def test_typefind_vc1_sequence_layer():
    layer = vc1.make_sequence_layer(
        vc1.PROFILE_MAIN, vc1.StructC(profile=vc1.PROFILE_MAIN),
        320, 240, 2, 25, 1)
    assert find_type(layer + b"\x00" * 8) == "video/x-wmv"


def test_typefind_existing_still_win():
    # the XML probe must not shadow earlier magics
    assert find_type(b"YUV4MPEG2 W64 H48 F30:1\n") \
        == "video/x-yuv4mpeg"
    assert find_type(b"\xff\xd8\xff\xe0" + b"\x00" * 16) \
        == "image/jpeg"


def test_typefind_ttml():
    assert find_type(b'<?xml version="1.0"?><tt xmlns='
                     b'"http://www.w3.org/ns/ttml"></tt>') \
        == "application/ttml+xml"
