"""h265parse (gst/videoparsers) — upstream unit-test transcription
(tests/check/elements/h265parse.c canned x265 NALs as goldens)."""

import pytest

import gstbad as gt
from gstbad.io import h264 as h26x
from gstbad.io import h265nal as h

# h265parse.c:52-109 (16x16 x265 stream + HDR SEIs)
H265_VPS = bytes([
    0x00, 0x00, 0x00, 0x01, 0x40, 0x01, 0x0c, 0x01, 0xff, 0xff, 0x01,
    0x60, 0x00, 0x00, 0x03, 0x00, 0x90, 0x00, 0x00, 0x03, 0x00, 0x00,
    0x03, 0x00, 0x3f, 0x95, 0x98, 0x09,
])
H265_SPS = bytes([
    0x00, 0x00, 0x00, 0x01, 0x42, 0x01, 0x01, 0x01, 0x60, 0x00, 0x00,
    0x03, 0x00, 0x90, 0x00, 0x00, 0x03, 0x00, 0x00, 0x03, 0x00, 0x3f,
    0xa0, 0x88, 0x45, 0x96, 0x56, 0x6a, 0xbc, 0xaf, 0xff, 0x00, 0x01,
    0x00, 0x01, 0x6a, 0x0c, 0x02, 0x0c, 0x08, 0x00, 0x00, 0x03, 0x00,
    0x08, 0x00, 0x00, 0x03, 0x00, 0xf0, 0x40,
])
H265_PPS = bytes([0x00, 0x00, 0x00, 0x01, 0x44, 0x01, 0xc1, 0x73,
                  0xd0, 0x89])
H265_SEI_CLLI = bytes([0x00, 0x00, 0x00, 0x01, 0x4e, 0x01, 0x90, 0x04,
                       0x03, 0xe8, 0x01, 0x90, 0x80])
H265_SEI_MDCV = bytes([
    0x00, 0x00, 0x00, 0x01, 0x4e, 0x01, 0x89, 0x18, 0x33, 0xc2, 0x86,
    0xc4, 0x1d, 0x4c, 0x0b, 0xb8, 0x84, 0xd0, 0x3e, 0x80, 0x3d, 0x13,
    0x40, 0x42, 0x00, 0x98, 0x96, 0x80, 0x00, 0x00, 0x03, 0x00, 0x01,
    0x80,
])

# h265parse.c:120-145 (single-slice 128x128)
H265_128_VPS = H265_VPS
H265_128_SPS = bytes([
    0x00, 0x00, 0x00, 0x01, 0x42, 0x01, 0x01, 0x01, 0x60, 0x00, 0x00,
    0x03, 0x00, 0x90, 0x00, 0x00, 0x03, 0x00, 0x00, 0x03, 0x00, 0x3f,
    0xa0, 0x10, 0x20, 0x20, 0x59, 0x65, 0x66, 0x92, 0x4c, 0xaf, 0xff,
    0x00, 0x01, 0x00, 0x01, 0x01, 0x00, 0x00, 0x03, 0x00, 0x01, 0x00,
    0x00, 0x03, 0x00, 0x1e, 0x08,
])
H265_128_PPS = bytes([0x00, 0x00, 0x00, 0x01, 0x44, 0x01, 0xc1, 0x72,
                      0xb4, 0x22, 0x40])
H265_128_IDR = bytes([
    0x00, 0x00, 0x00, 0x01, 0x28, 0x01, 0xaf, 0x0e, 0xe0, 0x34, 0x82,
    0x15, 0x84, 0xf4, 0x70, 0x4f, 0xff, 0xed, 0x41, 0x3f, 0xff, 0xe4,
    0xcd, 0xc4, 0x7c, 0x03, 0x0c, 0xc2, 0xbb, 0xb0, 0x74, 0xe5, 0xef,
    0x4f, 0xe1, 0xa3, 0xd4, 0x00, 0x02, 0xc2,
])

# h265parse.c:154-188 (two-slice IDR from omxh265enc)
H265_S_VPS = bytes([
    0x00, 0x00, 0x00, 0x01, 0x40, 0x01, 0x0c, 0x01, 0xff, 0xff, 0x01,
    0x40, 0x00, 0x00, 0x03, 0x00, 0x90, 0x00, 0x00, 0x03, 0x00, 0x00,
    0x03, 0x00, 0x1e, 0x25, 0x02, 0x40,
])
H265_S_SPS = bytes([
    0x00, 0x00, 0x00, 0x01, 0x42, 0x01, 0x01, 0x01, 0x40, 0x00, 0x00,
    0x03, 0x00, 0x90, 0x00, 0x00, 0x03, 0x00, 0x00, 0x03, 0x00, 0x1e,
    0xa0, 0x10, 0x20, 0x20, 0x59, 0xe9, 0x6e, 0x44, 0xa1, 0x73, 0x50,
    0x60, 0x20, 0x2e, 0x10, 0x00, 0x00, 0x03, 0x00, 0x10, 0x00, 0x00,
    0x03, 0x01, 0xe5, 0x1a, 0xff, 0xff, 0x10, 0x3e, 0x80, 0x5d, 0xf7,
    0xc2, 0x01, 0x04,
])
H265_S_PPS = bytes([0x00, 0x00, 0x00, 0x01, 0x44, 0x01, 0xc0, 0x71,
                    0x81, 0x8d, 0xb2])
H265_S_SLICE1 = bytes([
    0x00, 0x00, 0x00, 0x01, 0x28, 0x01, 0xac, 0x46, 0x13, 0xb6, 0x45,
    0x43, 0xaf, 0xee, 0x3d, 0x3f, 0x76, 0xe5, 0x73, 0x2f, 0xee, 0xd2,
    0xeb, 0xbf, 0x80,
])
H265_S_SLICE2 = bytes([
    0x00, 0x00, 0x00, 0x01, 0x28, 0x01, 0x30, 0xc4, 0x60, 0x13, 0xb6,
    0x45, 0x43, 0xaf, 0xee, 0x3d, 0x3f, 0x76, 0xe5, 0x73, 0x2f, 0xee,
    0xd2, 0xeb, 0xbf, 0x80,
])

STREAM16 = H265_VPS + H265_SPS + H265_PPS


def _nal(raw):
    return h26x.split_bytestream(raw)[0]


# ---------------------------------------------------------------- io

def test_sps_16x16_golden():
    """h265parse.c:279-285: 16x16, main profile, main tier, level 2.1."""
    sps = h.parse_sps(_nal(H265_SPS))
    assert (sps.width, sps.height) == (16, 16)
    assert h.profile_name(sps.ptl) == "main"
    assert h.tier_name(sps.ptl) == "main"
    assert h.level_name(sps.ptl) == "2.1"
    assert (sps.fps_n, sps.fps_d) == (30, 1)


def test_sps_128x128_golden():
    sps = h.parse_sps(_nal(H265_128_SPS))
    assert (sps.width, sps.height) == (128, 128)
    sps = h.parse_sps(_nal(H265_S_SPS))
    assert (sps.width, sps.height) == (128, 128)


def test_nal_types():
    assert h.nal_type(_nal(H265_VPS)) == h.NAL_VPS
    assert h.nal_type(_nal(H265_SPS)) == h.NAL_SPS
    assert h.nal_type(_nal(H265_PPS)) == h.NAL_PPS
    assert h.nal_type(_nal(H265_128_IDR)) == h.NAL_IDR_N_LP
    assert h.is_irap(h.nal_type(_nal(H265_128_IDR)))


def test_sei_goldens():
    """h265parse.c:324-327 HDR SEI strings."""
    (t1, p1), = h.parse_sei(_nal(H265_SEI_CLLI))
    assert t1 == h.SEI_CLLI
    assert h26x.content_light_level_string(p1) == "1000:400"
    (t2, p2), = h.parse_sei(_nal(H265_SEI_MDCV))
    assert h26x.mastering_display_string(p2) == \
        "34000:16000:13250:34500:7500:3000:15635:16450:10000000:1"


def test_first_slice_flag():
    assert h.first_slice_segment_in_pic(_nal(H265_S_SLICE1)) == 1
    assert h.first_slice_segment_in_pic(_nal(H265_S_SLICE2)) == 0


def test_hvcc_roundtrip():
    cd = h.build_hvcc([_nal(H265_VPS)], [_nal(H265_SPS)],
                      [_nal(H265_PPS)])
    assert cd[0] == 1
    ln, nals = h.parse_hvcc(cd)
    assert ln == 4
    assert nals == [_nal(H265_VPS), _nal(H265_SPS), _nal(H265_PPS)]


# ----------------------------------------------------------- element

def test_parse_detect_stream():
    el = gt.make("h265parse")
    el.push(STREAM16 + H265_128_IDR)
    el.finish()
    caps = el.src_caps
    assert caps["width"] == 16 and caps["height"] == 16
    assert caps["profile"] == "main"
    assert caps["tier"] == "main"
    assert caps["level"] == "2.1"


def test_parse_detect_stream_with_hdr_sei():
    el = gt.make("h265parse")
    el.push(H265_SEI_CLLI + H265_SEI_MDCV + STREAM16 + H265_128_IDR)
    el.finish()
    assert el.src_caps["content-light-level"] == "1000:400"
    assert el.src_caps["mastering-display-info"] == \
        "34000:16000:13250:34500:7500:3000:15635:16450:10000000:1"


def test_parse_normal_split_invariance():
    stream = (H265_128_VPS + H265_128_SPS + H265_128_PPS
              + H265_128_IDR) * 3
    el = gt.make("h265parse")
    whole = el.push(stream) + el.finish()
    assert len(whole) == 3
    for step in (1, 7):
        el = gt.make("h265parse")
        got = []
        for i in range(0, len(stream), step):
            got += el.push(stream[i:i + step])
        got += el.finish()
        assert [o["data"] for o in got] == [o["data"] for o in whole]


def test_au_contains_headers_plus_idr():
    """verify_buffer_bs_au (h265parse.c:195-231): the first AU is
    VPS+SPS+PPS+IDR byte-exact, later AUs are the bare frame."""
    stream = (H265_128_VPS + H265_128_SPS + H265_128_PPS
              + H265_128_IDR) + H265_128_IDR
    el = gt.make("h265parse")
    outs = el.push(stream) + el.finish()
    assert len(outs) == 2
    assert outs[0]["data"] == (H265_128_VPS + H265_128_SPS
                               + H265_128_PPS + H265_128_IDR)
    assert outs[1]["data"] == H265_128_IDR
    assert all(o["keyframe"] for o in outs)


def test_multi_slice_single_au():
    """Two slices of one picture (first_slice flag 1 then 0) stay in
    ONE AU (the upstream sliced tests' grouping)."""
    stream = (H265_S_VPS + H265_S_SPS + H265_S_PPS
              + H265_S_SLICE1 + H265_S_SLICE2) * 2
    el = gt.make("h265parse")
    outs = el.push(stream) + el.finish()
    assert len(outs) == 2
    assert outs[0]["data"].endswith(H265_S_SLICE1 + H265_S_SLICE2)


def test_bytestream_to_hvc1():
    el = gt.make("h265parse")
    el.set_output("hvc1", "au")
    outs = el.push(STREAM16 + H265_128_IDR) + el.finish()
    cd = el.src_caps["codec_data"]
    ln, nals = h.parse_hvcc(cd)
    assert nals[0] == _nal(H265_VPS)
    idr = _nal(H265_128_IDR)
    assert outs[-1]["data"] == len(idr).to_bytes(4, "big") + idr


def test_hvc1_to_bytestream():
    cd = h.build_hvcc([_nal(H265_S_VPS)], [_nal(H265_S_SPS)],
                      [_nal(H265_S_PPS)])
    el = gt.make("h265parse", **{"config-interval": -1})
    el.set_caps("hvc1", codec_data=cd)
    el.set_output("byte-stream", "au")
    s1 = _nal(H265_S_SLICE1)
    outs = el.push(len(s1).to_bytes(4, "big") + s1, pts_ns=0)
    nals = h26x.split_bytestream(outs[0]["data"])
    assert [h.nal_type(n) for n in nals] == [
        h.NAL_VPS, h.NAL_SPS, h.NAL_PPS, h.NAL_IDR_N_LP]
    assert el.src_caps["width"] == 128
