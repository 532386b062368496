"""h264parse (gst/videoparsers) — upstream unit-test transcription
(tests/check/elements/h264parse.c canned NALs as goldens)."""

import pytest

import gstbad as gt
from gstbad.io import h264 as h

# h264parse.c:70-135 vectors
H264_AUD = bytes([0x00, 0x00, 0x00, 0x01, 0x09, 0xf0])
H264_SPS = bytes([
    0x00, 0x00, 0x00, 0x01, 0x67, 0x4d, 0x40, 0x15,
    0xec, 0xa4, 0xbf, 0x2e, 0x02, 0x20, 0x00, 0x00,
    0x03, 0x00, 0x2e, 0xe6, 0xb2, 0x80, 0x01, 0xe2,
    0xc5, 0xb2, 0xc0,
])
H264_PPS = bytes([0x00, 0x00, 0x00, 0x01, 0x68, 0xeb, 0xec, 0xb2])
H264_SEI_BUFFERING = bytes([0x00, 0x00, 0x00, 0x01, 0x06, 0x00, 0x01,
                            0xc0])
H264_SEI_CLLI = bytes([0x00, 0x00, 0x00, 0x01, 0x06, 0x90, 0x04, 0x03,
                       0xe8, 0x01, 0x90, 0x80])
H264_SEI_MDCV = bytes([
    0x00, 0x00, 0x00, 0x01, 0x06, 0x89, 0x18, 0x84,
    0xd0, 0x3e, 0x80, 0x33, 0x90, 0x86, 0xc4, 0x1d,
    0x4c, 0x0b, 0xb8, 0x3d, 0x13, 0x40, 0x42, 0x00,
    0x98, 0x96, 0x80, 0x00, 0x00, 0x03, 0x00, 0x01,
    0x80,
])
H264_AVC_CODEC_DATA = bytes([
    0x01, 0x4d, 0x40, 0x15, 0xff, 0xe1, 0x00, 0x17,
    0x67, 0x4d, 0x40, 0x15, 0xec, 0xa4, 0xbf, 0x2e,
    0x02, 0x20, 0x00, 0x00, 0x03, 0x00, 0x2e, 0xe6,
    0xb2, 0x80, 0x01, 0xe2, 0xc5, 0xb2, 0xc0, 0x01,
    0x00, 0x04, 0x68, 0xeb, 0xec, 0xb2,
])
H264_IDRFRAME = bytes([
    0x00, 0x00, 0x00, 0x01, 0x65, 0x88, 0x84, 0x00,
    0x10, 0xff, 0xfe, 0xf6, 0xf0, 0xfe, 0x05, 0x36,
    0x56, 0x04, 0x50, 0x96, 0x7b, 0x3f, 0x53, 0xe1,
])

STREAM = H264_SPS + H264_PPS + H264_IDRFRAME


# ---------------------------------------------------------------- io

def test_sps_golden():
    """h264parse.c:426-429: 32x24 main 2.1."""
    sps = h.parse_sps(h.split_bytestream(H264_SPS)[0])
    assert (sps.width, sps.height) == (32, 24)
    assert h.profile_name(sps.profile_idc, sps.constraint_flags) \
        == "main"
    assert h.level_name(sps.level_idc, sps.constraint_flags) == "2.1"
    assert sps.par_n == 1 and sps.par_d == 1


def test_avcc_golden():
    """h264parse.c:110-118: codec_data byte-exact."""
    sps = h.split_bytestream(H264_SPS)[0]
    pps = h.split_bytestream(H264_PPS)[0]
    assert h.build_avcc([sps], [pps]) == H264_AVC_CODEC_DATA
    ln, sl, pl = h.parse_avcc(H264_AVC_CODEC_DATA)
    assert ln == 4 and sl == [sps] and pl == [pps]


def test_sei_goldens():
    """h264parse.c:485-489 HDR SEI caps strings."""
    clli = h.split_bytestream(H264_SEI_CLLI)[0]
    mdcv = h.split_bytestream(H264_SEI_MDCV)[0]
    (t1, p1), = h.parse_sei(clli)
    assert t1 == h.SEI_CLLI
    assert h.content_light_level_string(p1) == "1000:400"
    (t2, p2), = h.parse_sei(mdcv)
    assert t2 == h.SEI_MDCV
    assert h.mastering_display_string(p2) == \
        "7500:3000:34000:16000:13200:34500:15635:16450:10000000:1"
    # buffering-period SEI parses without error
    (t3, _), = h.parse_sei(h.split_bytestream(H264_SEI_BUFFERING)[0])
    assert t3 == 0


def test_level_names():
    assert h.level_name(10, 0) == "1"
    assert h.level_name(11, 0x08) == "1b"
    assert h.level_name(11, 0) == "1.1"
    assert h.level_name(31, 0) == "3.1"
    assert h.level_name(40, 0) == "4"


def test_compatible_caps_table():
    """test_parse_compatible_caps (h264parse.c:621-679): each peer
    profile must be reachable from the SPS profile/constraints."""
    CS0, CS1, CS3 = 0x80, 0x40, 0x10
    cases = [
        (66, 0, "extended"),
        (66, CS1, "baseline"), (66, CS1, "main"), (66, CS1, "high"),
        (66, CS1, "high-10"), (66, CS1, "high-4:2:2"),
        (66, CS1, "high-4:4:4"),
        (77, 0, "high"), (77, 0, "high-10"), (77, 0, "high-4:2:2"),
        (77, 0, "high-4:4:4"),
        (88, CS0, "baseline"),
        (88, CS0 | CS1, "constrained-baseline"),
        (88, CS0 | CS1, "baseline"), (88, CS0 | CS1, "main"),
        (88, CS0 | CS1, "high"), (88, CS0 | CS1, "high-10"),
        (88, CS0 | CS1, "high-4:2:2"), (88, CS0 | CS1, "high-4:4:4"),
        (100, 0, "high-10"), (100, 0, "high-4:2:2"),
        (100, 0, "high-4:4:4"),
        (110, 0, "high-4:2:2"), (110, 0, "high-4:4:4"),
        (110, CS3, "high-10-intra"), (110, CS3, "high-4:2:2-intra"),
        (110, CS3, "high-4:4:4-intra"),
        (122, 0, "high-4:4:4"),
        (122, CS3, "high-4:2:2-intra"), (122, CS3, "high-4:4:4-intra"),
        (244, CS3, "high-4:4:4-intra"),
    ]
    for profile_idc, flags, peer in cases:
        assert peer in h.compatible_profiles(profile_idc, flags), \
            (profile_idc, flags, peer)


def test_emulation_removal():
    assert h.remove_emulation(b"\x00\x00\x03\x01") == b"\x00\x00\x01"
    assert h.remove_emulation(b"\x00\x00\x03\x00\x00\x03") \
        == b"\x00\x00\x00\x00"
    assert h.remove_emulation(b"\x01\x02\x03") == b"\x01\x02\x03"


# ----------------------------------------------------------- element

def test_parse_detect_stream():
    """test_parse_detect_stream: caps from the stream."""
    el = gt.make("h264parse")
    el.set_output("byte-stream", "au")
    el.push(STREAM)
    outs = el.finish()
    assert outs
    caps = el.src_caps
    assert caps["width"] == 32 and caps["height"] == 24
    assert caps["profile"] == "main" and caps["level"] == "2.1"


def test_parse_detect_stream_with_hdr_sei():
    el = gt.make("h264parse")
    el.push(H264_SEI_CLLI + H264_SEI_MDCV + STREAM)
    el.finish()
    caps = el.src_caps
    assert caps["content-light-level"] == "1000:400"
    assert caps["mastering-display-info"] == \
        "7500:3000:34000:16000:13200:34500:15635:16450:10000000:1"


def test_parse_normal_and_split():
    """gst_parser_test_normal / _split: output invariant to input
    chunking."""
    stream = (H264_AUD + STREAM) * 3
    whole = []
    el = gt.make("h264parse")
    whole += el.push(stream)
    whole += el.finish()
    for step in (1, 5, 17):
        el = gt.make("h264parse")
        got = []
        for i in range(0, len(stream), step):
            got += el.push(stream[i:i + step])
        got += el.finish()
        assert [o["data"] for o in got] == [o["data"] for o in whole]
    # AUD starts each AU: 3 aus out
    assert len(whole) == 3
    assert all(o["keyframe"] for o in whole)


def test_parse_skip_garbage():
    """gst_parser_test_skip_garbage: leading garbage is skipped."""
    el = gt.make("h264parse")
    outs = el.push(b"\xde\xad" * 32 + STREAM)
    outs += el.finish()
    assert len(outs) == 1
    assert outs[0]["data"].endswith(H264_IDRFRAME)


def test_bytestream_to_avc():
    """byte-stream in -> avc out: codec_data byte-exact, SPS/PPS
    stripped, length-prefixed payload."""
    el = gt.make("h264parse")
    el.set_output("avc", "au")
    outs = el.push(STREAM + H264_AUD) + el.finish()
    assert el.src_caps["codec_data"] == H264_AVC_CODEC_DATA
    idr_nal = h.split_bytestream(H264_IDRFRAME)[0]
    au = [o for o in outs if o["data"]]
    assert au[0]["data"] == len(idr_nal).to_bytes(4, "big") + idr_nal


def test_avc_to_bytestream():
    """avc in (codec-data) -> byte-stream out with headers inserted
    before the IDR (config-interval=-1)."""
    idr_nal = h.split_bytestream(H264_IDRFRAME)[0]
    el = gt.make("h264parse", **{"config-interval": -1})
    el.set_caps("avc", codec_data=H264_AVC_CODEC_DATA)
    el.set_output("byte-stream", "au")
    outs = el.push(len(idr_nal).to_bytes(4, "big") + idr_nal,
                   pts_ns=0)
    assert len(outs) == 1
    data = outs[0]["data"]
    nals = h.split_bytestream(data)
    assert [h.nal_type(n) for n in nals] == [h.NAL_SPS, h.NAL_PPS,
                                             h.NAL_SLICE_IDR]
    assert el.src_caps["width"] == 32


def test_nal_alignment_output():
    el = gt.make("h264parse")
    el.set_output("byte-stream", "nal")
    outs = el.push(STREAM) + el.finish()
    types = [h.nal_type(h.split_bytestream(o["data"])[0]) for o in outs]
    assert types == [h.NAL_SPS, h.NAL_PPS, h.NAL_SLICE_IDR]


def test_two_frames_au_split():
    """Two IDRs without AUDs split on first_mb_in_slice == 0."""
    el = gt.make("h264parse")
    outs = el.push(STREAM + H264_IDRFRAME) + el.finish()
    assert len(outs) == 2
    assert outs[1]["data"] == H264_IDRFRAME.replace(
        b"\x00\x00\x00\x01", b"\x00\x00\x00\x01", 1)
