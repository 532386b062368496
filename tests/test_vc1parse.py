"""vc1parse (gst/videoparsers/gstvc1parse.c) + the VC-1 codecparser
(gst-libs/gst/codecparsers/gstvc1parser.c)."""

import pytest

import gstbad as gt
from gstbad.io import vc1


class BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, value, n):
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def bytes(self):
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(int("".join(map(str, bits[i:i + 8])), 2)
                     for i in range(0, len(bits), 8))


def _advanced_seq_hdr(level=3, w=1280, h=720, interlace=0,
                      display_ext=1, aspect_ratio=1, frnr=3, frdr=2):
    """An advanced-profile sequence header bitstream
    (parse_sequence_header_advanced field order,
    gstvc1parser.c:782-900)."""
    bw = BitWriter()
    bw.put(vc1.PROFILE_ADVANCED, 2)
    bw.put(level, 3)
    bw.put(1, 2)        # colordiff 4:2:0
    bw.put(5, 3)        # frmrtq_postproc
    bw.put(10, 5)       # bitrtq_postproc
    bw.put(0, 1)        # postprocflag
    bw.put((w >> 1) - 1, 12)
    bw.put((h >> 1) - 1, 12)
    bw.put(0, 1)        # pulldown
    bw.put(interlace, 1)
    bw.put(0, 1)        # tfcntrflag
    bw.put(0, 1)        # finterpflag
    bw.put(1, 1)        # reserved
    bw.put(0, 1)        # psf
    bw.put(display_ext, 1)
    if display_ext:
        bw.put(w - 1, 14)
        bw.put(h - 1, 14)
        bw.put(1, 1)            # aspect_ratio_flag
        bw.put(aspect_ratio, 4)
        if aspect_ratio == 15:
            bw.put(3, 8)        # horiz
            bw.put(2, 8)        # vert
        bw.put(1, 1)            # framerate_flag
        bw.put(0, 1)            # framerateind = indexed
        bw.put(frnr, 8)
        bw.put(frdr, 4)
        bw.put(0, 1)            # color_format_flag
    bw.put(0, 1)        # hrd_param_flag
    return bw.bytes()


def _entrypoint(extended_mv=1, coded_size=0):
    bw = BitWriter()
    bw.put(0, 1)  # broken_link
    bw.put(1, 1)  # closed_entry
    bw.put(0, 1)  # panscan
    bw.put(0, 1)  # refdist
    bw.put(1, 1)  # loopfilter
    bw.put(0, 1)  # fastuvmc
    bw.put(extended_mv, 1)
    bw.put(0, 2)  # dquant
    bw.put(1, 1)  # vstransform
    bw.put(0, 1)  # overlap
    bw.put(1, 2)  # quantizer
    bw.put(1 if coded_size else 0, 1)
    if coded_size:
        bw.put((coded_size[0] >> 1) - 1, 12)
        bw.put((coded_size[1] >> 1) - 1, 12)
    if extended_mv:
        bw.put(1, 1)  # extended_dmv
    bw.put(0, 1)  # range_mapy_flag
    bw.put(0, 1)  # range_mapuv_flag
    return bw.bytes()


def _main_struct_c():
    c = vc1.StructC(profile=vc1.PROFILE_MAIN, frmrtq_postproc=5,
                    bitrtq_postproc=10, loop_filter=1, multires=0,
                    fastuvmc=1, extended_mv=0, dquant=1, vstransform=1,
                    overlap=1, syncmarker=0, rangered=0, maxbframes=2,
                    quantizer=1, finterpflag=0)
    return c


# ----------------------------------------------------------- bitstream

def test_struct_c_word_roundtrip():
    """The STRUCT_C word the element assembles parses back field-exact
    (gstvc1parse.c:809-833 <-> gstvc1parser.c:1574-1640)."""
    c = _main_struct_c()
    word = vc1.make_struct_c_from_fields(vc1.PROFILE_MAIN, c)
    got = vc1.parse_struct_c(word.to_bytes(4, "big"))
    for f in ("profile", "frmrtq_postproc", "bitrtq_postproc",
              "loop_filter", "multires", "fastuvmc", "extended_mv",
              "dquant", "vstransform", "overlap", "syncmarker",
              "rangered", "maxbframes", "quantizer", "finterpflag"):
        assert getattr(got, f) == getattr(c, f), f
    # calculate_framerate_bitrate: frmrtq 5 -> 22 fps, bitrtq 10 -> 672
    assert got.framerate == 22 and got.bitrate == 672


def test_framerate_bitrate_special_cases():
    """gstvc1parser.c:710-733 special rows."""
    assert vc1._framerate_bitrate(0, 31) == (0, 0)
    assert vc1._framerate_bitrate(0, 30) == (2, 1952)
    assert vc1._framerate_bitrate(1, 31) == (6, 2016)
    assert vc1._framerate_bitrate(7, 31) == (30, 2016)


def test_sequence_layer_roundtrip():
    blob = vc1.make_sequence_layer(vc1.PROFILE_MAIN, _main_struct_c(),
                                   width=320, height=240, level=2,
                                   fps_n=25, fps_d=1)
    assert len(blob) == 36
    sl = vc1.parse_sequence_layer(blob)
    assert sl.numframes == 0xFFFFFF
    assert sl.struct_c.profile == vc1.PROFILE_MAIN
    assert sl.struct_c.quantizer == 1
    # writer puts height in VERT_SIZE, width in HORIZ_SIZE
    assert sl.struct_a.vert_size == 240
    assert sl.struct_a.horiz_size == 320
    assert sl.struct_b.level == 2
    assert sl.struct_b.framerate == 25


def test_sequence_layer_unknown_framerate_uses_profile_max():
    """gstvc1parse.c:859-866: fps 0/0 writes the profile/level
    maximum (main/high = 30)."""
    blob = vc1.make_sequence_layer(vc1.PROFILE_MAIN, _main_struct_c(),
                                   width=320, height=240, level=2)
    assert vc1.parse_sequence_layer(blob).struct_b.framerate == 30


def test_sequence_layer_validation():
    blob = bytearray(vc1.make_sequence_layer(
        vc1.PROFILE_MAIN, _main_struct_c(), 320, 240, 2, 25, 1))
    for off, name in ((3, "0xC5"), (4, "0x04 word"), (20, "0x0C word")):
        bad = bytearray(blob)
        bad[off] ^= 0xFF
        with pytest.raises(vc1.Vc1Error):
            vc1.parse_sequence_layer(bytes(bad))
    with pytest.raises(vc1.Vc1Error):
        vc1.parse_sequence_layer(bytes(blob[:35]))


def test_advanced_sequence_header():
    hdr = vc1.parse_sequence_header(_advanced_seq_hdr())
    assert hdr.profile == vc1.PROFILE_ADVANCED
    adv = hdr.advanced
    assert adv.level == 3
    assert adv.max_coded_width == 1280
    assert adv.max_coded_height == 720
    assert adv.interlace == 0
    assert (adv.disp_horiz_size, adv.disp_vert_size) == (1280, 720)
    assert (adv.par_n, adv.par_d) == (1, 1)          # Table 7 index 1
    # Table 8/9: nr=3 dr=2 -> 30000/1001
    assert (adv.fps_n, adv.fps_d) == (30000, 1001)
    assert hdr.mb_width == 1280 // 16 and hdr.mb_height == 720 // 16
    # frmrtq 5 / bitrtq 10 convenience values
    assert adv.framerate == 22 and adv.bitrate == 672


def test_advanced_seq_hdr_custom_par_and_exp_framerate():
    bw = BitWriter()
    bw.put(vc1.PROFILE_ADVANCED, 2)
    bw.put(1, 3)
    bw.put(1, 2)
    bw.put(0, 3)
    bw.put(0, 5)
    bw.put(0, 1)
    bw.put((64 >> 1) - 1, 12)
    bw.put((48 >> 1) - 1, 12)
    bw.put(0, 4)   # pulldown/interlace/tfcntr/finterp
    bw.put(1, 1)   # reserved
    bw.put(0, 1)   # psf
    bw.put(1, 1)   # display_ext
    bw.put(63, 14)
    bw.put(47, 14)
    bw.put(1, 1)   # aspect flag
    bw.put(15, 4)  # custom PAR
    bw.put(3, 8)
    bw.put(2, 8)
    bw.put(1, 1)   # framerate flag
    bw.put(1, 1)   # framerateind -> exponential
    bw.put(959, 16)
    bw.put(0, 1)   # color format
    bw.put(0, 1)   # hrd
    adv = vc1.parse_sequence_header(bw.bytes()).advanced
    assert (adv.par_n, adv.par_d) == (4, 3)   # 1+horiz, 1+vert
    assert (adv.fps_n, adv.fps_d) == (960, 32)


def test_entrypoint_header():
    hdr = vc1.parse_sequence_header(_advanced_seq_hdr())
    ep = vc1.parse_entry_point_header(_entrypoint(), hdr)
    assert ep.closed_entry == 1
    assert ep.loopfilter == 1
    assert ep.extended_mv == 1 and ep.extended_dmv == 1
    assert ep.quantizer == 1
    assert hdr.advanced.entrypoint is ep


def test_entrypoint_coded_size():
    hdr = vc1.parse_sequence_header(_advanced_seq_hdr())
    ep = vc1.parse_entry_point_header(
        _entrypoint(extended_mv=0, coded_size=(640, 480)), hdr)
    assert (ep.coded_width, ep.coded_height) == (640, 480)
    assert hdr.mb_width == 640 // 16


def test_bdu_scan():
    data = (b"\x00\x00\x01\x0f" + b"a" * 5
            + b"\x00\x00\x01\x0e" + b"b" * 3
            + b"\x00\x00\x01\x0d" + b"c" * 7)
    bdus = vc1.split_bdus(data)
    assert [(t, data[o:o + s]) for t, o, s in bdus] == [
        (vc1.SEQUENCE, b"a" * 5), (vc1.ENTRYPOINT, b"b" * 3),
        (vc1.FRAME, b"c" * 7)]
    one = vc1.identify_next_bdu(data)
    assert one.type == vc1.SEQUENCE and one.size == 5
    tail = vc1.identify_next_bdu(data[-11:])
    assert tail.type == vc1.FRAME and tail.size == -1  # NO_BDU_END
    assert vc1.identify_next_bdu(b"\xff" * 20) is None


def test_frame_layer_header_roundtrip():
    hdr = vc1.make_frame_layer_header(1234, True, 0xDEADBEEF)
    assert len(hdr) == 8
    assert vc1.parse_frame_layer_header(hdr) == (1234, True, 0xDEADBEEF)
    hdr = vc1.make_frame_layer_header(7, False, 40)
    assert vc1.parse_frame_layer_header(hdr) == (7, False, 40)


@pytest.mark.parametrize("blob", [
    b"", b"\x00", b"\xff" * 8, b"\xff" * 35,
    _advanced_seq_hdr()[:3],
])
def test_fuzz_raises_value_error_only(blob):
    for fn in (vc1.parse_sequence_layer, vc1.parse_sequence_header):
        try:
            fn(blob)
        except ValueError:
            pass


# ------------------------------------------------------------- element

def _adv_asf_codec_data():
    seq = _advanced_seq_hdr()
    ep = _entrypoint()
    return (b"\x2b" + b"\x00\x00\x01\x0f" + seq
            + b"\x00\x00\x01\x0e" + ep), seq, ep


def test_element_profile_strcmp_inversion_quirk():
    """gstvc1parse.c:2357-2363 inverts its strcmp tests: caps profile
    "simple" lands in the MAIN branch, "main"/"advanced" in SIMPLE."""
    el = gt.make("vc1parse")
    el.set_caps(profile="simple", stream_format="asf")
    assert el.profile == vc1.PROFILE_MAIN
    el2 = gt.make("vc1parse")
    el2.set_caps(profile="main", stream_format="asf")
    assert el2.profile == vc1.PROFILE_SIMPLE


def test_element_seq_layer_codec_data_swaps_dimensions():
    """gstvc1parse.c:2229-2230 reads width from VERT_SIZE and height
    from HORIZ_SIZE — swapped vs the writer (gstvc1parse.c:838-840);
    reproduced faithfully."""
    layer = vc1.make_sequence_layer(vc1.PROFILE_MAIN, _main_struct_c(),
                                    width=320, height=240, level=1,
                                    fps_n=25, fps_d=1)
    el = gt.make("vc1parse")
    el.set_caps(codec_data=layer, stream_format="frame-layer")
    assert el.in_header_format == "sequence-layer"
    assert (el.width, el.height) == (240, 320)  # the documented swap
    assert el.level == 1


def test_element_asf_to_sequence_layer_raw_frame():
    """ASF (packetized, 4-byte STRUCT_C codec_data) to
    sequence-layer-raw-frame: the synthesized 36-byte layer precedes
    the untouched frames (gstvc1parse.c:1908-1919)."""
    c = _main_struct_c()
    codec_data = vc1.make_struct_c_from_fields(
        vc1.PROFILE_MAIN, c).to_bytes(4, "big")
    el = gt.make("vc1parse")
    el.set_caps(width=320, height=240, framerate=(25, 1),
                header_format="asf", stream_format="asf",
                codec_data=codec_data)
    el.set_output(header_format="none",
                  stream_format="sequence-layer-raw-frame")
    out = el.chain(b"frame-one", pts_ns=0)
    out += el.chain(b"frame-two", pts_ns=40)
    assert len(out) == 3
    layer = out[0]["data"]
    assert len(layer) == 36 and layer[3] == 0xC5
    sl = vc1.parse_sequence_layer(layer)
    assert sl.struct_a.vert_size == 240  # height first, like the C
    assert sl.struct_b.framerate == 25
    assert out[1]["data"] == b"frame-one"
    assert out[2]["data"] == b"frame-two"
    assert out[1]["caps"]["profile"] == "main"
    assert out[1]["caps"]["format"] == "WMV3"


def test_element_advanced_asf_to_bdu():
    """Advanced ASF to bdu: raw frames get the 0x0000010D start code
    prepended, already-coded frames pass through
    (gstvc1parse.c:1568-1623)."""
    codec_data, seq, ep = _adv_asf_codec_data()
    el = gt.make("vc1parse")
    el.set_caps(format="WVC1", header_format="asf", stream_format="asf",
                codec_data=codec_data)
    assert el.profile == vc1.PROFILE_ADVANCED
    assert el.width == 1280 and el.height == 720
    el.set_output(header_format="asf", stream_format="bdu")
    out = el.chain(b"rawframe", pts_ns=0)
    assert out[0]["data"] == b"\x00\x00\x01\x0drawframe"
    out = el.chain(b"\x00\x00\x01\x0dcoded", pts_ns=40)
    assert out[0]["data"] == b"\x00\x00\x01\x0dcoded"
    caps = out[0]["caps"]
    assert caps["format"] == "WVC1"
    assert caps["profile"] == "advanced"
    assert caps["level"] == "3"
    assert caps["codec_data"] == codec_data


def test_element_asf_to_frame_layer_advanced():
    """Advanced ASF to frame-layer: the first frame carries seq hdr +
    entrypoint BDUs after the 8-byte header, keyframes re-carry the
    entrypoint (gstvc1parse.c:1625-1709)."""
    codec_data, seq, ep = _adv_asf_codec_data()
    el = gt.make("vc1parse")
    el.set_caps(format="WVC1", header_format="asf", stream_format="asf",
                codec_data=codec_data)
    el.set_output(header_format="asf", stream_format="frame-layer")
    first = el.chain(b"K1", pts_ns=0, keyframe=True)[0]["data"]
    size, key, ts = vc1.parse_frame_layer_header(first[:8])
    assert (size, key, ts) == (2, True, 0)
    assert first[8:] == (b"\x00\x00\x01\x0f" + seq
                         + b"\x00\x00\x01\x0e" + ep
                         + b"\x00\x00\x01\x0d" + b"K1")
    delta = el.chain(b"D2", pts_ns=40, keyframe=False)[0]["data"]
    assert delta[8:] == b"\x00\x00\x01\x0dD2"
    key2 = el.chain(b"K3", pts_ns=80, keyframe=True)[0]["data"]
    assert key2[8:] == (b"\x00\x00\x01\x0e" + ep
                        + b"\x00\x00\x01\x0dK3")


def test_element_bdu_frame_to_sequence_layer_bdu_frame():
    """bdu-frame to sequence-layer-bdu-frame prepends ONE synthesized
    sequence layer (gstvc1parse.c:1855-1870)."""
    seq = _advanced_seq_hdr()
    ep = _entrypoint()
    stream = (b"\x00\x00\x01\x0f" + seq + b"\x00\x00\x01\x0e" + ep
              + b"\x00\x00\x01\x0d" + b"frame-a"
              + b"\x00\x00\x01\x0d" + b"frame-b")
    el = gt.make("vc1parse")
    el.set_caps(format="WVC1", stream_format="bdu-frame")
    el.set_output(header_format="none",
                  stream_format="sequence-layer-bdu-frame")
    out = []
    for i in range(0, len(stream), 7):   # odd chunking
        out += el.chain(stream[i:i + 7])
    out += el.finish()
    assert len(out) == 5
    assert out[0]["data"][3] == 0xC5     # the sequence layer
    assert out[1]["data"] == b"\x00\x00\x01\x0f" + seq
    assert out[2]["data"] == b"\x00\x00\x01\x0e" + ep
    assert out[3]["data"] == b"\x00\x00\x01\x0dframe-a"
    assert out[4]["data"] == b"\x00\x00\x01\x0dframe-b"


def test_element_sequence_layer_frame_layer_passthrough_and_detect():
    """A sequence-layer + frame-layer stream with no stream-format in
    caps is DETECTED (gstvc1parse.c:667-686) and passes through when
    in == out."""
    layer = vc1.make_sequence_layer(vc1.PROFILE_MAIN, _main_struct_c(),
                                    320, 240, 2, 25, 1)
    f1 = vc1.make_frame_layer_header(4, True, 0) + b"AAAA"
    f2 = vc1.make_frame_layer_header(2, False, 40) + b"BB"
    el = gt.make("vc1parse")
    el.set_caps(header_format="sequence-layer")  # no stream-format
    out = el.chain(layer + f1 + f2)
    assert el.in_stream_format == "sequence-layer-frame-layer"
    assert [o["data"] for o in out] == [layer, f1, f2]


def test_element_sequence_layer_frame_layer_to_frame_layer():
    """Dropping the sequence layer unit on the way to frame-layer
    output (NO_FRAME drop, gstvc1parse.c:2001-2008)."""
    layer = vc1.make_sequence_layer(vc1.PROFILE_MAIN, _main_struct_c(),
                                    320, 240, 2, 25, 1)
    f1 = vc1.make_frame_layer_header(4, True, 0) + b"AAAA"
    el = gt.make("vc1parse")
    el.set_caps(header_format="sequence-layer",
                stream_format="sequence-layer-frame-layer")
    el.set_output(header_format="sequence-layer",
                  stream_format="frame-layer")
    out = el.chain(layer + f1)
    assert [o["data"] for o in out] == [f1]
    assert out[0]["caps"]["codec_data"] == layer


def test_element_simple_profile_rejects_bdu_output():
    """gstvc1parse.c:334-344."""
    c = vc1.StructC(profile=vc1.PROFILE_SIMPLE)
    codec_data = vc1.make_struct_c_from_fields(
        vc1.PROFILE_SIMPLE, c).to_bytes(4, "big")
    el = gt.make("vc1parse")
    el.set_caps(width=176, height=144, header_format="asf",
                stream_format="asf", codec_data=codec_data)
    el.set_output(header_format="asf", stream_format="bdu")
    with pytest.raises(vc1.Vc1Error):
        el.chain(b"frame")


def test_element_needs_headers_before_frames():
    el = gt.make("vc1parse")
    el.set_caps(format="WVC1", stream_format="asf")  # no codec_data
    el.set_output(header_format="none", stream_format="asf")
    with pytest.raises(vc1.Vc1Error):
        el.chain(b"frame")
