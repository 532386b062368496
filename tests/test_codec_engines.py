"""VP8 / AV1 / MPEG-2 stateless-decoder base layers
(gstbad/codecs/{vp8,av1,mpeg2}.py vs
gst-libs/gst/codecs/gst{vp8,av1,mpeg2}decoder.c).

Real streams from libvpx / libaom / mpeg2video; output order checked
against the corresponding libavcodec decoders.
"""

import pytest

from gstbad.codecs.av1 import Av1Decoder
from gstbad.codecs.mpeg2 import Mpeg2Decoder
from gstbad.codecs.vp8 import Vp8Decoder
from gstbad.io import mpegvideo as mv


def _oracle():
    from gstbad.io import codecoracle
    return codecoracle


# ----------------------------------------------------------------- VP8

def test_vp8_output_matches_real_decoder():
    co = _oracle()
    pkts = co.encode("libvpx", "auto-alt-ref=1,lag-in-frames=8,g=20",
                     96, 64, 25)
    d = Vp8Decoder()
    outs = []
    for i, p in enumerate(pkts):
        outs += d.push_frame(p.data, i)
    got = [pkts[o.system_frame_number].pts for o in outs]
    assert got == co.decode_output_pts("vp8", pkts)


def test_vp8_keyframe_fills_all_refs():
    co = _oracle()
    pkts = co.encode("libvpx", "g=20", 96, 64, 3)
    d = Vp8Decoder()
    d.push_frame(pkts[0].data, 0)
    assert d.last_picture is d.golden_ref_picture is d.alt_ref_picture
    d.push_frame(pkts[1].data, 1)
    # inter frame with refresh_last only: last moves, golden/alt stay
    assert d.last_picture is not None


def test_vp8_wait_keyframe_drops_leading_inter():
    co = _oracle()
    pkts = co.encode("libvpx", "g=20", 96, 64, 10)
    d = Vp8Decoder()
    # feed from the second (inter) frame: everything dropped until a
    # keyframe arrives (gstvp8decoder.c:363-374)
    outs = []
    for i, p in enumerate(pkts[1:]):
        outs += d.push_frame(p.data, i)
    assert outs == []
    assert d.wait_keyframe


def test_vp8_copy_semantics_order():
    """copy_buffer_to_golden == 2 must read the freshly-updated altref
    (the reference updates alt before golden,
    gstvp8decoder.c:225-266)."""
    from gstbad.codecs.vp8 import Vp8Picture
    d = Vp8Decoder()
    d.wait_keyframe = False
    old_last = Vp8Picture(system_frame_number=100)
    d.last_picture = d.golden_ref_picture = d.alt_ref_picture = old_last

    import gstbad.io.vp8 as iovp8
    hdr = iovp8.FrameHdr()
    hdr.key_frame = False
    hdr.refresh_alternate_frame = True
    hdr.copy_buffer_to_golden = 2      # golden <- (new) altref
    hdr.refresh_last = False
    pic = Vp8Picture(system_frame_number=1, frame_hdr=hdr)
    d._update_reference(pic)
    assert d.alt_ref_picture is pic
    assert d.golden_ref_picture is pic      # saw the NEW altref
    assert d.last_picture is old_last
    # copy_buffer_to_alternate == 1 reads the OLD last
    hdr2 = iovp8.FrameHdr()
    hdr2.key_frame = False
    hdr2.copy_buffer_to_alternate = 1
    hdr2.refresh_last = True
    pic2 = Vp8Picture(system_frame_number=2, frame_hdr=hdr2)
    d._update_reference(pic2)
    assert d.alt_ref_picture is old_last    # previous last
    assert d.last_picture is pic2


# ----------------------------------------------------------------- AV1

AOM_CONFIGS = [
    ("realtime", "usage=realtime,cpu-used=8,g=20"),
    ("altref", "usage=good,cpu-used=6,lag-in-frames=16,"
               "auto-alt-ref=1,g=30"),
]


@pytest.mark.parametrize("name,opts", AOM_CONFIGS,
                         ids=[c[0] for c in AOM_CONFIGS])
def test_av1_output_matches_real_decoder(name, opts):
    co = _oracle()
    pkts = co.encode("libaom-av1", opts, 96, 64, 25)
    d = Av1Decoder()
    outs = []
    for i, p in enumerate(pkts):
        outs += d.push_tu(p.data, i)
    got = [pkts[o.system_frame_number].pts for o in outs]
    assert got == co.decode_output_pts("libaom-av1", pkts)
    assert len(outs) == 25


def test_av1_show_existing_duplicates():
    """The altref stream must exercise show_existing duplication
    (gstav1decoder.c:356-392)."""
    co = _oracle()
    pkts = co.encode("libaom-av1", AOM_CONFIGS[1][1], 96, 64, 25)
    d = Av1Decoder()
    outs = []
    for i, p in enumerate(pkts):
        outs += d.push_tu(p.data, i)
    dups = [o for o in outs if o.picture.duplicate_of is not None]
    assert dups, "expected show_existing_frame pictures in altref stream"
    for o in dups:
        # the shown slot is a real previously-decoded hidden picture
        ref = o.picture.duplicate_of
        assert ref.frame_hdr is not None and not ref.show_frame
        assert ref.system_frame_number < o.system_frame_number


def test_av1_hidden_frames_enter_dpb_not_output():
    co = _oracle()
    pkts = co.encode("libaom-av1", AOM_CONFIGS[1][1], 96, 64, 25)
    d = Av1Decoder()
    n_outs = 0
    hidden_seen = False
    from gstbad.io import av1obu as av1
    for i, p in enumerate(pkts):
        for o in av1.split_obu_stream(p.data):
            if o.obu_type == av1.OBU_FRAME:
                # peek show_frame bit region via the engine state later
                pass
        outs = d.push_tu(p.data, i)
        n_outs += len(outs)
        if not outs:
            hidden_seen = True  # TU held only hidden frames
    # hidden frames land in ref slots
    assert n_outs == 25
    # altref slots hold a non-shown picture at some point
    assert any(s is not None and not s.show_frame
               and s.duplicate_of is None for s in d.dpb) or hidden_seen


# --------------------------------------------------------------- MPEG2

MPEG2_CONFIGS = [
    ("ippp", "bf=0,g=12"),
    ("ibbp", "bf=2,g=12"),
    ("cgop", "bf=2,g=12,cgop=1"),
    ("ildct", "bf=2,g=12,ildct=1,alternate_scan=1"),
    ("longgop", "bf=3,g=30"),
]


@pytest.mark.parametrize("name,opts", MPEG2_CONFIGS,
                         ids=[c[0] for c in MPEG2_CONFIGS])
def test_mpeg2_output_matches_real_decoder(name, opts):
    co = _oracle()
    pkts = co.encode("mpeg2video", opts, 96, 64, 30)
    d = Mpeg2Decoder()
    outs = []
    for i, p in enumerate(pkts):
        outs += d.push_frame(p.data, i)
    outs += d.drain()
    got = [pkts[o.system_frame_number].pts for o in outs]
    assert got == co.decode_output_pts("mpeg2video", pkts)
    assert len(outs) == 30


def test_mpeg2_poc_tracks_tsn():
    """POC = gop_tsn + ovl_tsn*1024 + tsn: display order within each
    GOP follows temporal_sequence_number."""
    co = _oracle()
    pkts = co.encode("mpeg2video", "bf=2,g=12", 96, 64, 24)
    d = Mpeg2Decoder()
    outs = []
    for i, p in enumerate(pkts):
        outs += d.push_frame(p.data, i)
    outs += d.drain()
    pocs = [o.picture.pic_order_cnt for o in outs]
    assert pocs == sorted(pocs)
    assert len(set(pocs)) == len(pocs)


def test_mpeg2_open_gop_leading_b_decode_only():
    """A leading B frame without a backward reference in an open GOP
    is marked decode-only and not output
    (gstmpeg2decoder.c:741-747)."""
    co = _oracle()
    pkts = co.encode("mpeg2video", "bf=2,g=12", 96, 64, 24)
    # find the second GOP's first I frame, then join mid-stream with
    # the sequence headers prepended
    second_key = [i for i, p in enumerate(pkts) if p.key][1]
    seq_blob = pkts[0].data[:pkts[0].data.find(b"\x00\x00\x01\x00")]
    d = Mpeg2Decoder()
    outs = []
    joined = pkts[second_key:]
    for i, p in enumerate(joined):
        data = (seq_blob + p.data) if i == 0 else p.data
        outs += d.push_frame(data, i)
    outs += d.drain()
    got = [joined[o.system_frame_number].pts for o in outs]
    # leading B's reference the previous (missing) GOP: dropped
    assert len(outs) < len(joined)
    assert got == sorted(got)


def test_mpeg2_picture_ext_parse():
    ext = mv.parse_picture_ext(bytes([0x80 | 0x02, 0x22, 0x13 | 0x08,
                                      0x80, 0x80]))
    assert ext.picture_structure == mv.PICTURE_STRUCTURE_FRAME
    assert ext.top_field_first == 1
    assert ext.progressive_frame == 1
    gop = mv.parse_gop(bytes([0b0_00001_00, 0b0001_1_000,
                              0b001_00000, 0b1_1_1_00000]))
    assert (gop.hour, gop.minute, gop.second) == (1, 1, 1)
    assert gop.closed_gop == 1 and gop.broken_link == 1
