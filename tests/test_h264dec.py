"""H.264 stateless-decoder base layer (gstbad/codecs/h264.py vs
gst-libs/gst/codecs/gsth264decoder.c).

Two oracle tiers:
- REAL streams: libx264-encoded IPPP / IBBP / B-pyramid / open-GOP
  structures; our DPB engine's output order must equal libavcodec's
  h264 decoder output order (the same ground truth the reference's
  hardware subclasses are held to).
- Hand-crafted header streams (tests/helpers/h264synth.py): POC unit
  vectors for all three pic_order_cnt_types, MMCO 1-6 marking
  transitions, frame_num gaps, ref-list construction (8.2.4.2 spec
  examples).
"""

import pytest

from gstbad.codecs import h264 as dec
from gstbad.codecs.h264 import H264Decoder
from gstbad.io import h264 as h

from helpers import h264synth as syn


def _oracle():
    from gstbad.io import codecoracle
    return codecoracle


# ------------------------------------------------------- real streams

X264_CONFIGS = [
    ("ippp", "x264-params=bframes=0:keyint=25:ref=3"),
    ("ibbp", "x264-params=bframes=2:b-adapt=0:keyint=25:ref=3"),
    ("bpyramid",
     "x264-params=bframes=3:b-adapt=0:b-pyramid=normal:keyint=25:ref=4"),
    ("opengop",
     "x264-params=bframes=3:b-adapt=2:b-pyramid=normal:keyint=20:"
     "open-gop=1:ref=5"),
    ("smallgop", "x264-params=bframes=2:b-adapt=0:keyint=8:ref=2"),
]


@pytest.mark.parametrize("name,opts", X264_CONFIGS,
                         ids=[c[0] for c in X264_CONFIGS])
def test_output_order_matches_real_decoder(name, opts):
    co = _oracle()
    pkts = co.encode("libx264", opts, 96, 64, 40)
    d = H264Decoder()
    outs = []
    for i, p in enumerate(pkts):
        outs += d.push_au(p.data, i)
    outs += d.drain()
    got = [pkts[o.system_frame_number].pts for o in outs]
    want = co.decode_output_pts("h264", pkts)
    assert got == want
    assert len(outs) == 40
    # POC order is the output order
    pocs = [o.poc for o in outs]
    gop_starts = [i for i, o in enumerate(outs) if o.poc == 0]
    for a, b in zip(gop_starts, gop_starts[1:] + [len(outs)]):
        assert pocs[a:b] == sorted(pocs[a:b])


def test_mmco_and_modification_exercised_by_bpyramid():
    """x264 B-pyramid emits MMCO-1 ops and L0 modifications — make
    sure the real-stream tests actually walk those code paths."""
    co = _oracle()
    pkts = co.encode("libx264", X264_CONFIGS[2][1], 96, 64, 40)
    n_mmco = n_mod = 0
    sps_d, pps_d = {}, {}
    for p in pkts:
        for nal in h.split_bytestream(p.data):
            t = h.nal_type(nal)
            if t == h.NAL_SPS:
                s = h.parse_sps(nal)
                sps_d[s.sps_id] = s
            elif t == h.NAL_PPS:
                pp = h.parse_pps(nal)
                pps_d[pp.pps_id] = pp
            elif t in (1, 5):
                hdr = h.parse_slice_header(nal, sps_d, pps_d)
                n_mmco += len(hdr.dec_ref_pic_marking.ops)
                n_mod += len(hdr.ref_pic_list_modification_l0)
    assert n_mmco > 0
    assert n_mod > 0


def test_ref_lists_on_real_stream():
    """P-slice L0 must start with the most recent short-term ref
    (pic_num descending); B-slice L0/L1 split by POC."""
    co = _oracle()
    pkts = co.encode("libx264",
                     "x264-params=bframes=2:b-adapt=0:keyint=25:ref=3:weightp=0",
                     96, 64, 30)
    d = H264Decoder()
    sps_d, pps_d = {}, {}
    checked_p = checked_b = 0
    for i, p in enumerate(pkts):
        # peek the slice type before pushing
        stype = None
        for nal in h.split_bytestream(p.data):
            t = h.nal_type(nal)
            if t == h.NAL_SPS:
                s = h.parse_sps(nal)
                sps_d[s.sps_id] = s
            elif t == h.NAL_PPS:
                pp = h.parse_pps(nal)
                pps_d[pp.pps_id] = pp
            elif t in (1, 5) and stype is None:
                hdr = h.parse_slice_header(nal, sps_d, pps_d)
                stype = hdr.slice_type
                mods = hdr.ref_pic_list_modification_l0
        d.push_au(p.data, i)
        me = d.last_finished_picture
        assert me is not None and me.system_frame_number == i
        if stype == h.SLICE_P and not mods and me.ref_list0:
            nums = [q.pic_num for q in me.ref_list0
                    if q.is_short_ref()]
            assert nums == sorted(nums, reverse=True)
            checked_p += 1
        if stype == h.SLICE_B and me.ref_list1:
            l0, l1 = me.ref_list0, me.ref_list1
            # l0 leads with the closest past POC, l1 with the
            # closest future POC
            past = [q.pic_order_cnt for q in l0
                    if q.pic_order_cnt <= me.pic_order_cnt]
            fut = [q.pic_order_cnt for q in l1
                   if q.pic_order_cnt > me.pic_order_cnt]
            assert past == sorted(past, reverse=True)
            assert fut == sorted(fut)
            checked_b += 1
    assert checked_p > 3 and checked_b > 3


# ----------------------------------------------------- POC unit vectors

def _push_stream(d, nals_per_au):
    outs = []
    for i, nals in enumerate(nals_per_au):
        outs += d.push_au(syn.annexb(*nals), i)
    outs += d.drain()
    return outs


def test_poc_type0_basic():
    """8.2.1.1: msb wraps when lsb jumps by >= MaxPocLsb/2."""
    sps = syn.make_sps(poc_type=0, log2_max_poc_lsb=4,
                       num_ref_frames=4)
    pps = syn.make_pps()
    aus = [[sps, pps, syn.make_slice(2, 0, idr=True, poc_lsb=0)]]
    # lsb sequence walking past the wrap: 0,4,8,12,0(wrap->msb16),4
    for k, lsb in enumerate([4, 8, 12, 0, 4], start=1):
        aus.append([syn.make_slice(0, k % 16, poc_lsb=lsb)])
    d = H264Decoder()
    outs = _push_stream(d, aus)
    assert [o.poc for o in outs] == [0, 4, 8, 12, 16, 20]
    assert [o.system_frame_number for o in outs] == [0, 1, 2, 3, 4, 5]


def test_poc_type0_negative_wrap():
    """lsb jumping UP by > MaxPocLsb/2 pulls msb down."""
    sps = syn.make_sps(poc_type=0, log2_max_poc_lsb=4,
                       num_ref_frames=4)
    pps = syn.make_pps()
    d = H264Decoder()
    d.push_au(syn.annexb(sps, pps,
                         syn.make_slice(2, 0, idr=True, poc_lsb=8)))
    # non-ref B with lsb 14 > 8 and 14-8 <= 8: same msb -> poc 14?
    # choose lsb=1 (1 < 8, 8-1=7 < 8): same msb -> poc 1
    outs = d.push_au(syn.annexb(
        syn.make_slice(0, 1, poc_lsb=1, nal_ref_idc=0)))
    outs += d.drain()
    assert [o.poc for o in outs] == [1, 8]


def test_poc_type1():
    """8.2.1.2 with a 2-entry offset cycle."""
    sps = syn.make_sps(poc_type=1, offsets_for_ref_frame=(4, 2),
                       num_ref_frames=4)
    pps = syn.make_pps()
    aus = [[sps, pps, syn.make_slice(2, 0, idr=True, poc_type=1)]]
    for k in range(1, 5):
        aus.append([syn.make_slice(0, k, poc_type=1)])
    d = H264Decoder()
    outs = _push_stream(d, aus)
    # abs_frame_num = frame_num; expected POC cycle: frame1 -> 4,
    # frame2 -> 6, frame3 -> 10, frame4 -> 12
    assert [o.poc for o in outs] == [0, 4, 6, 10, 12]


def test_poc_type2():
    """8.2.1.3: POC = 2*frame_num (refs), 2*fn-1 (non-refs)."""
    sps = syn.make_sps(poc_type=2, num_ref_frames=4)
    pps = syn.make_pps()
    aus = [[sps, pps, syn.make_slice(2, 0, idr=True, poc_type=2)],
           [syn.make_slice(0, 1, poc_type=2)],
           [syn.make_slice(0, 2, poc_type=2, nal_ref_idc=0)],
           [syn.make_slice(0, 2, poc_type=2)]]
    d = H264Decoder()
    outs = _push_stream(d, aus)
    assert [o.poc for o in outs] == [0, 2, 3, 4]
    # type 2 has no reordering: every frame must come out in order
    assert [o.system_frame_number for o in outs] == [0, 1, 2, 3]


def test_poc_type2_frame_num_wrap():
    """frame_num_offset accumulates across the wrap."""
    sps = syn.make_sps(poc_type=2, log2_max_frame_num=4,
                       num_ref_frames=2)
    pps = syn.make_pps()
    aus = [[sps, pps, syn.make_slice(2, 0, idr=True, poc_type=2)]]
    for k in range(1, 20):
        aus.append([syn.make_slice(0, k % 16, poc_type=2)])
    d = H264Decoder()
    outs = _push_stream(d, aus)
    assert [o.poc for o in outs] == [2 * k for k in range(20)]


# ------------------------------------------------------------- MMCO

def _idr_then_refs(n_ref_frames=4, n=3):
    sps = syn.make_sps(poc_type=0, num_ref_frames=n_ref_frames)
    pps = syn.make_pps()
    aus = [[sps, pps,
            syn.make_slice(2, 0, idr=True, poc_lsb=0)]]
    for k in range(1, n):
        aus.append([syn.make_slice(0, k, poc_lsb=(2 * k) % 16)])
    return aus


def test_mmco1_unmark_short():
    """MMCO 1: difference_of_pic_nums_minus1 unmarks a short ref
    (8.2.5.4.1)."""
    aus = _idr_then_refs(n_ref_frames=4, n=3)
    # frame 3 unmarks picNumX = 3 - (1+1) = 1
    aus.append([syn.make_slice(0, 3, poc_lsb=6,
                               mmco_ops=[(1, 1, 0)])])
    d = H264Decoder()
    for i, nals in enumerate(aus):
        d.push_au(syn.annexb(*nals), i)
    short_fns = sorted(p.frame_num for p in d.dpb.pic_list
                       if p.is_short_ref())
    assert short_fns == [0, 2, 3]  # frame_num 1 unmarked


def test_mmco2_and_3_long_term():
    """MMCO 3 converts a short ref to long-term; MMCO 2 unmarks it by
    long_term_pic_num (8.2.5.4.2/.3)."""
    aus = _idr_then_refs(n_ref_frames=4, n=3)
    # frame 3: MMCO 4 sets max_long_term_frame_idx=0 (plus1=1), then
    # MMCO 3 moves picNumX=2 (diff_minus1=0) to long_term_frame_idx 0
    aus.append([syn.make_slice(0, 3, poc_lsb=6,
                               mmco_ops=[(4, 1, 0), (3, 0, 0)])])
    d = H264Decoder()
    for i, nals in enumerate(aus):
        d.push_au(syn.annexb(*nals), i)
    longs = [p for p in d.dpb.pic_list if p.is_long_ref()]
    assert len(longs) == 1 and longs[0].frame_num == 2
    assert d.max_long_term_frame_idx == 0
    # next frame unmarks it via MMCO 2 (long_term_pic_num == 0)
    d.push_au(syn.annexb(syn.make_slice(0, 4, poc_lsb=8,
                                        mmco_ops=[(2, 0, 0)])), 99)
    assert not [p for p in d.dpb.pic_list if p.is_long_ref()]


def test_mmco5_resets_poc_and_frame_num():
    """MMCO 5: all refs unmarked, current POC rebased to 0, frame_num
    zeroed (8.2.5.4.5; C.4.4 drains the DPB)."""
    aus = _idr_then_refs(n_ref_frames=4, n=3)
    aus.append([syn.make_slice(0, 3, poc_lsb=6,
                               mmco_ops=[(5, 0, 0)])])
    d = H264Decoder()
    outs = []
    for i, nals in enumerate(aus):
        outs += d.push_au(syn.annexb(*nals), i)
    # mem_mgmt_5 drained everything before the current picture
    assert [o.system_frame_number for o in outs] == [0, 1, 2]
    pics = d.dpb.pic_list
    assert len(pics) == 1 and pics[0].frame_num == 0
    assert pics[0].pic_order_cnt == 0 and pics[0].mem_mgmt_5
    # the following picture's POC counts from the rebased state
    outs = d.push_au(syn.annexb(
        syn.make_slice(0, 1, poc_lsb=8)), 50)
    outs += d.drain()
    assert [o.poc for o in outs] == [0, 8]


def test_mmco6_current_to_long():
    """MMCO 6: the current picture becomes a long-term ref."""
    aus = _idr_then_refs(n_ref_frames=4, n=2)
    aus.append([syn.make_slice(0, 2, poc_lsb=4,
                               mmco_ops=[(4, 2, 0), (6, 0, 1)])])
    d = H264Decoder()
    for i, nals in enumerate(aus):
        d.push_au(syn.annexb(*nals), i)
    longs = [p for p in d.dpb.pic_list if p.is_long_ref()]
    assert len(longs) == 1 and longs[0].long_term_frame_idx == 1


def test_idr_long_term_reference_flag():
    """IDR with long_term_reference_flag becomes long-term idx 0
    (gsth264decoder.c:1993-2001)."""
    sps = syn.make_sps(num_ref_frames=2)
    pps = syn.make_pps()
    d = H264Decoder()
    d.push_au(syn.annexb(sps, pps, syn.make_slice(
        2, 0, idr=True, poc_lsb=0, long_term_reference_flag=1)), 0)
    p = d.dpb.pic_list[0]
    assert p.is_long_ref() and p.long_term_frame_idx == 0


# ------------------------------------------------- sliding window / gaps

def test_sliding_window_evicts_lowest_frame_num_wrap():
    """8.2.5.3: with num_ref_frames=2, the third ref evicts the oldest."""
    aus = _idr_then_refs(n_ref_frames=2, n=4)
    d = H264Decoder()
    for i, nals in enumerate(aus):
        d.push_au(syn.annexb(*nals), i)
    short_fns = sorted(p.frame_num for p in d.dpb.pic_list
                       if p.is_short_ref())
    assert short_fns == [2, 3]


def test_frame_num_gap_generates_nonexisting(recwarn):
    """7-23: with gaps allowed, missing frame_nums become non-existing
    short-term refs (not output)."""
    sps = syn.make_sps(poc_type=2, num_ref_frames=4, gaps_allowed=1)
    pps = syn.make_pps()
    d = H264Decoder()
    outs = d.push_au(syn.annexb(
        sps, pps, syn.make_slice(2, 0, idr=True, poc_type=2)), 0)
    outs += d.push_au(syn.annexb(syn.make_slice(0, 1, poc_type=2)), 1)
    # jump frame_num 1 -> 4: gap pictures for 2 and 3
    outs += d.push_au(syn.annexb(syn.make_slice(0, 4, poc_type=2)), 2)
    nonex = [p for p in d.dpb.pic_list if p.nonexisting]
    assert sorted(p.frame_num for p in nonex) == [2, 3]
    assert all(p.is_short_ref() for p in nonex)
    outs += d.drain()
    # non-existing pictures are never output; real frames all are
    assert [o.system_frame_number for o in outs] == [0, 1, 2]
    # (frames 0 and 1 were already inside outs of earlier pushes only
    # if the DPB overflowed; with normal latency they drain here)


def test_gap_not_allowed_is_tolerated():
    sps = syn.make_sps(poc_type=2, num_ref_frames=4, gaps_allowed=0)
    pps = syn.make_pps()
    d = H264Decoder()
    d.push_au(syn.annexb(sps, pps,
                         syn.make_slice(2, 0, idr=True, poc_type=2)), 0)
    d.push_au(syn.annexb(syn.make_slice(0, 5, poc_type=2)), 1)
    assert not [p for p in d.dpb.pic_list if p.nonexisting]


# --------------------------------------------------------- DPB/bumping

def test_idr_no_output_of_prior_pics_drops_pending():
    """C.4.4: no_output_of_prior_pics empties the DPB WITHOUT output."""
    sps = syn.make_sps(num_ref_frames=4)
    pps = syn.make_pps()
    d = H264Decoder()
    d.push_au(syn.annexb(sps, pps,
                         syn.make_slice(2, 0, idr=True, poc_lsb=0)), 0)
    d.push_au(syn.annexb(syn.make_slice(0, 1, poc_lsb=2)), 1)
    outs = d.push_au(syn.annexb(syn.make_slice(
        2, 0, idr=True, poc_lsb=0, no_output_of_prior_pics=1)), 2)
    outs += d.drain()
    assert [o.system_frame_number for o in outs] == [2]


def test_idr_without_flag_drains_with_output():
    sps = syn.make_sps(num_ref_frames=4)
    pps = syn.make_pps()
    d = H264Decoder()
    d.push_au(syn.annexb(sps, pps,
                         syn.make_slice(2, 0, idr=True, poc_lsb=0)), 0)
    d.push_au(syn.annexb(syn.make_slice(0, 1, poc_lsb=2)), 1)
    outs = d.push_au(syn.annexb(syn.make_slice(
        2, 0, idr=True, poc_lsb=0)), 2)
    outs += d.drain()
    assert [o.system_frame_number for o in outs] == [0, 1, 2]


def test_flush_discards():
    sps = syn.make_sps(num_ref_frames=4)
    pps = syn.make_pps()
    d = H264Decoder()
    d.push_au(syn.annexb(sps, pps,
                         syn.make_slice(2, 0, idr=True, poc_lsb=0)), 0)
    d.flush()
    assert d.dpb.pic_list == []
    assert d.drain() == []


def test_avc_input_via_codec_data():
    """AVC (length-prefixed) input with avcC codec data."""
    co = _oracle()
    pkts = co.encode("libx264",
                     "x264-params=bframes=2:b-adapt=0:keyint=25",
                     96, 64, 20)
    # build avcC from the in-band SPS/PPS, then strip param sets and
    # re-frame as AVC
    sps_nal = pps_nal = None
    for nal in h.split_bytestream(pkts[0].data):
        if h.nal_type(nal) == h.NAL_SPS:
            sps_nal = nal
        elif h.nal_type(nal) == h.NAL_PPS:
            pps_nal = nal
    avcc = h.build_avcc([sps_nal], [pps_nal])
    d = H264Decoder()
    d.set_codec_data(avcc)
    outs = []
    for i, p in enumerate(pkts):
        payload = [n for n in h.split_bytestream(p.data)
                   if h.nal_type(n) in (1, 5, 6, 9)]
        outs += d.push_au(h.to_avc(payload), i, avc=True)
    outs += d.drain()
    got = [pkts[o.system_frame_number].pts for o in outs]
    assert got == co.decode_output_pts("h264", pkts)


# ---------------------------------------------------- field pictures

def test_field_pairing_and_output():
    """PAFF: top+bottom fields pair into one output picture
    (gsth264decoder.c:1124-1200, 820-902)."""
    sps = syn.make_sps(num_ref_frames=4, frame_mbs_only=0)
    pps = syn.make_pps()
    d = H264Decoder()
    # IDR top field + bottom field in separate AUs
    d.push_au(syn.annexb(sps, pps, syn.make_slice(
        2, 0, idr=True, poc_lsb=0, field_pic=True, bottom_field=False,
        frame_mbs_only=0)), 0)
    d.push_au(syn.annexb(syn.make_slice(
        2, 0, poc_lsb=1, field_pic=True, bottom_field=True,
        frame_mbs_only=0)), 1)
    d.push_au(syn.annexb(syn.make_slice(
        0, 1, poc_lsb=2, field_pic=True, bottom_field=False,
        frame_mbs_only=0)), 2)
    d.push_au(syn.annexb(syn.make_slice(
        0, 1, poc_lsb=3, field_pic=True, bottom_field=True,
        frame_mbs_only=0)), 3)
    outs = d.drain()
    # two complete field pairs, output at the first field's sfn
    assert [o.system_frame_number for o in outs] == [0, 2]
    assert all(o.picture.other_field is not None
               or o.picture.interlaced for o in outs)


def test_field_ref_list_interleaves_parities():
    """8.2.4.2.5: field P lists alternate same/opposite parity."""
    sps = syn.make_sps(num_ref_frames=4, frame_mbs_only=0)
    pps = syn.make_pps()
    d = H264Decoder()
    d.push_au(syn.annexb(sps, pps, syn.make_slice(
        2, 0, idr=True, poc_lsb=0, field_pic=True, frame_mbs_only=0)), 0)
    d.push_au(syn.annexb(syn.make_slice(
        2, 0, poc_lsb=1, field_pic=True, bottom_field=True,
        frame_mbs_only=0)), 1)
    d.push_au(syn.annexb(syn.make_slice(
        0, 1, poc_lsb=2, field_pic=True, frame_mbs_only=0)), 2)
    # the P top field's INITIAL list (before the num_ref_idx_active
    # truncation): same parity (top idr) first, then the bottom field
    fields = [p.field for p in d.ref_pic_list_p0]
    assert fields[0] == dec.FIELD_TOP
    assert dec.FIELD_BOTTOM in fields
