"""VP9 stateful parser + decoder base layer (gstbad/codecs/vp9.py
vs gst-libs/gst/codecs/gstvp9statefulparser.c + gstvp9decoder.c).

Real streams come from libvpx (the library VP9 is defined against);
output count/order is checked against libavcodec's vp9 decoder.
Cross-frame statefulness (segmentation/loop-filter persistence,
past-independence resets) is exercised on aq-mode streams and
hand-built headers.
"""

import pytest

from gstbad.codecs import vp9 as cvp9
from gstbad.io import vp9 as iovp9


def _oracle():
    from gstbad.io import codecoracle
    return codecoracle


def _frames(pkts):
    for i, p in enumerate(pkts):
        for f in iovp9.split_superframe(p.data):
            yield i, f


VPX_CONFIGS = [
    ("plain", "deadline=good,cpu-used=8,g=20"),
    ("altref", "auto-alt-ref=1,lag-in-frames=16,deadline=good,"
               "cpu-used=2,g=30,b=100000"),
    ("aq", "aq-mode=2,deadline=good,cpu-used=8,crf=30,b=0"),
    ("errres", "error-resilient=1,deadline=good,cpu-used=8,g=25"),
]


@pytest.mark.parametrize("name,opts", VPX_CONFIGS,
                         ids=[c[0] for c in VPX_CONFIGS])
def test_output_matches_real_decoder(name, opts):
    co = _oracle()
    pkts = co.encode("libvpx-vp9", opts, 160, 128, 30)
    d = cvp9.Vp9Decoder()
    outs = []
    for i, f in _frames(pkts):
        outs += d.push_frame(f, i)
    got = [pkts[o.system_frame_number].pts for o in outs]
    want = co.decode_output_pts("vp9", pkts)
    assert got == want == list(range(30))


def test_keyframe_refreshes_all_slots():
    co = _oracle()
    pkts = co.encode("libvpx-vp9", "deadline=good,cpu-used=8,g=20",
                     96, 64, 5)
    d = cvp9.Vp9Decoder()
    i, f = next(_frames(pkts))
    d.push_frame(f, 0)
    assert all(s is not None and s.frame_hdr.frame_type == cvp9.KEY_FRAME
               for s in d.dpb)


def test_inter_frame_fields():
    """refresh flags / ref indices / size-from-refs on real inter
    frames."""
    co = _oracle()
    pkts = co.encode("libvpx-vp9", "deadline=good,cpu-used=8,g=20",
                     96, 64, 20)
    d = cvp9.Vp9Decoder()
    n_inter = 0
    for i, f in _frames(pkts):
        d.push_frame(f, i)
        hdr = d.parser  # stateful side
        last = d.dpb[0].frame_hdr if d.dpb[0] else None
    d2 = cvp9.Vp9Decoder()
    for i, f in _frames(pkts):
        outs = d2.push_frame(f, i)
        h = outs[0].picture.frame_hdr if outs else None
        if h is not None and h.frame_type == cvp9.INTER_FRAME:
            assert all(0 <= ix < 8 for ix in h.ref_frame_idx)
            assert h.width == 96 and h.height == 64
            assert h.header_size_in_bytes > 0
            assert 0 < h.frame_header_length_in_bytes <= len(f)
            n_inter += 1
    assert n_inter >= 15


def test_segmentation_persists_across_frames():
    """The stateful parser must carry per-segment feature data into
    frames that do not update it (the reason
    GstVp9StatefulParser exists; gstvp9statefulparser.c:1074-1078)."""
    co = _oracle()
    pkts = co.encode("libvpx-vp9",
                     "aq-mode=2,deadline=good,cpu-used=8,crf=30,b=0",
                     160, 128, 25)
    d = cvp9.Vp9Decoder()
    carried = 0
    update_seen = False
    last_data = None
    for i, f in _frames(pkts):
        d.push_frame(f, i)
        sp = d.parser.segmentation_params
        assert sp.segmentation_enabled
        if sp.segmentation_update_data:
            update_seen = True
            last_data = [list(x) for x in sp.feature_data]
        elif last_data is not None:
            # no update this frame: data must be carried verbatim
            assert sp.feature_data == last_data
            carried += 1
    assert update_seen
    assert carried > 0


def test_error_resilient_past_independence():
    """error-resilient frames reset lf deltas to the spec 7.2
    defaults."""
    co = _oracle()
    pkts = co.encode("libvpx-vp9",
                     "error-resilient=1,deadline=good,cpu-used=8,g=25",
                     96, 64, 10)
    d = cvp9.Vp9Decoder()
    for i, f in _frames(pkts):
        d.push_frame(f, i)
        lf = d.parser.loop_filter_params
        if not lf.loop_filter_delta_update:
            assert lf.loop_filter_ref_deltas == [1, 0, -1, -1]


def test_show_existing_frame_duplicates():
    """A hand-built show_existing_frame header (marker+profile+flag+
    slot fits in one byte) must duplicate the slot picture without
    touching the DPB (gstvp9decoder.c:317-345)."""
    co = _oracle()
    pkts = co.encode("libvpx-vp9", "deadline=good,cpu-used=8,g=20",
                     96, 64, 3)
    d = cvp9.Vp9Decoder()
    for i, f in _frames(pkts):
        d.push_frame(f, i)
    slot2 = d.dpb[2]
    # 0b10 (marker) 0b00 (profile) 1 (show_existing) 010 (slot 2)
    se = bytes([0b10_0_0_1_010 & 0xFF])
    dpb_before = list(d.dpb)
    outs = d.push_frame(se, 99)
    assert len(outs) == 1
    assert outs[0].picture.duplicate_of is slot2
    assert d.dpb == dpb_before


def test_show_existing_empty_slot_raises():
    d = cvp9.Vp9Decoder()
    with pytest.raises(ValueError):
        d.push_frame(bytes([0b10_0_0_1_010]), 0)


def test_quant_lookup_spec_values():
    """Spot values from the VP9 spec 8.6.1 tables."""
    assert cvp9.get_dc_quant(0, 0, 8) == 4
    assert cvp9.get_dc_quant(255, 0, 8) == 1336
    assert cvp9.get_ac_quant(0, 0, 8) == 4
    assert cvp9.get_ac_quant(255, 0, 8) == 1828
    assert cvp9.get_dc_quant(0, 0, 10) == 4
    assert cvp9.get_ac_quant(255, 0, 12) == 29247
    # delta clamps
    assert cvp9.get_dc_quant(250, 10, 8) == cvp9.get_dc_quant(255, 0, 8)
    assert cvp9.get_ac_quant(3, -10, 8) == cvp9.get_ac_quant(0, 0, 8)


def test_qindex_abs_vs_delta():
    """8.6.1 get_qindex: delta adds to base, abs replaces."""
    seg = cvp9.SegmentationParams()
    quant = cvp9.QuantizationParams(base_q_idx=100)
    assert cvp9.get_qindex(seg, quant, 0) == 100
    seg.segmentation_enabled = 1
    seg.feature_enabled[3][cvp9.SEG_LVL_ALT_Q] = 1
    seg.feature_data[3][cvp9.SEG_LVL_ALT_Q] = -30
    assert cvp9.get_qindex(seg, quant, 3) == 70
    assert cvp9.get_qindex(seg, quant, 0) == 100
    seg.segmentation_abs_or_delta_update = 1
    assert cvp9.get_qindex(seg, quant, 3) == 0  # abs: clamp(-30)
    seg.feature_data[3][cvp9.SEG_LVL_ALT_Q] = 200
    assert cvp9.get_qindex(seg, quant, 3) == 200


def test_lossless_flag():
    """lossless requires base_q_idx == 0 and all deltas == 0."""
    co = _oracle()
    pkts = co.encode("libvpx-vp9", "lossless=1,deadline=good,cpu-used=8",
                     96, 64, 5)
    d = cvp9.Vp9Decoder()
    for i, f in _frames(pkts):
        outs = d.push_frame(f, i)
        assert outs[0].picture.frame_hdr.lossless_flag


def test_tile_info_parse():
    """Wider frames force >0 tile columns; tile_cols_log2 respects
    the min/max sb64 bounds (6.2.13/14)."""
    co = _oracle()
    pkts = co.encode("libvpx-vp9",
                     "tile-columns=2,deadline=good,cpu-used=8",
                     640, 128, 3)
    d = cvp9.Vp9Decoder()
    seen = []
    for i, f in _frames(pkts):
        outs = d.push_frame(f, i)
        if outs:
            seen.append(outs[0].picture.frame_hdr.tile_cols_log2)
    assert seen and max(seen) >= 1
