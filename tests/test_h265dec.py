"""H.265 stateless-decoder base layer (gstbad/codecs/h265.py vs
gst-libs/gst/codecs/gsth265decoder.c).

Oracles:
- libavcodec's hevc decoder: our DPB engine's output order must equal
  its output order on libx265-encoded IPPP / B / B-pyramid / open-GOP
  structures.
- libde265 (the exact library the reference's ext/libde265 wraps):
  lossless-encoded frames carry their index in the last luma row, so
  the de265 output sequence is recoverable and must equal our order.
- Structural checks: CRA/RASL dropping when a stream is joined
  mid-GOP, RPS-driven reference marking, bump timing vs
  sps_max_num_reorder_pics.
"""

import pytest

from gstbad.codecs.h265 import H265Decoder
from gstbad.io import h265nal as hv


def _oracle():
    from gstbad.io import codecoracle
    return codecoracle


X265_CONFIGS = [
    ("ippp", "x265-params=bframes=0:keyint=25:ref=3"),
    ("ibbp", "x265-params=bframes=2:b-adapt=0:keyint=25:ref=3"),
    ("bpyramid",
     "x265-params=bframes=3:b-adapt=0:b-pyramid=1:keyint=25:ref=4"),
    ("opengop",
     "x265-params=bframes=4:b-adapt=2:keyint=20:open-gop=1:ref=4"),
    ("longgop", "x265-params=bframes=8:b-adapt=2:keyint=50:ref=5"),
]


def _run_engine(pkts):
    d = H265Decoder()
    outs = []
    for i, p in enumerate(pkts):
        outs += d.push_au(p.data, i)
    outs += d.drain()
    return d, outs


@pytest.mark.parametrize("name,opts", X265_CONFIGS,
                         ids=[c[0] for c in X265_CONFIGS])
def test_output_order_matches_real_decoder(name, opts):
    co = _oracle()
    pkts = co.encode("libx265", opts, 128, 96, 40)
    _, outs = _run_engine(pkts)
    got = [pkts[o.system_frame_number].pts for o in outs]
    want = co.decode_output_pts("hevc", pkts)
    assert got == want
    assert len(outs) == 40
    pocs = [o.poc for o in outs]
    gop_starts = [i for i, o in enumerate(outs) if o.poc == 0]
    for a, b in zip(gop_starts, gop_starts[1:] + [len(outs)]):
        assert pocs[a:b] == sorted(pocs[a:b])


def test_against_libde265():
    """Cross-oracle: lossless x265 frames carry their index in the
    last luma row (codecoracle fill_frame: y[h-1,x] = x+h-1+3i);
    libde265's output order must equal our engine's."""
    h265 = pytest.importorskip("gstbad.io.h265")
    if not h265.available():
        pytest.skip("libde265 unavailable")
    co = _oracle()
    n = 30
    pkts = co.encode(
        "libx265",
        "x265-params=bframes=3:b-adapt=0:b-pyramid=1:keyint=25:"
        "ref=3:lossless=1", 128, 96, n)
    _, outs = _run_engine(pkts)
    got = [pkts[o.system_frame_number].pts for o in outs]

    dec = h265.H265Decoder()
    dec.push(b"".join(p.data for p in pkts))
    dec.flush()
    frames = dec.decode()
    # libde265's pull loop may leave the tail picture buffered
    assert len(frames) >= n - 1
    de265_order = []
    for f in frames:
        v = int(f["y"][-1, 0])          # x=0: v = (h-1 + 3i) & 255
        i = ((v - (96 - 1)) * 171) % 256  # 171 = 3^-1 mod 256
        de265_order.append(i)
    assert de265_order == got[:len(de265_order)] \
        == list(range(len(de265_order)))


def test_rps_parsing_on_real_stream():
    """x265 SPS carries inter-RPS-predicted short-term sets; the
    derivation (7-47..7-50) must produce negative/positive deltas."""
    co = _oracle()
    pkts = co.encode("libx265", X265_CONFIGS[2][1], 128, 96, 30)
    sps_d, pps_d = {}, {}
    n_slices = n_with_refs = 0
    for p in pkts:
        for nal in hv.split_bytestream(p.data):
            t = hv.nal_type(nal)
            if t == hv.NAL_SPS:
                sps = hv.parse_sps_full(nal)
                sps_d[sps.sps_id] = sps
                assert sps.max_dec_pic_buffering[-1] >= 2
            elif t == hv.NAL_PPS:
                pps = hv.parse_pps_full(nal)
                pps_d[pps.pps_id] = pps
            elif hv.is_slice(t):
                hdr = hv.parse_slice_header_full(nal, sps_d, pps_d)
                n_slices += 1
                if not hdr.is_i():
                    assert hdr.st_rps is not None
                    assert hdr.st_rps.num_delta_pocs > 0
                    for dp in hdr.st_rps.delta_poc_s0:
                        assert dp < 0
                    for dp in hdr.st_rps.delta_poc_s1:
                        assert dp > 0
                    n_with_refs += 1
    assert n_slices >= 30 and n_with_refs > 20


def test_ref_lists_on_real_stream():
    """l0 starts with the closest PocStCurrBefore, l1 with the closest
    PocStCurrAfter (8.3.4)."""
    co = _oracle()
    pkts = co.encode("libx265",
                     "x265-params=bframes=2:b-adapt=0:keyint=25:ref=3",
                     128, 96, 30)
    d = H265Decoder()
    checked_b = 0
    for i, p in enumerate(pkts):
        d.push_au(p.data, i)
        me = d.last_finished_picture
        if me is not None and me.ref_list1:
            l0 = [q.pic_order_cnt for q in me.ref_list0 if q]
            l1 = [q.pic_order_cnt for q in me.ref_list1 if q]
            assert l0 and l0[0] < me.pic_order_cnt
            assert l1 and l1[0] > me.pic_order_cnt
            checked_b += 1
    assert checked_b > 5


def test_cra_join_drops_rasl():
    """Joining an open-GOP stream at a CRA must drop its RASL
    pictures (NoRaslOutputFlag; gsth265decoder.c:1604-1611)."""
    co = _oracle()
    pkts = co.encode(
        "libx265",
        "x265-params=bframes=4:b-adapt=0:keyint=15:open-gop=1:ref=3",
        128, 96, 48)
    # find a mid-stream CRA followed by RASL pictures
    def _is_cra(p):
        return any(hv.nal_type(n) == hv.NAL_CRA
                   for n in hv.split_bytestream(p.data))
    cra_idx = [i for i, p in enumerate(pkts) if _is_cra(p)]
    start = next(i for i in cra_idx
                 if any(hv.is_rasl(hv.nal_type(n))
                        for q in pkts[i:i + 6]
                        for n in hv.split_bytestream(q.data)))
    # confirm RASL NALs follow it
    has_rasl = False
    for p in pkts[start:start + 6]:
        for nal in hv.split_bytestream(p.data):
            if hv.is_rasl(hv.nal_type(nal)):
                has_rasl = True
    assert has_rasl, "expected RASL pictures after the mid-stream CRA"
    # also prepend the parameter sets (hvc1-style out-of-band)
    param_nals = [nal for nal in hv.split_bytestream(pkts[0].data)
                  if hv.nal_type(nal) in (hv.NAL_VPS, hv.NAL_SPS,
                                          hv.NAL_PPS)]
    d = H265Decoder()
    outs = []
    joined = pkts[start:]
    for i, p in enumerate(joined):
        data = (hv.to_bytestream(param_nals) + p.data) if i == 0 \
            else p.data
        outs += d.push_au(data, i)
    outs += d.drain()
    # the oracle agrees when fed the same tail
    want = co.decode_output_pts("hevc",
                                [_with_params(joined[0], param_nals)]
                                + joined[1:])
    got = [joined[o.system_frame_number].pts for o in outs]
    assert got == want
    # RASL pictures were dropped: fewer outputs than inputs
    assert len(outs) < len(joined)


def _with_params(pkt, param_nals):
    from gstbad.io.codecoracle import Packet
    return Packet(hv.to_bytestream(param_nals) + pkt.data,
                  pkt.pts, pkt.dts, pkt.key)


def test_reorder_latency_matches_sps():
    """Bump timing: with sps_max_num_reorder_pics = R, the engine may
    buffer at most R+1 pictures before the first output."""
    co = _oracle()
    pkts = co.encode("libx265",
                     "x265-params=bframes=3:b-adapt=0:keyint=25:ref=3",
                     128, 96, 20)
    d = H265Decoder()
    first_out_at = None
    for i, p in enumerate(pkts):
        outs = d.push_au(p.data, i)
        if outs and first_out_at is None:
            first_out_at = i
    sps = next(iter(d.sps_by_id.values()))
    reorder = sps.max_num_reorder_pics[sps.max_sub_layers_minus1]
    assert first_out_at is not None
    assert first_out_at <= reorder + 1


def test_idr_resets_poc():
    co = _oracle()
    pkts = co.encode("libx265",
                     "x265-params=bframes=0:keyint=10:ref=2:no-open-gop=1",
                     128, 96, 25)
    _, outs = _run_engine(pkts)
    # every 10th output restarts POC at 0
    assert [o.poc for o in outs[:10]] == sorted(
        o.poc for o in outs[:10])
    assert outs[10].poc == 0 and outs[20].poc == 0


def test_marking_follows_rps():
    """After each picture, every DPB entry still marked ref must be
    reachable from some RPS of the last slice — x265's ref=2 stream
    keeps at most 3 short-term refs alive."""
    co = _oracle()
    pkts = co.encode("libx265",
                     "x265-params=bframes=0:keyint=50:ref=2",
                     128, 96, 30)
    d = H265Decoder()
    for i, p in enumerate(pkts):
        d.push_au(p.data, i)
        n_refs = sum(1 for q in d.dpb.pic_list if q.ref)
        assert n_refs <= 4
