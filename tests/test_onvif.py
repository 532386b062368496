"""rtponviftimestamp / rtponvifparse (gst/onvif) — upstream test
transcription (tests/check/elements/rtponviftimestamp.c harness
semantics: extension layout, C/E/D/T flags, one-buffer latency)."""

import pytest

import gstbad as gt
from gstbad.io.rtp import RtpPacket
from gstbad.elements.onvif import (EXTENSION_ID, to_ntp,
                                       from_ntp_parts)

NSEC = 1_000_000_000
NTP_OFFSET = 3600 * NSEC  # the upstream test's 1h offset analog
CSEQ = 0x78


def rtp(pts_clean=True, payload=b""):
    return RtpPacket(payload_type=96, seq=1, timestamp=0,
                     ssrc=0x11223344, payload=payload).serialize()


def expected_ext(pts_ns, clean, e, d, t=False, cseq=CSEQ):
    data = bytearray(12)
    data[0:8] = to_ntp(pts_ns + NTP_OFFSET).to_bytes(8, "big")
    flags = 0
    if clean:
        flags |= 1 << 7
    if e:
        flags |= 1 << 6
    if d:
        flags |= 1 << 5
    if t:
        flags |= 1 << 4
    data[8] = flags
    data[9] = cseq
    return (EXTENSION_ID, bytes(data))


def make_el(**kw):
    props = {"ntp-offset": NTP_OFFSET, "cseq": CSEQ}
    props.update(kw)
    return gt.make("rtponviftimestamp", **props)


def test_apply_clean_point():
    """test_apply_clean_point: C bit set, first buffer carries D."""
    el = make_el()
    out = el.chain(rtp(), pts_ns=0, keyframe=True)
    pkt = RtpPacket.parse(out[0])
    assert pkt.extension == expected_ext(0, clean=True, e=False,
                                         d=True)


def test_apply_no_e_bit():
    """Without set-e-bit buffers pass through immediately, E never
    set; only the first has D."""
    el = make_el()
    outs = []
    for i in range(3):
        outs += el.chain(rtp(), pts_ns=i * NSEC, keyframe=False)
    outs += el.event_eos()
    assert len(outs) == 3
    for i, o in enumerate(outs):
        pkt = RtpPacket.parse(o)
        assert pkt.extension == expected_ext(i * NSEC, clean=False,
                                             e=False, d=(i == 0))


def test_apply_e_bit():
    """set-e-bit: one-buffer latency; the last buffer (flushed at EOS)
    carries E."""
    el = make_el(**{"set-e-bit": True})
    outs = []
    for i in range(3):
        outs += el.chain(rtp(), pts_ns=i * NSEC)
    assert len(outs) == 2  # one behind
    outs += el.event_eos()
    assert len(outs) == 3
    for i, o in enumerate(outs):
        pkt = RtpPacket.parse(o)
        assert pkt.extension == expected_ext(
            i * NSEC, clean=True, e=(i == 2), d=(i == 0))


def test_apply_t_bit():
    """set-t-bit: the last buffer before EOS carries T (and E when
    both set)."""
    el = make_el(**{"set-e-bit": True, "set-t-bit": True})
    outs = el.chain(rtp(), pts_ns=0)
    outs += el.chain(rtp(), pts_ns=NSEC)
    outs += el.event_eos()
    last = RtpPacket.parse(outs[-1])
    assert last.extension == expected_ext(NSEC, clean=True, e=True,
                                          d=False, t=True)


def test_segment_boundary_e_bit():
    """A new segment flushes the held buffer with E and re-arms D
    (test_reusable_element_e_bit shape)."""
    el = make_el(**{"set-e-bit": True})
    outs = el.chain(rtp(), pts_ns=0)
    outs += el.event_segment()
    assert len(outs) == 1
    pkt = RtpPacket.parse(outs[0])
    assert pkt.extension == expected_ext(0, clean=True, e=True, d=True)
    outs = el.chain(rtp(), pts_ns=2 * NSEC)
    outs += el.event_eos()
    pkt = RtpPacket.parse(outs[0])
    assert pkt.extension == expected_ext(2 * NSEC, clean=True, e=True,
                                         d=True)


def test_parse_roundtrip():
    """rtponvifparse recovers pts/flags and signals EOS on T."""
    el = make_el(**{"set-e-bit": True, "set-t-bit": True})
    outs = el.chain(rtp(), pts_ns=5 * NSEC, keyframe=True)
    outs += el.event_eos()
    parse = gt.make("rtponvifparse")
    got = parse.chain(outs[0])
    assert got["pts"] == 5 * NSEC + NTP_OFFSET
    assert got["keyframe"]
    assert got["discont"]
    assert got["eos"]  # T bit -> EOS downstream


def test_parse_passthrough_without_extension():
    parse = gt.make("rtponvifparse")
    data = rtp(payload=b"payload")
    got = parse.chain(data)
    assert got["data"] == data
    assert got["pts"] is None and not got["eos"]


def test_ntp_conversion():
    """32.32 fixed point both ways (convert_to_ntp in the upstream
    harness)."""
    for t in (0, 1, NSEC, 5 * NSEC + 123456789):
        ntp = to_ntp(t)
        sec, frac = ntp >> 32, ntp & 0xFFFFFFFF
        back = from_ntp_parts(sec, frac)
        assert abs(back - t) <= 1  # 1 ns quantization


def test_rtp_packet_roundtrip():
    p = RtpPacket(marker=True, payload_type=96, seq=0x1234,
                  timestamp=0xDEADBEEF, ssrc=42, csrcs=[1, 2],
                  payload=b"hello")
    p.extension = (0xABAC, bytes(12))
    q = RtpPacket.parse(p.serialize())
    assert q.marker and q.payload_type == 96 and q.seq == 0x1234
    assert q.csrcs == [1, 2]
    assert q.extension == (0xABAC, bytes(12))
    assert q.payload == b"hello"
