"""sdpdemux / io/sdp.py — RFC 4566 parse, media->caps
(gst_sdp_media_get_caps_from_media semantics) and the injected-RTP
session (gstsdpdemux.c:371-458 stream setup)."""

import numpy as np
import pytest

import gstbad as gt
from gstbad.io import rtp as rtp_io
from gstbad.io import sdp as sdp_io


SDP = """v=0
o=- 123 1 IN IP4 10.0.0.1
s=GstBad session
c=IN IP4 224.2.1.1/127
t=0 0
a=recvonly
m=video 5004 RTP/AVP 96
a=rtpmap:96 H264/90000
a=fmtp:96 packetization-mode=1; profile-level-id=42C01E
m=audio 5006 RTP/AVP 0
m=audio 5008 RTP/AVP 97
c=IN IP4 10.0.0.7
a=rtpmap:97 opus/48000/2
"""


def test_sdp_parse():
    msg = sdp_io.SdpMessage.parse(SDP)
    assert msg.session_name == "GstBad session"
    assert msg.connection.address == "224.2.1.1"
    assert msg.connection.ttl == 127
    assert len(msg.medias) == 3
    v, a0, a1 = msg.medias
    assert (v.media, v.port, v.proto, v.formats) \
        == ("video", 5004, "RTP/AVP", ["96"])
    assert a1.connections[0].address == "10.0.0.7"
    assert v.get_attribute_val("rtpmap") == "96 H264/90000"


def test_media_to_caps_dynamic_and_static():
    msg = sdp_io.SdpMessage.parse(SDP)
    caps = sdp_io.media_to_caps(msg.medias[0], 96)
    assert caps["media"] == "video" and caps["payload"] == 96
    assert caps["encoding-name"] == "H264"
    assert caps["clock-rate"] == 90000
    assert caps["packetization-mode"] == "1"
    assert caps["profile-level-id"] == "42C01E"
    # static PT 0 = PCMU/8000 (RFC 3551, no rtpmap needed)
    caps0 = sdp_io.media_to_caps(msg.medias[1], 0)
    assert caps0["encoding-name"] == "PCMU"
    assert caps0["clock-rate"] == 8000
    # rtpmap with encoding-params
    caps97 = sdp_io.media_to_caps(msg.medias[2], 97)
    assert caps97["encoding-name"] == "OPUS"
    assert caps97["encoding-params"] == "2"
    # dynamic PT without rtpmap is an error
    with pytest.raises(sdp_io.SdpError):
        sdp_io.media_to_caps(msg.medias[1], 98)


def test_sdpdemux_streams_and_rtp_flow():
    el = gt.make("sdpdemux")
    streams = el.push_sdp(SDP)
    assert len(streams) == 3
    v = streams[0]
    assert v.pt == 96 and v.caps["encoding-name"] == "H264"
    assert v.destination == "224.2.1.1" and v.multicast
    assert v.ttl == 127
    assert (v.rtp_port, v.rtcp_port) == (5004, 5005)
    a1 = streams[2]
    assert a1.destination == "10.0.0.7" and not a1.multicast

    # out-of-order RTP (incl. a 16-bit seq wrap) reorders per stream
    rng = np.random.default_rng(5)
    payloads = [rng.integers(0, 256, 20, np.uint8).tobytes()
                for _ in range(4)]
    seqs = [65534, 65535, 0, 1]
    order = [2, 0, 3, 1]
    for i in order:
        pkt = rtp_io.RtpPacket(payload_type=96, seq=seqs[i],
                               timestamp=90000 * i, ssrc=0x1234,
                               payload=payloads[i])
        assert el.push_rtp(pkt.serialize(), port=5004) is v
    out = el.pull(0)
    assert [o["payload"] for o in out] == payloads
    assert [o["seq"] for o in out] == seqs
    assert all(o["caps"]["encoding-name"] == "H264" for o in out)

    # payload-type routing without a port
    pkt = rtp_io.RtpPacket(payload_type=0, seq=7, payload=b"\xff" * 8)
    s = el.push_rtp(pkt.serialize())
    assert s is streams[1]
    assert el.pull(1)[0]["caps"]["encoding-name"] == "PCMU"


def test_sdpdemux_container_rule():
    """Two m= sections with the SAME dynamic PT mark the second as a
    container stream (gstsdpdemux.c:405-413)."""
    sdp = """v=0
o=- 1 1 IN IP4 10.0.0.1
s=x
c=IN IP4 10.0.0.2
m=video 5000 RTP/AVP 96
a=rtpmap:96 MP2T/90000
m=audio 5002 RTP/AVP 96
a=rtpmap:96 MP2T/90000
"""
    el = gt.make("sdpdemux")
    streams = el.push_sdp(sdp)
    assert not streams[0].container
    assert streams[1].container


def test_sdpdemux_no_connection_rejected():
    el = gt.make("sdpdemux")
    with pytest.raises(Exception, match="no connection"):
        el.push_sdp("v=0\ns=x\nm=video 5000 RTP/AVP 96\n"
                    "a=rtpmap:96 H264/90000\n")
