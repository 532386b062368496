"""sdpdemux — gst/sdp/gstsdpdemux.c with an injected transport.

The reference parses an SDP from its sink pad, creates one stream per
m= section with application/x-rtp caps
(gst_sdp_demux_create_stream, gstsdpdemux.c:371-458), then spawns
rtpbin + udpsrc pairs to receive the session.  This rebuild keeps the
whole stream-setup layer — payload-type resolution, caps, connection
address/ttl/multicast, rtp/rtcp ports, the shared-container rule for
repeated dynamic PTs — and replaces the network half with injected RTP
packet delivery (push_rtp), reordered per stream by wrap-aware sequence
number (the jitterbuffer's reordering contract) before pull().

Properties mirror gstsdpdemux.c: debug, timeout, latency,
redirect (rtsp-sdp redirection is accepted but not followed — no
network).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from gstbad.core.element import Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import require
from gstbad.io import rtp as rtp_io
from gstbad.io import sdp as sdp_io


@dataclass
class SdpStream:
    """GstSDPStream (gstsdpdemux.c:371-458)."""
    id: int = 0
    pt: int = -1
    caps: Dict[str, object] = field(default_factory=dict)
    container: bool = False
    destination: str = ""
    ttl: int = 0
    multicast: bool = False
    rtp_port: int = 0
    rtcp_port: int = 0
    eos: bool = False
    _packets: List[rtp_io.RtpPacket] = field(default_factory=list)


@register
class SdpDemux(Element):
    NAME = "sdpdemux"
    KIND = "host-source"
    PROPERTIES = (
        Property("debug", bool, False, static=True),
        Property("timeout", int, 10_000_000, 0, None, static=True),
        Property("latency", int, 200, 0, 65535, static=True),
        Property("redirect", bool, True, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self.streams: List[SdpStream] = []
        self._message: Optional[sdp_io.SdpMessage] = None

    # -- SDP ingestion ------------------------------------------------

    def push_sdp(self, text: str) -> List[SdpStream]:
        """The sink-pad EOS path: parse the collected SDP and create
        every stream (gst_sdp_demux_sink_event -> create_stream)."""
        msg = sdp_io.SdpMessage.parse(text)
        self._message = msg
        for idx, media in enumerate(msg.medias):
            stream = SdpStream(id=len(self.streams))
            if media.formats:
                stream.pt = int(media.formats[0])
                stream.caps = sdp_io.media_to_caps(media, stream.pt)
                if stream.pt >= 96 and any(
                        s.pt == stream.pt for s in self.streams):
                    # same dynamic PT twice = one container stream
                    # (gstsdpdemux.c:405-413)
                    stream.container = True
            conn = (media.connections[0] if media.connections
                    else msg.connection)
            require(conn is not None and conn.address,
                    f"sdpdemux: media {idx} has no connection")
            stream.destination = conn.address
            stream.ttl = conn.ttl
            stream.multicast = sdp_io.is_multicast_address(
                conn.address)
            stream.rtp_port = media.port
            # FIXME upstream too: RFC 3605 rtcp attribute is ignored,
            # rtcp port is always rtp+1 (gstsdpdemux.c:436-442)
            stream.rtcp_port = media.port + 1
            self.streams.append(stream)
        return self.streams

    # -- injected transport -------------------------------------------

    def push_rtp(self, data: bytes, port: Optional[int] = None
                 ) -> Optional[SdpStream]:
        """Deliver one RTP packet; routed by destination port when
        given, else by payload type."""
        pkt = rtp_io.RtpPacket.parse(data)
        stream = None
        if port is not None:
            for s in self.streams:
                if s.rtp_port == port:
                    stream = s
                    break
        if stream is None:
            for s in self.streams:
                if s.pt == pkt.payload_type:
                    stream = s
                    break
        if stream is None:
            return None
        stream._packets.append(pkt)
        return stream

    def eos(self) -> None:
        for s in self.streams:
            s.eos = True

    def pull(self, stream_id: int) -> List[dict]:
        """Drain a stream's packets in sequence order (wrap-aware,
        like the rtpbin jitterbuffer's reordering) as depayloader-ready
        dicts carrying the stream caps."""
        s = self.streams[stream_id]
        pkts = s._packets
        s._packets = []
        if pkts:
            base = pkts[0].seq
            # signed 16-bit wrap distance to the first arrival, so a
            # seq that wrapped sorts after 0xFFFF, not before 0
            pkts.sort(key=lambda p: (((p.seq - base + 0x8000)
                                      & 0xFFFF) - 0x8000))
        return [dict(caps=s.caps, pt=p.payload_type, seq=p.seq,
                     timestamp=p.timestamp, marker=p.marker,
                     ssrc=p.ssrc, payload=p.payload)
                for p in pkts]

    def process(self, params, state, batch: FrameBatch):
        return state, batch
