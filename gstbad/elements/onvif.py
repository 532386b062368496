"""rtponviftimestamp + rtponvifparse (gst/onvif/) over io/rtp.py.

The ONVIF Streaming Spec RTP header extension (id 0xABAC, 3 words):
8-byte NTP timestamp, flag byte C|E|D|T|mbz, CSeq low byte, padding.

rtponviftimestamp (gstrtponviftimestamp.c): writes the extension on
every packet — NTP time = stream time + ntp-offset scaled into 32.32
fixed point, C when the buffer is a clean point (not delta), D on the
first buffer after activation/discont, E on the last buffer of a
contiguous section (requires one-buffer latency: with set-e-bit the
element holds each buffer until the next one or EOS/segment), T with
set-t-bit on EOS.

rtponvifparse (gstrtponvifparse.c): reads the extension back into
pts/keyframe/discont and signals EOS on T; packets without the 0xABAC
extension pass through untouched.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from gstbad.core.element import Element, Property
from gstbad.core.registry import register
from gstbad.io.rtp import RtpPacket

NSEC = 1_000_000_000
EXTENSION_ID = 0xABAC
EXTENSION_SIZE = 3


def to_ntp(t_ns: int) -> int:
    """gst_util_uint64_scale(time, 1<<32, GST_SECOND)."""
    return (t_ns * (1 << 32)) // NSEC


def from_ntp_parts(seconds: int, fraction: int) -> int:
    """gstrtponvifparse.c:119-128: ns = seconds*1e9 +
    (fraction * 1e9 >> 32)."""
    return seconds * NSEC + ((fraction * NSEC) >> 32)


@register
class RtpOnvifTimestamp(Element):
    NAME = "rtponviftimestamp"
    KIND = "host-source"
    PROPERTIES = (
        Property("ntp-offset", int, -1, None, None, static=True),
        Property("cseq", int, 0, 0, 2 ** 31 - 1, static=True),
        Property("set-e-bit", bool, False, static=True),
        Property("set-t-bit", bool, False, static=True),
        Property("drop-out-of-segment", bool, True, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._held: Optional[Dict] = None
        self._d_bit = True   # first buffer after activation
        self._e_bit = False
        self._t_bit = False

    def _stamp(self, pkt: RtpPacket, pts_ns: int,
               keyframe: bool, discont: bool) -> RtpPacket:
        """handle_buffer (gstrtponviftimestamp.c:471-594)."""
        data = bytearray(4 * EXTENSION_SIZE)
        ntp_offset = self.props["ntp-offset"]
        if ntp_offset < 0:
            raise ValueError("rtponviftimestamp: no ntp-offset")
        if pts_ns >= 0:
            data[0:8] = to_ntp(pts_ns + ntp_offset) \
                .to_bytes(8, "big")
        flags = 0
        if keyframe:
            flags |= 1 << 7
        if self._e_bit:
            flags |= 1 << 6
            self._e_bit = False
        if self._d_bit or discont:
            flags |= 1 << 5
            self._d_bit = False
        if self._t_bit:
            flags |= 1 << 4
            self._t_bit = False
        data[8] = flags
        data[9] = self.props["cseq"] & 0xFF
        pkt.extension = (EXTENSION_ID, bytes(data))
        return pkt

    def chain(self, data: bytes, pts_ns: int = -1,
              keyframe: bool = True,
              discont: bool = False) -> List[bytes]:
        """Returns the packets ready to push (with e/t bits enabled the
        element runs one buffer behind, gstrtponviftimestamp.c:606-625)."""
        item = dict(pkt=RtpPacket.parse(data), pts=pts_ns,
                    keyframe=keyframe, discont=discont)
        if not self.props["set-e-bit"] and not self.props["set-t-bit"]:
            return [self._emit(item)]
        out = []
        if self._held is not None:
            out.append(self._emit(self._held))
        self._held = item
        return out

    def _emit(self, item: Dict) -> bytes:
        pkt = self._stamp(item["pkt"], item["pts"], item["keyframe"],
                          item["discont"])
        return pkt.serialize()

    def event_eos(self) -> List[bytes]:
        """EOS flushes the held buffer with E (and T when set-t-bit)."""
        out = []
        if self._held is not None:
            if self.props["set-e-bit"]:
                self._e_bit = True
            if self.props["set-t-bit"]:
                self._t_bit = True
            out.append(self._emit(self._held))
            self._held = None
        return out

    def event_segment(self) -> List[bytes]:
        """A new segment ends the contiguous section: flush the held
        buffer with E, next buffer carries D."""
        out = []
        if self._held is not None:
            if self.props["set-e-bit"]:
                self._e_bit = True
            out.append(self._emit(self._held))
            self._held = None
        self._d_bit = True
        return out

    def process(self, params, state, batch):
        return state, batch


@register
class RtpOnvifParse(Element):
    NAME = "rtponvifparse"
    KIND = "host-source"
    PROPERTIES = ()

    def chain(self, data: bytes) -> Dict:
        """-> {data, pts, keyframe, discont, eos}
        (gstrtponvifparse.c:71-157)."""
        pkt = RtpPacket.parse(data)
        out = dict(data=data, pts=None, keyframe=None, discont=None,
                   eos=False)
        if pkt.extension is None:
            return out
        ext_id, ext = pkt.extension
        if ext_id != EXTENSION_ID or len(ext) != 4 * EXTENSION_SIZE:
            return out
        seconds = int.from_bytes(ext[0:4], "big")
        fraction = int.from_bytes(ext[4:8], "big")
        if seconds == 0xFFFFFFFF and fraction == 0xFFFFFFFF:
            out["pts"] = None
        else:
            out["pts"] = from_ntp_parts(seconds, fraction)
        flags = ext[8]
        out["keyframe"] = bool(flags & (1 << 7))
        out["discont"] = bool(flags & (1 << 5))
        out["eos"] = bool(flags & (1 << 4))
        return out

    def process(self, params, state, batch):
        return state, batch
