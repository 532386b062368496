"""mpegtsmux / tsdemux / tsparse elements (gst/mpegtsmux,
gst/mpegtsdemux) over the io/mpegts.py from-spec TS layer.

mpegtsmux (gstbasetsmux.c + gstmpegtsmux.c): request a stream per
input (`connect`), push timestamped buffers, collect 188-byte TS
output.  Timestamps convert with the reference's
GSTTIME_TO_MPEGTIME = ns * 9 / 100000 (gstbasetsmux.c macro);
properties carry the tsmux defaults (pat/pmt interval 9000, pcr 3600 in
90 kHz ticks, tsmuxcommon.h:103-109).

tsdemux (tsdemux.c): push TS bytes, pull per-PES packets with
MPEGTIME_TO_GSTTIME timestamps, stream-type map and PCR observation.

tsparse (mpegtsparse.c): validated 188-byte passthrough with PSI
observation (programs/streams exposed) and continuity accounting.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from gstbad.core.element import Element, Property
from gstbad.core.registry import register
from gstbad.io import mpegts as ts_io


def ns_to_90k(ns: int) -> int:
    """GSTTIME_TO_MPEGTIME (gstbasetsmux.c)."""
    return ns * 9 // 100000


def k90_to_ns(t: int) -> int:
    """MPEGTIME_TO_GSTTIME."""
    return t * 100000 // 9


@register
class MpegTsMux(Element):
    NAME = "mpegtsmux"
    KIND = "host-source"
    PROPERTIES = (
        Property("pat-interval", int, ts_io.DEFAULT_PAT_INTERVAL,
                 1, None, static=True),
        Property("pmt-interval", int, ts_io.DEFAULT_PMT_INTERVAL,
                 1, None, static=True),
        Property("pcr-interval", int, ts_io.DEFAULT_PCR_INTERVAL,
                 1, None, static=True),
        Property("m2ts-mode", bool, False, static=True,
                 doc="192-byte packets with the 4-byte 30-bit PCR "
                     "arrival prefix (gstmpegtsmux.c:150-230)"),
    )

    #: caps-name -> TS stream type (the gstmpegtsmux.c sink template /
    #: create_new_stream walk)
    CAPS_TYPES = {
        "video/mpeg1": ts_io.ST_VIDEO_MPEG1,
        "video/mpeg2": ts_io.ST_VIDEO_MPEG2,
        "video/mpeg4": ts_io.ST_VIDEO_MPEG4,
        "video/x-h264": ts_io.ST_VIDEO_H264,
        "video/x-h265": ts_io.ST_VIDEO_HEVC,
        "audio/mpeg1": ts_io.ST_AUDIO_MPEG1,
        "audio/mpeg2": ts_io.ST_AUDIO_MPEG2,
        "audio/mpeg": ts_io.ST_AUDIO_MPEG1,
        "audio/aac": ts_io.ST_AUDIO_AAC,
        "audio/x-ac3": ts_io.ST_PS_AUDIO_AC3,
        "audio/x-dts": ts_io.ST_PS_AUDIO_DTS,
        "meta/x-klv": ts_io.ST_PS_KLV,
        "private": ts_io.ST_PRIVATE_DATA,
    }

    def __init__(self, **props):
        super().__init__(**props)
        self._mux = ts_io.TsMux(
            pat_interval=self.props["pat-interval"],
            pmt_interval=self.props["pmt-interval"],
            pcr_interval=self.props["pcr-interval"])
        self.packets_out = 0

    def connect(self, caps_or_type, pid: int = -1,
                language: str = "") -> ts_io.TsMuxStream:
        """Request-pad analog: returns the stream handle."""
        if isinstance(caps_or_type, str):
            stream_type = self.CAPS_TYPES.get(caps_or_type)
            if stream_type is None:
                raise ValueError(f"mpegtsmux: unknown caps "
                                 f"{caps_or_type}")
        else:
            stream_type = int(caps_or_type)
        return self._mux.add_stream(stream_type, pid, language)

    def chain(self, stream: ts_io.TsMuxStream, data: bytes,
              pts_ns: int = -1, dts_ns: int = -1,
              random_access: bool = False) -> bytes:
        """One buffer in, its TS packets out (bytes, multiple of 188)."""
        pts = ns_to_90k(pts_ns) if pts_ns >= 0 else ts_io.NO_TS
        dts = ns_to_90k(dts_ns) if dts_ns >= 0 else ts_io.NO_TS
        pkts = self._mux.add_data(stream, data, pts, dts, random_access)
        self.packets_out += len(pkts)
        if self.props["m2ts-mode"]:
            # arrival timestamp = bottom 30 bits of the 27 MHz clock
            # (the reference interpolates between PCRs; our mux knows
            # the buffer clock directly)
            t27 = (pts * 300) & 0x3FFFFFFF if pts != ts_io.NO_TS else 0
            return b"".join(
                t27.to_bytes(4, "big") + p for p in pkts)
        return b"".join(pkts)

    def process(self, params, state, batch):
        return state, batch


@register
class TsDemuxElement(Element):
    NAME = "tsdemux"
    KIND = "host-source"
    PROPERTIES = ()

    def __init__(self, **props):
        super().__init__(**props)
        self._dmx = ts_io.TsDemux()

    def push_bytes(self, data: bytes) -> List[Dict]:
        return [self._out(p) for p in self._dmx.push(data)]

    def event_eos(self) -> List[Dict]:
        return [self._out(p) for p in self._dmx.eos()]

    def _out(self, p: ts_io.TsPacketOut) -> Dict:
        return dict(
            pid=p.pid, stream_type=p.stream_type, data=p.data,
            pts=(k90_to_ns(p.pts) if p.pts != ts_io.NO_TS else None),
            dts=(k90_to_ns(p.dts) if p.dts != ts_io.NO_TS else None),
            random_access=p.random_access)

    @property
    def streams(self) -> Dict[int, int]:
        return dict(self._dmx.streams)

    @property
    def pcr_pid(self) -> int:
        return self._dmx.pcr_pid

    @property
    def continuity_errors(self) -> int:
        return self._dmx.continuity_errors

    @property
    def si_sections(self):
        """Typed PSI/SI sections seen so far (the tsdemux
        section-message posting analog): io/mpegts_si.Section objects
        with get_pat/get_pmt/get_cat/get_nit/get_sdt/get_bat/get_eit/
        get_tdt/get_tot/get_atsc_* accessors."""
        return list(self._dmx.si_sections)

    def process(self, params, state, batch):
        return state, batch


@register
class TsParse(Element):
    NAME = "tsparse"
    KIND = "host-source"
    PROPERTIES = ()

    def __init__(self, **props):
        super().__init__(**props)
        self._dmx = ts_io.TsDemux()
        self._tail = b""

    def chain(self, data: bytes) -> bytes:
        """Aligned passthrough: emits whole validated 188-byte packets
        (mpegtsparse.c repackaging) while observing PSI."""
        self._dmx.push(data)
        buf = self._tail + data
        n = len(buf) // ts_io.PACKET_LENGTH
        out = buf[:n * ts_io.PACKET_LENGTH]
        self._tail = buf[n * ts_io.PACKET_LENGTH:]
        return out

    @property
    def programs(self) -> Dict[int, int]:
        return dict(self._dmx.pat)

    @property
    def streams(self) -> Dict[int, int]:
        return dict(self._dmx.streams)

    def process(self, params, state, batch):
        return state, batch


from gstbad.io import mpegps as ps_io


@register
class MpegPsMux(Element):
    """mpegpsmux (gst/mpegpsmux/mpegpsmux.c) over io/mpegps.py: pack/
    system/PSM cadence and stream-id allocation per the psmux library;
    finish() emits the 0x000001B9 program end code."""

    NAME = "mpegpsmux"
    KIND = "host-source"
    PROPERTIES = ()

    CAPS_TYPES = {
        "video/mpeg1": ps_io.ST_VIDEO_MPEG1,
        "video/mpeg2": ps_io.ST_VIDEO_MPEG2,
        "video/x-h264": ps_io.ST_VIDEO_H264,
        "audio/mpeg1": ps_io.ST_AUDIO_MPEG1,
        "audio/mpeg2": ps_io.ST_AUDIO_MPEG2,
        "audio/mpeg": ps_io.ST_AUDIO_MPEG1,
        "audio/aac": ps_io.ST_AUDIO_AAC,
        "private": ps_io.ST_PRIVATE_DATA,
    }

    def __init__(self, **props):
        super().__init__(**props)
        self._mux = ps_io.PsMux()

    def connect(self, caps_or_type) -> ps_io.PsMuxStream:
        if isinstance(caps_or_type, str):
            stream_type = self.CAPS_TYPES.get(caps_or_type)
            if stream_type is None:
                raise ValueError(f"mpegpsmux: unknown caps "
                                 f"{caps_or_type}")
        else:
            stream_type = int(caps_or_type)
        return self._mux.add_stream(stream_type)

    def chain(self, stream: ps_io.PsMuxStream, data: bytes,
              pts_ns: int = -1, dts_ns: int = -1) -> bytes:
        pts = ns_to_90k(pts_ns) if pts_ns >= 0 else ps_io.NO_TS
        dts = ns_to_90k(dts_ns) if dts_ns >= 0 else ps_io.NO_TS
        return self._mux.add_data(stream, data, pts, dts)

    def event_eos(self) -> bytes:
        return self._mux.finish()

    def process(self, params, state, batch):
        return state, batch


@register
class MpegPsDemux(Element):
    """mpegpsdemux (gst/mpegdemux/gstmpegdemux.c) over io/mpegps.py."""

    NAME = "mpegpsdemux"
    KIND = "host-source"
    PROPERTIES = ()

    def __init__(self, **props):
        super().__init__(**props)
        self._dmx = ps_io.PsDemux()

    def push_bytes(self, data: bytes) -> List[Dict]:
        return [dict(stream_id=p.stream_id, stream_type=p.stream_type,
                     data=p.data,
                     pts=(k90_to_ns(p.pts) if p.pts != ps_io.NO_TS
                          else None),
                     dts=(k90_to_ns(p.dts) if p.dts != ps_io.NO_TS
                          else None))
                for p in self._dmx.push(data)]

    @property
    def stream_types(self) -> Dict[int, int]:
        return dict(self._dmx.stream_types)

    @property
    def saw_end(self) -> bool:
        return self._dmx.saw_end

    def process(self, params, state, batch):
        return state, batch
