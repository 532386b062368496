"""MPEG transport stream mux/demux (gst/mpegtsmux, gst/mpegtsdemux).

From-spec (ISO 13818-1) implementation transcribing the reference's
tsmux library semantics:

  - 188-byte packets, sync 0x47 (tsmuxcommon.h:72-75); PIDs allocated
    from TSMUX_START_PMT_PID 0x20 / TSMUX_START_ES_PID 0x40, program
    numbers from 1, transport id 1 (tsmux.h:80-82, tsmux.c:86).
  - PES: start code 00 00 01 + stream id (0xE0 video / 0xC0 audio /
    0xBD private / 0xFD + extended id for AC3/DTS/LPCM,
    tsmuxstream.c:120-210), flags 0x81, PTS(0x3)/DTS(0x1) 33-bit
    encodings, bounded packet length when it fits 16 bits else 0
    (unbounded, video only) - tsmux_stream_write_pes_header
    (tsmuxstream.c:621-693).
  - PSI: PAT (table 0) and PMT (table 2) with pointer field, section
    syntax, version/current_next, CRC32-MPEG2 (poly 0x04C11DB7, init
    ~0, no final xor); default repeat intervals PAT/PMT 9000 and PCR
    3600 against the 90 kHz clock (tsmuxcommon.h:103-109).
  - PCR in the adaptation field as 33-bit base * 300 + 9-bit extension
    on the program's PCR pid; adaptation stuffing (0xFF) pads short
    payloads; the random-access flag sets the adaptation
    random_access_indicator (tsmuxcommon.h:87-89).

The demux side mirrors gst/mpegtsdemux's packetizer/tsdemux essentials:
0x47 resync with 188-byte confirmation, continuity-counter tracking,
PSI section assembly across packets, PAT/PMT table walks, PES
reassembly (bounded by length or flushed at the next payload unit
start / EOS), PTS/DTS extraction and PCR observation.

Round-trip is validated in tests against libavformat (native tsoracle
shim) in both directions.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

SYNC_BYTE = 0x47
PACKET_LENGTH = 188
M2TS_PACKET_LENGTH = 192  # 4-byte arrival timestamp + 188 (gstmpegtsmux.c:85)
HEADER_LENGTH = 4
PAYLOAD_LENGTH = PACKET_LENGTH - HEADER_LENGTH

CLOCK_FREQ = 90000  # TSMUX_CLOCK_FREQ (27 MHz / 300)
# fixed SI pids routed through section assembly (EN 300 468 table 2 +
# ATSC A/65 base pid): CAT, NIT, SDT/BAT, EIT, TDT/TOT, ATSC base
SI_PIDS = frozenset({0x0000, 0x0001, 0x0010, 0x0011, 0x0012, 0x0014,
                     0x1FFB})

DEFAULT_PAT_INTERVAL = CLOCK_FREQ // 10
DEFAULT_PMT_INTERVAL = CLOCK_FREQ // 10
DEFAULT_PCR_INTERVAL = CLOCK_FREQ // 25
DEFAULT_TS_ID = 0x0001

START_PROGRAM_ID = 0x0001
START_PMT_PID = 0x0020
START_ES_PID = 0x0040
PID_NULL = 0x1FFF

# tsmuxstream.h stream types
ST_VIDEO_MPEG1 = 0x01
ST_VIDEO_MPEG2 = 0x02
ST_AUDIO_MPEG1 = 0x03
ST_AUDIO_MPEG2 = 0x04
ST_PRIVATE_SECTIONS = 0x05
ST_PRIVATE_DATA = 0x06
ST_AUDIO_AAC = 0x0F
ST_VIDEO_MPEG4 = 0x10
ST_VIDEO_H264 = 0x1B
ST_VIDEO_JP2K = 0x21
ST_VIDEO_HEVC = 0x24
ST_PS_AUDIO_AC3 = 0x81
ST_PS_AUDIO_DTS = 0x8A
ST_PS_AUDIO_LPCM = 0x8B
ST_PS_KLV = 0x8E
ST_PS_OPUS = 0x8F

_VIDEO_TYPES = (ST_VIDEO_MPEG1, ST_VIDEO_MPEG2, ST_VIDEO_MPEG4,
                ST_VIDEO_H264, ST_VIDEO_HEVC)
_AUDIO_TYPES = (ST_AUDIO_MPEG1, ST_AUDIO_MPEG2, ST_AUDIO_AAC)

NO_TS = -(1 << 62)  # GST_CLOCK_STIME_NONE analog


class TsError(ValueError):
    pass


def crc32_mpeg(data: bytes) -> int:
    """CRC32-MPEG2: poly 0x04C11DB7 MSB-first, init 0xFFFFFFFF, no
    final inversion (what gst_mpegts_section CRCs use)."""
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7) if crc & 0x80000000 \
                else (crc << 1)
            crc &= 0xFFFFFFFF
    return crc


def _put_ts(marker: int, ts: int) -> bytes:
    """The 5-byte 33-bit PES timestamp encoding (tsmux_put_ts)."""
    ts &= (1 << 33) - 1
    return bytes([
        (marker << 4) | ((ts >> 29) & 0x0E) | 1,
        (ts >> 22) & 0xFF,
        ((ts >> 14) & 0xFE) | 1,
        (ts >> 7) & 0xFF,
        ((ts << 1) & 0xFE) | 1,
    ])


def _get_ts(data: bytes) -> int:
    return (((data[0] >> 1) & 0x07) << 30 | data[1] << 22
            | (data[2] >> 1) << 15 | data[3] << 7 | data[4] >> 1)


@dataclass
class TsMuxStream:
    """tsmuxstream.c:98-215 stream setup."""

    pid: int
    stream_type: int
    language: str = ""

    def __post_init__(self):
        self.is_video = self.stream_type in _VIDEO_TYPES \
            or self.stream_type == ST_VIDEO_JP2K
        self.is_audio = self.stream_type in _AUDIO_TYPES \
            or self.stream_type in (ST_PS_AUDIO_AC3, ST_PS_AUDIO_DTS,
                                    ST_PS_AUDIO_LPCM)
        self.id_extended = 0
        if self.stream_type in _VIDEO_TYPES:
            self.id = 0xE0
        elif self.stream_type in _AUDIO_TYPES:
            self.id = 0xC0
        elif self.stream_type == ST_PS_AUDIO_AC3:
            self.id, self.id_extended = 0xFD, 0x71
        elif self.stream_type == ST_PS_AUDIO_DTS:
            self.id, self.id_extended = 0xFD, 0x82
        elif self.stream_type == ST_PS_AUDIO_LPCM:
            self.id, self.id_extended = 0xFD, 0x80
        else:
            self.id = 0xBD  # private data (incl. JP2K, KLV, opus)
        self.cc = 0

    def next_cc(self) -> int:
        cc = self.cc
        self.cc = (cc + 1) & 0x0F
        return cc

    def pes_header(self, payload_size: int, pts: int, dts: int) -> bytes:
        """tsmux_stream_write_pes_header (tsmuxstream.c:621-693)."""
        write_pts = pts != NO_TS
        write_dts = write_pts and dts != NO_TS and dts != pts
        opt = bytearray()
        flags2 = 0
        if write_pts and write_dts:
            flags2 |= 0xC0
            opt += _put_ts(0x3, pts) + _put_ts(0x1, dts)
        elif write_pts:
            flags2 |= 0x80
            opt += _put_ts(0x2, pts)
        if self.id_extended:
            flags2 |= 0x01
            opt += bytes([0x0F, 0x81, self.id_extended])
        hdr_len = 9 + len(opt)
        total = hdr_len + payload_size - 6
        if total > 0xFFFF:
            total = 0  # unbounded, video only
            if not self.is_video:
                raise TsError("PES too large for a bounded non-video "
                              "stream")
        return (b"\x00\x00\x01" + bytes([self.id])
                + struct.pack(">H", total)
                + bytes([0x81, flags2, hdr_len - 9]) + bytes(opt))


class TsMux:
    """tsmux.c: PAT/PMT/PCR cadence + packetization.

    add_stream() -> TsMuxStream; add_data(stream, bytes, pts, dts,
    random_access) emits the TS packets for one PES (the gstbasetsmux
    one-buffer-one-PES aggregation)."""

    def __init__(self, pat_interval: int = DEFAULT_PAT_INTERVAL,
                 pmt_interval: int = DEFAULT_PMT_INTERVAL,
                 pcr_interval: int = DEFAULT_PCR_INTERVAL,
                 transport_id: int = DEFAULT_TS_ID):
        self.pat_interval = pat_interval
        self.pmt_interval = pmt_interval
        self.pcr_interval = pcr_interval
        self.transport_id = transport_id
        self.program_number = START_PROGRAM_ID
        self.pmt_pid = START_PMT_PID
        self.next_es_pid = START_ES_PID
        self.streams: List[TsMuxStream] = []
        self.pcr_stream: Optional[TsMuxStream] = None
        self._pat_cc = 0
        self._pmt_cc = 0
        self._si_cc: Dict[int, int] = {}
        self._last_pat_ts = None
        self._last_pmt_ts = None
        self._last_pcr = None
        self._pat_version = 0
        self._pmt_version = 0

    def add_stream(self, stream_type: int, pid: int = -1,
                   language: str = "") -> TsMuxStream:
        if pid < 0:
            pid = self.next_es_pid
            self.next_es_pid += 1
        st = TsMuxStream(pid, stream_type, language)
        self.streams.append(st)
        if self.pcr_stream is None or (st.is_video
                                       and not self.pcr_stream.is_video):
            self.pcr_stream = st
        return st

    # -- PSI sections ------------------------------------------------------

    def _section(self, table_id: int, table_id_ext: int, version: int,
                 body: bytes) -> bytes:
        sec = bytearray()
        sec.append(table_id)
        length = len(body) + 5 + 4  # after length field, incl. CRC
        sec += struct.pack(">H", 0xB000 | length)
        sec += struct.pack(">H", table_id_ext)
        sec.append(0xC1 | ((version & 0x1F) << 1))  # current_next=1
        sec += b"\x00\x00"  # section_number, last_section_number
        sec += body
        sec += struct.pack(">I", crc32_mpeg(bytes(sec)))
        return bytes(sec)

    def _pat_section(self) -> bytes:
        body = struct.pack(">HH", self.program_number,
                           0xE000 | self.pmt_pid)
        return self._section(0x00, self.transport_id, self._pat_version,
                             body)

    def _pmt_section(self) -> bytes:
        body = bytearray()
        pcr_pid = self.pcr_stream.pid if self.pcr_stream else PID_NULL
        body += struct.pack(">H", 0xE000 | pcr_pid)
        body += struct.pack(">H", 0xF000)  # program_info_length 0
        for st in self.streams:
            es_info = b""
            if st.is_audio and st.language:
                lang = st.language.encode()[:3].ljust(3, b" ")
                es_info = bytes([0x0A, 4]) + lang + b"\x00"
            body.append(st.stream_type)
            body += struct.pack(">H", 0xE000 | st.pid)
            body += struct.pack(">H", 0xF000 | len(es_info))
            body += es_info
        return self._section(0x02, self.program_number,
                             self._pmt_version, bytes(body))

    def _psi_packet(self, pid: int, section: bytes, cc: int) -> bytes:
        pkt = bytearray()
        pkt.append(SYNC_BYTE)
        pkt += struct.pack(">H", 0x4000 | pid)  # PUSI set
        pkt.append(0x10 | cc)  # payload only
        pkt.append(0x00)  # pointer_field
        pkt += section
        if len(pkt) > PACKET_LENGTH:
            raise TsError("PSI section does not fit one packet")
        pkt += b"\xFF" * (PACKET_LENGTH - len(pkt))
        return bytes(pkt)

    def psi_packets(self, pid: int, section: bytes) -> List[bytes]:
        """Packetize an arbitrary SI section (EIT/BAT/TOT/VCT/...) onto
        `pid`, spanning multiple TS packets when the section exceeds one
        payload (tsmux_section_write_packet's spanning walk).  Keeps a
        per-pid continuity counter."""
        cc = self._si_cc.get(pid, 0)
        out = []
        pos = 0
        first = True
        while pos < len(section) or first:
            pkt = bytearray()
            pkt.append(SYNC_BYTE)
            pkt += struct.pack(">H", (0x4000 if first else 0) | pid)
            pkt.append(0x10 | cc)
            cc = (cc + 1) & 0x0F
            if first:
                pkt.append(0x00)  # pointer_field
                first = False
            room = PACKET_LENGTH - len(pkt)
            pkt += section[pos:pos + room]
            pos += room
            pkt += b"\xFF" * (PACKET_LENGTH - len(pkt))
            out.append(bytes(pkt))
        self._si_cc[pid] = cc
        return out

    def _maybe_psi(self, ts90k: int) -> List[bytes]:
        out = []
        if (self._last_pat_ts is None
                or ts90k - self._last_pat_ts >= self.pat_interval):
            out.append(self._psi_packet(0x0000, self._pat_section(),
                                        self._pat_cc))
            self._pat_cc = (self._pat_cc + 1) & 0x0F
            self._last_pat_ts = ts90k
        if (self._last_pmt_ts is None
                or ts90k - self._last_pmt_ts >= self.pmt_interval):
            out.append(self._psi_packet(self.pmt_pid,
                                        self._pmt_section(),
                                        self._pmt_cc))
            self._pmt_cc = (self._pmt_cc + 1) & 0x0F
            self._last_pmt_ts = ts90k
        return out

    # -- data --------------------------------------------------------------

    def _ts_packet(self, st: TsMuxStream, payload: bytes, pusi: bool,
                   pcr: Optional[int], random_access: bool) -> bytes:
        """One 188-byte packet; adaptation carries PCR/flags/stuffing."""
        need_af = (pcr is not None or random_access
                   or len(payload) < PAYLOAD_LENGTH)
        pkt = bytearray()
        pkt.append(SYNC_BYTE)
        pkt += struct.pack(">H", (0x4000 if pusi else 0) | st.pid)
        pkt.append((0x30 if need_af else 0x10) | st.next_cc())
        if need_af:
            af = bytearray()
            flags = 0
            if random_access:
                flags |= 0x40
            if pcr is not None:
                flags |= 0x10
                base, ext = divmod(pcr, 300)
                base &= (1 << 33) - 1
                # 48-bit field: 33-bit base, 6 reserved bits, 9-bit ext
                af += ((base << 15) | (0x3F << 9) | ext) \
                    .to_bytes(6, "big")
            af.insert(0, flags)
            stuffing = PAYLOAD_LENGTH - 1 - len(af) - len(payload)
            if stuffing < 0:
                raise TsError("payload too large for packet")
            pkt.append(len(af) + stuffing)
            pkt += af
            pkt += b"\xFF" * stuffing
        pkt += payload
        assert len(pkt) == PACKET_LENGTH, len(pkt)
        return bytes(pkt)

    def add_data(self, st: TsMuxStream, data: bytes,
                 pts: int = NO_TS, dts: int = NO_TS,
                 random_access: bool = False) -> List[bytes]:
        """One input buffer -> PSI (if due) + one PES -> TS packets."""
        ref = pts if pts != NO_TS else (
            self._last_pat_ts if self._last_pat_ts is not None else 0)
        out = self._maybe_psi(ref)
        pes = st.pes_header(len(data), pts, dts) + data
        first = True
        pos = 0
        while pos < len(pes) or first:
            pcr = None
            if st is self.pcr_stream and first:
                t = pts if pts != NO_TS else 0
                if (self._last_pcr is None
                        or t - self._last_pcr >= self.pcr_interval):
                    pcr = t * 300
                    self._last_pcr = t
            chunk = pes[pos:pos + PAYLOAD_LENGTH]
            # a PCR/flagged first packet has less payload room
            if pcr is not None or (first and random_access):
                room = PAYLOAD_LENGTH - 1 - 1 \
                    - (6 if pcr is not None else 0)
                chunk = pes[pos:pos + room]
            out.append(self._ts_packet(st, chunk, first, pcr,
                                       random_access and first))
            pos += len(chunk)
            first = False
        return out


# ----------------------------------------------------------------------
# Demux

@dataclass
class TsPacketOut:
    pid: int
    stream_type: int
    data: bytes
    pts: int = NO_TS
    dts: int = NO_TS
    random_access: bool = False


@dataclass
class _PesState:
    stream_type: int
    buf: bytearray = field(default_factory=bytearray)
    need: int = -1          # bounded PES length (incl. header) or -1
    pts: int = NO_TS
    dts: int = NO_TS
    random_access: bool = False
    cc: int = -1


class TsDemux:
    """mpegtspacketizer.c + tsdemux.c essentials: resync, PSI
    assembly, PAT/PMT walk, PES reassembly.  M2TS (192-byte packets
    with a 4-byte arrival-timestamp prefix) is auto-detected like the
    packetizer's size probe."""

    def __init__(self):
        self.packet_size = None  # 188 or 192, sniffed
        self._buf = b""
        self.pat: Dict[int, int] = {}       # program_number -> PMT pid
        self.pmt_pids: Dict[int, int] = {}  # pid -> program_number
        self.streams: Dict[int, int] = {}   # pid -> stream_type
        self.pcr_pid = -1
        self.last_pcr = None
        self._psi_buf: Dict[int, bytearray] = {}
        self._pes: Dict[int, _PesState] = {}
        self.continuity_errors = 0
        # typed PSI/SI sections in arrival order (the tsdemux
        # section-message analog); io/mpegts_si.Section objects
        self.si_sections: list = []

    def _sniff_size(self) -> None:
        """Detect 188 vs 192 (m2ts: sync at offset 4 with 192
        spacing)."""
        b = self._buf
        if len(b) >= 4 + 193 and b[4] == SYNC_BYTE \
                and b[196] == SYNC_BYTE \
                and (len(b) < 389 or b[388] == SYNC_BYTE):
            self.packet_size = M2TS_PACKET_LENGTH
        elif len(b) >= 189 and b[0] == SYNC_BYTE \
                and b[188] == SYNC_BYTE:
            self.packet_size = PACKET_LENGTH

    def push(self, data: bytes) -> List[TsPacketOut]:
        self._buf += data
        out: List[TsPacketOut] = []
        if self.packet_size is None:
            self._sniff_size()
            if self.packet_size is None and len(self._buf) < 4 + 193:
                return out
            if self.packet_size is None:
                self.packet_size = PACKET_LENGTH
        psize = self.packet_size
        prefix = psize - PACKET_LENGTH
        while True:
            idx = self._buf.find(bytes([SYNC_BYTE]))
            if idx < 0:
                self._buf = b""
                break
            if idx > prefix:
                self._buf = self._buf[idx - prefix:]
            if len(self._buf) < psize:
                break
            # confirm sync spacing when more data is available
            if (len(self._buf) > psize
                    and self._buf[psize + prefix] != SYNC_BYTE):
                nxt = self._buf.find(bytes([SYNC_BYTE]), prefix + 1)
                if nxt < 0:
                    self._buf = b""
                    break
                self._buf = self._buf[nxt - prefix:]
                continue
            pkt = self._buf[prefix:psize]
            self._buf = self._buf[psize:]
            out.extend(self._packet(pkt))
        return out

    def eos(self) -> List[TsPacketOut]:
        """Flush unbounded PES payloads (tsdemux drains at EOS)."""
        out = []
        for pid, pes in self._pes.items():
            if pes.buf:
                done = self._finish_pes(pid, pes)
                if done:
                    out.append(done)
        return out

    # -- internals ---------------------------------------------------------

    def _packet(self, pkt: bytes) -> List[TsPacketOut]:
        pid = struct.unpack_from(">H", pkt, 1)[0] & 0x1FFF
        if pid == PID_NULL:
            return []
        if pkt[1] & 0x80:  # transport_error_indicator
            return []
        pusi = bool(pkt[1] & 0x40)
        afc = (pkt[3] >> 4) & 0x3
        cc = pkt[3] & 0x0F
        pos = 4
        random_access = False
        if afc & 0x2:
            af_len = pkt[4]
            pos = 5 + af_len
            if af_len > 0:
                flags = pkt[5]
                random_access = bool(flags & 0x40)
                if flags & 0x10 and af_len >= 7:
                    v = int.from_bytes(pkt[6:12], "big")
                    base = v >> 15
                    ext = v & 0x1FF
                    if pid == self.pcr_pid:
                        self.last_pcr = base * 300 + ext
        if not afc & 0x1 or pos >= PACKET_LENGTH:
            return []
        payload = pkt[pos:]

        if pid == 0x0000 or pid in self.pmt_pids or pid in SI_PIDS:
            self._psi(pid, pusi, payload)
            return []
        if pid in self.streams:
            return self._pes_payload(pid, pusi, cc, payload,
                                     random_access)
        return []

    def _psi(self, pid: int, pusi: bool, payload: bytes) -> None:
        if pusi:
            pointer = payload[0]
            section = payload[1 + pointer:]
            self._psi_buf[pid] = bytearray(section)
        elif pid in self._psi_buf:
            self._psi_buf[pid] += payload
        else:
            return
        buf = self._psi_buf[pid]
        while len(buf) >= 3 and buf[0] != 0xFF:
            length = (struct.unpack_from(">H", buf, 1)[0] & 0x0FFF) + 3
            if len(buf) < length:
                return
            self._section(pid, bytes(buf[:length]))
            del buf[:length]

    def _section(self, pid: int, sec: bytes) -> None:
        # long sections are CRC-checked and dropped when corrupt; short
        # sections are not (the reference checks CRCs only behind the
        # syntax indicator, gstmpegtssection.c:181-187 — TDT carries no
        # CRC at all)
        if (sec[1] & 0x80) and crc32_mpeg(sec) != 0:
            return  # bad CRC: drop (packetizer does the same)
        # tsdemux section posting: wrap + collect every PSI/SI section
        # (PAT/PMT/CAT/NIT/SDT/BAT/EIT/TDT/TOT/ATSC) as a typed Section
        from gstbad.io import mpegts_si
        try:
            self.si_sections.append(mpegts_si.section_new(pid, sec))
        except mpegts_si.SiError:
            pass
        if pid in SI_PIDS and pid != 0x0000:
            return
        table_id = sec[0]
        body = sec[8:-4]
        if table_id == 0x00 and pid == 0x0000:
            for off in range(0, len(body) - 3, 4):
                prog, pmt = struct.unpack_from(">HH", body, off)
                pmt &= 0x1FFF
                if prog != 0:
                    self.pat[prog] = pmt
                    self.pmt_pids[pmt] = prog
        elif table_id == 0x02 and pid in self.pmt_pids:
            self.pcr_pid = struct.unpack_from(">H", body, 0)[0] & 0x1FFF
            info_len = struct.unpack_from(">H", body, 2)[0] & 0x0FFF
            off = 4 + info_len
            while off + 5 <= len(body):
                stype = body[off]
                es_pid = struct.unpack_from(">H", body, off + 1)[0] \
                    & 0x1FFF
                es_len = struct.unpack_from(">H", body, off + 3)[0] \
                    & 0x0FFF
                self.streams[es_pid] = stype
                self._pes.setdefault(es_pid, _PesState(stype))
                self._pes[es_pid].stream_type = stype
                off += 5 + es_len

    def _pes_payload(self, pid: int, pusi: bool, cc: int,
                     payload: bytes,
                     random_access: bool) -> List[TsPacketOut]:
        pes = self._pes[pid]
        out = []
        if pes.cc >= 0 and cc != (pes.cc + 1) & 0x0F:
            self.continuity_errors += 1
            pes.buf.clear()
            pes.need = -1
        pes.cc = cc
        if pusi:
            if pes.buf:
                done = self._finish_pes(pid, pes)
                if done:
                    out.append(done)
            pes.buf = bytearray(payload)
            pes.random_access = random_access
        elif pes.buf is not None:
            pes.buf += payload
        if pes.buf[:3] == b"\x00\x00\x01" and len(pes.buf) >= 6:
            length = struct.unpack_from(">H", pes.buf, 4)[0]
            pes.need = 6 + length if length else -1
        if pes.need > 0 and len(pes.buf) >= pes.need:
            done = self._finish_pes(pid, pes, pes.need)
            if done:
                out.append(done)
        return out

    def _finish_pes(self, pid: int, pes: _PesState,
                    limit: int = -1) -> Optional[TsPacketOut]:
        buf = bytes(pes.buf if limit < 0 else pes.buf[:limit])
        rest = bytes(pes.buf[limit:]) if limit >= 0 else b""
        pes.buf = bytearray(rest)
        pes.need = -1
        if buf[:3] != b"\x00\x00\x01" or len(buf) < 9:
            return None
        flags2 = buf[7]
        hdr_len = buf[8]
        pos = 9
        pts = dts = NO_TS
        if flags2 & 0x80:
            pts = _get_ts(buf[pos:pos + 5])
            pos += 5
        if flags2 & 0x40:
            dts = _get_ts(buf[pos:pos + 5])
            pos += 5
        data = buf[9 + hdr_len:]
        ra, pes.random_access = pes.random_access, False
        return TsPacketOut(pid=pid, stream_type=pes.stream_type,
                           data=data, pts=pts, dts=dts,
                           random_access=ra)
