"""MPEG-TS PSI/SI section library (gst-libs/gst/mpegts/) — typed
section objects with parse + packetize, mirroring the GstMpegts API
surface the upstream unit test exercises (tests/check/libs/mpegts.c):

  - Section: the common long/short header
    (_packetize_common_section, gstmpegtssection.c:1124-1177 — note
    ISO tables OR 0x3000 into the length word while DVB tables OR
    0x7000, and the syntax bit is set for long sections);
  - PAT / PMT (ISO 13818-1), NIT / SDT (DVB), ATSC STT and the
    SCTE-35 splice information table, each with from_*/get_* pairs
    that survive a packetize -> re-parse round trip byte-exactly
    against the upstream test vectors;
  - get_* returns None on a bad CRC (the upstream corrupt-CRC
    assertions);
  - descriptors: registration (0x05), DVB network name (0x40) and DVB
    service (0x48) builders/parsers with the 255-byte caps, plus
    find_descriptor / parse_descriptors.
"""

from __future__ import annotations

import dataclasses
import datetime
import struct
from typing import List, Optional, Tuple

from gstbad.io.mpegts import crc32_mpeg

# table ids
TABLE_ID_PAT = 0x00
TABLE_ID_CAT = 0x01
TABLE_ID_PMT = 0x02
TABLE_ID_NIT_ACTUAL = 0x40
TABLE_ID_NIT_OTHER = 0x41
TABLE_ID_SDT_ACTUAL = 0x42
TABLE_ID_SDT_OTHER = 0x46
TABLE_ID_BAT = 0x4A
TABLE_ID_EIT_PF_ACTUAL = 0x4E           # present/following, actual TS
TABLE_ID_EIT_PF_OTHER = 0x4F
TABLE_ID_EIT_SCHEDULE_ACTUAL = 0x50     # 0x50..0x5F
TABLE_ID_EIT_SCHEDULE_OTHER = 0x60      # 0x60..0x6F
TABLE_ID_TDT = 0x70
TABLE_ID_TOT = 0x73
TABLE_ID_ATSC_MGT = 0xC7
TABLE_ID_ATSC_TVCT = 0xC8
TABLE_ID_ATSC_CVCT = 0xC9
TABLE_ID_ATSC_EIT = 0xCB
TABLE_ID_ATSC_STT = 0xCD
TABLE_ID_SCTE_SPLICE = 0xFC

_EIT_TABLE_IDS = frozenset(
    [TABLE_ID_EIT_PF_ACTUAL, TABLE_ID_EIT_PF_OTHER]
    + list(range(0x50, 0x70)))

# descriptor tags
DESC_REGISTRATION = 0x05
DESC_DVB_NETWORK_NAME = 0x40
DESC_DVB_SERVICE = 0x48

# DVB service types (gstmpegtsdescriptor.h)
DVB_SERVICE_DIGITAL_TELEVISION = 0x01

# running status (gstmpegtssection.h)
RUNNING_STATUS_UNDEFINED = 0
RUNNING_STATUS_NOT_RUNNING = 1
RUNNING_STATUS_STARTS_IN_FEW_SECONDS = 2
RUNNING_STATUS_PAUSING = 3
RUNNING_STATUS_RUNNING = 4
RUNNING_STATUS_OFF_AIR = 5

# SCTE splice commands (gstmpegtssection.h GstMpegtsSCTESpliceCommand)
SCTE_SPLICE_COMMAND_NULL = 0x00
SCTE_SPLICE_COMMAND_SCHEDULE = 0x04
SCTE_SPLICE_COMMAND_INSERT = 0x05
SCTE_SPLICE_COMMAND_TIME = 0x06
SCTE_SPLICE_COMMAND_BANDWIDTH = 0x07
SCTE_SPLICE_COMMAND_PRIVATE = 0xFF

# ISO 13818-1 tables write '001'+length, DVB tables write '011'+length
_ISO_TABLES = {TABLE_ID_PAT, TABLE_ID_PMT, TABLE_ID_SCTE_SPLICE}

_GPS_EPOCH = datetime.datetime(1980, 1, 6, tzinfo=datetime.timezone.utc)


class SiError(ValueError):
    pass


# ---------------------------------------------------------- descriptors

@dataclasses.dataclass
class Descriptor:
    """GstMpegtsDescriptor: tag + payload; data is the FULL descriptor
    bytes (tag, length, payload) like the C struct's data field."""
    tag: int
    length: int
    data: bytes

    @classmethod
    def build(cls, tag: int, payload: bytes) -> "Descriptor":
        return cls(tag=tag, length=len(payload),
                   data=bytes([tag, len(payload)]) + payload)


def descriptor_from_registration(fmt: str, extra: bytes = b""
                                 ) -> Descriptor:
    """gst_mpegts_descriptor_from_registration."""
    payload = fmt.encode("latin1")[:4] + extra
    return Descriptor.build(DESC_REGISTRATION, payload)


def descriptor_from_dvb_network_name(name: str
                                     ) -> Optional[Descriptor]:
    """0x40; NULL when the name exceeds 255 bytes (the upstream
    long-string check)."""
    encoded = name.encode()
    if len(encoded) > 255:
        return None
    return Descriptor.build(DESC_DVB_NETWORK_NAME, encoded)


def descriptor_parse_dvb_network_name(desc: Descriptor
                                      ) -> Optional[str]:
    if desc.tag != DESC_DVB_NETWORK_NAME:
        return None
    return desc.data[2:2 + desc.length].decode("latin1")


def descriptor_from_dvb_service(service_type: int,
                                name: Optional[str] = None,
                                provider: Optional[str] = None
                                ) -> Optional[Descriptor]:
    """0x48: type, provider_len+provider, name_len+name; NULL when
    either string exceeds 255 bytes."""
    name_b = (name or "").encode()
    prov_b = (provider or "").encode()
    if len(name_b) > 255 or len(prov_b) > 255:
        return None
    payload = bytes([service_type, len(prov_b)]) + prov_b \
        + bytes([len(name_b)]) + name_b
    return Descriptor.build(DESC_DVB_SERVICE, payload)


def descriptor_parse_dvb_service(desc: Descriptor
                                 ) -> Optional[Tuple[int, str, str]]:
    """(service_type, name, provider) or None."""
    if desc.tag != DESC_DVB_SERVICE or desc.length < 3:
        return None
    d = desc.data[2:]
    service_type = d[0]
    plen = d[1]
    provider = d[2:2 + plen].decode("latin1")
    nlen = d[2 + plen]
    name = d[3 + plen:3 + plen + nlen].decode("latin1")
    return service_type, name, provider


def parse_descriptors(data: bytes) -> Optional[List[Descriptor]]:
    out = []
    pos = 0
    while pos < len(data):
        if pos + 2 > len(data):
            return None
        tag, length = data[pos], data[pos + 1]
        if pos + 2 + length > len(data):
            return None
        out.append(Descriptor(tag, length,
                              data[pos:pos + 2 + length]))
        pos += 2 + length
    return out


def find_descriptor(descriptors: List[Descriptor], tag: int
                    ) -> Optional[Descriptor]:
    for d in descriptors:
        if d.tag == tag:
            return d
    return None


def _pack_descriptors(descriptors: List[Descriptor]) -> bytes:
    return b"".join(d.data for d in descriptors)


# -------------------------------------------------------------- section

@dataclasses.dataclass
class Section:
    """GstMpegtsSection."""
    pid: int = 0
    table_id: int = 0
    short_section: bool = False
    subtable_extension: int = 0
    version_number: int = 0
    current_next_indicator: bool = True
    section_number: int = 0
    last_section_number: int = 0
    data: bytes = b""
    # TDT is the one section with no CRC at all (EN 300 468 §5.2.5; the
    # reference only ever CRC-checks long sections and TDT is short,
    # gstmpegtssection.c:181-187).  SCTE-35 and TOT are short WITH a CRC.
    has_crc: bool = True
    _payload: object = None  # the typed table object, pre-packetize

    @property
    def section_length(self) -> int:
        return len(self.data)

    def _header(self, length: int) -> bytes:
        """_packetize_common_section
        (gstmpegtssection.c:1124-1177)."""
        out = bytearray()
        out.append(self.table_id)
        marker = 0x3000 if self.table_id in _ISO_TABLES else 0x7000
        word = (length - 3) | marker
        if not self.short_section:
            word |= 0x8000  # section_syntax_indicator
        out += struct.pack(">H", word)
        if self.short_section:
            return bytes(out)
        out += struct.pack(">H", self.subtable_extension)
        out.append(0xC0 | ((self.version_number & 0x1F) << 1)
                   | (1 if self.current_next_indicator else 0))
        out.append(self.section_number)
        out.append(self.last_section_number)
        return bytes(out)

    def packetize(self) -> bytes:
        """gst_mpegts_section_packetize: build data (cached)."""
        if self.data:
            return self.data
        body = self._payload_bytes()
        if not self.has_crc:
            length = (3 if self.short_section else 8) + len(body)
            self.data = self._header(length) + body
            return self.data
        length = (3 if self.short_section else 8) + len(body) + 4
        head = self._header(length)
        crc_input = head + body
        crc = crc32_mpeg(crc_input)
        self.data = crc_input + struct.pack(">I", crc)
        return self.data

    def _payload_bytes(self) -> bytes:
        builder = _PACKETIZERS.get(type(self._payload))
        if builder is None:
            raise SiError("no packetizer for this section")
        return builder(self._payload)

    # -- typed getters (None on bad CRC, like the upstream test) ------

    def _checked_body(self) -> Optional[bytes]:
        if not self.data:
            self.packetize()
        if crc32_mpeg(self.data) != 0:
            return None  # bad CRC
        start = 3 if self.short_section else 8
        return self.data[start:-4]

    def get_pat(self):
        if self.table_id != TABLE_ID_PAT:
            return None
        body = self._checked_body()
        if body is None:
            return None
        return _parse_pat(body)

    def get_pmt(self):
        if self.table_id != TABLE_ID_PMT:
            return None
        body = self._checked_body()
        if body is None:
            return None
        return _parse_pmt(self, body)

    def get_nit(self):
        if self.table_id not in (TABLE_ID_NIT_ACTUAL,
                                 TABLE_ID_NIT_OTHER):
            return None
        body = self._checked_body()
        if body is None:
            return None
        return _parse_nit(self, body)

    def get_sdt(self):
        if self.table_id not in (TABLE_ID_SDT_ACTUAL,
                                 TABLE_ID_SDT_OTHER):
            return None
        body = self._checked_body()
        if body is None:
            return None
        return _parse_sdt(self, body)

    def get_atsc_stt(self):
        if self.table_id != TABLE_ID_ATSC_STT:
            return None
        body = self._checked_body()
        if body is None:
            return None
        return _parse_stt(body)

    def get_scte_sit(self):
        if self.table_id != TABLE_ID_SCTE_SPLICE:
            return None
        if self._payload is not None and not self.data:
            return self._payload
        if not self.data or crc32_mpeg(self.data) != 0:
            return None
        return _parse_sit(self.data)

    def get_cat(self):
        """_parse_cat (gstmpegtssection.c:953-963): the body IS one
        descriptor loop."""
        if self.table_id != TABLE_ID_CAT:
            return None
        body = self._checked_body()
        if body is None:
            return None
        return parse_descriptors(body)

    def get_eit(self):
        if self.table_id not in _EIT_TABLE_IDS:
            return None
        body = self._checked_body()
        if body is None:
            return None
        return _parse_eit(self, body)

    def get_bat(self):
        if self.table_id != TABLE_ID_BAT:
            return None
        body = self._checked_body()
        if body is None:
            return None
        return _parse_bat(self, body)

    def get_tdt(self):
        """Short section, no CRC: the reference parses straight at
        data+3 (gst-dvb-section.c:1159-1162)."""
        if self.table_id != TABLE_ID_TDT or not self.short_section:
            return None
        if not self.data:
            self.packetize()
        if len(self.data) < 8:
            return None
        return parse_utc_time(self.data, 3)

    def get_tot(self):
        """Short section WITH a trailing CRC; the reference never
        checks it (short sections skip the CRC check,
        gstmpegtssection.c:181-187) — reproduced."""
        if self.table_id != TABLE_ID_TOT or not self.short_section:
            return None
        if not self.data:
            self.packetize()
        return _parse_tot(self.data)

    def get_atsc_vct(self):
        """TVCT or CVCT (gst-atsc-section.c:135-247)."""
        if self.table_id not in (TABLE_ID_ATSC_TVCT,
                                 TABLE_ID_ATSC_CVCT):
            return None
        body = self._checked_body()
        if body is None:
            return None
        return _parse_atsc_vct(self, body)

    def get_atsc_mgt(self):
        if self.table_id != TABLE_ID_ATSC_MGT:
            return None
        body = self._checked_body()
        if body is None:
            return None
        return _parse_atsc_mgt(body)

    def get_atsc_eit(self):
        if self.table_id != TABLE_ID_ATSC_EIT:
            return None
        body = self._checked_body()
        if body is None:
            return None
        return _parse_atsc_eit(self, body)


def section_new(pid: int, data: bytes) -> Section:
    """gst_mpegts_section_new: wrap raw section bytes."""
    if len(data) < 3:
        raise SiError("section too short")
    s = Section(pid=pid, table_id=data[0])
    s.short_section = not (data[1] & 0x80)
    if not s.short_section and len(data) >= 8:
        s.subtable_extension = struct.unpack_from(">H", data, 3)[0]
        s.version_number = (data[5] >> 1) & 0x1F
        s.current_next_indicator = bool(data[5] & 1)
        s.section_number = data[6]
        s.last_section_number = data[7]
    s.data = bytes(data)
    return s


# ------------------------------------------------------------------ PAT

@dataclasses.dataclass
class PatProgram:
    program_number: int = 0
    network_or_program_map_PID: int = 0


def _parse_pat(body: bytes) -> Optional[List[PatProgram]]:
    if len(body) % 4:
        return None
    out = []
    for off in range(0, len(body), 4):
        prog, pid = struct.unpack_from(">HH", body, off)
        out.append(PatProgram(prog, pid & 0x1FFF))
    return out


def _pack_pat(programs: List[PatProgram]) -> bytes:
    out = bytearray()
    for p in programs:
        out += struct.pack(">HH", p.program_number,
                           0xE000 | p.network_or_program_map_PID)
    return bytes(out)


def section_from_pat(programs: List[PatProgram],
                     ts_id: int) -> Section:
    s = Section(pid=0x00, table_id=TABLE_ID_PAT,
                subtable_extension=ts_id)
    s._payload = _PatWrap(programs)
    return s


@dataclasses.dataclass
class _PatWrap:
    programs: List[PatProgram]


# ------------------------------------------------------------------ PMT

@dataclasses.dataclass
class PmtStream:
    stream_type: int = 0
    pid: int = 0
    descriptors: List[Descriptor] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class Pmt:
    pcr_pid: int = 0x1FFF
    program_number: int = 0
    descriptors: List[Descriptor] = dataclasses.field(
        default_factory=list)
    streams: List[PmtStream] = dataclasses.field(default_factory=list)


def _parse_pmt(section: Section, body: bytes) -> Optional[Pmt]:
    if len(body) < 4:
        return None
    pmt = Pmt()
    pmt.program_number = section.subtable_extension
    pmt.pcr_pid = struct.unpack_from(">H", body, 0)[0] & 0x1FFF
    info_len = struct.unpack_from(">H", body, 2)[0] & 0xFFF
    pos = 4
    descs = parse_descriptors(body[pos:pos + info_len])
    if descs is None:
        return None
    pmt.descriptors = descs
    pos += info_len
    while pos < len(body):
        if pos + 5 > len(body):
            return None
        st = PmtStream()
        st.stream_type = body[pos]
        st.pid = struct.unpack_from(">H", body, pos + 1)[0] & 0x1FFF
        es_len = struct.unpack_from(">H", body, pos + 3)[0] & 0xFFF
        pos += 5
        descs = parse_descriptors(body[pos:pos + es_len])
        if descs is None:
            return None
        st.descriptors = descs
        pos += es_len
        pmt.streams.append(st)
    return pmt


def _pack_pmt(pmt: Pmt) -> bytes:
    out = bytearray()
    out += struct.pack(">H", 0xE000 | pmt.pcr_pid)
    info = _pack_descriptors(pmt.descriptors)
    out += struct.pack(">H", 0xF000 | len(info))
    out += info
    for st in pmt.streams:
        es = _pack_descriptors(st.descriptors)
        out.append(st.stream_type)
        out += struct.pack(">H", 0xE000 | st.pid)
        out += struct.pack(">H", 0xF000 | len(es))
        out += es
    return bytes(out)


def section_from_pmt(pmt: Pmt, pid: int) -> Section:
    s = Section(pid=pid, table_id=TABLE_ID_PMT,
                subtable_extension=pmt.program_number)
    s._payload = pmt
    return s


# ------------------------------------------------------------------ NIT

@dataclasses.dataclass
class NitStream:
    transport_stream_id: int = 0
    original_network_id: int = 0
    descriptors: List[Descriptor] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class Nit:
    actual_network: bool = True
    network_id: int = 0
    descriptors: List[Descriptor] = dataclasses.field(
        default_factory=list)
    streams: List[NitStream] = dataclasses.field(default_factory=list)


def _parse_nit(section: Section, body: bytes) -> Optional[Nit]:
    if len(body) < 2:
        return None
    nit = Nit()
    nit.actual_network = section.table_id == TABLE_ID_NIT_ACTUAL
    nit.network_id = section.subtable_extension
    net_len = struct.unpack_from(">H", body, 0)[0] & 0xFFF
    pos = 2
    descs = parse_descriptors(body[pos:pos + net_len])
    if descs is None:
        return None
    nit.descriptors = descs
    pos += net_len
    if pos + 2 > len(body):
        return None
    loop_len = struct.unpack_from(">H", body, pos)[0] & 0xFFF
    pos += 2
    end = pos + loop_len
    while pos < end:
        if pos + 6 > len(body):
            return None
        st = NitStream()
        st.transport_stream_id, st.original_network_id = \
            struct.unpack_from(">HH", body, pos)
        d_len = struct.unpack_from(">H", body, pos + 4)[0] & 0xFFF
        pos += 6
        descs = parse_descriptors(body[pos:pos + d_len])
        if descs is None:
            return None
        st.descriptors = descs
        pos += d_len
        nit.streams.append(st)
    return nit


def _pack_nit(nit: Nit) -> bytes:
    out = bytearray()
    net = _pack_descriptors(nit.descriptors)
    out += struct.pack(">H", 0xF000 | len(net))
    out += net
    loop = bytearray()
    for st in nit.streams:
        descs = _pack_descriptors(st.descriptors)
        loop += struct.pack(">HH", st.transport_stream_id,
                            st.original_network_id)
        loop += struct.pack(">H", 0xF000 | len(descs))
        loop += descs
    out += struct.pack(">H", 0xF000 | len(loop))
    out += loop
    return bytes(out)


def section_from_nit(nit: Nit) -> Section:
    s = Section(pid=0x10,
                table_id=(TABLE_ID_NIT_ACTUAL if nit.actual_network
                          else TABLE_ID_NIT_OTHER),
                subtable_extension=nit.network_id)
    s._payload = nit
    return s


# ------------------------------------------------------------------ SDT

@dataclasses.dataclass
class SdtService:
    service_id: int = 0
    EIT_schedule_flag: bool = False
    EIT_present_following_flag: bool = False
    running_status: int = RUNNING_STATUS_UNDEFINED
    free_CA_mode: bool = False
    descriptors: List[Descriptor] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class Sdt:
    actual_ts: bool = True
    transport_stream_id: int = 0
    original_network_id: int = 0
    services: List[SdtService] = dataclasses.field(
        default_factory=list)


def _parse_sdt(section: Section, body: bytes) -> Optional[Sdt]:
    if len(body) < 3:
        return None
    sdt = Sdt()
    sdt.actual_ts = section.table_id == TABLE_ID_SDT_ACTUAL
    sdt.transport_stream_id = section.subtable_extension
    sdt.original_network_id = struct.unpack_from(">H", body, 0)[0]
    pos = 3  # 1 reserved byte
    while pos < len(body):
        if pos + 5 > len(body):
            return None
        svc = SdtService()
        svc.service_id = struct.unpack_from(">H", body, pos)[0]
        flags = body[pos + 2]
        svc.EIT_schedule_flag = bool(flags & 0x02)
        svc.EIT_present_following_flag = bool(flags & 0x01)
        word = struct.unpack_from(">H", body, pos + 3)[0]
        svc.running_status = word >> 13
        svc.free_CA_mode = bool(word & 0x1000)
        d_len = word & 0xFFF
        pos += 5
        descs = parse_descriptors(body[pos:pos + d_len])
        if descs is None:
            return None
        svc.descriptors = descs
        pos += d_len
        sdt.services.append(svc)
    return sdt


def _pack_sdt(sdt: Sdt) -> bytes:
    out = bytearray()
    out += struct.pack(">H", sdt.original_network_id)
    out.append(0xFF)  # reserved
    for svc in sdt.services:
        descs = _pack_descriptors(svc.descriptors)
        out += struct.pack(">H", svc.service_id)
        out.append(0xFC | (0x02 if svc.EIT_schedule_flag else 0)
                   | (0x01 if svc.EIT_present_following_flag else 0))
        out += struct.pack(
            ">H", (svc.running_status << 13)
            | (0x1000 if svc.free_CA_mode else 0) | len(descs))
        out += descs
    return bytes(out)


def section_from_sdt(sdt: Sdt) -> Section:
    s = Section(pid=0x11,
                table_id=(TABLE_ID_SDT_ACTUAL if sdt.actual_ts
                          else TABLE_ID_SDT_OTHER),
                subtable_extension=sdt.transport_stream_id)
    s._payload = sdt
    return s


# ------------------------------------------------------------- ATSC STT

@dataclasses.dataclass
class AtscStt:
    protocol_version: int = 0
    system_time: int = 0
    gps_utc_offset: int = 0
    ds_status: int = 0
    ds_dayofmonth: int = 0
    ds_hour: int = 0

    def datetime_utc(self) -> datetime.datetime:
        """gst_mpegts_atsc_stt_get_datetime_utc: GPS epoch
        (1980-01-06) + system_time - gps_utc_offset."""
        return _GPS_EPOCH + datetime.timedelta(
            seconds=self.system_time - self.gps_utc_offset)


def _parse_stt(body: bytes) -> Optional[AtscStt]:
    if len(body) < 8:
        return None
    stt = AtscStt()
    stt.protocol_version = body[0]
    stt.system_time = struct.unpack_from(">I", body, 1)[0]
    stt.gps_utc_offset = body[5]
    daylight = struct.unpack_from(">H", body, 6)[0]
    stt.ds_status = daylight >> 15
    stt.ds_dayofmonth = (daylight >> 8) & 0x1F
    stt.ds_hour = daylight & 0xFF
    return stt


# ------------------------------------------------------------- SCTE SIT

@dataclasses.dataclass
class ScteSpliceEvent:
    insert_event: bool = False
    splice_event_id: int = 0
    splice_event_cancel_indicator: bool = False
    out_of_network_indicator: bool = False
    # non-0 default, like gst_mpegts_scte_splice_event_new
    program_splice_flag: bool = True
    duration_flag: bool = False
    splice_immediate_flag: bool = False
    program_splice_time_specified: bool = False
    program_splice_time: int = 0
    break_duration_auto_return: bool = False
    break_duration: int = 0
    unique_program_id: int = 0
    avail_num: int = 0
    avails_expected: int = 0


@dataclasses.dataclass
class ScteSit:
    encrypted_packet: bool = False
    encryption_algorithm: int = 0
    pts_adjustment: int = 0
    cw_index: int = 0
    tier: int = 0
    splice_command_length: int = 0
    splice_command_type: int = SCTE_SPLICE_COMMAND_NULL
    splice_time_specified: bool = False
    splice_time: int = 0
    splices: List[ScteSpliceEvent] = dataclasses.field(
        default_factory=list)
    descriptors: List[Descriptor] = dataclasses.field(
        default_factory=list)


def _parse_splice_event(data: bytes, pos: int, insert_event: bool
                        ) -> Optional[Tuple[ScteSpliceEvent, int]]:
    """_parse_slice_event (gst-scte-section.c:59-140)."""
    ev = ScteSpliceEvent(insert_event=insert_event)
    if pos + 5 > len(data):
        return None
    ev.splice_event_id = struct.unpack_from(">I", data, pos)[0]
    pos += 4
    ev.splice_event_cancel_indicator = bool(data[pos] >> 7)
    pos += 1
    if not ev.splice_event_cancel_indicator:
        if pos + 5 > len(data):
            return None
        b = data[pos]
        ev.out_of_network_indicator = bool(b >> 7)
        ev.program_splice_flag = bool((b >> 6) & 1)
        ev.duration_flag = bool((b >> 5) & 1)
        ev.splice_immediate_flag = bool((b >> 4) & 1)
        pos += 1
        if not ev.program_splice_flag:
            return None  # component splices unsupported
        if not ev.splice_immediate_flag:
            ev.program_splice_time_specified = bool(data[pos] >> 7)
            if ev.program_splice_time_specified:
                ev.program_splice_time = (data[pos] & 1) << 32
                pos += 1
                ev.program_splice_time += \
                    struct.unpack_from(">I", data, pos)[0]
                pos += 4
            else:
                pos += 1
        if ev.duration_flag:
            ev.break_duration_auto_return = bool(data[pos] >> 7)
            ev.break_duration = (data[pos] & 1) << 32
            pos += 1
            ev.break_duration += struct.unpack_from(">I", data, pos)[0]
            pos += 4
        ev.unique_program_id = struct.unpack_from(">H", data, pos)[0]
        pos += 2
        ev.avail_num = data[pos]
        ev.avails_expected = data[pos + 1]
        pos += 2
    return ev, pos


def _parse_sit(data: bytes) -> Optional[ScteSit]:
    """_parse_sit (gst-scte-section.c:170-295) over the FULL section
    bytes."""
    sit = ScteSit()
    pos = 3
    if data[pos] != 0:
        return None  # protocol_version must be 0
    pos += 1
    sit.encrypted_packet = bool(data[pos] >> 7)
    sit.encryption_algorithm = data[pos] & 0x3F
    sit.pts_adjustment = (data[pos] & 1) << 32
    pos += 1
    sit.pts_adjustment += struct.unpack_from(">I", data, pos)[0]
    pos += 4
    sit.cw_index = data[pos]
    pos += 1
    tmp = int.from_bytes(data[pos:pos + 3], "big")
    pos += 3
    sit.tier = tmp >> 12
    sit.splice_command_length = tmp & 0xFFF
    if sit.splice_command_length == 0xFFF:  # legacy "undefined"
        sit.splice_command_length = 0
    sit.splice_command_type = data[pos]
    pos += 1
    if sit.splice_command_type in (SCTE_SPLICE_COMMAND_NULL,
                                   SCTE_SPLICE_COMMAND_BANDWIDTH):
        pass
    elif sit.splice_command_type == SCTE_SPLICE_COMMAND_TIME:
        sit.splice_time_specified = bool(data[pos] >> 7)
        if sit.splice_time_specified:
            sit.splice_time = (data[pos] & 1) << 32
            pos += 1
            sit.splice_time += struct.unpack_from(">I", data, pos)[0]
            pos += 4
        else:
            pos += 1
    elif sit.splice_command_type == SCTE_SPLICE_COMMAND_INSERT:
        got = _parse_splice_event(data, pos, True)
        if got is None:
            return None
        ev, pos = got
        sit.splices.append(ev)
    else:
        return None
    desc_len = struct.unpack_from(">H", data, pos)[0]
    pos += 2
    descs = parse_descriptors(data[pos:pos + desc_len])
    if descs is None:
        return None
    sit.descriptors = descs
    pos += desc_len
    if pos != len(data) - 4:
        return None
    return sit


def _pack_sit_body(sit: ScteSit) -> bytes:
    """_packetize_sit body after the 3-byte short header
    (gst-scte-section.c:481-650)."""
    if sit.encrypted_packet:
        raise SiError("SCTE encrypted packet is not supported")
    if sit.splice_command_type in (SCTE_SPLICE_COMMAND_SCHEDULE,
                                   SCTE_SPLICE_COMMAND_TIME,
                                   SCTE_SPLICE_COMMAND_PRIVATE):
        raise SiError("SCTE command not supported")
    events = bytearray()
    for ev in sit.splices:
        events += struct.pack(">I", ev.splice_event_id)
        events.append(0xFF if ev.splice_event_cancel_indicator
                      else 0x7F)
        if not ev.splice_event_cancel_indicator:
            if not ev.program_splice_flag:
                raise SiError("only SCTE program splices supported")
            events.append(
                (ev.out_of_network_indicator << 7)
                | (ev.program_splice_flag << 6)
                | (ev.duration_flag << 5)
                | (ev.splice_immediate_flag << 4) | 0x0F)
            if not ev.splice_immediate_flag:
                if not ev.program_splice_time_specified:
                    events.append(0x7F)
                else:
                    events.append(
                        0xF2 | ((ev.program_splice_time >> 32) & 1))
                    events += struct.pack(
                        ">I", ev.program_splice_time & 0xFFFFFFFF)
            if ev.duration_flag:
                b = 0xFE if ev.break_duration_auto_return else 0x7E
                events.append(b | ((ev.break_duration >> 32) & 1))
                events += struct.pack(">I",
                                      ev.break_duration & 0xFFFFFFFF)
            events += struct.pack(">H", ev.unique_program_id)
            events.append(ev.avail_num)
            events.append(ev.avails_expected)
    descs = _pack_descriptors(sit.descriptors)
    out = bytearray()
    out.append(0)  # protocol version
    out.append((sit.pts_adjustment >> 32) & 1)
    out += struct.pack(">I", sit.pts_adjustment & 0xFFFFFFFF)
    out.append(sit.cw_index)
    tmp = ((sit.tier & 0xFFF) << 12) | (len(events) & 0xFFF)
    out += tmp.to_bytes(3, "big")
    out.append(sit.splice_command_type)
    out += events
    out += struct.pack(">H", len(descs))
    out += descs
    return bytes(out)


def section_from_scte_sit(sit: ScteSit, pid: int) -> Section:
    s = Section(pid=pid, table_id=TABLE_ID_SCTE_SPLICE,
                short_section=True)
    s._payload = sit
    return s


_PACKETIZERS = {
    _PatWrap: lambda w: _pack_pat(w.programs),
    Pmt: _pack_pmt,
    Nit: _pack_nit,
    Sdt: _pack_sdt,
    ScteSit: _pack_sit_body,
}


# ------------------------------------------------------- DVB UTC time

@dataclasses.dataclass
class DvbTime:
    """_parse_utc_time (gst-dvb-section.c:110-152): 16-bit MJD + 3 BCD
    time bytes.  hour == -1 mirrors the reference's 0xFFFFFF time
    (date-only GstDateTime)."""
    year: int = 0
    month: int = 0
    day: int = 0
    hour: int = 0
    minute: int = 0
    second: int = 0


def parse_utc_time(data: bytes, pos: int = 0) -> Optional[DvbTime]:
    """EN 300 468 Annex C decode, float-for-float with the reference
    (including the double literals and truncating guint casts)."""
    if pos + 5 > len(data):
        return None
    mjd = struct.unpack_from(">H", data, pos)[0]
    if mjd == 0xFFFF:
        return None
    year = int((mjd - 15078.2) / 365.25)
    month = int((mjd - 14956.1 - int(year * 365.25)) / 30.6001)
    day = mjd - 14956 - int(year * 365.25) - int(month * 30.6001)
    if month in (14, 15):
        year += 1
        month = month - 1 - 12
    else:
        month -= 1
    year += 1900
    u0, u1, u2 = data[pos + 2], data[pos + 3], data[pos + 4]
    hour = ((u0 & 0x30) >> 4) * 10 + (u0 & 0x0F)
    minute = ((u1 & 0x70) >> 4) * 10 + (u1 & 0x0F)
    second = ((u2 & 0x70) >> 4) * 10 + (u2 & 0x0F)
    if hour < 24 and minute < 60 and second < 60:
        return DvbTime(year, month, day, hour, minute, second)
    if u0 == 0xFF and u1 == 0xFF and u2 == 0xFF:
        return DvbTime(year, month, day, -1, -1, -1)
    return None


def pack_utc_time(t: DvbTime) -> bytes:
    """EN 300 468 Annex C encode (the inverse conversion the spec
    gives; round-trips through parse_utc_time bit-exactly)."""
    leap = 1 if t.month in (1, 2) else 0
    mjd = (14956 + t.day + int((t.year - 1900 - leap) * 365.25)
           + int((t.month + 1 + leap * 12) * 30.6001))
    if mjd > 0xFFFF:
        raise SiError("date beyond the 16-bit MJD range (2038-04-22)")

    def bcd(v: int) -> int:
        return ((v // 10) << 4) | (v % 10)

    if t.hour < 0:
        return struct.pack(">H", mjd) + b"\xff\xff\xff"
    return struct.pack(">H", mjd) + bytes(
        [bcd(t.hour), bcd(t.minute), bcd(t.second)])


# ------------------------------------------------------------------ EIT

@dataclasses.dataclass
class EitEvent:
    """GstMpegtsEITEvent (gst-dvb-section.c:235-270)."""
    event_id: int = 0
    start_time: Optional[DvbTime] = None
    duration: int = 0               # seconds
    running_status: int = 0
    free_CA_mode: bool = False
    descriptors: List[Descriptor] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class Eit:
    """GstMpegtsEIT (gst-dvb-section.c:203-289); service_id rides as
    the section's subtable_extension."""
    service_id: int = 0
    transport_stream_id: int = 0
    original_network_id: int = 0
    segment_last_section_number: int = 0
    last_table_id: int = 0
    actual_stream: bool = True
    present_following: bool = True
    events: List[EitEvent] = dataclasses.field(default_factory=list)


def _parse_eit(section: Section, body: bytes) -> Optional[Eit]:
    if len(body) < 6:
        return None
    eit = Eit()
    eit.service_id = section.subtable_extension
    eit.transport_stream_id, eit.original_network_id = \
        struct.unpack_from(">HH", body, 0)
    eit.segment_last_section_number = body[4]
    eit.last_table_id = body[5]
    tid = section.table_id
    eit.actual_stream = (tid == TABLE_ID_EIT_PF_ACTUAL
                         or 0x50 <= tid <= 0x5F)
    eit.present_following = tid in (TABLE_ID_EIT_PF_ACTUAL,
                                    TABLE_ID_EIT_PF_OTHER)
    pos, end = 6, len(body)
    while pos < end:
        if end - pos < 12:   # 12 is the minimum entry size
            return None
        ev = EitEvent()
        ev.event_id = struct.unpack_from(">H", body, pos)[0]
        ev.start_time = parse_utc_time(body, pos + 2)
        d0, d1, d2 = body[pos + 7], body[pos + 8], body[pos + 9]
        ev.duration = ((((d0 & 0xF0) >> 4) * 10 + (d0 & 0x0F)) * 3600
                       + (((d1 & 0xF0) >> 4) * 10 + (d1 & 0x0F)) * 60
                       + ((d2 & 0xF0) >> 4) * 10 + (d2 & 0x0F))
        pos += 10
        ev.running_status = body[pos] >> 5
        ev.free_CA_mode = bool((body[pos] >> 4) & 0x01)
        dll = struct.unpack_from(">H", body, pos)[0] & 0x0FFF
        pos += 2
        descs = parse_descriptors(body[pos:pos + dll])
        if descs is None:
            return None
        ev.descriptors = descs
        pos += dll
        eit.events.append(ev)
    if pos != end:
        return None
    return eit


def _pack_eit(eit: Eit) -> bytes:
    out = bytearray()
    out += struct.pack(">HH", eit.transport_stream_id,
                       eit.original_network_id)
    out.append(eit.segment_last_section_number)
    out.append(eit.last_table_id)

    def bcd(v: int) -> int:
        return ((v // 10) << 4) | (v % 10)

    for ev in eit.events:
        out += struct.pack(">H", ev.event_id)
        out += (b"\xff\xff\xff\xff\xff" if ev.start_time is None
                else pack_utc_time(ev.start_time))
        h, rem = divmod(ev.duration, 3600)
        m, s = divmod(rem, 60)
        out += bytes([bcd(h), bcd(m), bcd(s)])
        descs = _pack_descriptors(ev.descriptors)
        out += struct.pack(
            ">H", (ev.running_status << 13)
            | (0x1000 if ev.free_CA_mode else 0) | len(descs))
        out += descs
    return bytes(out)


def section_from_eit(eit: Eit, table_id: Optional[int] = None) -> Section:
    """table_id defaults from the actual/present_following flags (the
    first schedule table id for non-p/f)."""
    if table_id is None:
        if eit.present_following:
            table_id = (TABLE_ID_EIT_PF_ACTUAL if eit.actual_stream
                        else TABLE_ID_EIT_PF_OTHER)
        else:
            table_id = (TABLE_ID_EIT_SCHEDULE_ACTUAL if eit.actual_stream
                        else TABLE_ID_EIT_SCHEDULE_OTHER)
    s = Section(pid=0x12, table_id=table_id,
                subtable_extension=eit.service_id)
    s._payload = eit
    return s


# ------------------------------------------------------------------ BAT

@dataclasses.dataclass
class BatStream:
    """GstMpegtsBATStream (gst-dvb-section.c:313-330)."""
    transport_stream_id: int = 0
    original_network_id: int = 0
    descriptors: List[Descriptor] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class Bat:
    """GstMpegtsBAT (gst-dvb-section.c:362-460); bouquet_id rides as
    the section's subtable_extension."""
    bouquet_id: int = 0
    descriptors: List[Descriptor] = dataclasses.field(
        default_factory=list)
    streams: List[BatStream] = dataclasses.field(default_factory=list)


def _parse_bat(section: Section, body: bytes) -> Optional[Bat]:
    if len(body) < 4:
        return None
    bat = Bat()
    bat.bouquet_id = section.subtable_extension
    dll = struct.unpack_from(">H", body, 0)[0] & 0x0FFF
    pos = 2
    descs = parse_descriptors(body[pos:pos + dll])
    if descs is None or pos + dll + 2 > len(body):
        return None
    bat.descriptors = descs
    pos += dll
    loop_len = struct.unpack_from(">H", body, pos)[0] & 0x0FFF
    pos += 2
    end = pos + loop_len
    if end > len(body):
        return None
    while pos < end:
        if pos + 6 > end:   # each entry is at least 6 bytes
            return None
        st = BatStream()
        st.transport_stream_id, st.original_network_id = \
            struct.unpack_from(">HH", body, pos)
        d_len = struct.unpack_from(">H", body, pos + 4)[0] & 0x0FFF
        pos += 6
        descs = parse_descriptors(body[pos:pos + d_len])
        if descs is None:
            return None
        st.descriptors = descs
        pos += d_len
        bat.streams.append(st)
    return bat


def _pack_bat(bat: Bat) -> bytes:
    out = bytearray()
    descs = _pack_descriptors(bat.descriptors)
    out += struct.pack(">H", 0xF000 | len(descs))
    out += descs
    loop = bytearray()
    for st in bat.streams:
        d = _pack_descriptors(st.descriptors)
        loop += struct.pack(">HH", st.transport_stream_id,
                            st.original_network_id)
        loop += struct.pack(">H", 0xF000 | len(d))
        loop += d
    out += struct.pack(">H", 0xF000 | len(loop))
    out += loop
    return bytes(out)


def section_from_bat(bat: Bat) -> Section:
    s = Section(pid=0x11, table_id=TABLE_ID_BAT,
                subtable_extension=bat.bouquet_id)
    s._payload = bat
    return s


# ------------------------------------------------------------------ CAT

@dataclasses.dataclass
class Cat:
    """CAT is one bare descriptor loop (gstmpegtssection.c:953-963)."""
    descriptors: List[Descriptor] = dataclasses.field(
        default_factory=list)


def _pack_cat(cat: Cat) -> bytes:
    return _pack_descriptors(cat.descriptors)


def section_from_cat(cat: Cat) -> Section:
    s = Section(pid=0x01, table_id=TABLE_ID_CAT)
    s._payload = cat
    return s


# ------------------------------------------------------------ TDT / TOT

def section_from_tdt(time: DvbTime) -> Section:
    """TDT: a SHORT section whose whole body is the 5-byte UTC time,
    with NO CRC (EN 300 468 §5.2.5; gst-dvb-section.c:1159-1162)."""
    s = Section(pid=0x14, table_id=TABLE_ID_TDT, short_section=True,
                has_crc=False)
    s._payload = _TdtWrap(time)
    return s


@dataclasses.dataclass
class _TdtWrap:
    time: DvbTime


@dataclasses.dataclass
class Tot:
    """GstMpegtsTOT (gst-dvb-section.c:1215-1241): UTC time + one
    descriptor loop; a short section that DOES carry a trailing CRC."""
    utc_time: Optional[DvbTime] = None
    descriptors: List[Descriptor] = dataclasses.field(
        default_factory=list)


def _parse_tot(data: bytes) -> Optional[Tot]:
    if len(data) < 14:
        return None
    tot = Tot()
    tot.utc_time = parse_utc_time(data, 3)
    desc_len = struct.unpack_from(">H", data, 8)[0] & 0xFFF
    descs = parse_descriptors(data[10:10 + desc_len])
    if descs is None:
        return None
    tot.descriptors = descs
    return tot


def _pack_tot(tot: Tot) -> bytes:
    descs = _pack_descriptors(tot.descriptors)
    out = bytearray(pack_utc_time(tot.utc_time)
                    if tot.utc_time is not None else b"\xff" * 5)
    out += struct.pack(">H", 0xF000 | len(descs))
    out += descs
    return bytes(out)


def section_from_tot(tot: Tot) -> Section:
    s = Section(pid=0x14, table_id=TABLE_ID_TOT, short_section=True)
    s._payload = tot
    return s


# ------------------------------------------------------------- ATSC VCT

@dataclasses.dataclass
class AtscVctSource:
    """GstMpegtsAtscVCTSource (gst-atsc-section.c:168-232)."""
    short_name: str = ""
    major_channel_number: int = 0
    minor_channel_number: int = 0
    modulation_mode: int = 0
    carrier_frequency: int = 0
    channel_TSID: int = 0
    program_number: int = 0
    ETM_location: int = 0
    access_controlled: bool = False
    hidden: bool = False
    path_select: bool = False       # CVCT only
    out_of_band: bool = False       # CVCT only
    hide_guide: bool = False
    service_type: int = 0
    source_id: int = 0
    descriptors: List[Descriptor] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class AtscVct:
    """GstMpegtsAtscVCT; cable=True is the CVCT (table 0xC9)."""
    cable: bool = False
    transport_stream_id: int = 0
    protocol_version: int = 0
    sources: List[AtscVctSource] = dataclasses.field(
        default_factory=list)
    descriptors: List[Descriptor] = dataclasses.field(
        default_factory=list)


def _parse_atsc_vct(section: Section, body: bytes) -> Optional[AtscVct]:
    if len(body) < 2 + 2 + 2:
        return None
    vct = AtscVct()
    vct.cable = section.table_id == TABLE_ID_ATSC_CVCT
    vct.transport_stream_id = section.subtable_extension
    vct.protocol_version = body[0]
    source_nb = body[1]
    pos = 2
    for _ in range(source_nb):
        if len(body) - pos < 32 + 2:
            return None
        src = AtscVctSource()
        # 14 bytes UTF-16BE, NUL-padded (the reference g_convert's all
        # 14 bytes; trailing NULs stripped here for a usable str)
        src.short_name = body[pos:pos + 14].decode(
            "utf-16-be", errors="replace").rstrip("\x00")
        pos += 14
        tmp32 = struct.unpack_from(">I", body, pos)[0]
        src.major_channel_number = (tmp32 >> 18) & 0x03FF
        src.minor_channel_number = (tmp32 >> 8) & 0x03FF
        src.modulation_mode = tmp32 & 0xF
        pos += 4
        src.carrier_frequency = struct.unpack_from(">I", body, pos)[0]
        pos += 4
        src.channel_TSID = struct.unpack_from(">H", body, pos)[0]
        pos += 2
        src.program_number = struct.unpack_from(">H", body, pos)[0]
        pos += 2
        tmp16 = struct.unpack_from(">H", body, pos)[0]
        src.ETM_location = (tmp16 >> 14) & 0x3
        src.access_controlled = bool((tmp16 >> 13) & 0x1)
        src.hidden = bool((tmp16 >> 12) & 0x1)
        src.path_select = bool((tmp16 >> 11) & 0x1)
        src.out_of_band = bool((tmp16 >> 10) & 0x1)
        src.hide_guide = bool((tmp16 >> 9) & 0x1)
        src.service_type = tmp16 & 0x3F
        pos += 2
        src.source_id = struct.unpack_from(">H", body, pos)[0]
        pos += 2
        dll = struct.unpack_from(">H", body, pos)[0] & 0x03FF
        pos += 2
        if len(body) - pos < dll + 2:
            return None
        descs = parse_descriptors(body[pos:pos + dll])
        if descs is None:
            return None
        src.descriptors = descs
        pos += dll
        vct.sources.append(src)
    if len(body) - pos < 2:
        return None
    dll = struct.unpack_from(">H", body, pos)[0] & 0x03FF
    pos += 2
    if len(body) - pos < dll:
        return None
    descs = parse_descriptors(body[pos:pos + dll])
    if descs is None:
        return None
    vct.descriptors = descs
    return vct


def _pack_atsc_vct(vct: AtscVct) -> bytes:
    out = bytearray()
    out.append(vct.protocol_version)
    out.append(len(vct.sources))
    for src in vct.sources:
        name = src.short_name.encode("utf-16-be")[:14]
        out += name + b"\x00" * (14 - len(name))
        tmp32 = (0xF0000000
                 | ((src.major_channel_number & 0x3FF) << 18)
                 | ((src.minor_channel_number & 0x3FF) << 8)
                 | 0xF0 | (src.modulation_mode & 0xF))
        out += struct.pack(">I", tmp32)
        out += struct.pack(">I", src.carrier_frequency)
        out += struct.pack(">H", src.channel_TSID)
        out += struct.pack(">H", src.program_number)
        tmp16 = ((src.ETM_location & 0x3) << 14
                 | (0x2000 if src.access_controlled else 0)
                 | (0x1000 if src.hidden else 0)
                 | (0x0800 if src.path_select else 0)
                 | (0x0400 if src.out_of_band else 0)
                 | (0x0200 if src.hide_guide else 0)
                 | 0x01C0 | (src.service_type & 0x3F))
        out += struct.pack(">H", tmp16)
        out += struct.pack(">H", src.source_id)
        descs = _pack_descriptors(src.descriptors)
        out += struct.pack(">H", 0xFC00 | len(descs))
        out += descs
    descs = _pack_descriptors(vct.descriptors)
    out += struct.pack(">H", 0xFC00 | len(descs))
    out += descs
    return bytes(out)


def section_from_atsc_vct(vct: AtscVct) -> Section:
    s = Section(pid=0x1FFB,
                table_id=(TABLE_ID_ATSC_CVCT if vct.cable
                          else TABLE_ID_ATSC_TVCT),
                subtable_extension=vct.transport_stream_id)
    s._payload = vct
    return s


# ------------------------------------------------------------- ATSC MGT

@dataclasses.dataclass
class AtscMgtTable:
    """GstMpegtsAtscMGTTable (gst-atsc-section.c:372-404)."""
    table_type: int = 0
    pid: int = 0
    version_number: int = 0
    number_bytes: int = 0
    descriptors: List[Descriptor] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class AtscMgt:
    protocol_version: int = 0
    tables: List[AtscMgtTable] = dataclasses.field(default_factory=list)
    descriptors: List[Descriptor] = dataclasses.field(
        default_factory=list)


def _parse_atsc_mgt(body: bytes) -> Optional[AtscMgt]:
    if len(body) < 5:
        return None
    mgt = AtscMgt()
    mgt.protocol_version = body[0]
    tables_defined = struct.unpack_from(">H", body, 1)[0]
    pos = 3
    for _ in range(tables_defined):
        if pos + 11 > len(body):
            return None
        t = AtscMgtTable()
        t.table_type = struct.unpack_from(">H", body, pos)[0]
        t.pid = struct.unpack_from(">H", body, pos + 2)[0] & 0x1FFF
        t.version_number = body[pos + 4] & 0x1F
        t.number_bytes = struct.unpack_from(">I", body, pos + 5)[0]
        dll = struct.unpack_from(">H", body, pos + 9)[0] & 0x0FFF
        pos += 11
        descs = parse_descriptors(body[pos:pos + dll])
        if descs is None:
            return None
        t.descriptors = descs
        pos += dll
        mgt.tables.append(t)
    if pos + 2 > len(body):
        return None
    dll = struct.unpack_from(">H", body, pos)[0] & 0xFFF
    pos += 2
    descs = parse_descriptors(body[pos:pos + dll])
    if descs is None:
        return None
    mgt.descriptors = descs
    return mgt


def _pack_atsc_mgt(mgt: AtscMgt) -> bytes:
    """_packetize_mgt (gst-atsc-section.c:420-517) with one documented
    DIVERGENCE: the reference indexes `mgt->tables` with the constant 1
    instead of the loop variable (an upstream bug that repeats table[1]
    for every row); this packs each table correctly so that
    pack->parse round-trips."""
    out = bytearray()
    out.append(mgt.protocol_version)
    out += struct.pack(">H", len(mgt.tables))
    for t in mgt.tables:
        out += struct.pack(">H", t.table_type)
        out += struct.pack(">H", 0xE000 | (t.pid & 0x1FFF))
        out.append(0xE0 | (t.version_number & 0x1F))
        out += struct.pack(">I", t.number_bytes)
        descs = _pack_descriptors(t.descriptors)
        out += struct.pack(">H", 0xF000 | len(descs))
        out += descs
    descs = _pack_descriptors(mgt.descriptors)
    out += struct.pack(">H", 0xF000 | len(descs))
    out += descs
    return bytes(out)


def section_from_atsc_mgt(mgt: AtscMgt) -> Section:
    s = Section(pid=0x1FFB, table_id=TABLE_ID_ATSC_MGT)
    s._payload = mgt
    return s


# ------------------------------------------------------------- ATSC EIT

@dataclasses.dataclass
class AtscStringSegment:
    """GstMpegtsAtscStringSegment (gst-atsc-section.c:800-812)."""
    compression_type: int = 0
    mode: int = 0
    compressed_data: bytes = b""


@dataclasses.dataclass
class AtscMultString:
    """GstMpegtsAtscMultString (gst-atsc-section.c:747-827)."""
    iso_639_langcode: str = "eng"
    segments: List[AtscStringSegment] = dataclasses.field(
        default_factory=list)


def _parse_atsc_mult_string(data: bytes
                            ) -> Optional[List[AtscMultString]]:
    if not data:
        return []
    num_strings = data[0]
    pos = 1
    out = []
    for _ in range(num_strings):
        if len(data) - pos < 4:
            return None
        ms = AtscMultString()
        ms.iso_639_langcode = data[pos:pos + 3].decode(
            "latin-1")
        num_segments = data[pos + 3]
        pos += 4
        for _ in range(num_segments):
            if len(data) - pos < 3:
                return None
            seg = AtscStringSegment()
            seg.compression_type = data[pos]
            seg.mode = data[pos + 1]
            size = data[pos + 2]
            pos += 3
            if len(data) - pos < size:
                return None
            seg.compressed_data = data[pos:pos + size]
            pos += size
            ms.segments.append(seg)
        out.append(ms)
    return out


def _pack_atsc_mult_string(strings: List[AtscMultString]) -> bytes:
    """_packetize_atsc_mult_string (gst-atsc-section.c:830-878)."""
    out = bytearray([len(strings)])
    for ms in strings:
        out += ms.iso_639_langcode.encode("latin-1")[:3].ljust(3, b"\x00")
        out.append(len(ms.segments))
        for seg in ms.segments:
            out.append(seg.compression_type)
            out.append(seg.mode)
            out.append(len(seg.compressed_data))
            out += seg.compressed_data
    return bytes(out)


@dataclasses.dataclass
class AtscEitEvent:
    """GstMpegtsAtscEITEvent (gst-atsc-section.c:985-1030)."""
    event_id: int = 0
    start_time: int = 0             # GPS seconds
    etm_location: int = 0
    length_in_seconds: int = 0
    titles: List[AtscMultString] = dataclasses.field(
        default_factory=list)
    descriptors: List[Descriptor] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class AtscEit:
    source_id: int = 0
    protocol_version: int = 0
    events: List[AtscEitEvent] = dataclasses.field(default_factory=list)


def _parse_atsc_eit(section: Section, body: bytes) -> Optional[AtscEit]:
    if len(body) < 2:
        return None
    eit = AtscEit()
    eit.source_id = section.subtable_extension
    eit.protocol_version = body[0]
    num_events = body[1]
    pos = 2
    for _ in range(num_events):
        if len(body) - pos < 12:
            return None
        ev = AtscEitEvent()
        ev.event_id = struct.unpack_from(">H", body, pos)[0] & 0x3FFF
        ev.start_time = struct.unpack_from(">I", body, pos + 2)[0]
        tmp = struct.unpack_from(">I", body, pos + 6)[0]
        ev.etm_location = (tmp >> 28) & 0x3
        ev.length_in_seconds = (tmp >> 8) & 0x0FFFFF
        text_length = tmp & 0xFF
        pos += 10
        if text_length > len(body) - pos - 2:
            return None
        titles = _parse_atsc_mult_string(body[pos:pos + text_length])
        if titles is None:
            return None
        ev.titles = titles
        pos += text_length
        dll = struct.unpack_from(">H", body, pos)[0] & 0x0FFF
        pos += 2
        if len(body) - pos < dll:
            return None
        descs = parse_descriptors(body[pos:pos + dll])
        if descs is None:
            return None
        ev.descriptors = descs
        pos += dll
        eit.events.append(ev)
    if pos != len(body):
        return None
    return eit


def _pack_atsc_eit(eit: AtscEit) -> bytes:
    out = bytearray()
    out.append(eit.protocol_version)
    out.append(len(eit.events))
    for ev in eit.events:
        out += struct.pack(">H", 0xC000 | (ev.event_id & 0x3FFF))
        out += struct.pack(">I", ev.start_time)
        text = _pack_atsc_mult_string(ev.titles)
        # bits 31-30 reserved, 29-28 etm_location,
        # 27-8 length_in_seconds, 7-0 title_length
        tmp = ((0x3 << 30) | ((ev.etm_location & 0x3) << 28)
               | ((ev.length_in_seconds & 0x0FFFFF) << 8)
               | (len(text) & 0xFF))
        out += struct.pack(">I", tmp)
        out += text
        descs = _pack_descriptors(ev.descriptors)
        out += struct.pack(">H", 0xF000 | len(descs))
        out += descs
    return bytes(out)


def section_from_atsc_eit(eit: AtscEit, pid: int) -> Section:
    """ATSC EIT PIDs come from the MGT (table types 0x100..0x17F)."""
    s = Section(pid=pid, table_id=TABLE_ID_ATSC_EIT,
                subtable_extension=eit.source_id)
    s._payload = eit
    return s


_PACKETIZERS.update({
    Eit: _pack_eit,
    Bat: _pack_bat,
    Cat: _pack_cat,
    _TdtWrap: lambda w: pack_utc_time(w.time),
    Tot: _pack_tot,
    AtscVct: _pack_atsc_vct,
    AtscMgt: _pack_atsc_mgt,
    AtscEit: _pack_atsc_eit,
})
