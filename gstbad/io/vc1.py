"""VC-1 (SMPTE 421M) bitstream structures
(gst-libs/gst/codecparsers/gstvc1parser.c).

Covers what the vc1parse element consumes:
  - struct C / A / B and the Annex-L sequence layer
    (gstvc1parser.c:1574-1656, 1537-1571, 1729-1814);
  - the advanced-profile sequence header incl. display extension,
    aspect-ratio table, indexed/exponential framerate and HRD
    (gstvc1parser.c:782-900);
  - the entry-point header (gstvc1parser.c:1936-2000);
  - BDU start-code scanning (gst_vc1_identify_next_bdu,
    gstvc1parser.c:1663-1716);
  - the Annex-L frame-layer header and the ASF<->BDU helpers the
    element builds on (gstvc1parse.c:783-874, 1568-1709).

All parse errors raise Vc1Error (a ValueError) — garbage in must not
escape as IndexError/struct.error (tests/test_parser_fuzz.py).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple

from gstbad.io.h264 import BitReader


class Vc1Error(ValueError):
    pass


# profiles (gstvc1parser.h GstVC1Profile)
PROFILE_SIMPLE = 0
PROFILE_MAIN = 1
PROFILE_ADVANCED = 3

# BDU start codes (gstvc1parser.h GstVC1StartCode)
END_OF_SEQ = 0x0A
SLICE = 0x0B
FIELD = 0x0C
FRAME = 0x0D
ENTRYPOINT = 0x0E
SEQUENCE = 0x0F
SLICE_USER = 0x1B
FIELD_USER = 0x1C
FRAME_USER = 0x1D
ENTRY_POINT_USER = 0x1E
SEQUENCE_USER = 0x1F

# SMPTE 421M Table 7 (gstvc1parse.c:1842-1863)
ASPECT_RATIOS = [(0, 0), (1, 1), (12, 11), (10, 11), (16, 11), (40, 33),
                 (24, 11), (20, 11), (32, 11), (80, 33), (18, 11),
                 (15, 11), (64, 33), (160, 99), (0, 0), (0, 0)]
# Tables 8/9
FRAMERATES_N = [0, 24000, 25000, 30000, 50000, 60000, 48000, 72000]
FRAMERATES_D = [0, 1000, 1001]

MAX_HRD_NUM_LEAKY_BUCKETS = 31


def _framerate_bitrate(frmrtq: int, bitrtq: int) -> Tuple[int, int]:
    """calculate_framerate_bitrate (gstvc1parser.c:710-733)."""
    if frmrtq == 0 and bitrtq == 31:
        return 0, 0
    if frmrtq == 0 and bitrtq == 30:
        return 2, 1952
    if frmrtq == 1 and bitrtq == 31:
        return 6, 2016
    framerate = 30 if frmrtq == 7 else 2 + frmrtq * 4
    bitrate = 2016 if bitrtq == 31 else 32 + bitrtq * 64
    return framerate, bitrate


@dataclasses.dataclass
class StructC:
    profile: int = 0
    wmvp: int = 0
    frmrtq_postproc: int = 0
    bitrtq_postproc: int = 0
    loop_filter: int = 0
    multires: int = 0
    fastuvmc: int = 0
    extended_mv: int = 0
    dquant: int = 0
    vstransform: int = 0
    overlap: int = 0
    syncmarker: int = 0
    rangered: int = 0
    maxbframes: int = 0
    quantizer: int = 0
    finterpflag: int = 0
    framerate: int = 0
    bitrate: int = 0
    coded_width: int = 0
    coded_height: int = 0
    slice_code: int = 0


@dataclasses.dataclass
class StructA:
    vert_size: int = 0
    horiz_size: int = 0


@dataclasses.dataclass
class StructB:
    level: int = 0
    cbr: int = 0
    hrd_buffer: int = 0
    hrd_rate: int = 0
    framerate: int = 0


@dataclasses.dataclass
class HrdParam:
    hrd_num_leaky_buckets: int = 0
    bit_rate_exponent: int = 0
    buffer_size_exponent: int = 0
    hrd_rate: List[int] = dataclasses.field(default_factory=list)
    hrd_buffer: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class EntryPointHdr:
    broken_link: int = 0
    closed_entry: int = 0
    panscan_flag: int = 0
    refdist_flag: int = 0
    loopfilter: int = 0
    fastuvmc: int = 0
    extended_mv: int = 0
    dquant: int = 0
    vstransform: int = 0
    overlap: int = 0
    quantizer: int = 0
    hrd_full: List[int] = dataclasses.field(default_factory=list)
    coded_size_flag: int = 0
    coded_width: int = 0
    coded_height: int = 0
    extended_dmv: int = 0
    range_mapy_flag: int = 0
    range_mapy: int = 0
    range_mapuv_flag: int = 0
    range_mapuv: int = 0


@dataclasses.dataclass
class AdvancedSeqHdr:
    level: int = 0
    colordiff_format: int = 0
    frmrtq_postproc: int = 0
    bitrtq_postproc: int = 0
    framerate: int = 0
    bitrate: int = 0
    postprocflag: int = 0
    max_coded_width: int = 0
    max_coded_height: int = 0
    pulldown: int = 0
    interlace: int = 0
    tfcntrflag: int = 0
    finterpflag: int = 0
    psf: int = 0
    display_ext: int = 0
    disp_horiz_size: int = 0
    disp_vert_size: int = 0
    aspect_ratio_flag: int = 0
    aspect_ratio: int = 0
    aspect_horiz_size: int = 0
    aspect_vert_size: int = 0
    par_n: int = 0
    par_d: int = 0
    framerate_flag: int = 0
    framerateind: int = 0
    frameratenr: int = 0
    frameratedr: int = 0
    framerateexp: int = 0
    fps_n: int = 0
    fps_d: int = 0
    color_format_flag: int = 0
    color_prim: int = 0
    transfer_char: int = 0
    matrix_coef: int = 0
    hrd_param_flag: int = 0
    hrd_param: HrdParam = dataclasses.field(default_factory=HrdParam)
    entrypoint: Optional[EntryPointHdr] = None


@dataclasses.dataclass
class SeqHdr:
    profile: int = 0
    struct_c: StructC = dataclasses.field(default_factory=StructC)
    advanced: AdvancedSeqHdr = \
        dataclasses.field(default_factory=AdvancedSeqHdr)
    mb_width: int = 0
    mb_height: int = 0
    mb_stride: int = 0

    def _calc_mb(self, width: int, height: int) -> None:
        self.mb_width = (width + 15) >> 4
        self.mb_height = (height + 15) >> 4
        self.mb_stride = self.mb_width + 1


@dataclasses.dataclass
class SeqLayer:
    numframes: int = 0
    struct_c: StructC = dataclasses.field(default_factory=StructC)
    struct_a: StructA = dataclasses.field(default_factory=StructA)
    struct_b: StructB = dataclasses.field(default_factory=StructB)


def _parse_struct_c(br: BitReader) -> StructC:
    """parse_sequence_header_struct_c (gstvc1parser.c:1574-1656)."""
    c = StructC()
    try:
        c.profile = br.read(2)
        if c.profile == PROFILE_ADVANCED:
            return c
        br.read(1)  # old interlaced mode (reserved)
        c.wmvp = br.read(1)
        c.frmrtq_postproc = br.read(3)
        c.bitrtq_postproc = br.read(5)
        c.loop_filter = br.read(1)
        c.framerate, c.bitrate = _framerate_bitrate(c.frmrtq_postproc,
                                                    c.bitrtq_postproc)
        br.read(1)  # reserved3
        c.multires = br.read(1)
        br.read(1)  # reserved4
        c.fastuvmc = br.read(1)
        c.extended_mv = br.read(1)
        c.dquant = br.read(2)
        c.vstransform = br.read(1)
        br.read(1)  # reserved5
        c.overlap = br.read(1)
        c.syncmarker = br.read(1)
        c.rangered = br.read(1)
        c.maxbframes = br.read(3)
        c.quantizer = br.read(2)
        c.finterpflag = br.read(1)
        if c.wmvp:
            c.coded_width = br.read(11)
            c.coded_height = br.read(11)
            c.framerate = br.read(5)
            br.read(1)
            c.slice_code = br.read(1)
    except ValueError as e:
        raise Vc1Error(f"struct C truncated: {e}") from e
    return c


def parse_struct_c(data: bytes) -> StructC:
    return _parse_struct_c(BitReader(data))


def parse_struct_a(data: bytes) -> StructA:
    if len(data) < 8:
        raise Vc1Error("struct A needs 8 bytes")
    a = StructA()
    a.vert_size, a.horiz_size = struct.unpack_from(">II", data)
    return a


def parse_struct_b(data: bytes) -> StructB:
    if len(data) < 12:
        raise Vc1Error("struct B needs 12 bytes")
    br = BitReader(data)
    b = StructB()
    b.level = br.read(3)
    b.cbr = br.read(1)
    br.read(4)  # res4
    b.hrd_buffer = br.read(24)
    b.hrd_rate = br.read(32)
    b.framerate = br.read(32)
    return b


def parse_sequence_layer(data: bytes) -> SeqLayer:
    """gst_vc1_parse_sequence_layer (gstvc1parser.c:1729-1814): 32-bit
    little-endian words except STRUCT_C (big-endian); structA/structB
    words are byte-swapped to BE before bit-parsing."""
    if len(data) < 36:
        raise Vc1Error("sequence layer needs 36 bytes")
    sl = SeqLayer()
    sl.numframes = int.from_bytes(data[0:3], "little")
    if data[3] != 0xC5:
        raise Vc1Error("sequence layer: missing 0xC5 marker")
    if struct.unpack_from("<I", data, 4)[0] != 0x04:
        raise Vc1Error("sequence layer: bad 0x00000004 word")
    sl.struct_c = parse_struct_c(data[8:12])
    a_words = struct.unpack_from("<II", data, 12)
    sl.struct_a = parse_struct_a(struct.pack(">II", *a_words))
    if struct.unpack_from("<I", data, 20)[0] != 0x0C:
        raise Vc1Error("sequence layer: bad 0x0000000C word")
    b_words = struct.unpack_from("<III", data, 24)
    sl.struct_b = parse_struct_b(struct.pack(">III", *b_words))
    return sl


def _parse_hrd_param(br: BitReader) -> HrdParam:
    h = HrdParam()
    h.hrd_num_leaky_buckets = br.read(5)
    h.bit_rate_exponent = br.read(4)
    h.buffer_size_exponent = br.read(4)
    for _ in range(h.hrd_num_leaky_buckets):
        h.hrd_rate.append(br.read(16))
        h.hrd_buffer.append(br.read(16))
    return h


def _parse_sequence_header_advanced(hdr: SeqHdr, br: BitReader) -> None:
    """parse_sequence_header_advanced (gstvc1parser.c:782-900)."""
    adv = hdr.advanced
    adv.level = br.read(3)
    adv.colordiff_format = br.read(2)
    adv.frmrtq_postproc = br.read(3)
    adv.bitrtq_postproc = br.read(5)
    adv.framerate, adv.bitrate = _framerate_bitrate(adv.frmrtq_postproc,
                                                    adv.bitrtq_postproc)
    adv.postprocflag = br.read(1)
    adv.max_coded_width = (br.read(12) + 1) << 1
    adv.max_coded_height = (br.read(12) + 1) << 1
    hdr._calc_mb(adv.max_coded_width, adv.max_coded_height)
    adv.pulldown = br.read(1)
    adv.interlace = br.read(1)
    adv.tfcntrflag = br.read(1)
    adv.finterpflag = br.read(1)
    br.read(1)  # reserved
    adv.psf = br.read(1)
    adv.display_ext = br.read(1)
    if adv.display_ext:
        adv.disp_horiz_size = br.read(14) + 1
        adv.disp_vert_size = br.read(14) + 1
        adv.aspect_ratio_flag = br.read(1)
        if adv.aspect_ratio_flag:
            adv.aspect_ratio = br.read(4)
            if adv.aspect_ratio == 15:
                adv.aspect_horiz_size = br.read(8)
                adv.aspect_vert_size = br.read(8)
                adv.par_n = 1 + adv.aspect_horiz_size
                adv.par_d = 1 + adv.aspect_vert_size
            else:
                adv.par_n, adv.par_d = ASPECT_RATIOS[adv.aspect_ratio]
        adv.framerate_flag = br.read(1)
        if adv.framerate_flag:
            adv.framerateind = br.read(1)
            if not adv.framerateind:
                adv.frameratenr = br.read(8)
                adv.frameratedr = br.read(4)
            else:
                adv.framerateexp = br.read(16)
            if 0 < adv.frameratenr < 8 and 0 < adv.frameratedr < 3:
                adv.fps_n = FRAMERATES_N[adv.frameratenr]
                adv.fps_d = FRAMERATES_D[adv.frameratedr]
            else:
                adv.fps_n = adv.framerateexp + 1
                adv.fps_d = 32
        adv.color_format_flag = br.read(1)
        if adv.color_format_flag:
            adv.color_prim = br.read(8)
            adv.transfer_char = br.read(8)
            adv.matrix_coef = br.read(8)
    adv.hrd_param_flag = br.read(1)
    if adv.hrd_param_flag:
        adv.hrd_param = _parse_hrd_param(br)


def parse_sequence_header(data: bytes) -> SeqHdr:
    """gst_vc1_parse_sequence_header (gstvc1parser.c:1891-1918)."""
    br = BitReader(data)
    hdr = SeqHdr()
    hdr.struct_c = _parse_struct_c(br)
    hdr.profile = hdr.struct_c.profile
    try:
        if hdr.profile == PROFILE_ADVANCED:
            _parse_sequence_header_advanced(hdr, br)
        else:
            hdr._calc_mb(hdr.struct_c.coded_width,
                         hdr.struct_c.coded_height)
    except ValueError as e:
        raise Vc1Error(f"sequence header truncated: {e}") from e
    return hdr


def parse_entry_point_header(data: bytes, seqhdr: SeqHdr
                             ) -> EntryPointHdr:
    """gst_vc1_parse_entry_point_header (gstvc1parser.c:1925-2000)."""
    br = BitReader(data)
    ep = EntryPointHdr()
    try:
        ep.broken_link = br.read(1)
        ep.closed_entry = br.read(1)
        ep.panscan_flag = br.read(1)
        ep.refdist_flag = br.read(1)
        ep.loopfilter = br.read(1)
        ep.fastuvmc = br.read(1)
        ep.extended_mv = br.read(1)
        ep.dquant = br.read(2)
        ep.vstransform = br.read(1)
        ep.overlap = br.read(1)
        ep.quantizer = br.read(2)
        adv = seqhdr.advanced
        if adv.hrd_param_flag:
            n = adv.hrd_param.hrd_num_leaky_buckets
            if n > MAX_HRD_NUM_LEAKY_BUCKETS:
                raise Vc1Error("too many leaky buckets")
            for _ in range(n):
                ep.hrd_full.append(br.read(8))
        ep.coded_size_flag = br.read(1)
        if ep.coded_size_flag:
            ep.coded_width = br.read(12)
            ep.coded_height = br.read(12)
            ep.coded_height = (ep.coded_height + 1) << 1
            ep.coded_width = (ep.coded_width + 1) << 1
            seqhdr._calc_mb(ep.coded_width, ep.coded_height)
        if ep.extended_mv:
            ep.extended_dmv = br.read(1)
        ep.range_mapy_flag = br.read(1)
        if ep.range_mapy_flag:
            ep.range_mapy = br.read(3)
        ep.range_mapuv_flag = br.read(1)
        if ep.range_mapuv_flag:
            ep.range_mapuv = br.read(3)
    except ValueError as e:
        raise Vc1Error(f"entry point truncated: {e}") from e
    seqhdr.advanced.entrypoint = ep
    return ep


# ---------------------------------------------------------------- BDUs

def scan_start_code(data: bytes, start: int = 0) -> int:
    """Offset of the next 00 00 01 xx start code, or -1
    (scan_for_start_codes, gstvc1parser.c:684-693)."""
    pos = start
    while True:
        pos = data.find(b"\x00\x00\x01", pos)
        if pos < 0 or pos + 3 >= len(data):
            return -1
        return pos


@dataclasses.dataclass
class Bdu:
    type: int = 0
    sc_offset: int = 0      # offset of the start code
    offset: int = 0         # offset of the payload (after 00 00 01 xx)
    size: int = 0           # payload size (excl. next start code)


def identify_next_bdu(data: bytes) -> Optional[Bdu]:
    """gst_vc1_identify_next_bdu (gstvc1parser.c:1663-1716).
    Returns None when no start code is found; size == -1 means the BDU
    end was not found (need more data)."""
    if len(data) < 4:
        raise Vc1Error("buffer too small")
    off1 = scan_start_code(data)
    if off1 < 0:
        return None
    bdu = Bdu()
    bdu.sc_offset = off1
    bdu.offset = off1 + 4
    bdu.type = data[bdu.offset - 1]
    if bdu.type == END_OF_SEQ:
        bdu.size = 0
        return bdu
    off2 = scan_start_code(data, bdu.offset)
    if off2 < 0:
        bdu.size = -1  # NO_BDU_END
    else:
        bdu.size = off2 - bdu.offset
    return bdu


def split_bdus(data: bytes) -> List[Tuple[int, int, int]]:
    """All (type, payload_offset, payload_size) units in data."""
    out = []
    pos = 0
    while pos + 4 <= len(data):
        sc = scan_start_code(data, pos)
        if sc < 0:
            break
        typ = data[sc + 3]
        nxt = scan_start_code(data, sc + 4)
        end = len(data) if nxt < 0 else nxt
        out.append((typ, sc + 4, end - (sc + 4)))
        pos = end
    return out


# ----------------------------------------------------- writers/helpers

def make_struct_c_from_fields(profile: int, c: StructC) -> int:
    """The simple/main STRUCT_C word both make_sequence_layer and the
    ASF codec-data builder assemble (gstvc1parse.c:809-833, 996-1022):
    reserved4 and reserved6 set to one, reserved3/5 zero."""
    v = profile << 30
    if profile != PROFILE_ADVANCED:
        v |= (c.wmvp << 28)
        v |= (c.frmrtq_postproc << 25)
        v |= (c.bitrtq_postproc << 20)
        v |= (c.loop_filter << 19)
        v |= (c.multires << 17)
        v |= (1 << 16)
        v |= (c.fastuvmc << 15)
        v |= (c.extended_mv << 14)
        v |= (c.dquant << 12)
        v |= (c.vstransform << 11)
        v |= (c.overlap << 9)
        v |= (c.syncmarker << 8)
        v |= (c.rangered << 7)
        v |= (c.maxbframes << 4)
        v |= (c.quantizer << 2)
        v |= (c.finterpflag << 1)
        v |= 1
    return v


def max_framerate(profile: int, level: int) -> int:
    """gst_vc1_parse_get_max_framerate (gstvc1parse.c:731-781)."""
    if profile == PROFILE_SIMPLE:
        return {0: 15, 1: 30}[level]
    if profile == PROFILE_MAIN:
        return {0: 24, 1: 30, 2: 30}[level]
    return {0: 30, 1: 30, 2: 60, 3: 60, 4: 60}[level]


def make_sequence_layer(profile: int, struct_c: StructC, width: int,
                        height: int, level: int = -1, fps_n: int = 0,
                        fps_d: int = 0) -> bytes:
    """gst_vc1_parse_make_sequence_layer (gstvc1parse.c:783-874):
    0xFFFFFF frame count + 0xC5, STRUCT_C big-endian, everything else
    little-endian; level defaults to HIGH (0x4); unknown framerate
    writes the profile/level maximum."""
    out = bytearray(36)
    out[0:4] = b"\xff\xff\xff\xc5"
    struct.pack_into("<I", out, 4, 4)
    struct.pack_into(">I", out, 8,
                     make_struct_c_from_fields(profile, struct_c))
    if profile != PROFILE_ADVANCED:
        struct.pack_into("<I", out, 12, height)
        struct.pack_into("<I", out, 16, width)
    struct.pack_into("<I", out, 20, 0x0C)
    out[24:27] = b"\x00\x00\x00"  # unknown HRD_BUFFER
    out[27] = ((level if level != -1 else 0x4) << 5) & 0xFF
    struct.pack_into("<I", out, 28, 0)  # unknown HRD_RATE
    if fps_d == 0:
        rate = max_framerate(profile, level if level != -1 else 0x4 if
                             profile == PROFILE_ADVANCED else 2)
        struct.pack_into("<I", out, 32, rate)
    else:
        struct.pack_into("<I", out, 32, int(fps_n / fps_d + 0.5))
    return bytes(out)


def make_frame_layer_header(frame_size: int, keyframe: bool,
                            timestamp: int) -> bytes:
    """The 8-byte Annex-L frame-layer header
    (gstvc1parse.c:1661-1669): 24-bit LE size, 0x80 keyframe flag,
    32-bit LE timestamp."""
    return frame_size.to_bytes(3, "little") \
        + (b"\x80" if keyframe else b"\x00") \
        + (timestamp & 0xFFFFFFFF).to_bytes(4, "little")


def parse_frame_layer_header(data: bytes) -> Tuple[int, bool, int]:
    """(frame_size, keyframe, timestamp)."""
    if len(data) < 8:
        raise Vc1Error("frame layer header needs 8 bytes")
    size = int.from_bytes(data[0:3], "little")
    keyframe = bool(data[3] & 0x80)
    ts = struct.unpack_from("<I", data, 4)[0]
    return size, keyframe, ts
