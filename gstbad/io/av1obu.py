"""AV1 OBU-level bitstream parsing (gst/videoparsers/gstav1parse.c
over codecparsers/gstav1parser.c).

Covers the OBU layer the parser element frames with:
  - leb128 read/write, OBU headers (type, extension, has-size) and the
    low-overhead (size-delimited) stream walk;
  - annex-b framing both ways (temporal_unit_size / frame_unit_size /
    obu_length prefixes, has_size_field stripped exactly like
    gst_av1_parse_push_data's annexb writer);
  - sequence-header OBU parse: profile, still picture, operating
    points, frame width/height bits -> max sizes, color config bit
    depth (the upstream test pins 400x300, profile "0", depth 8);
  - temporal-unit grouping at temporal delimiters.

Frame-level alignment parses the uncompressed frame header through
tile_info (gstav1parser.c:3501-4063 gst_av1_parse_uncompressed_frame_
header, :2188 gst_av1_parse_tile_info) plus the tile-group header walk
(:4388 gst_av1_parse_tile_group), so standalone TILE_GROUP OBUs
complete frames exactly like the reference
(gstav1parse.c:1190-1197: tg_end == num_tiles - 1).  The reference
frame store (8 slots: sizes / order hints / frame ids,
gst_av1_parser_reference_frame_update :4259) is carried so
frame_size_with_refs and frame_refs_short_signaling resolve.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from gstbad.io.h264 import BitReader

OBU_SEQUENCE_HEADER = 1
OBU_TEMPORAL_DELIMITER = 2
OBU_FRAME_HEADER = 3
OBU_TILE_GROUP = 4
OBU_METADATA = 5
OBU_FRAME = 6
OBU_REDUNDANT_FRAME_HEADER = 7
OBU_TILE_LIST = 8
OBU_PADDING = 15


def read_leb128(data: bytes, pos: int) -> Tuple[int, int]:
    value = 0
    for i in range(8):
        b = data[pos + i]
        value |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            return value, pos + i + 1
    raise ValueError("leb128 too long")


def write_leb128(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


@dataclass
class Obu:
    obu_type: int
    has_size: bool
    extension: bytes          # 0 or 1 byte
    payload: bytes
    raw: bytes                # header + size field + payload

    def without_size_field(self) -> bytes:
        """Header with has_size cleared + payload (annex-b form)."""
        hdr = bytes([self.raw[0] & ~0x02]) + self.extension
        return hdr + self.payload

    def with_size_field(self) -> bytes:
        hdr = bytes([self.raw[0] | 0x02]) + self.extension
        return hdr + write_leb128(len(self.payload)) + self.payload


def parse_obu(data: bytes, pos: int = 0,
              bounded_size: Optional[int] = None) -> Tuple[Obu, int]:
    """One OBU at pos; bounded_size (annex-b obu_length) covers OBUs
    without a size field."""
    start = pos
    b0 = data[pos]
    if b0 & 0x80:
        raise ValueError("obu forbidden bit set")
    obu_type = (b0 >> 3) & 0x0F
    has_ext = bool(b0 & 0x04)
    has_size = bool(b0 & 0x02)
    pos += 1
    ext = b""
    if has_ext:
        ext = data[pos:pos + 1]
        pos += 1
    if has_size:
        size, pos = read_leb128(data, pos)
    elif bounded_size is not None:
        size = bounded_size - (pos - start)
    else:
        raise ValueError("obu without size in an unbounded stream")
    payload = data[pos:pos + size]
    if len(payload) < size:
        raise ValueError("truncated obu")
    pos += size
    return Obu(obu_type, has_size, ext, payload,
               data[start:pos]), pos


def split_obu_stream(data: bytes) -> List[Obu]:
    """Low-overhead bitstream: size-delimited OBUs back to back."""
    out = []
    pos = 0
    while pos < len(data):
        obu, pos = parse_obu(data, pos)
        out.append(obu)
    return out


def split_annexb(data: bytes) -> List[List[List[Obu]]]:
    """Annex-B: [temporal units [frame units [obus]]]."""
    tus = []
    pos = 0
    while pos < len(data):
        tu_size, pos = read_leb128(data, pos)
        tu_end = pos + tu_size
        frames = []
        while pos < tu_end:
            fu_size, pos = read_leb128(data, pos)
            fu_end = pos + fu_size
            obus = []
            while pos < fu_end:
                obu_len, pos = read_leb128(data, pos)
                obu, pos = parse_obu(data, pos, bounded_size=obu_len)
                obus.append(obu)
            frames.append(obus)
        tus.append(frames)
    return tus


def to_annexb_tu(frames: List[List[Obu]]) -> bytes:
    """One temporal unit in annex-b form (size fields stripped)."""
    body = b""
    for obus in frames:
        fu = b""
        for obu in obus:
            raw = obu.without_size_field()
            fu += write_leb128(len(raw)) + raw
        body += write_leb128(len(fu)) + fu
    return write_leb128(len(body)) + body


SELECT_SCREEN_CONTENT_TOOLS = 2
SELECT_INTEGER_MV = 2
NUM_REF_FRAMES = 8
REFS_PER_FRAME = 7
PRIMARY_REF_NONE = 7
SUPERRES_NUM = 8
SUPERRES_DENOM_MIN = 9
MAX_TILE_WIDTH = 4096
MAX_TILE_AREA = 4096 * 2304
MAX_TILE_COLS = 64
MAX_TILE_ROWS = 64

FRAME_KEY = 0
FRAME_INTER = 1
FRAME_INTRA_ONLY = 2
FRAME_SWITCH = 3


@dataclass
class SequenceHeader:
    profile: int = 0
    still_picture: bool = False
    reduced: bool = False
    level: int = 0
    tier: int = 0
    max_width: int = 0
    max_height: int = 0
    bit_depth: int = 8
    monochrome: bool = False
    frame_width_bits: int = 0
    frame_height_bits: int = 0
    frame_id_numbers_present: bool = False
    delta_frame_id_length: int = 0       # minus_2 + 2
    additional_frame_id_length: int = 0  # minus_1 + 1
    use_128x128_superblock: bool = False
    enable_order_hint: bool = False
    enable_ref_frame_mvs: bool = False
    order_hint_bits: int = 0             # 0 when order hints disabled
    seq_force_screen_content_tools: int = SELECT_SCREEN_CONTENT_TOOLS
    seq_force_integer_mv: int = SELECT_INTEGER_MV
    enable_superres: bool = False
    decoder_model_info_present: bool = False
    equal_picture_interval: bool = False
    buffer_delay_length: int = 0
    buffer_removal_time_length: int = 0
    frame_presentation_time_length: int = 0
    # (idc, decoder_model_present_for_this_op) per operating point
    operating_points: List[Tuple[int, bool]] = field(default_factory=list)


def parse_sequence_header(payload: bytes) -> SequenceHeader:
    """5.5.1 sequence_header_obu (gstav1parser.c:1140)."""
    r = BitReader(payload)
    sh = SequenceHeader()
    sh.profile = r.read(3)
    sh.still_picture = bool(r.read(1))
    reduced = r.read(1)
    sh.reduced = bool(reduced)
    if reduced:
        sh.level = r.read(5)
        sh.operating_points = [(0, False)]
    else:
        timing_info_present = r.read(1)
        decoder_model_info = 0
        if timing_info_present:
            # timing_info: num_units_in_display_tick, time_scale,
            # equal_picture_interval(+uvlc)
            r.read(32)
            r.read(32)
            if r.read(1):
                sh.equal_picture_interval = True
                _read_uvlc(r)
            decoder_model_info = r.read(1)
            if decoder_model_info:
                # 5.5.4 decoder_model_info: buffer_delay_length_minus_1,
                # num_units_in_decoding_tick,
                # buffer_removal_time_length_minus_1,
                # frame_presentation_time_length_minus_1
                sh.decoder_model_info_present = True
                sh.buffer_delay_length = r.read(5) + 1
                r.read(32)
                sh.buffer_removal_time_length = r.read(5) + 1
                sh.frame_presentation_time_length = r.read(5) + 1
        initial_display_delay = r.read(1)
        n_ops = r.read(5) + 1
        for i in range(n_ops):
            idc = r.read(12)  # operating_point_idc
            level = r.read(5)
            tier = r.read(1) if level > 7 else 0
            if i == 0:
                sh.level = level
                sh.tier = tier
            dm_for_op = False
            if timing_info_present and decoder_model_info:
                if r.read(1):  # decoder_model_present_for_op
                    dm_for_op = True
                    n = sh.buffer_delay_length
                    r.read(n)
                    r.read(n)
                    r.read(1)
            if initial_display_delay:
                if r.read(1):
                    r.read(4)
            sh.operating_points.append((idc, dm_for_op))
    wbits = r.read(4) + 1
    hbits = r.read(4) + 1
    sh.frame_width_bits = wbits
    sh.frame_height_bits = hbits
    sh.max_width = r.read(wbits) + 1
    sh.max_height = r.read(hbits) + 1
    if not reduced and r.read(1):  # frame_id_numbers_present
        sh.frame_id_numbers_present = True
        sh.delta_frame_id_length = r.read(4) + 2
        sh.additional_frame_id_length = r.read(3) + 1
    sh.use_128x128_superblock = bool(r.read(1))
    r.read(2)  # enable_filter_intra, enable_intra_edge_filter
    if not reduced:
        r.read(4)  # interintra, masked, warped, dual_filter
        enable_order_hint = r.read(1)
        sh.enable_order_hint = bool(enable_order_hint)
        if enable_order_hint:
            r.read(1)  # enable_jnt_comp
            sh.enable_ref_frame_mvs = bool(r.read(1))
        if r.read(1):  # seq_choose_screen_content_tools
            force_sct = SELECT_SCREEN_CONTENT_TOOLS
        else:
            force_sct = r.read(1)
        sh.seq_force_screen_content_tools = force_sct
        if force_sct > 0:
            if r.read(1):  # seq_choose_integer_mv
                sh.seq_force_integer_mv = SELECT_INTEGER_MV
            else:
                sh.seq_force_integer_mv = r.read(1)
        else:
            sh.seq_force_integer_mv = SELECT_INTEGER_MV
        if enable_order_hint:
            sh.order_hint_bits = r.read(3) + 1
    sh.enable_superres = bool(r.read(1))
    r.read(2)  # enable_cdef, enable_restoration
    # color config
    high = r.read(1)
    if sh.profile == 2 and high:
        sh.bit_depth = 12 if r.read(1) else 10
    else:
        sh.bit_depth = 10 if high else 8
    if sh.profile != 1:
        sh.monochrome = bool(r.read(1))
    return sh


def _read_uvlc(r: BitReader) -> int:
    zeros = 0
    while r.read(1) == 0:
        zeros += 1
        if zeros > 31:
            return (1 << 32) - 1
    if zeros == 0:
        return 0
    return (1 << zeros) - 1 + r.read(zeros)


# --------------------------------------------------------------------
# Uncompressed frame header (through tile_info) + tile groups
# (gstav1parser.c:3501 gst_av1_parse_uncompressed_frame_header,
#  :1814-1966 frame/render/superres/with-refs sizes, :2188 tile_info,
#  :4388 gst_av1_parse_tile_group, :4259 reference_frame_update,
#  :3364 gst_av1_set_frame_refs, :3309 gst_av1_mark_ref_frames).
#
# The parse stops after tile_info: everything the parser element needs
# for frame-level alignment (frame sizes, refresh semantics, the
# reference store, NumTiles and tileBits for standalone TILE_GROUP
# completion) is known by then; quantization/segmentation/loop-filter/
# film-grain syntax that follows only matters to a decoder.
# --------------------------------------------------------------------


@dataclass
class RefFrame:
    valid: bool = False
    frame_id: int = 0
    frame_type: int = FRAME_KEY
    upscaled_width: int = 0
    frame_width: int = 0
    frame_height: int = 0
    render_width: int = 0
    render_height: int = 0
    order_hint: int = 0


@dataclass
class ParserState:
    """The mutable cross-OBU parser context (GstAV1Parser.state)."""
    ref: List[RefFrame] = field(
        default_factory=lambda: [RefFrame() for _ in range(NUM_REF_FRAMES)])
    current_frame_id: int = 0
    prev_frame_id: int = 0
    sequence_changed: bool = True
    begin_first_frame: bool = False
    seen_frame_header: bool = False
    # sizes of the open frame
    frame_width: int = 0
    frame_height: int = 0
    upscaled_width: int = 0
    render_width: int = 0
    render_height: int = 0
    mi_cols: int = 0
    mi_rows: int = 0
    # tile layout of the open frame
    tile_cols: int = 1
    tile_rows: int = 1
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    tile_size_bytes: int = 1
    mi_col_starts: List[int] = field(default_factory=list)
    mi_row_starts: List[int] = field(default_factory=list)


@dataclass
class FrameHeader:
    show_existing_frame: bool = False
    frame_to_show_map_idx: int = 0
    frame_type: int = FRAME_KEY
    frame_is_intra: bool = True
    show_frame: bool = True
    showable_frame: bool = False
    error_resilient_mode: bool = False
    disable_cdf_update: bool = False
    allow_screen_content_tools: int = 0
    force_integer_mv: int = 0
    current_frame_id: int = 0
    frame_size_override_flag: bool = False
    order_hint: int = 0
    primary_ref_frame: int = PRIMARY_REF_NONE
    refresh_frame_flags: int = 0
    ref_frame_idx: List[int] = field(
        default_factory=lambda: [-1] * REFS_PER_FRAME)
    frame_width: int = 0
    frame_height: int = 0
    upscaled_width: int = 0
    render_width: int = 0
    render_height: int = 0
    allow_intrabc: bool = False
    allow_high_precision_mv: bool = False
    interpolation_filter: int = 0
    is_motion_mode_switchable: bool = False
    use_ref_frame_mvs: bool = False
    # tile_info results
    tile_cols: int = 1
    tile_rows: int = 1
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    tile_size_bytes: int = 1
    num_tiles: int = 1
    header_bits: int = 0  # bit position just past tile_info


def _tile_log2(blk_size: int, target: int) -> int:
    k = 0
    while (blk_size << k) < target:
        k += 1
    return k


def _read_ns(r: BitReader, n: int) -> int:
    """4.10.7 ns(n) (av1_bitstreamfn_ns)."""
    w = n.bit_length()  # floor_log2(n) + 1 for n >= 1
    m = (1 << w) - n
    v = r.read(w - 1)
    if v < m:
        return v
    return (v << 1) - m + r.read(1)


def _read_le(r: BitReader, n: int) -> int:
    """4.10.4 le(n): unsigned little-endian n bytes."""
    t = 0
    for i in range(n):
        t |= r.read(8) << (8 * i)
    return t


def _relative_dist(seq: SequenceHeader, a: int, b: int) -> int:
    if not seq.enable_order_hint:
        return 0
    diff = a - b
    m = 1 << (seq.order_hint_bits - 1)
    return (diff & (m - 1)) - (diff & m)


def _superres_and_image_size(r: BitReader, seq: SequenceHeader,
                             st: ParserState, fh: FrameHeader) -> None:
    """5.9.8 superres_params + 5.9.9 compute_image_size."""
    use_superres = r.read(1) if seq.enable_superres else 0
    if use_superres:
        denom = r.read(3) + SUPERRES_DENOM_MIN
    else:
        denom = SUPERRES_NUM
    st.upscaled_width = st.frame_width
    st.frame_width = (st.upscaled_width * SUPERRES_NUM +
                      denom // 2) // denom
    st.mi_cols = 2 * ((st.frame_width + 7) >> 3)
    st.mi_rows = 2 * ((st.frame_height + 7) >> 3)


def _frame_size(r: BitReader, seq: SequenceHeader, st: ParserState,
                fh: FrameHeader) -> None:
    """5.9.5 frame_size."""
    if fh.frame_size_override_flag:
        st.frame_width = r.read(seq.frame_width_bits) + 1
        st.frame_height = r.read(seq.frame_height_bits) + 1
    else:
        st.frame_width = seq.max_width
        st.frame_height = seq.max_height
    _superres_and_image_size(r, seq, st, fh)


def _render_size(r: BitReader, st: ParserState) -> None:
    """5.9.6 render_size."""
    if r.read(1):  # render_and_frame_size_different
        st.render_width = r.read(16) + 1
        st.render_height = r.read(16) + 1
    else:
        st.render_width = st.upscaled_width
        st.render_height = st.frame_height


def _frame_size_with_refs(r: BitReader, seq: SequenceHeader,
                          st: ParserState, fh: FrameHeader) -> None:
    """5.9.7 frame_size_with_refs."""
    found = False
    for i in range(REFS_PER_FRAME):
        if r.read(1):
            ref = st.ref[fh.ref_frame_idx[i]]
            st.upscaled_width = ref.upscaled_width
            st.frame_width = st.upscaled_width
            st.frame_height = ref.frame_height
            st.render_width = ref.render_width
            st.render_height = ref.render_height
            found = True
            break
    if not found:
        _frame_size(r, seq, st, fh)
        _render_size(r, st)
    else:
        _superres_and_image_size(r, seq, st, fh)


def _mark_ref_frames(seq: SequenceHeader, st: ParserState,
                     id_len: int) -> None:
    """5.9.4 mark_ref_frames (gstav1parser.c:3309)."""
    diff_len = seq.delta_frame_id_length
    cur = st.current_frame_id
    for e in st.ref:
        if cur > (1 << diff_len):
            if e.frame_id > cur or e.frame_id < cur - (1 << diff_len):
                e.valid = False
        else:
            if e.frame_id > cur and \
                    e.frame_id < (1 << id_len) + cur - (1 << diff_len):
                e.valid = False


def _set_frame_refs(seq: SequenceHeader, st: ParserState,
                    fh: FrameHeader, last_idx: int,
                    gold_idx: int) -> None:
    """7.8 set_frame_refs (gstav1parser.c:3364) — resolves the 7
    ref_frame_idx slots from last/gold + order hints when
    frame_refs_short_signaling is set."""
    # slots (0-based against REF_LAST_FRAME): LAST=0, LAST2=1, LAST3=2,
    # GOLDEN=3, BWDREF=4, ALTREF2=5, ALTREF=6
    ref_frame_list = [1, 2, 4, 5, 6]  # LAST2, LAST3, BWDREF, ALTREF2, ALTREF
    cur_frame_hint = 1 << (seq.order_hint_bits - 1)
    fh.ref_frame_idx = [-1] * REFS_PER_FRAME
    fh.ref_frame_idx[0] = last_idx
    fh.ref_frame_idx[3] = gold_idx
    used = [False] * NUM_REF_FRAMES
    used[last_idx] = True
    used[gold_idx] = True
    shifted = [cur_frame_hint +
               _relative_dist(seq, st.ref[i].order_hint, fh.order_hint)
               for i in range(NUM_REF_FRAMES)]
    last_order_hint = shifted[last_idx]

    # ALTREF: backward ref with highest output order
    ref = -1
    for i in range(NUM_REF_FRAMES):
        hint = shifted[i]
        if not used[i] and hint >= cur_frame_hint and \
                (ref < 0 or hint >= last_order_hint):
            ref = i
            last_order_hint = hint
    if ref >= 0:
        fh.ref_frame_idx[6] = ref
        used[ref] = True
    # BWDREF: closest backward
    ref = -1
    earliest = last_order_hint
    for i in range(NUM_REF_FRAMES):
        hint = shifted[i]
        if not used[i] and hint >= cur_frame_hint and \
                (ref < 0 or hint < earliest):
            ref = i
            earliest = hint
    if ref >= 0:
        fh.ref_frame_idx[4] = ref
        used[ref] = True
    # ALTREF2: next closest backward
    ref = -1
    earliest = last_order_hint
    for i in range(NUM_REF_FRAMES):
        hint = shifted[i]
        if not used[i] and hint >= cur_frame_hint and \
                (ref < 0 or hint < earliest):
            ref = i
            earliest = hint
    if ref >= 0:
        fh.ref_frame_idx[5] = ref
        used[ref] = True
    # forward refs, anti-chronological
    last_order_hint = 0
    for slot in ref_frame_list:
        if fh.ref_frame_idx[slot] < 0:
            ref = -1
            for j in range(NUM_REF_FRAMES):
                hint = shifted[j]
                if not used[j] and hint < cur_frame_hint and \
                        (ref < 0 or hint >= last_order_hint):
                    ref = j
                    last_order_hint = hint
            if ref >= 0:
                fh.ref_frame_idx[slot] = ref
                used[ref] = True
    # remaining: smallest output order
    ref = -1
    earliest = cur_frame_hint * 2
    for i in range(NUM_REF_FRAMES):
        hint = shifted[i]
        if ref < 0 or hint < earliest:
            ref = i
            earliest = hint
    for i in range(REFS_PER_FRAME):
        if fh.ref_frame_idx[i] < 0:
            fh.ref_frame_idx[i] = ref


def _tile_info(r: BitReader, seq: SequenceHeader, st: ParserState,
               fh: FrameHeader) -> None:
    """5.9.15 tile_info (gstav1parser.c:2188)."""
    if seq.use_128x128_superblock:
        sb_cols = (st.mi_cols + 31) >> 5
        sb_rows = (st.mi_rows + 31) >> 5
        sb_shift = 5
    else:
        sb_cols = (st.mi_cols + 15) >> 4
        sb_rows = (st.mi_rows + 15) >> 4
        sb_shift = 4
    sb_size = sb_shift + 2
    max_tile_width_sb = MAX_TILE_WIDTH >> sb_size
    max_tile_area_sb = MAX_TILE_AREA >> (2 * sb_size)
    min_log2_tile_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_tile_cols = _tile_log2(1, min(sb_cols, MAX_TILE_COLS))
    max_log2_tile_rows = _tile_log2(1, min(sb_rows, MAX_TILE_ROWS))
    min_log2_tiles = max(min_log2_tile_cols,
                         _tile_log2(max_tile_area_sb, sb_rows * sb_cols))

    col_starts: List[int] = []
    row_starts: List[int] = []
    if r.read(1):  # uniform_tile_spacing_flag
        tile_cols_log2 = min_log2_tile_cols
        while tile_cols_log2 < max_log2_tile_cols:
            if r.read(1):
                tile_cols_log2 += 1
            else:
                break
        tile_width_sb = (sb_cols + (1 << tile_cols_log2) - 1) \
            >> tile_cols_log2
        for start_sb in range(0, sb_cols, tile_width_sb):
            col_starts.append(start_sb << sb_shift)
        tile_cols = len(col_starts)
        col_starts.append(st.mi_cols)

        min_log2_tile_rows = max(min_log2_tiles - tile_cols_log2, 0)
        tile_rows_log2 = min_log2_tile_rows
        while tile_rows_log2 < max_log2_tile_rows:
            if r.read(1):
                tile_rows_log2 += 1
            else:
                break
        tile_height_sb = (sb_rows + (1 << tile_rows_log2) - 1) \
            >> tile_rows_log2
        for start_sb in range(0, sb_rows, tile_height_sb):
            row_starts.append(start_sb << sb_shift)
        tile_rows = len(row_starts)
        row_starts.append(st.mi_rows)
    else:
        widest_tile_sb = 0
        start_sb = 0
        while start_sb < sb_cols:
            col_starts.append(start_sb << sb_shift)
            max_width = min(sb_cols - start_sb, max_tile_width_sb)
            size_sb = _read_ns(r, max_width) + 1
            widest_tile_sb = max(size_sb, widest_tile_sb)
            start_sb += size_sb
        tile_cols = len(col_starts)
        col_starts.append(st.mi_cols)
        tile_cols_log2 = _tile_log2(1, tile_cols)

        if min_log2_tiles > 0:
            max_tile_area_sb = (sb_rows * sb_cols) >> (min_log2_tiles + 1)
        else:
            max_tile_area_sb = sb_rows * sb_cols
        max_tile_height_sb = max(max_tile_area_sb // widest_tile_sb, 1)

        start_sb = 0
        while start_sb < sb_rows:
            row_starts.append(start_sb << sb_shift)
            max_height = min(sb_rows - start_sb, max_tile_height_sb)
            size_sb = _read_ns(r, max_height) + 1
            start_sb += size_sb
        tile_rows = len(row_starts)
        row_starts.append(st.mi_rows)
        tile_rows_log2 = _tile_log2(1, tile_rows)

    if tile_cols_log2 > 0 or tile_rows_log2 > 0:
        r.read(tile_cols_log2 + tile_rows_log2)  # context_update_tile_id
        st.tile_size_bytes = r.read(2) + 1
    st.tile_cols = tile_cols
    st.tile_rows = tile_rows
    st.tile_cols_log2 = tile_cols_log2
    st.tile_rows_log2 = tile_rows_log2
    st.mi_col_starts = col_starts
    st.mi_row_starts = row_starts
    fh.tile_cols = tile_cols
    fh.tile_rows = tile_rows
    fh.tile_cols_log2 = tile_cols_log2
    fh.tile_rows_log2 = tile_rows_log2
    fh.tile_size_bytes = st.tile_size_bytes
    fh.num_tiles = tile_cols * tile_rows


def parse_frame_header(obu: Obu, seq: SequenceHeader,
                       st: ParserState) -> FrameHeader:
    """5.9.2 uncompressed_header through tile_info
    (gstav1parser.c:3501-4063), with the cross-frame reference-store
    and frame-id state transcribed.  Raises ValueError on the
    bitstream violations the reference rejects."""
    if seq is None:
        raise ValueError("frame header before sequence header")
    r = BitReader(obu.payload)
    fh = FrameHeader()
    temporal_id = obu.extension[0] >> 5 if obu.extension else 0
    spatial_id = (obu.extension[0] >> 3) & 3 if obu.extension else 0

    id_len = 0
    if seq.frame_id_numbers_present:
        id_len = seq.additional_frame_id_length + seq.delta_frame_id_length
    all_frames = (1 << NUM_REF_FRAMES) - 1

    if seq.reduced:
        fh.show_existing_frame = False
        fh.frame_type = FRAME_KEY
        fh.frame_is_intra = True
        fh.show_frame = True
        fh.showable_frame = False
        if st.sequence_changed:
            st.sequence_changed = False
            st.begin_first_frame = True
    else:
        fh.show_existing_frame = bool(r.read(1))
        if fh.show_existing_frame:
            if st.sequence_changed:
                raise ValueError(
                    "new sequence starts with show_existing_frame")
            fh.frame_to_show_map_idx = r.read(3)
            ref = st.ref[fh.frame_to_show_map_idx]
            if not ref.valid:
                raise ValueError("frame_to_show is invalid")
            if seq.decoder_model_info_present and \
                    not seq.equal_picture_interval:
                r.read(seq.frame_presentation_time_length)
            fh.refresh_frame_flags = 0
            if seq.frame_id_numbers_present:
                display_frame_id = r.read(id_len)
                if display_frame_id != ref.frame_id:
                    raise ValueError("reference frame id mismatch")
            fh.frame_type = ref.frame_type
            if fh.frame_type == FRAME_KEY:
                fh.refresh_frame_flags = all_frames
            # Reproduced reference quirk (gstav1parser.c show_existing
            # path: memset + goto success): current_frame_id and
            # order_hint are NOT copied from the shown ref slot and stay
            # 0, so reference_frame_update after a show-existing KEY
            # frame stamps frame_id=0/order_hint=0 into all 8 slots —
            # diverging from spec 7.21 load semantics, faithfully.
            fh.frame_width = ref.frame_width
            fh.frame_height = ref.frame_height
            fh.upscaled_width = ref.upscaled_width
            fh.render_width = ref.render_width
            fh.render_height = ref.render_height
            fh.header_bits = r.pos
            st.seen_frame_header = False
            return fh

        fh.frame_type = r.read(2)
        if st.sequence_changed:
            if fh.frame_type == FRAME_KEY:
                st.sequence_changed = False
                st.begin_first_frame = True
            else:
                raise ValueError("sequence changed without a keyframe")
        fh.frame_is_intra = fh.frame_type in (FRAME_INTRA_ONLY, FRAME_KEY)
        fh.show_frame = bool(r.read(1))
        if seq.still_picture and (fh.frame_type != FRAME_KEY
                                  or not fh.show_frame):
            raise ValueError("still pictures must be shown keyframes")
        if fh.show_frame and seq.decoder_model_info_present and \
                not seq.equal_picture_interval:
            r.read(seq.frame_presentation_time_length)
        if fh.show_frame:
            fh.showable_frame = fh.frame_type != FRAME_KEY
        else:
            fh.showable_frame = bool(r.read(1))
        if fh.frame_type == FRAME_SWITCH or \
                (fh.frame_type == FRAME_KEY and fh.show_frame):
            fh.error_resilient_mode = True
        else:
            fh.error_resilient_mode = bool(r.read(1))

    if fh.frame_type == FRAME_KEY and fh.show_frame:
        for e in st.ref:
            e.valid = False
            e.order_hint = 0

    fh.disable_cdf_update = bool(r.read(1))
    if seq.seq_force_screen_content_tools == SELECT_SCREEN_CONTENT_TOOLS:
        fh.allow_screen_content_tools = r.read(1)
    else:
        fh.allow_screen_content_tools = seq.seq_force_screen_content_tools
    if fh.allow_screen_content_tools:
        if seq.seq_force_integer_mv == SELECT_INTEGER_MV:
            fh.force_integer_mv = r.read(1)
        else:
            fh.force_integer_mv = seq.seq_force_integer_mv
    else:
        fh.force_integer_mv = 0
    if fh.frame_is_intra:
        fh.force_integer_mv = 1

    if seq.frame_id_numbers_present:
        have_prev = (not st.begin_first_frame and
                     not (fh.frame_type == FRAME_KEY and fh.show_frame))
        if have_prev:
            st.prev_frame_id = st.current_frame_id
        fh.current_frame_id = r.read(id_len)
        st.current_frame_id = fh.current_frame_id
        if have_prev:
            if st.current_frame_id > st.prev_frame_id:
                diff = st.current_frame_id - st.prev_frame_id
            else:
                diff = ((1 << id_len) + st.current_frame_id
                        - st.prev_frame_id)
            if st.current_frame_id == st.prev_frame_id or \
                    diff >= (1 << (id_len - 1)):
                raise ValueError("invalid current_frame_id")
        _mark_ref_frames(seq, st, id_len)
    else:
        fh.current_frame_id = 0
        st.prev_frame_id = st.current_frame_id
        st.current_frame_id = 0

    if fh.frame_type == FRAME_SWITCH:
        fh.frame_size_override_flag = True
    elif seq.reduced:
        fh.frame_size_override_flag = False
    else:
        fh.frame_size_override_flag = bool(r.read(1))

    fh.order_hint = r.read(seq.order_hint_bits)
    if fh.frame_is_intra or fh.error_resilient_mode:
        fh.primary_ref_frame = PRIMARY_REF_NONE
    else:
        fh.primary_ref_frame = r.read(3)

    if seq.decoder_model_info_present:
        if r.read(1):  # buffer_removal_time_present_flag
            for idc, dm_present in seq.operating_points:
                if not dm_present:
                    continue
                in_temporal = (idc >> temporal_id) & 1
                in_spatial = (idc >> (spatial_id + 8)) & 1
                if idc == 0 or (in_temporal and in_spatial):
                    r.read(seq.buffer_removal_time_length)

    if fh.frame_type == FRAME_SWITCH or \
            (fh.frame_type == FRAME_KEY and fh.show_frame):
        fh.refresh_frame_flags = all_frames
    else:
        fh.refresh_frame_flags = r.read(8)
    if fh.frame_type == FRAME_INTRA_ONLY and \
            fh.refresh_frame_flags == 0xFF:
        raise ValueError("intra-only frame with refresh 0xFF")

    if not fh.frame_is_intra or fh.refresh_frame_flags != all_frames:
        if fh.error_resilient_mode and seq.enable_order_hint:
            for i in range(NUM_REF_FRAMES):
                hint = r.read(seq.order_hint_bits)
                if hint != st.ref[i].order_hint:
                    st.ref[i].valid = False

    if fh.frame_is_intra:
        _frame_size(r, seq, st, fh)
        _render_size(r, st)
        if fh.allow_screen_content_tools and \
                st.upscaled_width == st.frame_width:
            fh.allow_intrabc = bool(r.read(1))
    else:
        frame_refs_short_signaling = False
        if seq.enable_order_hint:
            frame_refs_short_signaling = bool(r.read(1))
            if frame_refs_short_signaling:
                last_idx = r.read(3)
                gold_idx = r.read(3)
                _set_frame_refs(seq, st, fh, last_idx, gold_idx)
        for i in range(REFS_PER_FRAME):
            if not frame_refs_short_signaling:
                fh.ref_frame_idx[i] = r.read(3)
            if seq.frame_id_numbers_present:
                delta_id = r.read(seq.delta_frame_id_length) + 1
                expected = (fh.current_frame_id + (1 << id_len)
                            - delta_id) % (1 << id_len)
                if expected != st.ref[fh.ref_frame_idx[i]].frame_id:
                    raise ValueError("reference buffer frame id mismatch")
        if fh.frame_size_override_flag and not fh.error_resilient_mode:
            _frame_size_with_refs(r, seq, st, fh)
        else:
            _frame_size(r, seq, st, fh)
            _render_size(r, st)
        if fh.force_integer_mv:
            fh.allow_high_precision_mv = False
        else:
            fh.allow_high_precision_mv = bool(r.read(1))
        if r.read(1):  # is_filter_switchable
            fh.interpolation_filter = 4  # SWITCHABLE
        else:
            fh.interpolation_filter = r.read(2)
        fh.is_motion_mode_switchable = bool(r.read(1))
        if fh.error_resilient_mode or not seq.enable_ref_frame_mvs:
            fh.use_ref_frame_mvs = False
        else:
            fh.use_ref_frame_mvs = bool(r.read(1))

    fh.upscaled_width = st.upscaled_width
    fh.frame_width = st.frame_width
    fh.frame_height = st.frame_height
    fh.render_width = st.render_width
    fh.render_height = st.render_height

    if not (seq.reduced or fh.disable_cdf_update):
        r.read(1)  # disable_frame_end_update_cdf

    if fh.primary_ref_frame != PRIMARY_REF_NONE and \
            not st.ref[fh.ref_frame_idx[fh.primary_ref_frame]].valid:
        raise ValueError("primary ref points at an invalid frame")

    _tile_info(r, seq, st, fh)
    fh.header_bits = r.pos
    st.seen_frame_header = not fh.show_existing_frame
    return fh


def reference_frame_update(st: ParserState, fh: FrameHeader) -> None:
    """7.20 reference_frame_update
    (gstav1parser.c:4259, the fields the parse consumes)."""
    if fh.frame_type == FRAME_INTRA_ONLY and \
            fh.refresh_frame_flags == 0xFF:
        raise ValueError("intra-only frame with refresh 0xFF")
    for i in range(NUM_REF_FRAMES):
        if (fh.refresh_frame_flags >> i) & 1:
            e = st.ref[i]
            e.valid = True
            e.frame_id = fh.current_frame_id
            e.frame_type = fh.frame_type
            e.upscaled_width = fh.upscaled_width
            e.frame_width = fh.frame_width
            e.frame_height = fh.frame_height
            e.render_width = fh.render_width
            e.render_height = fh.render_height
            e.order_hint = fh.order_hint


@dataclass
class TileGroup:
    num_tiles: int
    tg_start: int
    tg_end: int
    # (tile_num, byte offset into the payload, byte size) per tile
    entries: List[Tuple[int, int, int]] = field(default_factory=list)


def parse_tile_group(payload: bytes, st: ParserState) -> TileGroup:
    """5.11.1 tile_group_obu header + the tile-size walk
    (gstav1parser.c:4388)."""
    if not st.seen_frame_header:
        raise ValueError("tile group without a frame header")
    r = BitReader(payload)
    num_tiles = st.tile_cols * st.tile_rows
    present = False
    if num_tiles > 1:
        present = bool(r.read(1))
    if num_tiles == 1 or not present:
        tg_start, tg_end = 0, num_tiles - 1
    else:
        tile_bits = st.tile_cols_log2 + st.tile_rows_log2
        tg_start = r.read(tile_bits)
        tg_end = r.read(tile_bits)
    if tg_end < tg_start:
        raise ValueError("tg_end < tg_start")
    # byte_alignment()
    while r.pos & 7:
        r.read(1)
    sz = len(payload) - (r.pos >> 3)
    tg = TileGroup(num_tiles, tg_start, tg_end)
    for tile_num in range(tg_start, tg_end + 1):
        if tile_num == tg_end:
            tile_size = sz
        else:
            tile_size = _read_le(r, st.tile_size_bytes) + 1
            sz -= tile_size + st.tile_size_bytes
            if sz < 0:
                raise ValueError("tile sizes exceed the obu")
        tg.entries.append((tile_num, r.pos >> 3, tile_size))
        if tile_num < tg_end:
            if (r.pos >> 3) + tile_size > len(payload):
                raise ValueError("truncated tile")
            r.pos += tile_size * 8
    if tg_end == num_tiles - 1:
        st.seen_frame_header = False
    return tg
