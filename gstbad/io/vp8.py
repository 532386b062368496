"""VP8 frame-header parser
(gst-libs/gst/codecparsers/gstvp8parser.c + gstvp8rangedecoder.c /
dboolhuff from RFC 6386).

- BoolDecoder: the RFC 6386 boolean entropy decoder with libvpx's
  64-bit value window and count bookkeeping (dboolhuff.h:60-116:
  split = 1 + ((range-1)*prob >> 8), normalization via the vp8_norm
  shift table, count going VP8_LOTS_OF_BITS past the end) so the
  reported decoder state (range / value / count) matches
  gst_vp8_range_decoder_get_state bit for bit;
- parse_frame_header: the uncompressed data chunk (3-byte frame tag,
  9d 01 2a start code, 14-bit dimensions + scale codes), then the
  first-partition header walk: segmentation, loop-filter adjustments,
  token partitions, quant indices, reference refresh/copy flags,
  token and mv probability updates against the RFC 6386 update
  tables, intra mode probability refreshes, and the DCT partition
  size trailer (gstvp8parser.c:283-505);
- Parser keeps the persistent entropy state across frames exactly
  like GstVp8Parser (probabilities refreshed only when
  refresh_entropy_probs; key frames reset everything).

Errors raise Vp8Error (a ValueError).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from gstbad.io import _vp8_tables as T

VP8_LOTS_OF_BITS = 0x40000000
_BD_VALUE_SIZE = 64  # size_t on the reference's 64-bit targets

# vp8_norm[256] (dboolhuff.c / RFC 6386): leading-zero shift per range
_NORM = [0] * 256
_NORM[1] = 7
for _i in range(2, 4):
    _NORM[_i] = 6
for _i in range(4, 8):
    _NORM[_i] = 5
for _i in range(8, 16):
    _NORM[_i] = 4
for _i in range(16, 32):
    _NORM[_i] = 3
for _i in range(32, 64):
    _NORM[_i] = 2
for _i in range(64, 128):
    _NORM[_i] = 1


class Vp8Error(ValueError):
    pass


class BoolDecoder:
    """BOOL_DECODER (dboolhuff.h) with byte-identical state."""

    def __init__(self, data: bytes):
        self.buf = data
        self.pos = 0            # user_buffer offset
        self.value = 0
        self.count = -8
        self.range = 255
        self._fill()

    def _fill(self):
        """vp8dx_bool_decoder_fill (dboolhuff.c:38-75)."""
        shift = _BD_VALUE_SIZE - 8 - (self.count + 8)
        bits_left = (len(self.buf) - self.pos) * 8
        x = shift + 8 - bits_left
        loop_end = 0
        if x >= 0:
            self.count += VP8_LOTS_OF_BITS
            loop_end = x
        if x < 0 or bits_left:
            while shift >= loop_end:
                self.count += 8
                self.value |= self.buf[self.pos] << shift
                self.value &= (1 << _BD_VALUE_SIZE) - 1
                self.pos += 1
                shift -= 8

    def read(self, prob: int) -> int:
        """vp8dx_decode_bool (dboolhuff.h:60-97)."""
        split = 1 + (((self.range - 1) * prob) >> 8)
        if self.count < 0:
            self._fill()
        bigsplit = split << (_BD_VALUE_SIZE - 8)
        rng = split
        bit = 0
        if self.value >= bigsplit:
            rng = self.range - split
            self.value -= bigsplit
            bit = 1
        shift = _NORM[rng]
        self.range = (rng << shift) & 0xFFFFFFFF
        self.value = (self.value << shift) & ((1 << _BD_VALUE_SIZE) - 1)
        self.count -= shift
        return bit

    def literal(self, bits: int) -> int:
        z = 0
        for b in range(bits - 1, -1, -1):
            z |= self.read(0x80) << b
        return z

    def sint(self, bits: int) -> int:
        v = self.literal(bits)
        if self.literal(1):
            v = -v
        return v

    def get_pos(self) -> int:
        """gst_vp8_range_decoder_get_pos: bits consumed so far."""
        return self.pos * 8 - (8 + self.count)

    def get_state(self):
        """(range, value_msb, count%8) per
        gst_vp8_range_decoder_get_state."""
        if self.count < 0:
            self._fill()
        return (self.range,
                (self.value >> (_BD_VALUE_SIZE - 8)) & 0xFF,
                (8 + self.count) % 8)


# ------------------------------------------------------------- headers

@dataclasses.dataclass
class Segmentation:
    segmentation_enabled: bool = False
    update_mb_segmentation_map: bool = False
    update_segment_feature_data: bool = False
    segment_feature_mode: int = 0
    quantizer_update_value: List[int] = dataclasses.field(
        default_factory=lambda: [0] * 4)
    lf_update_value: List[int] = dataclasses.field(
        default_factory=lambda: [0] * 4)
    segment_prob: List[int] = dataclasses.field(
        default_factory=lambda: [0] * 3)


@dataclasses.dataclass
class MbLfAdjustments:
    loop_filter_adj_enable: bool = False
    mode_ref_lf_delta_update: bool = False
    ref_frame_delta: List[int] = dataclasses.field(
        default_factory=lambda: [0] * 4)
    mb_mode_delta: List[int] = dataclasses.field(
        default_factory=lambda: [0] * 4)


@dataclasses.dataclass
class QuantIndices:
    y_ac_qi: int = 0
    y_dc_delta: int = 0
    y2_dc_delta: int = 0
    y2_ac_delta: int = 0
    uv_dc_delta: int = 0
    uv_ac_delta: int = 0


@dataclasses.dataclass
class ModeProbs:
    y_prob: List[int] = dataclasses.field(default_factory=list)
    uv_prob: List[int] = dataclasses.field(default_factory=list)


def _default_mode_probs(key_frame: bool) -> ModeProbs:
    if key_frame:
        return ModeProbs(list(T.KF_Y_MODE_PROBS),
                         list(T.KF_UV_MODE_PROBS))
    return ModeProbs(list(T.NK_Y_MODE_PROBS), list(T.NK_UV_MODE_PROBS))


@dataclasses.dataclass
class FrameHdr:
    key_frame: bool = False
    version: int = 0
    show_frame: bool = False
    first_part_size: int = 0
    width: int = 0
    height: int = 0
    horiz_scale_code: int = 0
    vert_scale_code: int = 0
    data_chunk_size: int = 0
    color_space: int = 0
    clamping_type: int = 0
    filter_type: int = 0
    loop_filter_level: int = 0
    sharpness_level: int = 0
    log2_nbr_of_dct_partitions: int = 0
    partition_size: List[int] = dataclasses.field(
        default_factory=lambda: [0] * 8)
    quant_indices: QuantIndices = dataclasses.field(
        default_factory=QuantIndices)
    refresh_entropy_probs: bool = False
    refresh_golden_frame: bool = False
    refresh_alternate_frame: bool = False
    refresh_last: bool = False
    copy_buffer_to_golden: int = 0
    copy_buffer_to_alternate: int = 0
    sign_bias_golden: int = 0
    sign_bias_alternate: int = 0
    mb_no_skip_coeff: bool = False
    prob_skip_false: int = 0
    prob_intra: int = 0
    prob_last: int = 0
    prob_gf: int = 0
    mode_probs: ModeProbs = None
    token_probs: List[int] = None   # flattened [4][8][3][11]
    mv_probs: List[int] = None      # flattened [2][19]
    header_size: int = 0
    rd_range: int = 0
    rd_value: int = 0
    rd_count: int = 0


class Parser:
    """GstVp8Parser: persistent cross-frame entropy state."""

    def __init__(self):
        self.init()

    def init(self):
        self.segmentation = Segmentation()
        self.mb_lf_adjust = MbLfAdjustments()
        self.token_probs = list(T.DEFAULT_TOKEN_PROBS)
        self.mv_probs = list(T.DEFAULT_MV_PROBS)
        self.mode_probs = _default_mode_probs(False)

    # -- sub-parsers (gstvp8parser.c:75-250) ---------------------------

    def _parse_update_segmentation(self, bd: BoolDecoder):
        seg = self.segmentation
        seg.update_mb_segmentation_map = False
        seg.update_segment_feature_data = False
        seg.segmentation_enabled = bool(bd.literal(1))
        if not seg.segmentation_enabled:
            return
        seg.update_mb_segmentation_map = bool(bd.literal(1))
        seg.update_segment_feature_data = bool(bd.literal(1))
        if seg.update_segment_feature_data:
            seg.segment_feature_mode = bd.literal(1)
            for i in range(4):
                seg.quantizer_update_value[i] = \
                    bd.sint(7) if bd.literal(1) else 0
            for i in range(4):
                seg.lf_update_value[i] = \
                    bd.sint(6) if bd.literal(1) else 0
        if seg.update_mb_segmentation_map:
            for i in range(3):
                seg.segment_prob[i] = \
                    bd.literal(8) if bd.literal(1) else 255

    def _parse_mb_lf_adjustments(self, bd: BoolDecoder):
        adj = self.mb_lf_adjust
        adj.mode_ref_lf_delta_update = False
        adj.loop_filter_adj_enable = bool(bd.literal(1))
        if not adj.loop_filter_adj_enable:
            return
        adj.mode_ref_lf_delta_update = bool(bd.literal(1))
        if not adj.mode_ref_lf_delta_update:
            return
        for i in range(4):
            if bd.literal(1):
                adj.ref_frame_delta[i] = bd.sint(6)
        for i in range(4):
            if bd.literal(1):
                adj.mb_mode_delta[i] = bd.sint(6)

    @staticmethod
    def _parse_quant_indices(bd: BoolDecoder, q: QuantIndices):
        q.y_ac_qi = bd.literal(7)
        for field in ("y_dc_delta", "y2_dc_delta", "y2_ac_delta",
                      "uv_dc_delta", "uv_ac_delta"):
            setattr(q, field, bd.sint(4) if bd.literal(1) else 0)

    @staticmethod
    def _parse_token_prob_update(bd: BoolDecoder, probs: List[int]):
        for i in range(4 * 8 * 3 * 11):
            if bd.read(T.TOKEN_UPDATE_PROBS[i]):
                probs[i] = bd.literal(8)

    @staticmethod
    def _parse_mv_prob_update(bd: BoolDecoder, probs: List[int]):
        for i in range(2 * 19):
            if bd.read(T.MV_UPDATE_PROBS[i]):
                prob = bd.literal(7)
                probs[i] = (prob << 1) if prob else 1

    # -- the public API -------------------------------------------------

    def parse_frame_header(self, data: bytes) -> FrameHdr:
        hdr = FrameHdr()
        if len(data) < 3:
            raise Vp8Error("frame too short")
        frame_tag = int.from_bytes(data[0:3], "little")
        hdr.key_frame = not (frame_tag & 1)
        hdr.version = (frame_tag >> 1) & 0x07
        hdr.show_frame = bool((frame_tag >> 4) & 1)
        hdr.first_part_size = (frame_tag >> 5) & 0x7FFFF
        pos = 3
        if hdr.key_frame:
            if len(data) < 10:
                raise Vp8Error("key frame too short")
            if data[3:6] != b"\x9d\x01\x2a":
                pass  # the reference only warns
            size_code = int.from_bytes(data[6:8], "little")
            hdr.width = size_code & 0x3FFF
            hdr.horiz_scale_code = size_code >> 14
            size_code = int.from_bytes(data[8:10], "little")
            hdr.height = size_code & 0x3FFF
            hdr.vert_scale_code = size_code >> 14
            pos = 10
            self.init()  # reset parser state on key frames
        hdr.data_chunk_size = pos

        if hdr.first_part_size == 0 \
                or pos + hdr.first_part_size > len(data):
            raise Vp8Error("first partition out of bounds")
        bd = BoolDecoder(data[pos:pos + hdr.first_part_size])

        if hdr.key_frame:
            hdr.color_space = bd.literal(1)
            hdr.clamping_type = bd.literal(1)
        self._parse_update_segmentation(bd)
        hdr.filter_type = bd.literal(1)
        hdr.loop_filter_level = bd.literal(6)
        hdr.sharpness_level = bd.literal(3)
        self._parse_mb_lf_adjustments(bd)
        hdr.log2_nbr_of_dct_partitions = bd.literal(2)
        self._parse_quant_indices(bd, hdr.quant_indices)

        if hdr.key_frame:
            hdr.refresh_entropy_probs = bool(bd.literal(1))
            hdr.refresh_last = True
            hdr.refresh_golden_frame = True
            hdr.refresh_alternate_frame = True
            hdr.mode_probs = _default_mode_probs(True)
        else:
            hdr.refresh_golden_frame = bool(bd.literal(1))
            hdr.refresh_alternate_frame = bool(bd.literal(1))
            if not hdr.refresh_golden_frame:
                hdr.copy_buffer_to_golden = bd.literal(2)
            if not hdr.refresh_alternate_frame:
                hdr.copy_buffer_to_alternate = bd.literal(2)
            hdr.sign_bias_golden = bd.literal(1)
            hdr.sign_bias_alternate = bd.literal(1)
            hdr.refresh_entropy_probs = bool(bd.literal(1))
            hdr.refresh_last = bool(bd.literal(1))
            hdr.mode_probs = ModeProbs(list(self.mode_probs.y_prob),
                                       list(self.mode_probs.uv_prob))
        hdr.token_probs = list(self.token_probs)
        hdr.mv_probs = list(self.mv_probs)

        self._parse_token_prob_update(bd, hdr.token_probs)

        hdr.mb_no_skip_coeff = bool(bd.literal(1))
        if hdr.mb_no_skip_coeff:
            hdr.prob_skip_false = bd.literal(8)

        if not hdr.key_frame:
            hdr.prob_intra = bd.literal(8)
            hdr.prob_last = bd.literal(8)
            hdr.prob_gf = bd.literal(8)
            if bd.literal(1):
                hdr.mode_probs.y_prob = [bd.literal(8)
                                         for _ in range(4)]
            if bd.literal(1):
                hdr.mode_probs.uv_prob = [bd.literal(8)
                                          for _ in range(3)]
            self._parse_mv_prob_update(bd, hdr.mv_probs)

        if hdr.refresh_entropy_probs:
            self.token_probs = list(hdr.token_probs)
            self.mv_probs = list(hdr.mv_probs)
            if not hdr.key_frame:
                self.mode_probs = ModeProbs(
                    list(hdr.mode_probs.y_prob),
                    list(hdr.mode_probs.uv_prob))

        hdr.header_size = bd.get_pos()
        hdr.rd_range, hdr.rd_value, hdr.rd_count = bd.get_state()

        self._calc_partition_sizes(hdr, data[pos:])
        return hdr

    @staticmethod
    def _calc_partition_sizes(hdr: FrameHdr, data: bytes):
        """calc_partition_sizes (gstvp8parser.c:251-282)."""
        num = 1 << hdr.log2_nbr_of_dct_partitions
        ofs = hdr.first_part_size + 3 * (num - 1)
        if ofs > len(data):
            raise Vp8Error("not enough bytes for partition sizes")
        part_ofs = hdr.first_part_size
        for i in range(num - 1):
            size = int.from_bytes(data[part_ofs:part_ofs + 3],
                                  "little")
            part_ofs += 3
            hdr.partition_size[i] = size
            ofs += size
        if ofs > len(data):
            raise Vp8Error("not enough bytes for last partition")
        hdr.partition_size[num - 1] = len(data) - ofs
        for i in range(num, 8):
            hdr.partition_size[i] = 0
