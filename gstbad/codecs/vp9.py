"""VP9 stateful parser + stateless-decoder base layer
(gst-libs/gst/codecs/gstvp9statefulparser.c + gstvp9decoder.c).

The stateful parser owns the cross-frame uncompressed-header state the
plain per-frame parser cannot carry:

- loop-filter ref/mode deltas that persist until updated
  (parse_loop_filter_params, gstvp9statefulparser.c:592-622);
- segmentation tree/pred probs and per-segment feature data with
  abs-or-delta semantics (parse_segmentation_params, :685-760);
- setup_past_independence resets on intra/error-resilient frames
  (:822-846, spec 7.2);
- color config inheritance for inter frames (:1002-1008);
- per-slot reference width/height for frame_size_with_refs
  (:532-566, :1081-1088).

The decoder layer (gstvp9decoder.c) is the 8-slot ref_frame_map:
refresh_frame_flags slot replacement (keyframes refresh all —
gstvp9picture.c:161-187 gst_vp9_dpb_add), show_existing_frame
duplication (:317-345) and show_frame-gated output (:392-401).
Derived helpers gst_vp9_get_qindex/dc_quant/ac_quant (:1108-1223)
compute per-segment dequantizers.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import List, Optional

from gstbad.data import vp9_quant_tables as qt
from gstbad.io.h264 import BitReader

FRAME_MARKER = 2
SYNC_CODE = 0x498342

KEY_FRAME = 0
INTER_FRAME = 1

CS_SRGB = 7
CR_FULL = 1
CR_LIMITED = 0
CS_BT_601 = 2

REFS_PER_FRAME = 3
REF_FRAMES = 8
MAX_REF_LF_DELTAS = 4
MAX_MODE_LF_DELTAS = 2
MAX_SEGMENTS = 8
SEG_TREE_PROBS = 7
PREDICTION_PROBS = 3
MAX_PROB = 255

SEG_LVL_ALT_Q = 0
SEG_LVL_ALT_L = 1
SEG_LVL_REF_FRAME = 2
SEG_LVL_SKIP = 3
SEG_LVL_MAX = 4

# ref slot names within loop_filter_ref_deltas
REF_FRAME_INTRA = 0
REF_FRAME_LAST = 1
REF_FRAME_GOLDEN = 2
REF_FRAME_ALTREF = 3


class Vp9ParseError(ValueError):
    pass


def _sread(r: BitReader, bits: int) -> int:
    """VP9_READ_SIGNED_N: magnitude then sign bit."""
    value = r.read(bits)
    return -value if r.read(1) else value


@dataclass
class LoopFilterParams:
    loop_filter_level: int = 0
    loop_filter_sharpness: int = 0
    loop_filter_delta_enabled: int = 0
    loop_filter_delta_update: int = 0
    update_ref_delta: List[int] = dfield(
        default_factory=lambda: [0] * MAX_REF_LF_DELTAS)
    loop_filter_ref_deltas: List[int] = dfield(
        default_factory=lambda: [0] * MAX_REF_LF_DELTAS)
    update_mode_delta: List[int] = dfield(
        default_factory=lambda: [0] * MAX_MODE_LF_DELTAS)
    loop_filter_mode_deltas: List[int] = dfield(
        default_factory=lambda: [0] * MAX_MODE_LF_DELTAS)

    def copy(self) -> "LoopFilterParams":
        return LoopFilterParams(
            self.loop_filter_level, self.loop_filter_sharpness,
            self.loop_filter_delta_enabled, self.loop_filter_delta_update,
            list(self.update_ref_delta), list(self.loop_filter_ref_deltas),
            list(self.update_mode_delta),
            list(self.loop_filter_mode_deltas))


@dataclass
class QuantizationParams:
    base_q_idx: int = 0
    delta_q_y_dc: int = 0
    delta_q_uv_dc: int = 0
    delta_q_uv_ac: int = 0


@dataclass
class SegmentationParams:
    segmentation_enabled: int = 0
    segmentation_update_map: int = 0
    segmentation_temporal_update: int = 0
    segmentation_update_data: int = 0
    segmentation_abs_or_delta_update: int = 0
    segmentation_tree_probs: List[int] = dfield(
        default_factory=lambda: [0] * SEG_TREE_PROBS)
    segmentation_pred_prob: List[int] = dfield(
        default_factory=lambda: [0] * PREDICTION_PROBS)
    feature_enabled: List[List[int]] = dfield(
        default_factory=lambda: [[0] * SEG_LVL_MAX
                                 for _ in range(MAX_SEGMENTS)])
    feature_data: List[List[int]] = dfield(
        default_factory=lambda: [[0] * SEG_LVL_MAX
                                 for _ in range(MAX_SEGMENTS)])

    def copy(self) -> "SegmentationParams":
        return SegmentationParams(
            self.segmentation_enabled, self.segmentation_update_map,
            self.segmentation_temporal_update,
            self.segmentation_update_data,
            self.segmentation_abs_or_delta_update,
            list(self.segmentation_tree_probs),
            list(self.segmentation_pred_prob),
            [list(x) for x in self.feature_enabled],
            [list(x) for x in self.feature_data])


@dataclass
class FrameHeader:
    profile: int = 0
    show_existing_frame: int = 0
    frame_to_show_map_idx: int = 0
    frame_type: int = KEY_FRAME
    show_frame: int = 0
    error_resilient_mode: int = 0
    intra_only: int = 0
    reset_frame_context: int = 0
    bit_depth: int = 8
    color_space: int = 0
    color_range: int = 0
    subsampling_x: int = 1
    subsampling_y: int = 1
    width: int = 0
    height: int = 0
    render_and_frame_size_different: int = 0
    render_width: int = 0
    render_height: int = 0
    refresh_frame_flags: int = 0
    ref_frame_idx: List[int] = dfield(
        default_factory=lambda: [0] * REFS_PER_FRAME)
    ref_frame_sign_bias: List[int] = dfield(
        default_factory=lambda: [0] * 4)
    allow_high_precision_mv: int = 0
    interpolation_filter: int = 0
    refresh_frame_context: int = 0
    frame_parallel_decoding_mode: int = 0
    frame_context_idx: int = 0
    loop_filter_params: LoopFilterParams = dfield(
        default_factory=LoopFilterParams)
    quantization_params: QuantizationParams = dfield(
        default_factory=QuantizationParams)
    segmentation_params: SegmentationParams = dfield(
        default_factory=SegmentationParams)
    lossless_flag: bool = False
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    header_size_in_bytes: int = 0
    frame_header_length_in_bytes: int = 0


# interpolation filter map (gstvp9statefulparser.c:567-591)
FILTER_EIGHTTAP_SMOOTH = 1
FILTER_EIGHTTAP = 0
FILTER_EIGHTTAP_SHARP = 2
FILTER_BILINEAR = 3
FILTER_SWITCHABLE = 4
_FILTER_MAP = [FILTER_EIGHTTAP_SMOOTH, FILTER_EIGHTTAP,
               FILTER_EIGHTTAP_SHARP, FILTER_BILINEAR]


class Vp9StatefulParser:
    """GstVp9StatefulParser."""

    def __init__(self) -> None:
        self.loop_filter_params = LoopFilterParams()
        self.segmentation_params = SegmentationParams()
        self.bit_depth = 8
        self.color_space = 0
        self.color_range = 0
        self.subsampling_x = 1
        self.subsampling_y = 1
        self.mi_cols = 0
        self.mi_rows = 0
        self.sb64_cols = 0
        self.sb64_rows = 0
        # per-slot (width, height)
        self.reference = [(0, 0)] * REF_FRAMES

    # -------------------------------------------------------- pieces

    def _parse_color_config(self, r: BitReader,
                            hdr: FrameHeader) -> None:
        if hdr.profile >= 2:
            hdr.bit_depth = 12 if r.read(1) else 10
        else:
            hdr.bit_depth = 8
        hdr.color_space = r.read(3)
        if hdr.color_space != CS_SRGB:
            hdr.color_range = r.read(1)
            if hdr.profile in (1, 3):
                hdr.subsampling_x = r.read(1)
                hdr.subsampling_y = r.read(1)
                if hdr.subsampling_x == 1 and hdr.subsampling_y == 1:
                    raise Vp9ParseError(
                        "4:2:0 not allowed in profile 1/3")
                r.read(1)
            else:
                hdr.subsampling_x = hdr.subsampling_y = 1
        else:
            hdr.color_range = CR_FULL
            if hdr.profile in (1, 3):
                r.read(1)
                hdr.subsampling_x = hdr.subsampling_y = 0
            else:
                raise Vp9ParseError("4:4:4 not allowed in profile 0/2")
        self.bit_depth = hdr.bit_depth
        self.color_space = hdr.color_space
        self.subsampling_x = hdr.subsampling_x
        self.subsampling_y = hdr.subsampling_y
        self.color_range = hdr.color_range

    def _compute_image_size(self, width: int, height: int) -> None:
        self.mi_cols = (width + 7) >> 3
        self.mi_rows = (height + 7) >> 3
        self.sb64_cols = (self.mi_cols + 7) >> 3
        self.sb64_rows = (self.mi_rows + 7) >> 3

    def _parse_frame_size(self, r: BitReader):
        w = r.read(16) + 1
        h = r.read(16) + 1
        self._compute_image_size(w, h)
        return w, h

    def _parse_render_size(self, r: BitReader, hdr: FrameHeader) -> None:
        hdr.render_and_frame_size_different = r.read(1)
        if hdr.render_and_frame_size_different:
            hdr.render_width = r.read(16) + 1
            hdr.render_height = r.read(16) + 1
        else:
            hdr.render_width = hdr.width
            hdr.render_height = hdr.height

    def _parse_frame_size_with_refs(self, r: BitReader,
                                    hdr: FrameHeader) -> None:
        found = 0
        for i in range(REFS_PER_FRAME):
            found = r.read(1)
            if found:
                idx = hdr.ref_frame_idx[i]
                hdr.width, hdr.height = self.reference[idx]
                break
        if not found:
            hdr.width, hdr.height = self._parse_frame_size(r)
        else:
            self._compute_image_size(hdr.width, hdr.height)
        self._parse_render_size(r, hdr)

    def _parse_loop_filter_params(self, r: BitReader) -> None:
        p = self.loop_filter_params
        p.loop_filter_level = r.read(6)
        p.loop_filter_sharpness = r.read(3)
        p.loop_filter_delta_enabled = r.read(1)
        if p.loop_filter_delta_enabled:
            p.loop_filter_delta_update = r.read(1)
            if p.loop_filter_delta_update:
                for i in range(MAX_REF_LF_DELTAS):
                    p.update_ref_delta[i] = r.read(1)
                    if p.update_ref_delta[i]:
                        p.loop_filter_ref_deltas[i] = _sread(r, 6)
                for i in range(MAX_MODE_LF_DELTAS):
                    p.update_mode_delta[i] = r.read(1)
                    if p.update_mode_delta[i]:
                        p.loop_filter_mode_deltas[i] = _sread(r, 6)

    @staticmethod
    def _parse_delta_q(r: BitReader) -> int:
        if not r.read(1):
            return 0
        return _sread(r, 4)

    def _parse_quantization_params(self, r: BitReader,
                                   hdr: FrameHeader) -> None:
        q = hdr.quantization_params
        q.base_q_idx = r.read(8)
        q.delta_q_y_dc = self._parse_delta_q(r)
        q.delta_q_uv_dc = self._parse_delta_q(r)
        q.delta_q_uv_ac = self._parse_delta_q(r)
        hdr.lossless_flag = (q.base_q_idx == 0 and q.delta_q_y_dc == 0
                             and q.delta_q_uv_dc == 0
                             and q.delta_q_uv_ac == 0)

    @staticmethod
    def _read_prob(r: BitReader) -> int:
        return r.read(8) if r.read(1) else MAX_PROB

    def _parse_segmentation_params(self, r: BitReader) -> None:
        p = self.segmentation_params
        p.segmentation_update_map = 0
        p.segmentation_update_data = 0
        p.segmentation_temporal_update = 0
        p.segmentation_enabled = r.read(1)
        if not p.segmentation_enabled:
            return
        p.segmentation_update_map = r.read(1)
        if p.segmentation_update_map:
            for i in range(SEG_TREE_PROBS):
                p.segmentation_tree_probs[i] = self._read_prob(r)
            p.segmentation_temporal_update = r.read(1)
            if p.segmentation_temporal_update:
                for i in range(PREDICTION_PROBS):
                    p.segmentation_pred_prob[i] = self._read_prob(r)
            else:
                p.segmentation_pred_prob = [MAX_PROB] * PREDICTION_PROBS
        p.segmentation_update_data = r.read(1)
        if p.segmentation_update_data:
            p.segmentation_abs_or_delta_update = r.read(1)
            for i in range(MAX_SEGMENTS):
                p.feature_enabled[i][SEG_LVL_ALT_Q] = r.read(1)
                p.feature_data[i][SEG_LVL_ALT_Q] = (
                    _sread(r, 8) if p.feature_enabled[i][SEG_LVL_ALT_Q]
                    else 0)
                p.feature_enabled[i][SEG_LVL_ALT_L] = r.read(1)
                p.feature_data[i][SEG_LVL_ALT_L] = (
                    _sread(r, 6) if p.feature_enabled[i][SEG_LVL_ALT_L]
                    else 0)
                p.feature_enabled[i][SEG_LVL_REF_FRAME] = r.read(1)
                p.feature_data[i][SEG_LVL_REF_FRAME] = (
                    r.read(2)
                    if p.feature_enabled[i][SEG_LVL_REF_FRAME] else 0)
                p.feature_enabled[i][SEG_LVL_SKIP] = r.read(1)

    def _parse_tile_info(self, r: BitReader, hdr: FrameHeader) -> None:
        min_log2 = 0
        while (64 << min_log2) < self.sb64_cols:
            min_log2 += 1
        max_log2 = 1
        while (self.sb64_cols >> max_log2) >= 4:
            max_log2 += 1
        max_log2 -= 1
        hdr.tile_cols_log2 = min_log2
        while hdr.tile_cols_log2 < max_log2:
            if r.read(1):
                hdr.tile_cols_log2 += 1
            else:
                break
        if hdr.tile_cols_log2 > 6:
            raise Vp9ParseError("invalid tile columns")
        hdr.tile_rows_log2 = r.read(1)
        if hdr.tile_rows_log2:
            hdr.tile_rows_log2 += r.read(1)

    def _setup_past_independence(self, hdr: FrameHeader) -> None:
        """spec 7.2 (gstvp9statefulparser.c:822-846)."""
        sp = self.segmentation_params
        sp.feature_enabled = [[0] * SEG_LVL_MAX
                              for _ in range(MAX_SEGMENTS)]
        sp.feature_data = [[0] * SEG_LVL_MAX for _ in range(MAX_SEGMENTS)]
        sp.segmentation_abs_or_delta_update = 0
        lf = self.loop_filter_params
        lf.loop_filter_delta_enabled = 1
        lf.loop_filter_ref_deltas[REF_FRAME_INTRA] = 1
        lf.loop_filter_ref_deltas[REF_FRAME_LAST] = 0
        lf.loop_filter_ref_deltas[REF_FRAME_GOLDEN] = -1
        lf.loop_filter_ref_deltas[REF_FRAME_ALTREF] = -1
        lf.loop_filter_mode_deltas = [0] * MAX_MODE_LF_DELTAS
        hdr.ref_frame_sign_bias = [0] * 4

    # ---------------------------------------------------------- main

    def parse_frame_header(self, data: bytes) -> FrameHeader:
        """gstvp9statefulparser.c:894-1105
        gst_vp9_stateful_parser_parse_frame_header."""
        r = BitReader(data)
        hdr = FrameHeader()
        if r.read(2) != FRAME_MARKER:
            raise Vp9ParseError("bad frame marker")
        low = r.read(1)
        high = r.read(1)
        hdr.profile = (high << 1) | low
        if hdr.profile == 3:
            r.read(1)
        hdr.show_existing_frame = r.read(1)
        if hdr.show_existing_frame:
            hdr.frame_to_show_map_idx = r.read(3)
            return hdr
        hdr.frame_type = r.read(1)
        hdr.show_frame = r.read(1)
        hdr.error_resilient_mode = r.read(1)
        frame_is_intra = False
        if hdr.frame_type == KEY_FRAME:
            if r.read(24) != SYNC_CODE:
                raise Vp9ParseError("bad sync code")
            self._parse_color_config(r, hdr)
            hdr.width, hdr.height = self._parse_frame_size(r)
            self._parse_render_size(r, hdr)
            hdr.refresh_frame_flags = 0xFF
            frame_is_intra = True
        else:
            if hdr.show_frame == 0:
                hdr.intra_only = r.read(1)
            frame_is_intra = bool(hdr.intra_only)
            if hdr.error_resilient_mode == 0:
                hdr.reset_frame_context = r.read(2)
            if hdr.intra_only:
                if r.read(24) != SYNC_CODE:
                    raise Vp9ParseError("bad sync code")
                if hdr.profile > 0:
                    self._parse_color_config(r, hdr)
                else:
                    self.color_space = hdr.color_space = CS_BT_601
                    self.color_range = hdr.color_range = CR_LIMITED
                    self.subsampling_x = self.subsampling_y = 1
                    hdr.subsampling_x = hdr.subsampling_y = 1
                    self.bit_depth = hdr.bit_depth = 8
                hdr.refresh_frame_flags = r.read(8)
                hdr.width, hdr.height = self._parse_frame_size(r)
                self._parse_render_size(r, hdr)
            else:
                hdr.color_space = self.color_space
                hdr.color_range = self.color_range
                hdr.subsampling_x = self.subsampling_x
                hdr.subsampling_y = self.subsampling_y
                hdr.bit_depth = self.bit_depth
                hdr.refresh_frame_flags = r.read(8)
                for i in range(REFS_PER_FRAME):
                    hdr.ref_frame_idx[i] = r.read(3)
                    hdr.ref_frame_sign_bias[REF_FRAME_LAST + i] = \
                        r.read(1)
                self._parse_frame_size_with_refs(r, hdr)
                hdr.allow_high_precision_mv = r.read(1)
                if r.read(1):
                    hdr.interpolation_filter = FILTER_SWITCHABLE
                else:
                    hdr.interpolation_filter = _FILTER_MAP[r.read(2)]
        if not hdr.error_resilient_mode:
            hdr.refresh_frame_context = r.read(1)
            hdr.frame_parallel_decoding_mode = r.read(1)
        else:
            hdr.refresh_frame_context = 0
            hdr.frame_parallel_decoding_mode = 1
        hdr.frame_context_idx = r.read(2)
        if frame_is_intra or hdr.error_resilient_mode:
            self._setup_past_independence(hdr)
        self._parse_loop_filter_params(r)
        self._parse_quantization_params(r, hdr)
        self._parse_segmentation_params(r)
        self._parse_tile_info(r, hdr)
        hdr.header_size_in_bytes = r.read(16)
        if not hdr.header_size_in_bytes:
            raise Vp9ParseError("zero header size")
        hdr.loop_filter_params = self.loop_filter_params.copy()
        hdr.segmentation_params = self.segmentation_params.copy()
        for i in range(REF_FRAMES):
            if hdr.refresh_frame_flags & (1 << i):
                self.reference[i] = (hdr.width, hdr.height)
        hdr.frame_header_length_in_bytes = (r.pos + 7) // 8
        return hdr


# ------------------------------------------------ derived (8.6.1)

def seg_feature_active(params: SegmentationParams, segment_id: int,
                       feature: int) -> bool:
    """6.4.9 (gstvp9statefulparser.c:1108-1130)."""
    return bool(params.segmentation_enabled
                and params.feature_enabled[segment_id][feature])


def get_qindex(seg: SegmentationParams, quant: QuantizationParams,
               segment_id: int) -> int:
    """8.6.1 get_qindex (gstvp9statefulparser.c:1132-1160)."""
    base = quant.base_q_idx
    if seg_feature_active(seg, segment_id, SEG_LVL_ALT_Q):
        data = seg.feature_data[segment_id][SEG_LVL_ALT_Q]
        if not seg.segmentation_abs_or_delta_update:
            data += base
        return max(0, min(255, data))
    return base


def get_dc_quant(qindex: int, delta_q_dc: int, bit_depth: int) -> int:
    """8.6.1 dc_q (gstvp9statefulparser.c:1162-1190)."""
    idx = max(0, min(255, qindex + delta_q_dc))
    return {8: qt.DC_QLOOKUP, 10: qt.DC_QLOOKUP_10,
            12: qt.DC_QLOOKUP_12}[bit_depth][idx]


def get_ac_quant(qindex: int, delta_q_ac: int, bit_depth: int) -> int:
    """8.6.1 ac_q (gstvp9statefulparser.c:1192-1223)."""
    idx = max(0, min(255, qindex + delta_q_ac))
    return {8: qt.AC_QLOOKUP, 10: qt.AC_QLOOKUP_10,
            12: qt.AC_QLOOKUP_12}[bit_depth][idx]


# ------------------------------------------------- decoder base layer

@dataclass(eq=False)
class Vp9Picture:
    """gstvp9picture.h GstVp9Picture."""
    system_frame_number: int = 0
    frame_hdr: Optional[FrameHeader] = None
    data: bytes = b""
    duplicate_of: Optional["Vp9Picture"] = None


@dataclass
class OutputPicture:
    picture: Vp9Picture
    system_frame_number: int


class Vp9Decoder:
    """GstVp9Decoder: the 8-slot reference map + show-frame gating
    (gstvp9decoder.c:245-410 handle_frame)."""

    def __init__(self) -> None:
        self.parser = Vp9StatefulParser()
        self.dpb: List[Optional[Vp9Picture]] = [None] * REF_FRAMES
        self.width = 0
        self.height = 0
        self.profile = -1
        self.had_sequence = False
        self._frame_counter = 0

    def push_frame(self, data: bytes, system_frame_number: int = -1) \
            -> List[OutputPicture]:
        """One coded VP9 frame (superframes must be split upstream,
        e.g. io/vp9.py split_superframe)."""
        if system_frame_number < 0:
            system_frame_number = self._frame_counter
        self._frame_counter = max(self._frame_counter,
                                  system_frame_number) + 1
        hdr = self.parser.parse_frame_header(data)
        outs: List[OutputPicture] = []
        if hdr.show_existing_frame:
            to_dup = self.dpb[hdr.frame_to_show_map_idx]
            if to_dup is None:
                raise Vp9ParseError(
                    f"show_existing_frame points at empty slot "
                    f"{hdr.frame_to_show_map_idx}")
            # duplicate_picture (gstvp9decoder.c:317-345); no dpb_add
            pic = Vp9Picture(system_frame_number=system_frame_number,
                             frame_hdr=to_dup.frame_hdr,
                             data=to_dup.data, duplicate_of=to_dup)
            outs.append(OutputPicture(pic, system_frame_number))
            return outs
        # new sequence check (gstvp9decoder.c:149-181)
        if (self.width != hdr.width or self.height != hdr.height
                or self.profile != hdr.profile or not self.had_sequence):
            self.width, self.height = hdr.width, hdr.height
            self.profile = hdr.profile
            self.had_sequence = True
        pic = Vp9Picture(system_frame_number=system_frame_number,
                         frame_hdr=hdr, data=data)
        self._dpb_add(pic)
        if hdr.show_frame:
            outs.append(OutputPicture(pic, system_frame_number))
        return outs

    def _dpb_add(self, picture: Vp9Picture) -> None:
        """gstvp9picture.c:161-187 gst_vp9_dpb_add."""
        hdr = picture.frame_hdr
        if hdr.frame_type == KEY_FRAME:
            flags = (1 << REF_FRAMES) - 1
        else:
            flags = hdr.refresh_frame_flags
        for i in range(REF_FRAMES):
            if flags & (1 << i):
                self.dpb[i] = picture

    def flush(self) -> None:
        self.dpb = [None] * REF_FRAMES
        self.had_sequence = False
