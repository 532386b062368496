"""H.265/HEVC bitstream parsing (gst/videoparsers/gsth265parse.c over
codecparsers/gsth265parser.c).

From-spec (ITU-T H.265) pieces the parser element uses: Annex-B /
length-prefixed NAL framing (2-byte NAL headers), profile_tier_level
and SPS parse (pic size + conformance window in chroma units -> width/
height, VUI par/timing), prefix-SEI walk (CLLI/MDCV share the H.264
payload syntax, gsth265parse.c caps strings), hvcC codec_data
(ISO 14496-15 HEVCDecoderConfigurationRecord), and AU boundaries via
first_slice_segment_in_pic_flag (the first bit after the NAL header).

Upstream goldens: the x265-generated 16x16 SPS must parse to
main/main-tier/level 2.1 (tests/check/elements/h265parse.c:279-285),
the 128x128 SPS to 128x128.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

from gstbad.io.h264 import (BitReader, remove_emulation,
                                split_bytestream, split_avc,
                                to_bytestream, to_avc,
                                content_light_level_string,
                                mastering_display_string)

NAL_IDR_W_RADL = 19
NAL_IDR_N_LP = 20
NAL_CRA = 21
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34
NAL_AUD = 35
NAL_PREFIX_SEI = 39

SEI_MDCV = 137
SEI_CLLI = 144


def nal_type(nal: bytes) -> int:
    return (nal[0] >> 1) & 0x3F if nal else 0


def is_slice(t: int) -> bool:
    return t <= 31


def is_irap(t: int) -> bool:
    return 16 <= t <= 23


@dataclass
class Ptl:
    profile_space: int = 0
    tier_flag: int = 0
    profile_idc: int = 0
    compat_flags: int = 0
    level_idc: int = 0


def _parse_ptl(r: BitReader, max_sub_layers_minus1: int) -> Ptl:
    """7.3.3 profile_tier_level."""
    ptl = Ptl()
    ptl.profile_space = r.read(2)
    ptl.tier_flag = r.read(1)
    ptl.profile_idc = r.read(5)
    ptl.compat_flags = r.read(32)
    r.read(4)   # progressive/interlaced/non-packed/frame-only
    r.read(32)  # reserved_zero_43bits...
    r.read(11)
    r.read(1)   # reserved / inbld
    ptl.level_idc = r.read(8)
    sub_profile = []
    sub_level = []
    for _ in range(max_sub_layers_minus1):
        sub_profile.append(r.read(1))
        sub_level.append(r.read(1))
    if max_sub_layers_minus1 > 0:
        for _ in range(8 - max_sub_layers_minus1):
            r.read(2)
    for i in range(max_sub_layers_minus1):
        if sub_profile[i]:
            r.read(32)
            r.read(32)
            r.read(24)
        if sub_level[i]:
            r.read(8)
    return ptl


@dataclass
class Sps:
    sps_id: int = 0
    chroma_format_idc: int = 1
    width: int = 0
    height: int = 0
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    ptl: Ptl = None
    par_n: int = 0
    par_d: int = 0
    fps_n: int = 0
    fps_d: int = 0
    raw: bytes = b""


def parse_sps(nal: bytes) -> Sps:
    """7.3.2.2.1 seq_parameter_set_rbsp."""
    rbsp = remove_emulation(nal[2:])  # 2-byte NAL header
    r = BitReader(rbsp)
    sps = Sps(raw=bytes(nal))
    r.read(4)  # sps_video_parameter_set_id
    max_sub_layers_minus1 = r.read(3)
    r.read(1)  # temporal_id_nesting
    sps.ptl = _parse_ptl(r, max_sub_layers_minus1)
    sps.sps_id = r.ue()
    sps.chroma_format_idc = r.ue()
    if sps.chroma_format_idc == 3:
        r.read(1)  # separate_colour_plane
    w = r.ue()
    hgt = r.ue()
    crop_l = crop_r = crop_t = crop_b = 0
    if r.read(1):  # conformance_window_flag
        crop_l, crop_r, crop_t, crop_b = r.ue(), r.ue(), r.ue(), r.ue()
    sub_wc = [1, 2, 2, 1][sps.chroma_format_idc]
    sub_hc = [1, 2, 1, 1][sps.chroma_format_idc]
    sps.width = w - sub_wc * (crop_l + crop_r)
    sps.height = hgt - sub_hc * (crop_t + crop_b)
    sps.bit_depth_luma = r.ue() + 8
    sps.bit_depth_chroma = r.ue() + 8
    log2_max_poc = r.ue() + 4
    sub_layer_ordering = r.read(1)
    for _ in range((max_sub_layers_minus1 + 1) if sub_layer_ordering
                   else 1):
        r.ue()
        r.ue()
        r.ue()
    r.ue()  # log2_min_luma_coding_block_size_minus3
    r.ue()  # log2_diff_max_min_luma_coding_block_size
    r.ue()  # log2_min_luma_transform_block_size_minus2
    r.ue()  # log2_diff_max_min_luma_transform_block_size
    r.ue()  # max_transform_hierarchy_depth_inter
    r.ue()  # max_transform_hierarchy_depth_intra
    if r.read(1):  # scaling_list_enabled
        if r.read(1):  # sps_scaling_list_data_present
            _skip_scaling_list_data(r)
    r.read(2)  # amp_enabled, sample_adaptive_offset_enabled
    if r.read(1):  # pcm_enabled
        r.read(8)
        r.ue()
        r.ue()
        r.read(1)
    num_short_term_rps = r.ue()
    prev_pics = 0
    for i in range(num_short_term_rps):
        prev_pics = _skip_st_rps(r, i, num_short_term_rps, prev_pics)
    if r.read(1):  # long_term_ref_pics_present
        for _ in range(r.ue()):
            r.read(log2_max_poc)
            r.read(1)
    r.read(2)  # temporal_mvp_enabled, strong_intra_smoothing
    if r.read(1):  # vui_parameters_present
        _parse_vui(r, sps)
    return sps


def _skip_scaling_list_data(r: BitReader) -> None:
    for size_id in range(4):
        matrix_count = 6 if size_id != 3 else 2
        for _ in range(matrix_count):
            if not r.read(1):  # pred_mode_flag
                r.ue()
            else:
                coefs = min(64, 1 << (4 + (size_id << 1)))
                if size_id > 1:
                    r.se()
                for _ in range(coefs):
                    r.se()


def _skip_st_rps(r: BitReader, idx: int, total: int,
                 prev_pics: int) -> int:
    """7.3.7 st_ref_pic_set; returns NumDeltaPocs for the next set."""
    inter_pred = r.read(1) if idx else 0
    if inter_pred:
        r.read(1)  # delta_rps_sign
        r.ue()     # abs_delta_rps_minus1
        kept = 0
        for _ in range(prev_pics + 1):
            used = r.read(1)
            if not used:
                if r.read(1):
                    kept += 1
            else:
                kept += 1
        return kept
    neg = r.ue()
    pos = r.ue()
    for _ in range(neg + pos):
        r.ue()
        r.read(1)
    return neg + pos


_ASPECT_RATIOS = [
    (0, 0), (1, 1), (12, 11), (10, 11), (16, 11), (40, 33), (24, 11),
    (20, 11), (32, 11), (80, 33), (18, 11), (15, 11), (64, 33),
    (160, 99), (4, 3), (3, 2), (2, 1),
]


def _parse_vui(r: BitReader, sps: Sps) -> None:
    """E.2.1 vui_parameters (prefix only, through timing)."""
    if r.read(1):  # aspect_ratio_info
        idc = r.read(8)
        if idc == 255:
            sps.par_n = r.read(16)
            sps.par_d = r.read(16)
        elif idc < len(_ASPECT_RATIOS):
            sps.par_n, sps.par_d = _ASPECT_RATIOS[idc]
    if r.read(1):  # overscan
        r.read(1)
    if r.read(1):  # video_signal_type
        r.read(4)
        if r.read(1):
            r.read(24)
    if r.read(1):  # chroma_loc
        r.ue()
        r.ue()
    r.read(3)  # neutral_chroma, field_seq, frame_field_info
    if r.read(1):  # default_display_window
        r.ue()
        r.ue()
        r.ue()
        r.ue()
    if r.read(1):  # vui_timing_info_present
        num = r.read(32)
        scale = r.read(32)
        if num and scale:
            sps.fps_n = scale
            sps.fps_d = num


def first_slice_segment_in_pic(nal: bytes) -> int:
    """The first slice-header bit after the 2-byte NAL header."""
    return (nal[2] >> 7) & 1 if len(nal) > 2 else 0


# ================================================ decoder-grade parse
# (gsth265parser.c full SPS/PPS/slice-header path, the fields the
# codecs DPB layer consumes — gsth265decoder.c:1589-1631 parse_slice)

NAL_TRAIL_N = 0
NAL_TRAIL_R = 1
NAL_TSA_N = 2
NAL_TSA_R = 3
NAL_STSA_N = 4
NAL_STSA_R = 5
NAL_RADL_N = 6
NAL_RADL_R = 7
NAL_RASL_N = 8
NAL_RASL_R = 9
NAL_BLA_W_LP = 16
NAL_BLA_W_RADL = 17
NAL_BLA_N_LP = 18
NAL_EOS = 36
NAL_EOB = 37

SLICE_B, SLICE_P, SLICE_I = 0, 1, 2


def is_idr(t: int) -> bool:
    return t in (NAL_IDR_W_RADL, NAL_IDR_N_LP)


def is_bla(t: int) -> bool:
    return t in (NAL_BLA_W_LP, NAL_BLA_W_RADL, NAL_BLA_N_LP)


def is_cra(t: int) -> bool:
    return t == NAL_CRA


def is_rasl(t: int) -> bool:
    return t in (NAL_RASL_N, NAL_RASL_R)


def is_radl(t: int) -> bool:
    return t in (NAL_RADL_N, NAL_RADL_R)


def nal_temporal_id(nal: bytes) -> int:
    """nuh_temporal_id_plus1 (low 3 bits of the 2nd header byte)."""
    return (nal[1] & 0x7) if len(nal) > 1 else 1


@dataclass
class StRps:
    """Derived short-term RPS (7.4.8 semantics, spec variables)."""
    num_negative_pics: int = 0
    num_positive_pics: int = 0
    delta_poc_s0: List[int] = None   # DeltaPocS0 (negative values)
    used_s0: List[int] = None        # UsedByCurrPicS0
    delta_poc_s1: List[int] = None
    used_s1: List[int] = None

    def __post_init__(self):
        for f in ("delta_poc_s0", "used_s0", "delta_poc_s1", "used_s1"):
            if getattr(self, f) is None:
                setattr(self, f, [])

    @property
    def num_delta_pocs(self) -> int:
        return self.num_negative_pics + self.num_positive_pics


def parse_st_rps(r: BitReader, idx: int, num_sets: int,
                 rps_list: List[StRps]) -> StRps:
    """7.3.7/7.4.8 st_ref_pic_set with inter-RPS prediction derivation
    (7-47..7-50); gsth265parser.c gst_h265_parser_parse_short_term_ref_pic_sets."""
    rps = StRps()
    inter_pred = r.read(1) if idx else 0
    if inter_pred:
        delta_idx = 1
        if idx == num_sets:  # slice-header RPS may reference any set
            delta_idx = r.ue() + 1
        ref = rps_list[idx - delta_idx]
        sign = r.read(1)
        abs_delta = r.ue() + 1
        delta_rps = (1 - 2 * sign) * abs_delta
        n = ref.num_delta_pocs
        used, use_delta = [], []
        for _ in range(n + 1):
            u = r.read(1)
            used.append(u)
            use_delta.append(r.read(1) if not u else 1)
        ref_s0 = ref.delta_poc_s0
        ref_s1 = ref.delta_poc_s1
        n_neg_ref = ref.num_negative_pics
        # (7-47) negative pics
        i = 0
        for j in range(ref.num_positive_pics - 1, -1, -1):
            d = ref_s1[j] + delta_rps
            if d < 0 and use_delta[n_neg_ref + j]:
                rps.delta_poc_s0.append(d)
                rps.used_s0.append(used[n_neg_ref + j])
                i += 1
        if delta_rps < 0 and use_delta[n]:
            rps.delta_poc_s0.append(delta_rps)
            rps.used_s0.append(used[n])
            i += 1
        for j in range(n_neg_ref):
            d = ref_s0[j] + delta_rps
            if d < 0 and use_delta[j]:
                rps.delta_poc_s0.append(d)
                rps.used_s0.append(used[j])
                i += 1
        rps.num_negative_pics = i
        # (7-48) positive pics
        i = 0
        for j in range(n_neg_ref - 1, -1, -1):
            d = ref_s0[j] + delta_rps
            if d > 0 and use_delta[j]:
                rps.delta_poc_s1.append(d)
                rps.used_s1.append(used[j])
                i += 1
        if delta_rps > 0 and use_delta[n]:
            rps.delta_poc_s1.append(delta_rps)
            rps.used_s1.append(used[n])
            i += 1
        for j in range(ref.num_positive_pics):
            d = ref_s1[j] + delta_rps
            if d > 0 and use_delta[n_neg_ref + j]:
                rps.delta_poc_s1.append(d)
                rps.used_s1.append(used[n_neg_ref + j])
                i += 1
        rps.num_positive_pics = i
        return rps
    neg = r.ue()
    pos = r.ue()
    prev = 0
    for _ in range(neg):
        d = r.ue() + 1
        prev -= d
        rps.delta_poc_s0.append(prev)
        rps.used_s0.append(r.read(1))
    rps.num_negative_pics = neg
    prev = 0
    for _ in range(pos):
        d = r.ue() + 1
        prev += d
        rps.delta_poc_s1.append(prev)
        rps.used_s1.append(r.read(1))
    rps.num_positive_pics = pos
    return rps


@dataclass
class SpsFull:
    """SPS fields the decoder layer needs (7.3.2.2.1)."""
    sps_id: int = 0
    chroma_format_idc: int = 1
    separate_colour_plane: int = 0
    width: int = 0
    height: int = 0
    max_sub_layers_minus1: int = 0
    log2_max_poc_lsb: int = 8
    max_dec_pic_buffering: List[int] = None   # per sublayer, minus1+1
    max_num_reorder_pics: List[int] = None
    max_latency_increase_plus1: List[int] = None
    pic_size_in_ctbs: int = 0
    sample_adaptive_offset: int = 0
    pcm_loop_filter_disabled: int = 0
    st_rps: List[StRps] = None
    long_term_ref_pics_present: int = 0
    lt_poc_lsb: List[int] = None
    lt_used_by_curr: List[int] = None
    temporal_mvp_enabled: int = 0
    field_seq_flag: int = 0
    raw: bytes = b""

    def __post_init__(self):
        for f in ("max_dec_pic_buffering", "max_num_reorder_pics",
                  "max_latency_increase_plus1", "st_rps", "lt_poc_lsb",
                  "lt_used_by_curr"):
            if getattr(self, f) is None:
                setattr(self, f, [])

    @property
    def max_poc_lsb(self) -> int:
        return 1 << self.log2_max_poc_lsb


def parse_sps_full(nal: bytes) -> SpsFull:
    """Full SPS parse for the decoder layer."""
    r = BitReader(remove_emulation(nal[2:]))
    sps = SpsFull(raw=bytes(nal))
    r.read(4)
    sps.max_sub_layers_minus1 = r.read(3)
    r.read(1)
    _parse_ptl(r, sps.max_sub_layers_minus1)
    sps.sps_id = r.ue()
    sps.chroma_format_idc = r.ue()
    if sps.chroma_format_idc == 3:
        sps.separate_colour_plane = r.read(1)
    w = r.ue()
    hgt = r.ue()
    if r.read(1):  # conformance_window
        r.ue(), r.ue(), r.ue(), r.ue()
    sps.width, sps.height = w, hgt  # decoder uses un-cropped CTB math
    r.ue()  # bit_depth_luma_minus8
    r.ue()  # bit_depth_chroma_minus8
    sps.log2_max_poc_lsb = r.ue() + 4
    sub_layer_ordering = r.read(1)
    n = sps.max_sub_layers_minus1 + 1 if sub_layer_ordering else 1
    dec_buf, reorder, latency = [], [], []
    for _ in range(n):
        dec_buf.append(r.ue() + 1)
        reorder.append(r.ue())
        latency.append(r.ue())
    while len(dec_buf) < sps.max_sub_layers_minus1 + 1:
        dec_buf.append(dec_buf[-1])
        reorder.append(reorder[-1])
        latency.append(latency[-1])
    sps.max_dec_pic_buffering = dec_buf
    sps.max_num_reorder_pics = reorder
    sps.max_latency_increase_plus1 = latency
    log2_min_cb = r.ue() + 3
    log2_diff_max_min = r.ue()
    ctb_log2 = log2_min_cb + log2_diff_max_min
    ctb = 1 << ctb_log2
    pic_w_ctbs = (w + ctb - 1) // ctb
    pic_h_ctbs = (hgt + ctb - 1) // ctb
    sps.pic_size_in_ctbs = pic_w_ctbs * pic_h_ctbs
    r.ue(), r.ue(), r.ue(), r.ue()  # transform block sizes/depths
    if r.read(1):  # scaling_list_enabled
        if r.read(1):
            _skip_scaling_list_data(r)
    r.read(1)  # amp_enabled
    sps.sample_adaptive_offset = r.read(1)
    if r.read(1):  # pcm_enabled
        r.read(8)
        r.ue(), r.ue()
        sps.pcm_loop_filter_disabled = r.read(1)
    num_sets = r.ue()
    for i in range(num_sets):
        sps.st_rps.append(parse_st_rps(r, i, num_sets, sps.st_rps))
    sps.long_term_ref_pics_present = r.read(1)
    if sps.long_term_ref_pics_present:
        for _ in range(r.ue()):
            sps.lt_poc_lsb.append(r.read(sps.log2_max_poc_lsb))
            sps.lt_used_by_curr.append(r.read(1))
    sps.temporal_mvp_enabled = r.read(1)
    r.read(1)  # strong_intra_smoothing
    if r.read(1):  # vui present
        try:
            vui_sps = Sps()
            _parse_vui(r, vui_sps)
            # field_seq_flag sits inside the fixed 3-bit group the
            # prefix parser reads; re-derive it cheaply is not worth
            # the complexity — keep 0 (progressive x265 streams).
        except ValueError:
            pass
    return sps


@dataclass
class PpsFull:
    """PPS fields through lists_modification_present (7.3.3.3)."""
    pps_id: int = 0
    sps_id: int = 0
    dependent_slice_segments_enabled: int = 0
    output_flag_present: int = 0
    num_extra_slice_header_bits: int = 0
    num_ref_idx_l0_default: int = 1
    num_ref_idx_l1_default: int = 1
    lists_modification_present: int = 0
    cabac_init_present: int = 0
    weighted_pred: int = 0
    weighted_bipred: int = 0
    cu_qp_delta_enabled: int = 0
    pps_slice_chroma_qp_offsets_present: int = 0
    transquant_bypass_enabled: int = 0
    tiles_enabled: int = 0
    entropy_coding_sync_enabled: int = 0
    loop_filter_across_slices: int = 0
    deblocking_filter_override_enabled: int = 0
    deblocking_filter_disabled: int = 0
    raw: bytes = b""


def parse_pps_full(nal: bytes) -> PpsFull:
    r = BitReader(remove_emulation(nal[2:]))
    pps = PpsFull(raw=bytes(nal))
    pps.pps_id = r.ue()
    pps.sps_id = r.ue()
    pps.dependent_slice_segments_enabled = r.read(1)
    pps.output_flag_present = r.read(1)
    pps.num_extra_slice_header_bits = r.read(3)
    r.read(1)  # sign_data_hiding
    pps.cabac_init_present = r.read(1)
    pps.num_ref_idx_l0_default = r.ue() + 1
    pps.num_ref_idx_l1_default = r.ue() + 1
    r.se()  # init_qp_minus26
    r.read(1)  # constrained_intra_pred
    r.read(1)  # transform_skip
    pps.cu_qp_delta_enabled = r.read(1)
    if pps.cu_qp_delta_enabled:
        r.ue()
    r.se()  # cb_qp_offset
    r.se()  # cr_qp_offset
    pps.pps_slice_chroma_qp_offsets_present = r.read(1)
    pps.weighted_pred = r.read(1)
    pps.weighted_bipred = r.read(1)
    pps.transquant_bypass_enabled = r.read(1)
    pps.tiles_enabled = r.read(1)
    pps.entropy_coding_sync_enabled = r.read(1)
    if pps.tiles_enabled:
        num_cols = r.ue() + 1
        num_rows = r.ue() + 1
        if not r.read(1):  # uniform_spacing
            for _ in range(num_cols - 1):
                r.ue()
            for _ in range(num_rows - 1):
                r.ue()
        r.read(1)  # loop_filter_across_tiles
    pps.loop_filter_across_slices = r.read(1)
    if r.read(1):  # deblocking_filter_control_present
        pps.deblocking_filter_override_enabled = r.read(1)
        pps.deblocking_filter_disabled = r.read(1)
        if not pps.deblocking_filter_disabled:
            r.se()
            r.se()
    if r.read(1):  # pps_scaling_list_data_present
        _skip_scaling_list_data(r)
    pps.lists_modification_present = r.read(1)
    return pps


@dataclass
class SliceHdr265:
    nal_type: int = 0
    temporal_id: int = 1
    first_slice_segment_in_pic: int = 0
    no_output_of_prior_pics: int = 0
    pps_id: int = 0
    dependent_slice_segment: int = 0
    slice_type: int = SLICE_I
    pic_output_flag: int = 1
    pic_order_cnt_lsb: int = 0
    # short-term RPS (resolved)
    st_rps: Optional[StRps] = None
    # long-term entries: (poc_lsb, used_by_curr, msb_present, msb_cycle)
    num_long_term_sps: int = 0
    lt_entries: List[Tuple[int, int, int, int]] = None
    num_ref_idx_l0_active: int = 1
    num_ref_idx_l1_active: int = 1
    ref_mod_flag_l0: int = 0
    ref_mod_flag_l1: int = 0
    list_entry_l0: List[int] = None
    list_entry_l1: List[int] = None
    num_pic_total_curr: int = 0

    def __post_init__(self):
        for f in ("lt_entries", "list_entry_l0", "list_entry_l1"):
            if getattr(self, f) is None:
                setattr(self, f, [])

    def is_i(self) -> bool:
        return self.slice_type == SLICE_I

    def is_p(self) -> bool:
        return self.slice_type == SLICE_P

    def is_b(self) -> bool:
        return self.slice_type == SLICE_B


def parse_slice_header_full(nal: bytes, sps_by_id, pps_by_id) \
        -> SliceHdr265:
    """7.3.6.1 slice_segment_header through ref_pic_list_modification
    (everything gsth265decoder.c consumes)."""
    t = nal_type(nal)
    hdr = SliceHdr265(nal_type=t, temporal_id=nal_temporal_id(nal))
    r = BitReader(remove_emulation(nal[2:]))
    hdr.first_slice_segment_in_pic = r.read(1)
    if 16 <= t <= 23:  # IRAP
        hdr.no_output_of_prior_pics = r.read(1)
    hdr.pps_id = r.ue()
    pps = pps_by_id.get(hdr.pps_id)
    if pps is None:
        raise ValueError(f"slice references unknown PPS {hdr.pps_id}")
    sps = sps_by_id.get(pps.sps_id)
    if sps is None:
        raise ValueError(f"PPS references unknown SPS {pps.sps_id}")
    if not hdr.first_slice_segment_in_pic:
        if pps.dependent_slice_segments_enabled:
            hdr.dependent_slice_segment = r.read(1)
        bits = max(1, (sps.pic_size_in_ctbs - 1).bit_length())
        r.read(bits)  # slice_segment_address
    if hdr.dependent_slice_segment:
        return hdr  # remaining fields copied from the indep slice
    r.read(pps.num_extra_slice_header_bits)
    hdr.slice_type = r.ue()
    if pps.output_flag_present:
        hdr.pic_output_flag = r.read(1)
    if sps.separate_colour_plane:
        r.read(2)
    if not is_idr(t):
        hdr.pic_order_cnt_lsb = r.read(sps.log2_max_poc_lsb)
        st_sps_flag = r.read(1)
        if not st_sps_flag:
            hdr.st_rps = parse_st_rps(r, len(sps.st_rps),
                                      len(sps.st_rps), sps.st_rps)
        elif sps.st_rps:
            nbits = max(0, (len(sps.st_rps) - 1).bit_length()) \
                if len(sps.st_rps) > 1 else 0
            idx = r.read(nbits) if nbits else 0
            hdr.st_rps = sps.st_rps[idx]
        else:
            hdr.st_rps = StRps()
        if sps.long_term_ref_pics_present:
            num_lt_sps = 0
            if sps.lt_poc_lsb:
                num_lt_sps = r.ue()
            num_lt_pics = r.ue()
            hdr.num_long_term_sps = num_lt_sps
            prev_msb_cycle = 0
            for i in range(num_lt_sps + num_lt_pics):
                if i < num_lt_sps:
                    lt_idx = 0
                    if len(sps.lt_poc_lsb) > 1:
                        nb = (len(sps.lt_poc_lsb) - 1).bit_length()
                        lt_idx = r.read(nb)
                    poc_lsb_lt = sps.lt_poc_lsb[lt_idx]
                    used = sps.lt_used_by_curr[lt_idx]
                else:
                    poc_lsb_lt = r.read(sps.log2_max_poc_lsb)
                    used = r.read(1)
                msb_present = r.read(1)
                msb_cycle = r.ue() if msb_present else 0
                hdr.lt_entries.append((poc_lsb_lt, used, msb_present,
                                       msb_cycle))
        if sps.temporal_mvp_enabled:
            r.read(1)  # slice_temporal_mvp_enabled
    if hdr.st_rps is None:
        hdr.st_rps = StRps()
    # NumPicTotalCurr (7-43)
    total = sum(hdr.st_rps.used_s0) + sum(hdr.st_rps.used_s1)
    total += sum(e[1] for e in hdr.lt_entries)
    hdr.num_pic_total_curr = total
    if sps.sample_adaptive_offset:
        r.read(2)  # slice_sao_luma/chroma
    if hdr.slice_type in (SLICE_P, SLICE_B):
        hdr.num_ref_idx_l0_active = pps.num_ref_idx_l0_default
        hdr.num_ref_idx_l1_active = pps.num_ref_idx_l1_default
        if r.read(1):  # num_ref_idx_active_override
            hdr.num_ref_idx_l0_active = r.ue() + 1
            if hdr.slice_type == SLICE_B:
                hdr.num_ref_idx_l1_active = r.ue() + 1
        if pps.lists_modification_present and total > 1:
            nbits = (total - 1).bit_length()
            hdr.ref_mod_flag_l0 = r.read(1)
            if hdr.ref_mod_flag_l0:
                for _ in range(hdr.num_ref_idx_l0_active):
                    hdr.list_entry_l0.append(r.read(nbits))
            if hdr.slice_type == SLICE_B:
                hdr.ref_mod_flag_l1 = r.read(1)
                if hdr.ref_mod_flag_l1:
                    for _ in range(hdr.num_ref_idx_l1_active):
                        hdr.list_entry_l1.append(r.read(nbits))
    return hdr


def parse_sei(nal: bytes) -> List[Tuple[int, bytes]]:
    """Prefix SEI: same payload walk as H.264 after the 2-byte header."""
    from gstbad.io import h264 as _h264
    return _h264.parse_sei(nal[1:])  # reuse: skip one extra header byte


# ---------------------------------------------------------------- names

def profile_name(ptl: Ptl) -> Optional[str]:
    """gst_codec_utils_h265_get_profile (the common cases)."""
    return {1: "main", 2: "main-10", 3: "main-still-picture",
            4: "format-range-extensions"}.get(ptl.profile_idc)


def tier_name(ptl: Ptl) -> str:
    return "high" if ptl.tier_flag else "main"


def level_name(ptl: Ptl) -> str:
    """level_idc is 30 x the level number."""
    if ptl.level_idc % 30 == 0:
        return str(ptl.level_idc // 30)
    return f"{ptl.level_idc // 30}.{(ptl.level_idc % 30) // 3}"


# ---------------------------------------------------------------- hvcC

def build_hvcc(vps_list: List[bytes], sps_list: List[bytes],
               pps_list: List[bytes], length_size: int = 4) -> bytes:
    """ISO 14496-15 8.3.3.1 HEVCDecoderConfigurationRecord
    (gst_h265_parse_make_codec_data)."""
    if not sps_list:
        raise ValueError("hvcC needs an SPS")
    sps = parse_sps(sps_list[0])
    ptl = sps.ptl
    out = bytearray()
    out.append(1)  # configurationVersion
    out.append((ptl.profile_space << 6) | (ptl.tier_flag << 5)
               | ptl.profile_idc)
    out += struct.pack(">I", ptl.compat_flags)
    out += b"\x00" * 6  # constraint indicator flags (general)
    out.append(ptl.level_idc)
    out += struct.pack(">H", 0xF000)  # min_spatial_segmentation_idc
    out.append(0xFC)  # parallelismType
    out.append(0xFC | (sps.chroma_format_idc & 0x3))
    out.append(0xF8 | ((sps.bit_depth_luma - 8) & 0x7))
    out.append(0xF8 | ((sps.bit_depth_chroma - 8) & 0x7))
    out += b"\x00\x00"  # avgFrameRate
    out.append((length_size - 1) & 0x3)  # constFrameRate=0 numTemporal=0
    arrays = [(NAL_VPS, vps_list), (NAL_SPS, sps_list),
              (NAL_PPS, pps_list)]
    arrays = [(t, lst) for t, lst in arrays if lst]
    out.append(len(arrays))
    for t, lst in arrays:
        out.append(0x80 | t)  # array_completeness=1
        out += struct.pack(">H", len(lst))
        for n in lst:
            out += struct.pack(">H", len(n)) + n
    return bytes(out)


def parse_hvcc(data: bytes) -> Tuple[int, List[bytes]]:
    """-> (nal_length_size, all nals in array order)."""
    if len(data) < 23 or data[0] != 1:
        raise ValueError("bad hvcC")
    length_size = (data[21] & 0x3) + 1
    n_arrays = data[22]
    pos = 23
    nals = []
    for _ in range(n_arrays):
        pos += 1
        (count,) = struct.unpack_from(">H", data, pos)
        pos += 2
        for _ in range(count):
            (ln,) = struct.unpack_from(">H", data, pos)
            pos += 2
            nals.append(data[pos:pos + ln])
            pos += ln
    return length_size, nals
