"""Hand-crafted H.264 NAL synthesis for DPB-layer unit vectors.

The decoder base layer (gstbad/codecs/h264.py) only parses slice
HEADERS — slice payloads can be empty.  That lets tests build tiny
conformant header streams exercising POC types 0/1/2, MMCO operations
and frame_num gaps that real encoders rarely emit
(the reference's own parser unit tests craft NALs the same way,
tests/check/libs/h264parser.c).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


class BitWriter:
    def __init__(self) -> None:
        self.bits: List[int] = []

    def u(self, value: int, n: int) -> "BitWriter":
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)
        return self

    def ue(self, v: int) -> "BitWriter":
        v += 1
        n = v.bit_length()
        self.u(0, n - 1)
        self.u(v, n)
        return self

    def se(self, v: int) -> "BitWriter":
        k = 2 * v - 1 if v > 0 else -2 * v
        return self.ue(k)

    def rbsp(self) -> bytes:
        """rbsp_trailing_bits + emulation prevention."""
        bits = self.bits + [1]
        while len(bits) % 8:
            bits.append(0)
        raw = bytearray()
        for i in range(0, len(bits), 8):
            b = 0
            for j in range(8):
                b = (b << 1) | bits[i + j]
            raw.append(b)
        out = bytearray()
        zeros = 0
        for b in raw:
            if zeros >= 2 and b <= 3:
                out.append(3)
                zeros = 0
            out.append(b)
            zeros = zeros + 1 if b == 0 else 0
        return bytes(out)


def make_sps(sps_id: int = 0, log2_max_frame_num: int = 4,
             poc_type: int = 0, log2_max_poc_lsb: int = 4,
             num_ref_frames: int = 2, gaps_allowed: int = 0,
             width_mbs: int = 4, height_mbs: int = 3,
             offset_for_non_ref_pic: int = 0,
             offset_for_top_to_bottom: int = 0,
             offsets_for_ref_frame: Sequence[int] = (),
             delta_pic_order_always_zero: int = 0,
             frame_mbs_only: int = 1, level_idc: int = 40) -> bytes:
    w = BitWriter()
    w.u(66, 8)          # profile baseline
    w.u(0, 8)           # constraint flags
    w.u(level_idc, 8)
    w.ue(sps_id)
    w.ue(log2_max_frame_num - 4)
    w.ue(poc_type)
    if poc_type == 0:
        w.ue(log2_max_poc_lsb - 4)
    elif poc_type == 1:
        w.u(delta_pic_order_always_zero, 1)
        w.se(offset_for_non_ref_pic)
        w.se(offset_for_top_to_bottom)
        w.ue(len(offsets_for_ref_frame))
        for o in offsets_for_ref_frame:
            w.se(o)
    w.ue(num_ref_frames)
    w.u(gaps_allowed, 1)
    w.ue(width_mbs - 1)
    w.ue(height_mbs - 1)
    w.u(frame_mbs_only, 1)
    if not frame_mbs_only:
        w.u(0, 1)       # mb_adaptive_frame_field
    w.u(1, 1)           # direct_8x8_inference
    w.u(0, 1)           # frame_cropping
    w.u(0, 1)           # vui_parameters_present
    return bytes([0x67]) + w.rbsp()


def make_pps(pps_id: int = 0, sps_id: int = 0,
             pic_order_present: int = 0) -> bytes:
    w = BitWriter()
    w.ue(pps_id)
    w.ue(sps_id)
    w.u(0, 1)           # entropy_coding_mode (CAVLC)
    w.u(pic_order_present, 1)
    w.ue(0)             # num_slice_groups_minus1
    w.ue(0)             # num_ref_idx_l0_default_active_minus1
    w.ue(0)             # num_ref_idx_l1_default_active_minus1
    w.u(0, 1)           # weighted_pred
    w.u(0, 2)           # weighted_bipred_idc
    w.se(0)             # pic_init_qp_minus26
    w.se(0)             # pic_init_qs_minus26
    w.se(0)             # chroma_qp_index_offset
    w.u(0, 1)           # deblocking_filter_control_present
    w.u(0, 1)           # constrained_intra_pred
    w.u(0, 1)           # redundant_pic_cnt_present
    return bytes([0x68]) + w.rbsp()


def make_slice(slice_type: int, frame_num: int, *,
               idr: bool = False, idr_pic_id: int = 0,
               nal_ref_idc: int = 1, pps_id: int = 0,
               poc_lsb: Optional[int] = None,
               delta_poc_bottom: int = 0,
               delta_poc: Tuple[int, int] = (0, 0),
               log2_max_frame_num: int = 4,
               poc_type: int = 0, log2_max_poc_lsb: int = 4,
               pic_order_present: int = 0,
               delta_pic_order_always_zero: int = 0,
               field_pic: bool = False, bottom_field: bool = False,
               frame_mbs_only: int = 1,
               long_term_reference_flag: int = 0,
               no_output_of_prior_pics: int = 0,
               mmco_ops: Sequence[Tuple[int, int, int]] = ()) -> bytes:
    """One P/B/I slice header NAL (empty payload)."""
    w = BitWriter()
    w.ue(0)             # first_mb_in_slice
    w.ue(slice_type)
    w.ue(pps_id)
    w.u(frame_num, log2_max_frame_num)
    if not frame_mbs_only:
        w.u(1 if field_pic else 0, 1)
        if field_pic:
            w.u(1 if bottom_field else 0, 1)
    if idr:
        w.ue(idr_pic_id)
    if poc_type == 0:
        w.u(poc_lsb if poc_lsb is not None else 0, log2_max_poc_lsb)
        if pic_order_present and not field_pic:
            w.se(delta_poc_bottom)
    elif poc_type == 1 and not delta_pic_order_always_zero:
        w.se(delta_poc[0])
        if pic_order_present and not field_pic:
            w.se(delta_poc[1])
    if slice_type % 5 == 1:      # B
        w.u(0, 1)       # direct_spatial_mv_pred
    if slice_type % 5 in (0, 1, 3):
        w.u(0, 1)       # num_ref_idx_active_override
    if slice_type % 5 not in (2, 4):
        w.u(0, 1)       # ref_pic_list_modification_flag_l0
    if slice_type % 5 == 1:
        w.u(0, 1)       # ref_pic_list_modification_flag_l1
    if nal_ref_idc:
        if idr:
            w.u(no_output_of_prior_pics, 1)
            w.u(long_term_reference_flag, 1)
        else:
            if mmco_ops:
                w.u(1, 1)    # adaptive_ref_pic_marking_mode
                for mmco, val, lt in mmco_ops:
                    w.ue(mmco)
                    if mmco in (1, 3):
                        w.ue(val)
                    if mmco == 2:
                        w.ue(val)
                    if mmco in (3, 6):
                        w.ue(lt)
                    if mmco == 4:
                        w.ue(val)
                w.ue(0)      # MMCO_END
            else:
                w.u(0, 1)
    # slice data: one skipped MB keeps parsers content (unused by the
    # engine, present for realism)
    nal_type = 5 if idr else 1
    hdr_byte = (nal_ref_idc << 5) | nal_type
    return bytes([hdr_byte]) + w.rbsp()


def annexb(*nals: bytes) -> bytes:
    return b"".join(b"\x00\x00\x00\x01" + n for n in nals)
