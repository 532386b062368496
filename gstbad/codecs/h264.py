"""H.264 stateless-decoder base layer: POC, DPB, reference marking,
reference-list construction and output reordering.

Transcribed semantics of gst-libs/gst/codecs/gsth264decoder.c +
gsth264picture.c (spec sections 8.2.1 POC, 8.2.4 ref lists, 8.2.5
marking, C.4 DPB operation), re-expressed as a plain state machine:

- POC for all three pic_order_cnt_types incl. mem_mgmt_5 resets
  (gsth264decoder.c:1503-1743 gst_h264_decoder_calculate_poc).
- Sliding-window + adaptive (MMCO 1-6) reference marking
  (gsth264decoder.c:1875-2013; gsth264picture.c:929-1158
  perform_memory_management_control_operation).
- DPB store/bump per C.4.5 (gsth264picture.c:688-919 needs_bump/bump),
  normal-latency (strict) mode: bump only when the DPB has no empty
  frame buffer.
- Reference list init for P (pic_num desc + long_term asc) and B
  (POC-split) slices with the 8.2.4.3 modification process
  (gsth264decoder.c:845-3112 construct_ref_pic_lists_* /
  modify_ref_pic_list).
- frame_num gap handling with "non-existing" pictures
  (gsth264decoder.c:923-1005 handle_frame_num_gap).
- Field pictures: first/second-field pairing, frame splitting for the
  per-field marking process, field ref lists (8.2.4.2.5)
  (gsth264decoder.c:1096-1200, 778-820 split_frame).

The engine consumes access units (Annex-B or AVC) through io/h264.py's
parser and emits pictures in output order; the pixel decode is NOT
performed here — exactly like the reference base class, where the
subclass (hardware) decodes and this layer sequences.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import Dict, List, Optional, Tuple

from gstbad.io import h264 as h

GST_H264_DPB_MAX_SIZE = 16

REF_NONE = 0
REF_SHORT = 1
REF_LONG = 2

FIELD_FRAME = 0
FIELD_TOP = 1
FIELD_BOTTOM = 2

MININT32 = -(1 << 31)

# level_idc -> MaxDpbMbs (Table A-1; gsth264decoder.c:2466-2487
# level_limits_map)
_LEVEL_MAX_DPB_MBS = {
    10: 396, 9: 396, 11: 900, 12: 2376, 13: 2376, 20: 2376, 21: 4752,
    22: 8100, 30: 8100, 31: 18000, 32: 20480, 40: 32768, 41: 32768,
    42: 34816, 50: 110400, 51: 184320, 52: 184320, 60: 696320,
    61: 696320, 62: 696320,
}


@dataclass(eq=False)
class H264Picture:
    """gsth264picture.h GstH264Picture."""
    system_frame_number: int = 0
    idr: bool = False
    idr_pic_id: int = 0
    nal_ref_idc: int = 0
    frame_num: int = 0
    pic_num: int = 0
    long_term_pic_num: int = 0
    frame_num_wrap: int = 0
    long_term_frame_idx: int = 0
    pic_order_cnt_type: int = 0
    pic_order_cnt_lsb: int = 0
    delta_pic_order_cnt_bottom: int = 0
    delta_pic_order_cnt0: int = 0
    delta_pic_order_cnt1: int = 0
    pic_order_cnt: int = 0
    pic_order_cnt_msb: int = 0
    frame_num_offset: int = 0
    top_field_order_cnt: int = 0
    bottom_field_order_cnt: int = 0
    mem_mgmt_5: bool = False
    nonexisting: bool = False
    ref: int = REF_NONE
    ref_pic: bool = False          # sticky "was ever a reference"
    needed_for_output: bool = False
    field: int = FIELD_FRAME
    second_field: bool = False
    other_field: Optional["H264Picture"] = None
    dec_ref_pic_marking: h.RefPicMarking = dfield(
        default_factory=h.RefPicMarking)
    interlaced: bool = False       # buffer flag analogs set at bump
    tff: bool = False
    # decode-time ref lists (filled when process_ref_pic_lists)
    ref_list0: List["H264Picture"] = dfield(default_factory=list)
    ref_list1: List["H264Picture"] = dfield(default_factory=list)

    def is_frame(self) -> bool:
        return self.field == FIELD_FRAME

    def is_ref(self) -> bool:
        return self.ref != REF_NONE

    def is_short_ref(self) -> bool:
        return self.ref == REF_SHORT

    def is_long_ref(self) -> bool:
        return self.ref == REF_LONG

    def set_reference(self, reference: int, other_field: bool) -> None:
        """gsth264picture.c:1160-1186 gst_h264_picture_set_reference."""
        self.ref = reference
        if reference > REF_NONE:
            self.ref_pic = True
        if other_field and self.other_field is not None:
            self.other_field.ref = reference
            if reference > REF_NONE:
                self.other_field.ref_pic = True


class H264Dpb:
    """gsth264picture.c GstH264Dpb (C.4.5 DPB operation)."""

    def __init__(self) -> None:
        self.pic_list: List[H264Picture] = []
        self.max_num_frames = 0
        self.interlaced = False
        self.max_num_reorder_frames = 0
        self.num_output_needed = 0
        self.last_output_poc = MININT32
        self.last_output_non_ref = False

    def clear(self) -> None:
        self.pic_list.clear()
        self.num_output_needed = 0
        self.last_output_poc = MININT32
        self.last_output_non_ref = False

    def add(self, picture: H264Picture) -> None:
        """gsth264picture.c:268-312 gst_h264_dpb_add (C.4.2: gap
        pictures are 'not needed for output')."""
        if not picture.nonexisting:
            picture.needed_for_output = True
            if picture.is_frame() or picture.second_field:
                self.num_output_needed += 1
        else:
            picture.needed_for_output = False
        if picture.second_field and picture.other_field is not None:
            picture.other_field.other_field = picture
        self.pic_list.append(picture)
        if picture.pic_order_cnt == 0:
            # IDR or mem_mgmt_5 resets output tracking
            self.last_output_poc = MININT32
            self.last_output_non_ref = False

    def delete_unused(self) -> None:
        self.pic_list = [p for p in self.pic_list
                         if p.needed_for_output or p.is_ref()]

    def num_ref_frames(self) -> int:
        return sum(1 for p in self.pic_list
                   if not p.second_field and p.is_ref())

    def mark_all_non_ref(self) -> None:
        for p in self.pic_list:
            p.set_reference(REF_NONE, False)

    def get_short_ref_by_pic_num(self, pic_num: int) \
            -> Optional[H264Picture]:
        for p in self.pic_list:
            if p.is_short_ref() and p.pic_num == pic_num:
                return p
        return None

    def get_long_ref_by_long_term_pic_num(self, num: int) \
            -> Optional[H264Picture]:
        for p in self.pic_list:
            if p.is_long_ref() and p.long_term_pic_num == num:
                return p
        return None

    def get_lowest_frame_num_short_ref(self) -> Optional[H264Picture]:
        cands = [p for p in self.pic_list if p.is_short_ref()]
        return min(cands, key=lambda p: p.frame_num_wrap, default=None)

    def short_term_refs(self, include_non_existing: bool,
                        include_second_field: bool) -> List[H264Picture]:
        out = []
        for p in self.pic_list:
            if not include_second_field and p.second_field:
                continue
            if p.is_short_ref() and (include_non_existing
                                     or not p.nonexisting):
                out.append(p)
        return out

    def long_term_refs(self, include_second_field: bool) \
            -> List[H264Picture]:
        return [p for p in self.pic_list if p.is_long_ref()
                and (include_second_field or not p.second_field)]

    def has_empty_frame_buffer(self) -> bool:
        """gsth264picture.c:688-720."""
        if not self.interlaced:
            return len(self.pic_list) < self.max_num_frames
        count = 0
        for p in self.pic_list:
            if p.second_field:
                continue
            if p.is_frame() or p.other_field is not None:
                count += 1
        return count < self.max_num_frames

    def _lowest_output_needed(self) \
            -> Tuple[int, Optional[H264Picture]]:
        """gsth264picture.c:722-760: smallest-POC complete picture
        still needed for output (fields only when paired)."""
        lowest, index = None, -1
        for i, p in enumerate(self.pic_list):
            if not p.needed_for_output:
                continue
            if not p.is_frame() and (p.other_field is None
                                     or p.second_field):
                continue
            if lowest is None or p.pic_order_cnt < lowest.pic_order_cnt:
                lowest, index = p, i
        return index, lowest

    def needs_bump(self, to_insert: Optional[H264Picture]) -> bool:
        """gsth264picture.c:762-919, normal-latency branch (C.4.5.3):
        bump only when there is no empty frame buffer and the current
        picture is a reference picture or follows the lowest POC."""
        index, lowest = self._lowest_output_needed()
        lowest_poc = lowest.pic_order_cnt if lowest else (1 << 31)
        if self.has_empty_frame_buffer():
            return False
        if to_insert is not None and to_insert.ref_pic:
            return True
        if to_insert is not None and to_insert.pic_order_cnt > lowest_poc:
            return True
        return False

    def bump(self, drain: bool) -> Optional[H264Picture]:
        """C.4.5.3 bumping (gsth264picture.c:921-987)."""
        index, picture = self._lowest_output_needed()
        if picture is None:
            return None
        picture.needed_for_output = False
        self.num_output_needed -= 1
        if not picture.is_ref() or drain:
            self.pic_list.pop(index)
        other = picture.other_field
        if other is not None:
            other.needed_for_output = False
            picture.interlaced = True
            if picture.pic_order_cnt < other.pic_order_cnt:
                picture.tff = True
            if not other.is_ref():
                try:
                    self.pic_list.remove(other)
                except ValueError:
                    pass
        self.last_output_poc = picture.pic_order_cnt
        self.last_output_non_ref = not picture.ref_pic
        return picture

    def set_last_output(self, picture: H264Picture) -> None:
        self.last_output_poc = picture.pic_order_cnt
        self.last_output_non_ref = not picture.ref_pic

    def perform_mmco(self, op: Tuple[int, int, int],
                     picture: H264Picture) -> bool:
        """8.2.5.4 adaptive marking (gsth264picture.c:1007-1158)."""
        mmco, val, lt_idx = op
        if mmco == h.MMCO_END:
            return True
        if mmco == h.MMCO_SHORT_TO_UNUSED:
            pic_num_x = picture.pic_num - (val + 1)
            other = self.get_short_ref_by_pic_num(pic_num_x)
            if other is None:
                return False
            other.set_reference(REF_NONE, picture.is_frame())
        elif mmco == h.MMCO_LONG_TO_UNUSED:
            other = self.get_long_ref_by_long_term_pic_num(val)
            if other is None:
                return False
            other.set_reference(REF_NONE, False)
        elif mmco == h.MMCO_SHORT_TO_LONG:
            pic_num_x = picture.pic_num - (val + 1)
            other = self.get_short_ref_by_pic_num(pic_num_x)
            if other is None:
                return False
            # unmark any existing long-term with this idx
            # (gsth264picture.c:1045-1110 incl. field-pair cases)
            for tmp in self.pic_list:
                if tmp.is_long_ref() and tmp.long_term_frame_idx == lt_idx:
                    if tmp.is_frame():
                        tmp.set_reference(REF_NONE, True)
                    elif (tmp.other_field is not None
                          and tmp.other_field.is_long_ref()
                          and tmp.other_field.long_term_frame_idx
                          == lt_idx):
                        tmp.set_reference(REF_NONE, True)
                    else:
                        if tmp.other_field is None:
                            tmp.set_reference(REF_NONE, False)
                        elif (tmp.other_field is not other
                              and (other.other_field is None
                                   or other.other_field is not tmp)):
                            tmp.set_reference(REF_NONE, False)
                    break
            other.set_reference(REF_LONG, picture.is_frame())
            other.long_term_frame_idx = lt_idx
            if (other.other_field is not None
                    and other.other_field.is_long_ref()):
                other.other_field.long_term_frame_idx = lt_idx
        elif mmco == h.MMCO_SET_MAX_LONG:
            max_idx = val - 1
            for other in self.pic_list:
                if (other.is_long_ref()
                        and other.long_term_frame_idx > max_idx):
                    other.set_reference(REF_NONE, False)
        elif mmco == h.MMCO_ALL_TO_UNUSED:
            for other in self.pic_list:
                other.set_reference(REF_NONE, False)
            picture.mem_mgmt_5 = True
            picture.frame_num = 0
            # 8.2.5.4.5 tempPicOrderCnt rebase
            if picture.field == FIELD_TOP:
                picture.top_field_order_cnt = picture.pic_order_cnt = 0
            elif picture.field == FIELD_BOTTOM:
                picture.bottom_field_order_cnt = picture.pic_order_cnt = 0
            else:
                picture.top_field_order_cnt -= picture.pic_order_cnt
                picture.bottom_field_order_cnt -= picture.pic_order_cnt
                picture.pic_order_cnt = min(picture.top_field_order_cnt,
                                            picture.bottom_field_order_cnt)
        elif mmco == h.MMCO_CURRENT_TO_LONG:
            for other in self.pic_list:
                if (other.is_long_ref()
                        and other.long_term_frame_idx == lt_idx):
                    other.set_reference(REF_NONE, True)
                    break
            picture.set_reference(REF_LONG, picture.second_field)
            picture.long_term_frame_idx = lt_idx
            if (picture.other_field is not None
                    and picture.other_field.is_long_ref()):
                picture.other_field.long_term_frame_idx = lt_idx
        else:
            return False
        return True


@dataclass
class OutputPicture:
    """What output_picture() hands the subclass: the picture plus its
    original AU payload so a pixel backend can decode it."""
    picture: H264Picture
    poc: int
    system_frame_number: int


class H264Decoder:
    """The GstH264Decoder state machine (gsth264decoder.c), minus
    GObject/caps plumbing.  Feed complete access units in decode order
    via push_au(); collect OutputPicture records in output order."""

    def __init__(self, process_ref_pic_lists: bool = True) -> None:
        self.sps_by_id: Dict[int, h.Sps] = {}
        self.pps_by_id: Dict[int, h.Pps] = {}
        self.dpb = H264Dpb()
        self.process_ref_pic_lists = process_ref_pic_lists
        self.active_sps: Optional[h.Sps] = None
        self.active_pps: Optional[h.Pps] = None
        self.current_picture: Optional[H264Picture] = None
        self.last_field: Optional[H264Picture] = None
        self.max_frame_num = 0
        self.max_pic_num = 0
        self.max_long_term_frame_idx = -1
        self.prev_frame_num = 0
        self.prev_ref_frame_num = 0
        self.prev_frame_num_offset = 0
        self.prev_has_memmgmnt5 = False
        self.prev_ref_has_memmgmnt5 = False
        self.prev_ref_field = FIELD_FRAME
        self.prev_ref_top_field_order_cnt = 0
        self.prev_ref_pic_order_cnt_msb = 0
        self.prev_ref_pic_order_cnt_lsb = 0
        self.last_output_poc = MININT32
        self.width = 0
        self.height = 0
        self.nal_length_size = 4
        self._outputs: List[OutputPicture] = []
        self._frame_counter = 0
        # test/observability hook: the most recently finished picture
        # (keeps its decode-time ref lists even when output directly)
        self.last_finished_picture: Optional[H264Picture] = None

    # ------------------------------------------------------- public

    def set_codec_data(self, avcc: bytes) -> None:
        length_size, sps_list, pps_list = h.parse_avcc(avcc)
        self.nal_length_size = length_size
        for s in sps_list:
            self.process_sps(h.parse_sps(s))
        for p in pps_list:
            pps = h.parse_pps(p)
            self.pps_by_id[pps.pps_id] = pps

    def push_au(self, data: bytes, system_frame_number: int = -1,
                avc: bool = False) -> List[OutputPicture]:
        """gsth264decoder.c:513-583 handle_frame: decode every NAL of
        one access unit, then finish the picture."""
        if system_frame_number < 0:
            system_frame_number = self._frame_counter
        self._frame_counter = max(self._frame_counter,
                                  system_frame_number) + 1
        nals = (h.split_avc(data, self.nal_length_size) if avc
                else h.split_bytestream(data))
        self._current_sfn = system_frame_number
        for nal in nals:
            self._decode_nal(nal)
        self._finish_current_picture()
        out, self._outputs = self._outputs, []
        return out

    def drain(self) -> List[OutputPicture]:
        """gsth264decoder.c:494-512 drain: bump everything out."""
        self._finish_current_picture()
        self._drain_internal()
        out, self._outputs = self._outputs, []
        return out

    def flush(self) -> None:
        """Flush without output (seek)."""
        self.current_picture = None
        self.last_field = None
        self.dpb.clear()
        self._outputs.clear()
        self.last_output_poc = MININT32

    # ------------------------------------------------------- NAL walk

    def _decode_nal(self, nal: bytes) -> None:
        t = h.nal_type(nal)
        if t == h.NAL_SPS:
            self.process_sps(h.parse_sps(nal))
        elif t == h.NAL_PPS:
            pps = h.parse_pps(nal)
            self.pps_by_id[pps.pps_id] = pps
        elif t in (h.NAL_SLICE, h.NAL_SLICE_IDR, 2, 3, 4):
            self._parse_slice(nal)

    def process_sps(self, sps: h.Sps) -> None:
        """gsth264decoder.c:2543-2652 process_sps: derive DPB size from
        the level and VUI, drain on sequence change."""
        self.sps_by_id[sps.sps_id] = sps
        level = sps.level_idc
        if (level == 11 and sps.profile_idc in (66, 77)
                and (sps.constraint_byte & 0x10)):  # constraint_set3
            level = 9  # Level 1b
        max_dpb_mbs = _LEVEL_MAX_DPB_MBS.get(level, 0)
        if not max_dpb_mbs:
            return
        width_mb = max(1, sps.width // 16)
        height_mb = max(1, sps.height // 16)
        max_dpb_frames = min(max_dpb_mbs // (width_mb * height_mb),
                             GST_H264_DPB_MAX_SIZE)
        if sps.vui_present and sps.bitstream_restriction:
            max_dpb_frames = max(1, sps.max_dec_frame_buffering)
        max_dpb_size = max(max_dpb_frames, sps.num_ref_frames)
        max_dpb_size = min(max_dpb_size, GST_H264_DPB_MAX_SIZE)
        interlaced = not sps.frame_mbs_only
        if (self.width != sps.width or self.height != sps.height
                or self.dpb.max_num_frames != max_dpb_size
                or self.dpb.interlaced != interlaced):
            self._finish_current_picture()
            self._drain_internal()
            self.width = sps.width
            self.height = sps.height
            self.dpb.max_num_frames = max_dpb_size
            self.dpb.interlaced = interlaced
        # update_max_num_reorder_frames (gsth264decoder.c:2391-2464)
        if sps.vui_present and sps.bitstream_restriction:
            reorder = sps.max_num_reorder_frames
            if reorder > self.dpb.max_num_frames:
                reorder = 0
            self.dpb.max_num_reorder_frames = reorder
        elif sps.profile_idc in (66, 83):
            self.dpb.max_num_reorder_frames = 0
        elif (sps.constraint_byte & 0x10) and sps.profile_idc in (
                44, 86, 100, 110, 122, 244):
            self.dpb.max_num_reorder_frames = 0
        else:
            self.dpb.max_num_reorder_frames = self.dpb.max_num_frames

    # ------------------------------------------------------ slice path

    def _parse_slice(self, nal: bytes) -> None:
        hdr = h.parse_slice_header(nal, self.sps_by_id, self.pps_by_id)
        # preprocess_slice (gsth264decoder.c:723-738)
        if self.current_picture is None and hdr.first_mb_in_slice != 0:
            raise ValueError("first slice of picture has "
                             f"first_mb_in_slice={hdr.first_mb_in_slice}")
        self.active_pps = self.pps_by_id[hdr.pps_id]
        self.active_sps = self.sps_by_id[self.active_pps.sps_id]
        # field boundary inside one AU buffer (gsth264decoder.c:1230-1248)
        if (self.dpb.interlaced and self.current_picture is not None
                and not self.current_picture.is_frame()
                and not self.current_picture.second_field):
            cur_field = FIELD_FRAME
            if hdr.field_pic_flag:
                cur_field = (FIELD_BOTTOM if hdr.bottom_field_flag
                             else FIELD_TOP)
            if cur_field != self.current_picture.field:
                self._finish_current_picture()
        if self.current_picture is None:
            first_field = self._find_first_field_picture(hdr)
            if first_field is not None:
                picture = self._new_second_field(first_field)
            else:
                picture = H264Picture()
            picture.system_frame_number = self._current_sfn
            self.current_picture = picture
            self._current_hdr = hdr
            self._start_current_picture(hdr)
        # decode_slice: record the per-slice ref lists on first slice
        self.max_pic_num = hdr.max_pic_num
        if self.process_ref_pic_lists:
            l0, l1 = self._modify_ref_pic_lists(hdr)
            self.current_picture.ref_list0 = l0
            self.current_picture.ref_list1 = l1

    def _find_first_field_picture(self, hdr: h.SliceHdr) \
            -> Optional[H264Picture]:
        """gsth264decoder.c:1124-1200."""
        prev_field = None
        if self.dpb.interlaced:
            if self.last_field is not None:
                prev_field = self.last_field
            elif self.dpb.pic_list:
                prev = self.dpb.pic_list[-1]
                if not prev.is_frame() and prev.other_field is None:
                    prev_field = prev
        if not hdr.field_pic_flag:
            if prev_field is not None:
                self.last_field = None
            return None
        if prev_field is None:
            return None
        if prev_field.frame_num != hdr.frame_num:
            self.last_field = None
            return None
        cur = FIELD_BOTTOM if hdr.bottom_field_flag else FIELD_TOP
        if cur == prev_field.field:
            self.last_field = None
            return None
        return prev_field

    def _new_second_field(self, first: H264Picture) -> H264Picture:
        """gsth264decoder.c:1096-1123 new_field_picture."""
        second = H264Picture()
        second.other_field = first
        second.second_field = True
        second.ref = first.ref
        second.ref_pic = first.ref_pic
        second.frame_num = first.frame_num
        if first is self.last_field:
            self.last_field = None
        return second

    def _start_current_picture(self, hdr: h.SliceHdr) -> None:
        """gsth264decoder.c:1032-1095 start_current_picture."""
        sps = self.active_sps
        self.max_frame_num = sps.max_frame_num
        if hdr.idr_pic_flag:
            self.prev_ref_frame_num = 0
        self._handle_frame_num_gap(hdr.frame_num)
        self._init_current_picture(hdr)
        pic = self.current_picture
        if pic.idr:
            if not pic.dec_ref_pic_marking.no_output_of_prior_pics:
                self._drain_internal()
            else:
                self.dpb.clear()
                self.last_field = None
        self._update_pic_nums(pic, hdr.frame_num)
        if self.process_ref_pic_lists:
            self._prepare_ref_pic_lists(pic)

    def _init_current_picture(self, hdr: h.SliceHdr) -> None:
        """fill_picture_from_slice + calculate_poc
        (gsth264decoder.c:1443-1502, 1503-1743)."""
        pic = self.current_picture
        pic.idr = bool(hdr.idr_pic_flag)
        pic.dec_ref_pic_marking = hdr.dec_ref_pic_marking
        if pic.idr:
            pic.idr_pic_id = hdr.idr_pic_id
        if hdr.field_pic_flag:
            pic.field = FIELD_BOTTOM if hdr.bottom_field_flag \
                else FIELD_TOP
        else:
            pic.field = FIELD_FRAME
        pic.nal_ref_idc = hdr.nal_ref_idc
        if hdr.nal_ref_idc != 0:
            pic.set_reference(REF_SHORT, False)
        pic.frame_num = hdr.frame_num
        # 7.4.3
        pic.pic_num = (hdr.frame_num if not hdr.field_pic_flag
                       else 2 * hdr.frame_num + 1)
        pic.pic_order_cnt_type = self.active_sps.pic_order_cnt_type
        if pic.pic_order_cnt_type == 0:
            pic.pic_order_cnt_lsb = hdr.pic_order_cnt_lsb
            pic.delta_pic_order_cnt_bottom = \
                hdr.delta_pic_order_cnt_bottom
        elif pic.pic_order_cnt_type == 1:
            pic.delta_pic_order_cnt0 = hdr.delta_pic_order_cnt[0]
            pic.delta_pic_order_cnt1 = hdr.delta_pic_order_cnt[1]
        self._calculate_poc(pic)

    def _calculate_poc(self, pic: H264Picture) -> None:
        """8.2.1 (gsth264decoder.c:1503-1743)."""
        sps = self.active_sps
        if pic.pic_order_cnt_type == 0:
            if pic.idr:
                prev_msb = prev_lsb = 0
            elif self.prev_ref_has_memmgmnt5:
                if self.prev_ref_field != FIELD_BOTTOM:
                    prev_msb = 0
                    prev_lsb = self.prev_ref_top_field_order_cnt
                else:
                    prev_msb = prev_lsb = 0
            else:
                prev_msb = self.prev_ref_pic_order_cnt_msb
                prev_lsb = self.prev_ref_pic_order_cnt_lsb
            max_lsb = sps.max_pic_order_cnt_lsb
            if (pic.pic_order_cnt_lsb < prev_lsb
                    and prev_lsb - pic.pic_order_cnt_lsb >= max_lsb // 2):
                pic.pic_order_cnt_msb = prev_msb + max_lsb
            elif (pic.pic_order_cnt_lsb > prev_lsb
                    and pic.pic_order_cnt_lsb - prev_lsb > max_lsb // 2):
                pic.pic_order_cnt_msb = prev_msb - max_lsb
            else:
                pic.pic_order_cnt_msb = prev_msb
            if pic.field != FIELD_BOTTOM:
                pic.top_field_order_cnt = (pic.pic_order_cnt_msb
                                           + pic.pic_order_cnt_lsb)
            if pic.field == FIELD_FRAME:
                pic.bottom_field_order_cnt = (
                    pic.top_field_order_cnt
                    + pic.delta_pic_order_cnt_bottom)
            elif pic.field == FIELD_BOTTOM:
                pic.bottom_field_order_cnt = (pic.pic_order_cnt_msb
                                              + pic.pic_order_cnt_lsb)
        elif pic.pic_order_cnt_type == 1:
            # 8.2.1.2
            if self.prev_has_memmgmnt5:
                self.prev_frame_num_offset = 0
            if pic.idr:
                pic.frame_num_offset = 0
            elif self.prev_frame_num > pic.frame_num:
                pic.frame_num_offset = (self.prev_frame_num_offset
                                        + self.max_frame_num)
            else:
                pic.frame_num_offset = self.prev_frame_num_offset
            n_cycle = len(sps.offset_for_ref_frame)
            abs_frame_num = (pic.frame_num_offset + pic.frame_num
                             if n_cycle else 0)
            if pic.nal_ref_idc == 0 and abs_frame_num > 0:
                abs_frame_num -= 1
            expected = 0
            if abs_frame_num > 0:
                if n_cycle == 0:
                    raise ValueError(
                        "num_ref_frames_in_pic_order_cnt_cycle == 0")
                cycle_cnt = (abs_frame_num - 1) // n_cycle
                in_cycle = (abs_frame_num - 1) % n_cycle
                expected = cycle_cnt * sum(sps.offset_for_ref_frame)
                expected += sum(sps.offset_for_ref_frame[:in_cycle + 1])
            if not pic.nal_ref_idc:
                expected += sps.offset_for_non_ref_pic
            if pic.field == FIELD_FRAME:
                pic.top_field_order_cnt = (expected
                                           + pic.delta_pic_order_cnt0)
                pic.bottom_field_order_cnt = (
                    pic.top_field_order_cnt
                    + sps.offset_for_top_to_bottom_field
                    + pic.delta_pic_order_cnt1)
            elif pic.field != FIELD_BOTTOM:
                pic.top_field_order_cnt = (expected
                                           + pic.delta_pic_order_cnt0)
            else:
                pic.bottom_field_order_cnt = (
                    expected + sps.offset_for_top_to_bottom_field
                    + pic.delta_pic_order_cnt0)
        elif pic.pic_order_cnt_type == 2:
            # 8.2.1.3
            if self.prev_has_memmgmnt5:
                self.prev_frame_num_offset = 0
            if pic.idr:
                pic.frame_num_offset = 0
            elif self.prev_frame_num > pic.frame_num:
                pic.frame_num_offset = (self.prev_frame_num_offset
                                        + self.max_frame_num)
            else:
                pic.frame_num_offset = self.prev_frame_num_offset
            if pic.idr:
                temp = 0
            elif not pic.nal_ref_idc:
                temp = 2 * (pic.frame_num_offset + pic.frame_num) - 1
            else:
                temp = 2 * (pic.frame_num_offset + pic.frame_num)
            if pic.field == FIELD_FRAME:
                pic.top_field_order_cnt = temp
                pic.bottom_field_order_cnt = temp
            elif pic.field == FIELD_BOTTOM:
                pic.bottom_field_order_cnt = temp
            else:
                pic.top_field_order_cnt = temp
        else:
            raise ValueError(
                f"invalid pic_order_cnt_type {pic.pic_order_cnt_type}")
        if pic.field == FIELD_FRAME:
            pic.pic_order_cnt = min(pic.top_field_order_cnt,
                                    pic.bottom_field_order_cnt)
        elif pic.field == FIELD_TOP:
            pic.pic_order_cnt = pic.top_field_order_cnt
        else:
            pic.pic_order_cnt = pic.bottom_field_order_cnt

    # ------------------------------------------------- frame_num gaps

    def _handle_frame_num_gap(self, frame_num: int) -> None:
        """7.4.3/7-23 non-existing frames
        (gsth264decoder.c:923-1005)."""
        sps = self.active_sps
        if self.prev_ref_frame_num == frame_num:
            return
        if ((self.prev_ref_frame_num + 1) % self.max_frame_num
                == frame_num):
            return
        if not self.dpb.pic_list:
            return
        if not sps.gaps_in_frame_num_allowed:
            return  # likely frame drop; keep decoding
        unused = (self.prev_ref_frame_num + 1) % self.max_frame_num
        while unused != frame_num:
            pic = H264Picture()
            pic.nonexisting = True
            pic.nal_ref_idc = 1
            pic.frame_num = pic.pic_num = unused
            pic.ref = REF_SHORT
            pic.ref_pic = True
            pic.field = FIELD_FRAME
            pic.pic_order_cnt_type = sps.pic_order_cnt_type
            self._calculate_poc(pic)
            self._update_pic_nums(pic, unused)
            self._sliding_window_marking(pic)
            self.dpb.delete_unused()
            while self.dpb.needs_bump(pic):
                out = self.dpb.bump(False)
                if out is None:
                    break
                self._do_output(out)
            if self.dpb.interlaced:
                other = self._split_frame(pic)
                self._add_to_dpb(pic)
                self._add_to_dpb(other)
            else:
                self._add_to_dpb(pic)
            # NOTE: the reference does NOT update prev_frame_num/
            # prev_ref_frame_num inside this loop (each gap picture's
            # POC is computed against the last FINISHED picture) —
            # reproduced faithfully.
            unused = (unused + 1) % self.max_frame_num

    # --------------------------------------------------- pic numbers

    def _update_pic_nums(self, current: H264Picture,
                         frame_num: int) -> None:
        """7.4.3.1 / 8.2.4.1 (gsth264decoder.c:739-777)."""
        for p in self.dpb.pic_list:
            if not p.is_ref():
                continue
            if p.is_long_ref():
                if current.is_frame():
                    p.long_term_pic_num = p.long_term_frame_idx
                elif current.field == p.field:
                    p.long_term_pic_num = 2 * p.long_term_frame_idx + 1
                else:
                    p.long_term_pic_num = 2 * p.long_term_frame_idx
            else:
                if p.frame_num > frame_num:
                    p.frame_num_wrap = p.frame_num - self.max_frame_num
                else:
                    p.frame_num_wrap = p.frame_num
                if current.is_frame():
                    p.pic_num = p.frame_num_wrap
                elif p.field == current.field:
                    p.pic_num = 2 * p.frame_num_wrap + 1
                else:
                    p.pic_num = 2 * p.frame_num_wrap

    # ------------------------------------------------------ ref lists

    def _prepare_ref_pic_lists(self, current: H264Picture) -> None:
        """gsth264decoder.c:3008-3046."""
        has_ref = any(p.is_ref() and not p.nonexisting
                      for p in self.dpb.pic_list)
        if not has_ref:
            self.ref_pic_list_p0: List[H264Picture] = []
            self.ref_pic_list_b0: List[H264Picture] = []
            self.ref_pic_list_b1: List[H264Picture] = []
            return
        if current.is_frame():
            self._construct_ref_pic_lists_p(current)
            self._construct_ref_pic_lists_b(current)
        else:
            self._construct_ref_field_pic_lists_p(current)
            self._construct_ref_field_pic_lists_b(current)

    def _construct_ref_pic_lists_p(self, current: H264Picture) -> None:
        """8.2.4.2.1 (gsth264decoder.c:845-880)."""
        shorts = self.dpb.short_term_refs(True, False)
        shorts.sort(key=lambda p: -p.pic_num)
        longs = self.dpb.long_term_refs(False)
        longs.sort(key=lambda p: p.long_term_pic_num)
        self.ref_pic_list_p0 = shorts + longs

    def _construct_ref_pic_lists_b(self, current: H264Picture) -> None:
        """8.2.4.2.3 (gsth264decoder.c:2761-2856)."""
        include_ne = current.pic_order_cnt_type != 0
        shorts = self.dpb.short_term_refs(include_ne, False)
        before = sorted(
            [p for p in shorts if p.pic_order_cnt
             <= current.pic_order_cnt],
            key=lambda p: -p.pic_order_cnt)
        after = sorted(
            [p for p in shorts if p.pic_order_cnt
             > current.pic_order_cnt],
            key=lambda p: p.pic_order_cnt)
        longs = sorted(self.dpb.long_term_refs(False),
                       key=lambda p: p.long_term_pic_num)
        b0 = before + after + longs
        b1 = after + before + longs
        if len(b1) > 1 and b0 == b1:
            b1 = [b1[1], b1[0]] + b1[2:]
        self.ref_pic_list_b0 = b0
        self.ref_pic_list_b1 = b1

    @staticmethod
    def _interleave_fields(field: int, ref_frame_list: List[H264Picture],
                           out: List[H264Picture]) -> None:
        """8.2.4.2.5 alternate same-parity / opposite-parity
        (gsth264decoder.c:2595-2626 init_picture_refs_fields_1)."""
        i = j = 0
        n = len(ref_frame_list)
        while i < n or j < n:
            while i < n and ref_frame_list[i].field != field:
                i += 1
            if i < n:
                out.append(ref_frame_list[i])
                i += 1
            while j < n and ref_frame_list[j].field == field:
                j += 1
            if j < n:
                out.append(ref_frame_list[j])
                j += 1

    def _construct_ref_field_pic_lists_p(self,
                                         current: H264Picture) -> None:
        """8.2.4.2.2/8.2.4.2.5 (gsth264decoder.c:2628-2702)."""
        shorts = self.dpb.short_term_refs(True, True)
        shorts.sort(key=lambda p: -p.frame_num_wrap)
        longs = sorted(self.dpb.long_term_refs(True),
                       key=lambda p: p.long_term_frame_idx)
        out: List[H264Picture] = []
        self._interleave_fields(current.field, shorts, out)
        self._interleave_fields(current.field, longs, out)
        self.ref_pic_list_p0 = out

    def _construct_ref_field_pic_lists_b(self,
                                         current: H264Picture) -> None:
        """8.2.4.2.4/8.2.4.2.5 (gsth264decoder.c:2858-3006)."""
        include_ne = current.pic_order_cnt_type != 0
        shorts = self.dpb.short_term_refs(include_ne, True)
        before = sorted(
            [p for p in shorts
             if p.pic_order_cnt <= current.pic_order_cnt],
            key=lambda p: -p.pic_order_cnt)
        after = sorted(
            [p for p in shorts
             if p.pic_order_cnt > current.pic_order_cnt],
            key=lambda p: p.pic_order_cnt)
        longs = sorted(self.dpb.long_term_refs(True),
                       key=lambda p: p.long_term_frame_idx)
        b0: List[H264Picture] = []
        b1: List[H264Picture] = []
        self._interleave_fields(current.field, before + after, b0)
        self._interleave_fields(current.field, longs, b0)
        self._interleave_fields(current.field, after + before, b1)
        self._interleave_fields(current.field, longs, b1)
        if len(b1) > 1 and b0 == b1:
            b1 = [b1[1], b1[0]] + b1[2:]
        self.ref_pic_list_b0 = b0
        self.ref_pic_list_b1 = b1

    def _modify_ref_pic_lists(self, hdr: h.SliceHdr) \
            -> Tuple[List[H264Picture], List[H264Picture]]:
        """gsth264decoder.c:3112-3141 modify_ref_pic_lists."""
        if hdr.is_p():
            l0 = list(self.ref_pic_list_p0)
            l0 = self._modify_one_list(
                l0, hdr.ref_pic_list_modification_l0,
                hdr.num_ref_idx_l0_active)
            return l0, []
        if hdr.is_b():
            l0 = self._modify_one_list(
                list(self.ref_pic_list_b0),
                hdr.ref_pic_list_modification_l0,
                hdr.num_ref_idx_l0_active)
            l1 = self._modify_one_list(
                list(self.ref_pic_list_b1),
                hdr.ref_pic_list_modification_l1,
                hdr.num_ref_idx_l1_active)
            return l0, l1
        return [], []

    def _modify_one_list(self, lst: List[Optional[H264Picture]],
                         mods: List[h.RefPicListMod],
                         num_active: int) -> List[H264Picture]:
        """8.2.4.3 (gsth264decoder.c:3147-3298 modify_ref_pic_list).
        The list is truncated/padded to num_active; modifications
        insert at the front cursor and squeeze duplicates out."""
        picture = self.current_picture
        if len(lst) > num_active:
            del lst[num_active:]
        if not mods:
            return [p for p in lst if p is not None]

        def pic_num_f(p: Optional[H264Picture]) -> int:
            if p is None:
                return -(1 << 30)
            if not p.is_long_ref():
                return p.pic_num
            return self.max_pic_num

        def long_term_pic_num_f(p: Optional[H264Picture]) -> int:
            if p is not None and p.is_long_ref():
                return p.long_term_pic_num
            return 2 * (self.max_long_term_frame_idx + 1)

        pic_num_lx_pred = picture.pic_num
        ref_idx_lx = 0
        for mod in mods:
            if mod.idc in (0, 1):
                if mod.idc == 0:
                    no_wrap = pic_num_lx_pred - (mod.value + 1)
                    if no_wrap < 0:
                        no_wrap += self.max_pic_num
                else:
                    no_wrap = pic_num_lx_pred + (mod.value + 1)
                    if no_wrap >= self.max_pic_num:
                        no_wrap -= self.max_pic_num
                pic_num_lx_pred = no_wrap
                pic_num_lx = (no_wrap - self.max_pic_num
                              if no_wrap > picture.pic_num else no_wrap)
                pic = self.dpb.get_short_ref_by_pic_num(pic_num_lx)
                if pic is None:
                    continue  # malformed stream
                # shift right and insert, then squeeze the duplicate
                while len(lst) < num_active + 1:
                    lst.append(None)
                lst.insert(ref_idx_lx, pic)
                ref_idx_lx += 1
                src = dst = ref_idx_lx
                while src <= num_active:
                    sp = lst[src] if src < len(lst) else None
                    if pic_num_f(sp) != pic_num_lx:
                        if dst < len(lst):
                            lst[dst] = sp
                        dst += 1
                    src += 1
            elif mod.idc == 2:
                pic = self.dpb.get_long_ref_by_long_term_pic_num(
                    mod.value)
                if pic is None:
                    continue
                while len(lst) < num_active + 1:
                    lst.append(None)
                lst.insert(ref_idx_lx, pic)
                ref_idx_lx += 1
                src = dst = ref_idx_lx
                while src <= num_active:
                    sp = lst[src] if src < len(lst) else None
                    if long_term_pic_num_f(sp) != mod.value:
                        if dst < len(lst):
                            lst[dst] = sp
                        dst += 1
                    src += 1
            elif mod.idc == 3:
                break
        if len(lst) > num_active:
            del lst[num_active:]
        return [p for p in lst if p is not None]

    # -------------------------------------------------------- marking

    def _sliding_window_marking(self, picture: H264Picture) -> bool:
        """8.2.5.3 (gsth264decoder.c:1920-1980)."""
        if picture.second_field:
            return True
        sps = self.active_sps
        num_ref = self.dpb.num_ref_frames()
        max_ref = max(1, sps.num_ref_frames)
        while num_ref >= max_ref:
            to_unmark = self.dpb.get_lowest_frame_num_short_ref()
            if to_unmark is None:
                return False
            to_unmark.set_reference(REF_NONE, True)
            num_ref -= 1
        return True

    def _reference_picture_marking(self, picture: H264Picture) -> None:
        """8.2.5.1 (gsth264decoder.c:1986-2013)."""
        if picture.idr:
            self.dpb.mark_all_non_ref()
            if picture.dec_ref_pic_marking.long_term_reference_flag:
                picture.set_reference(REF_LONG, False)
                picture.long_term_frame_idx = 0
                self.max_long_term_frame_idx = 0
            else:
                picture.set_reference(REF_SHORT, False)
                self.max_long_term_frame_idx = -1
            return
        if picture.dec_ref_pic_marking.adaptive_marking:
            for op in picture.dec_ref_pic_marking.ops:
                mmco = op[0]
                if mmco == h.MMCO_SET_MAX_LONG:
                    self.max_long_term_frame_idx = op[1] - 1
                elif mmco == h.MMCO_ALL_TO_UNUSED:
                    self.max_long_term_frame_idx = -1
                self.dpb.perform_mmco(op, picture)
            return
        self._sliding_window_marking(picture)

    # --------------------------------------------------------- finish

    def _split_frame(self, picture: H264Picture) -> H264Picture:
        """gsth264decoder.c:778-820 split_frame (interlaced DPB keeps
        per-field entries)."""
        other = H264Picture()
        other.other_field = picture
        other.second_field = True
        if picture.top_field_order_cnt < picture.bottom_field_order_cnt:
            picture.field = FIELD_TOP
            picture.pic_order_cnt = picture.top_field_order_cnt
            other.field = FIELD_BOTTOM
            other.pic_order_cnt = picture.bottom_field_order_cnt
        else:
            picture.field = FIELD_BOTTOM
            picture.pic_order_cnt = picture.bottom_field_order_cnt
            other.field = FIELD_TOP
            other.pic_order_cnt = picture.top_field_order_cnt
        other.top_field_order_cnt = picture.top_field_order_cnt
        other.bottom_field_order_cnt = picture.bottom_field_order_cnt
        other.frame_num = picture.frame_num
        other.ref = picture.ref
        other.ref_pic = picture.ref_pic
        other.nonexisting = picture.nonexisting
        other.system_frame_number = picture.system_frame_number
        return other

    def _finish_current_picture(self) -> None:
        if self.current_picture is None:
            return
        picture, self.current_picture = self.current_picture, None
        self._finish_picture(picture)

    def _finish_picture(self, picture: H264Picture) -> None:
        """gsth264decoder.c:2203-2327 finish_picture."""
        self.last_finished_picture = picture
        if picture.is_ref():
            self._reference_picture_marking(picture)
            self.prev_ref_has_memmgmnt5 = picture.mem_mgmt_5
            self.prev_ref_top_field_order_cnt = \
                picture.top_field_order_cnt
            self.prev_ref_pic_order_cnt_msb = picture.pic_order_cnt_msb
            self.prev_ref_pic_order_cnt_lsb = picture.pic_order_cnt_lsb
            self.prev_ref_field = picture.field
            self.prev_ref_frame_num = picture.frame_num
        self.prev_frame_num = picture.frame_num
        self.prev_has_memmgmnt5 = picture.mem_mgmt_5
        self.prev_frame_num_offset = picture.frame_num_offset
        self.dpb.delete_unused()
        # C.4.4: mem_mgmt_5 drains the DPB
        if picture.mem_mgmt_5:
            self._drain_internal()
        while self.dpb.needs_bump(picture):
            out = self.dpb.bump(False)
            if out is None:
                break
            self._do_output(out)
        # C.4.5.1/C.4.5.2 store-or-output
        if ((picture.second_field and picture.other_field is not None
                and picture.other_field.is_ref())
                or picture.is_ref()
                or self.dpb.has_empty_frame_buffer()):
            if self.dpb.interlaced and picture.is_frame():
                other = self._split_frame(picture)
                self._add_to_dpb(picture)
                self._add_to_dpb(other)
            else:
                self._add_to_dpb(picture)
        else:
            self._output_picture_directly(picture)

    def _add_to_dpb(self, picture: H264Picture) -> None:
        """gsth264decoder.c:903-922 add_picture_to_dpb."""
        if not self.dpb.interlaced:
            self.dpb.add(picture)
            return
        if (self.last_field is not None
                and picture.other_field is self.last_field):
            self.dpb.add(self.last_field)
            self.last_field = None
        self.dpb.add(picture)

    def _output_picture_directly(self, picture: H264Picture) -> None:
        """gsth264decoder.c:820-902 output_picture_directly (pairs
        non-ref fields outside the DPB)."""
        if picture.is_frame():
            self.dpb.set_last_output(picture)
            self._do_output(picture)
            return
        if self.last_field is None:
            if picture.second_field:
                return  # second field without first: drop
            self.last_field = picture
            return
        if (not picture.second_field or picture.other_field
                is not self.last_field):
            self.last_field = None
            return
        out = self.last_field
        self.last_field = None
        out.other_field = picture
        self.dpb.set_last_output(out)
        self._do_output(out)

    def _do_output(self, picture: H264Picture) -> None:
        """gsth264decoder.c:1762-1800 do_output_picture."""
        self.last_output_poc = picture.pic_order_cnt
        self._outputs.append(OutputPicture(
            picture=picture, poc=picture.pic_order_cnt,
            system_frame_number=picture.system_frame_number))

    def _drain_internal(self) -> None:
        """gsth264decoder.c:1855-1873."""
        while True:
            pic = self.dpb.bump(True)
            if pic is None:
                break
            self._do_output(pic)
        self.last_field = None
        self.dpb.clear()
        self.last_output_poc = MININT32
