"""H.265/HEVC stateless-decoder base layer: POC, RPS, DPB, output
reordering (gst-libs/gst/codecs/gsth265decoder.c + gsth265picture.c).

- POC 8.3.1 with prevTid0Pic tracking and IRAP/NoRaslOutputFlag resets
  (gsth265decoder.c:1057-1127 calculate_poc).
- RPS derivation 8.3.2: PocStCurrBefore/After/Foll, PocLtCurr/Foll
  from the st_ref_pic_set + long-term entries, marking everything not
  in an RPS as unused (gsth265decoder.c:1236-1453
  prepare_rps/derive_and_mark_rps).
- DPB per C.5.2: add with pic_latency_cnt, bump on
  num_output_needed > sps_max_num_reorder_pics, latency overflow, or
  dpb fullness (gsth265picture.c:504-632 needs_bump/bump;
  gsth265decoder.c:1530-1587 dpb_init C.5.2.2).
- RASL dropping after BLA/CRA-with-NoRaslOutputFlag, pic_output_flag
  handling, EOS/EOB new-bitstream tracking
  (gsth265decoder.c:990-1034 fill_picture_from_slice, 760-800
  decode_nal EOS/EOB cases).
- Reference lists 8.3.4: l0/l1 built by cycling StCurrBefore/After +
  LtCurr with the list_entry_lX rewrite
  (gsth265decoder.c:456-576 process_ref_pic_lists).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import Dict, List, Optional

from gstbad.io import h265nal as hv

MININT32 = -(1 << 31)


@dataclass(eq=False)
class H265Picture:
    """gsth265picture.h GstH265Picture."""
    system_frame_number: int = 0
    pic_order_cnt: int = 0
    pic_order_cnt_lsb: int = 0
    pic_latency_cnt: int = 0
    needed_for_output: bool = False
    ref: bool = False
    long_term: bool = False
    output_flag: bool = True
    NoRaslOutputFlag: bool = False
    NoOutputOfPriorPicsFlag: bool = False
    RapPicFlag: bool = False
    IntraPicFlag: bool = False
    nal_type: int = 0
    ref_list0: List["H265Picture"] = dfield(default_factory=list)
    ref_list1: List["H265Picture"] = dfield(default_factory=list)


class H265Dpb:
    """gsth265picture.c GstH265Dpb."""

    def __init__(self) -> None:
        self.pic_list: List[H265Picture] = []
        self.max_num_pics = 16
        self.num_output_needed = 0

    def clear(self) -> None:
        self.pic_list.clear()
        self.num_output_needed = 0

    def add(self, picture: H265Picture) -> None:
        """gsth265picture.c:198-234: C.5.2.3 additional bumping —
        every stored output-pending picture ages by one."""
        if picture.output_flag:
            for other in self.pic_list:
                if other.needed_for_output:
                    other.pic_latency_cnt += 1
            self.num_output_needed += 1
            picture.needed_for_output = True
        else:
            picture.needed_for_output = False
        # C.3.4: the current picture is marked short-term ref
        picture.ref = True
        picture.long_term = False
        self.pic_list.append(picture)

    def delete_unused(self) -> None:
        self.pic_list = [p for p in self.pic_list
                         if p.needed_for_output or p.ref]

    def mark_all_non_ref(self) -> None:
        for p in self.pic_list:
            p.ref = False
            p.long_term = False

    def get_ref_by_poc(self, poc: int) -> Optional[H265Picture]:
        for p in self.pic_list:
            if p.ref and p.pic_order_cnt == poc:
                return p
        return None

    def get_ref_by_poc_lsb(self, poc_lsb: int) -> Optional[H265Picture]:
        for p in self.pic_list:
            if p.ref and p.pic_order_cnt_lsb == poc_lsb:
                return p
        return None

    def get_short_ref_by_poc(self, poc: int) -> Optional[H265Picture]:
        for p in self.pic_list:
            if p.ref and not p.long_term and p.pic_order_cnt == poc:
                return p
        return None

    def needs_bump(self, max_num_reorder_pics: int,
                   max_latency_increase: int,
                   max_dec_pic_buffering: int) -> bool:
        """gsth265picture.c:504-556."""
        if len(self.pic_list) > self.max_num_pics:
            return True
        if self.num_output_needed > max_num_reorder_pics:
            return True
        if (self.num_output_needed and max_latency_increase
                and any(p.needed_for_output
                        and p.pic_latency_cnt >= max_latency_increase
                        for p in self.pic_list)):
            return True
        if (max_dec_pic_buffering
                and len(self.pic_list) >= max_dec_pic_buffering):
            return True
        return False

    def bump(self, drain: bool) -> Optional[H265Picture]:
        """C.5.2.4 (gsth265picture.c:592-632)."""
        lowest, index = None, -1
        for i, p in enumerate(self.pic_list):
            if not p.needed_for_output:
                continue
            if lowest is None or p.pic_order_cnt < lowest.pic_order_cnt:
                lowest, index = p, i
        if lowest is None:
            return None
        lowest.needed_for_output = False
        self.num_output_needed -= 1
        if not lowest.ref or drain:
            self.pic_list.pop(index)
        return lowest


@dataclass
class OutputPicture:
    picture: H265Picture
    poc: int
    system_frame_number: int


class H265Decoder:
    """The GstH265Decoder state machine over io/h265nal.py."""

    def __init__(self, process_ref_pic_lists: bool = True) -> None:
        self.sps_by_id: Dict[int, hv.SpsFull] = {}
        self.pps_by_id: Dict[int, hv.PpsFull] = {}
        self.dpb = H265Dpb()
        self.process_ref_pic_lists = process_ref_pic_lists
        self.active_sps: Optional[hv.SpsFull] = None
        self.current_picture: Optional[H265Picture] = None
        self.poc = 0
        self.poc_lsb = 0
        self.poc_msb = 0
        self.prev_tid0pic_poc_lsb = 0
        self.prev_tid0pic_poc_msb = 0
        self.new_bitstream = True
        self.prev_nal_is_eos = False
        self.associated_irap_NoRaslOutputFlag = False
        self.SpsMaxLatencyPictures = 0
        self.width = 0
        self.height = 0
        self.nal_length_size = 4
        self.last_output_poc = MININT32
        self._outputs: List[OutputPicture] = []
        self._frame_counter = 0
        # RPS state (spec variable names)
        self.PocStCurrBefore: List[int] = []
        self.PocStCurrAfter: List[int] = []
        self.PocStFoll: List[int] = []
        self.PocLtCurr: List[int] = []
        self.PocLtFoll: List[int] = []
        self.RefPicSetStCurrBefore: List[Optional[H265Picture]] = []
        self.RefPicSetStCurrAfter: List[Optional[H265Picture]] = []
        self.RefPicSetLtCurr: List[Optional[H265Picture]] = []
        self.NumPicTotalCurr = 0
        self.last_finished_picture: Optional[H265Picture] = None

    # ------------------------------------------------------- public

    def set_codec_data(self, hvcc: bytes) -> None:
        length_size, nals = hv.parse_hvcc(hvcc)
        self.nal_length_size = length_size
        for nal in nals:
            self._decode_nal(nal)

    def push_au(self, data: bytes, system_frame_number: int = -1,
                hevc: bool = False) -> List[OutputPicture]:
        """gsth265decoder.c:1710-1800 handle_frame."""
        if system_frame_number < 0:
            system_frame_number = self._frame_counter
        self._frame_counter = max(self._frame_counter,
                                  system_frame_number) + 1
        nals = (hv.split_avc(data, self.nal_length_size) if hevc
                else hv.split_bytestream(data))
        self._current_sfn = system_frame_number
        for nal in nals:
            self._decode_nal(nal)
        self._finish_current_picture()
        out, self._outputs = self._outputs, []
        return out

    def drain(self) -> List[OutputPicture]:
        self._finish_current_picture()
        self._drain_internal()
        out, self._outputs = self._outputs, []
        return out

    def flush(self) -> None:
        self.current_picture = None
        self.dpb.clear()
        self._outputs.clear()
        self.last_output_poc = MININT32

    # ------------------------------------------------------ NAL walk

    def _decode_nal(self, nal: bytes) -> None:
        t = hv.nal_type(nal)
        if t == hv.NAL_SPS:
            self.process_sps(hv.parse_sps_full(nal))
        elif t == hv.NAL_PPS:
            pps = hv.parse_pps_full(nal)
            self.pps_by_id[pps.pps_id] = pps
        elif hv.is_slice(t):
            self._parse_slice(nal)
            self.new_bitstream = False
            self.prev_nal_is_eos = False
        elif t == hv.NAL_EOB:
            self.new_bitstream = True
        elif t == hv.NAL_EOS:
            self.prev_nal_is_eos = True

    def process_sps(self, sps: hv.SpsFull) -> None:
        """gsth265decoder.c:284-368 process_sps (A.4.1 DPB size)."""
        self.sps_by_id[sps.sps_id] = sps
        max_luma_ps = 35651584
        pic_size = sps.width * sps.height
        max_dpb_pic_buf = 6
        if pic_size <= (max_luma_ps >> 2):
            max_dpb_size = max_dpb_pic_buf * 4
        elif pic_size <= (max_luma_ps >> 1):
            max_dpb_size = max_dpb_pic_buf * 2
        elif pic_size <= ((3 * max_luma_ps) >> 2):
            max_dpb_size = (max_dpb_pic_buf * 4) // 3
        else:
            max_dpb_size = max_dpb_pic_buf
        max_dpb_size = min(max_dpb_size, 16)
        if (self.width != sps.width or self.height != sps.height
                or self.dpb.max_num_pics != max_dpb_size):
            self._finish_current_picture()
            self._drain_internal()
            self.width = sps.width
            self.height = sps.height
            self.dpb.max_num_pics = max_dpb_size
        hi = sps.max_sub_layers_minus1
        if sps.max_latency_increase_plus1[hi]:
            self.SpsMaxLatencyPictures = (
                sps.max_num_reorder_pics[hi]
                + sps.max_latency_increase_plus1[hi] - 1)
        else:
            self.SpsMaxLatencyPictures = 0

    # ------------------------------------------------------- slices

    def _parse_slice(self, nal: bytes) -> None:
        hdr = hv.parse_slice_header_full(nal, self.sps_by_id,
                                         self.pps_by_id)
        if hdr.dependent_slice_segment:
            return  # continuation of the current picture
        if (self.current_picture is not None
                and hdr.first_slice_segment_in_pic):
            # preprocess_slice: new picture while one is open
            self._finish_current_picture()
        pps = self.pps_by_id[hdr.pps_id]
        self.active_sps = self.sps_by_id[pps.sps_id]
        if self.current_picture is None:
            pic = H265Picture()
            pic.system_frame_number = self._current_sfn
            pic.nal_type = hdr.nal_type
            self.current_picture = pic
            if not self._start_current_picture(hdr):
                return  # picture dropped (RASL)
        # decode_slice: build ref lists for the subclass
        if self.process_ref_pic_lists and self.current_picture:
            l0, l1 = self._process_ref_pic_lists(hdr)
            self.current_picture.ref_list0 = l0
            self.current_picture.ref_list1 = l1

    def _start_current_picture(self, hdr: hv.SliceHdr265) -> bool:
        pic = self.current_picture
        t = hdr.nal_type
        # fill_picture_from_slice (gsth265decoder.c:990-1034)
        if hv.NAL_BLA_W_LP <= t <= hv.NAL_CRA:
            pic.RapPicFlag = True
        if (hv.is_idr(t) or hv.is_bla(t)
                or (hv.is_cra(t) and self.new_bitstream)
                or self.prev_nal_is_eos):
            pic.NoRaslOutputFlag = True
        if 16 <= t <= 23:  # IRAP
            pic.IntraPicFlag = True
            self.associated_irap_NoRaslOutputFlag = pic.NoRaslOutputFlag
        if hv.is_rasl(t) and self.associated_irap_NoRaslOutputFlag:
            pic.output_flag = False
        else:
            pic.output_flag = bool(hdr.pic_output_flag)
        self._calculate_poc(hdr, pic)
        # Drop RASL pictures associated with a NoRaslOutputFlag IRAP
        # (gsth265decoder.c:1604-1611)
        if hv.is_rasl(t) and self.associated_irap_NoRaslOutputFlag:
            self.current_picture = None
            return False
        self._prepare_rps(hdr, pic)
        self._dpb_init(hdr, pic)
        return True

    def _calculate_poc(self, hdr: hv.SliceHdr265,
                       pic: H265Picture) -> None:
        """8.3.1 (gsth265decoder.c:1057-1127)."""
        sps = self.active_sps
        max_poc_lsb = sps.max_poc_lsb
        t = hdr.nal_type
        is_irap = 16 <= t <= 23
        if is_irap and pic.NoRaslOutputFlag:
            prev_lsb = prev_msb = 0  # unused (msb forced 0)
        else:
            prev_lsb = self.prev_tid0pic_poc_lsb
            prev_msb = self.prev_tid0pic_poc_msb
        if is_irap and pic.NoRaslOutputFlag:
            self.poc_msb = 0
        else:
            if (hdr.pic_order_cnt_lsb < prev_lsb
                    and prev_lsb - hdr.pic_order_cnt_lsb
                    >= max_poc_lsb // 2):
                self.poc_msb = prev_msb + max_poc_lsb
            elif (hdr.pic_order_cnt_lsb > prev_lsb
                    and hdr.pic_order_cnt_lsb - prev_lsb
                    > max_poc_lsb // 2):
                self.poc_msb = prev_msb - max_poc_lsb
            else:
                self.poc_msb = prev_msb
        self.poc = pic.pic_order_cnt = (self.poc_msb
                                        + hdr.pic_order_cnt_lsb)
        self.poc_lsb = pic.pic_order_cnt_lsb = hdr.pic_order_cnt_lsb
        if hv.is_idr(t):
            pic.pic_order_cnt = 0
            pic.pic_order_cnt_lsb = 0
            self.poc_lsb = self.poc_msb = 0
            self.prev_tid0pic_poc_lsb = 0
            self.prev_tid0pic_poc_msb = 0
        if (hdr.temporal_id == 1 and not hv.is_rasl(t)
                and not hv.is_radl(t) and _nal_is_ref(t)):
            self.prev_tid0pic_poc_lsb = hdr.pic_order_cnt_lsb
            self.prev_tid0pic_poc_msb = self.poc_msb

    def _prepare_rps(self, hdr: hv.SliceHdr265,
                     pic: H265Picture) -> None:
        """8.3.2 (gsth265decoder.c:1324-1453)."""
        sps = self.active_sps
        t = hdr.nal_type
        if (16 <= t <= 23) and pic.NoRaslOutputFlag:
            self.dpb.mark_all_non_ref()
        self.PocStCurrBefore = []
        self.PocStCurrAfter = []
        self.PocStFoll = []
        self.PocLtCurr = []
        self.PocLtFoll = []
        curr_msb_present: List[int] = []
        foll_msb_present: List[int] = []
        self.NumPicTotalCurr = 0
        if not hv.is_idr(t):
            rps = hdr.st_rps
            for i in range(rps.num_negative_pics):
                poc = pic.pic_order_cnt + rps.delta_poc_s0[i]
                if rps.used_s0[i]:
                    self.PocStCurrBefore.append(poc)
                else:
                    self.PocStFoll.append(poc)
            for i in range(rps.num_positive_pics):
                poc = pic.pic_order_cnt + rps.delta_poc_s1[i]
                if rps.used_s1[i]:
                    self.PocStCurrAfter.append(poc)
                else:
                    self.PocStFoll.append(poc)
            # long-term (7-38 DeltaPocMsbCycleLt accumulation + 8-5)
            delta_msb_cycle = []
            for i, (lsb, used, msb_present, msb_cycle) in \
                    enumerate(hdr.lt_entries):
                if i == 0 or i == hdr.num_long_term_sps:
                    delta_msb_cycle.append(msb_cycle)
                else:
                    delta_msb_cycle.append(msb_cycle
                                           + delta_msb_cycle[i - 1])
            for i, (lsb, used, msb_present, _mc) in \
                    enumerate(hdr.lt_entries):
                poc_lt = lsb
                if msb_present:
                    poc_lt += (pic.pic_order_cnt
                               - delta_msb_cycle[i] * sps.max_poc_lsb
                               - hdr.pic_order_cnt_lsb)
                if used:
                    self.PocLtCurr.append(poc_lt)
                    curr_msb_present.append(msb_present)
                else:
                    self.PocLtFoll.append(poc_lt)
                    foll_msb_present.append(msb_present)
            self.NumPicTotalCurr = hdr.num_pic_total_curr
        # derive_and_mark_rps (gsth265decoder.c:1236-1323)
        lt_curr: List[Optional[H265Picture]] = []
        lt_foll: List[Optional[H265Picture]] = []
        for i, poc in enumerate(self.PocLtCurr):
            lt_curr.append(self.dpb.get_ref_by_poc(poc)
                           if curr_msb_present[i]
                           else self.dpb.get_ref_by_poc_lsb(poc))
        for i, poc in enumerate(self.PocLtFoll):
            lt_foll.append(self.dpb.get_ref_by_poc(poc)
                           if foll_msb_present[i]
                           else self.dpb.get_ref_by_poc_lsb(poc))
        for p in lt_curr + lt_foll:
            if p is not None:
                p.ref = True
                p.long_term = True
        st_before = [self.dpb.get_short_ref_by_poc(poc)
                     for poc in self.PocStCurrBefore]
        st_after = [self.dpb.get_short_ref_by_poc(poc)
                    for poc in self.PocStCurrAfter]
        st_foll = [self.dpb.get_short_ref_by_poc(poc)
                   for poc in self.PocStFoll]
        self.RefPicSetStCurrBefore = st_before
        self.RefPicSetStCurrAfter = st_after
        self.RefPicSetLtCurr = lt_curr
        rps_pocs = {p.pic_order_cnt
                    for p in (st_before + st_after + st_foll
                              + lt_curr + lt_foll) if p is not None}
        for p in self.dpb.pic_list:
            if p.pic_order_cnt not in rps_pocs:
                p.ref = False
                p.long_term = False

    def _dpb_init(self, hdr: hv.SliceHdr265, pic: H265Picture) -> None:
        """C.5.2.2 (gsth265decoder.c:1530-1587)."""
        sps = self.active_sps
        t = hdr.nal_type
        hi = sps.max_sub_layers_minus1
        if (16 <= t <= 23) and pic.NoRaslOutputFlag \
                and not self.new_bitstream:
            if t == hv.NAL_CRA:
                pic.NoOutputOfPriorPicsFlag = True
            else:
                pic.NoOutputOfPriorPicsFlag = bool(
                    hdr.no_output_of_prior_pics)
            if pic.NoOutputOfPriorPicsFlag:
                self.dpb.clear()
                self.last_output_poc = MININT32
            else:
                self.dpb.delete_unused()
                while True:
                    out = self.dpb.bump(False)
                    if out is None:
                        break
                    self._do_output(out)
                self.last_output_poc = MININT32
        else:
            self.dpb.delete_unused()
            while self.dpb.needs_bump(
                    sps.max_num_reorder_pics[hi],
                    self.SpsMaxLatencyPictures,
                    sps.max_dec_pic_buffering[hi]):
                out = self.dpb.bump(False)
                if out is None:
                    break
                self._do_output(out)

    def _process_ref_pic_lists(self, hdr: hv.SliceHdr265):
        """8.3.4 (gsth265decoder.c:456-576)."""
        if hdr.is_i():
            return [], []
        if (not self.RefPicSetStCurrBefore
                and not self.RefPicSetStCurrAfter
                and not self.RefPicSetLtCurr):
            return [], []
        num_tmp = max(hdr.num_ref_idx_l0_active, self.NumPicTotalCurr)
        tmp: List[Optional[H265Picture]] = []
        while len(tmp) < num_tmp:
            tmp += self.RefPicSetStCurrBefore[
                :max(0, num_tmp - len(tmp))]
            tmp += self.RefPicSetStCurrAfter[:max(0, num_tmp - len(tmp))]
            tmp += self.RefPicSetLtCurr[:max(0, num_tmp - len(tmp))]
        l0 = []
        for i in range(hdr.num_ref_idx_l0_active):
            if hdr.ref_mod_flag_l0:
                l0.append(tmp[hdr.list_entry_l0[i]])
            else:
                l0.append(tmp[i])
        if hdr.is_p():
            return l0, []
        num_tmp = max(hdr.num_ref_idx_l1_active, self.NumPicTotalCurr)
        tmp = []
        while len(tmp) < num_tmp:
            tmp += self.RefPicSetStCurrAfter[:max(0, num_tmp - len(tmp))]
            tmp += self.RefPicSetStCurrBefore[
                :max(0, num_tmp - len(tmp))]
            tmp += self.RefPicSetLtCurr[:max(0, num_tmp - len(tmp))]
        l1 = []
        for i in range(hdr.num_ref_idx_l1_active):
            if hdr.ref_mod_flag_l1:
                l1.append(tmp[hdr.list_entry_l1[i]])
            else:
                l1.append(tmp[i])
        return l0, l1

    # -------------------------------------------------------- finish

    def _finish_current_picture(self) -> None:
        if self.current_picture is None:
            return
        picture, self.current_picture = self.current_picture, None
        self.last_finished_picture = picture
        sps = self.active_sps
        hi = sps.max_sub_layers_minus1
        self.dpb.delete_unused()
        self.dpb.add(picture)
        # C.5.2.2 note: max_dec_pic_buffering applies only BEFORE the
        # current picture decode -> pass 0 here
        while self.dpb.needs_bump(sps.max_num_reorder_pics[hi],
                                  self.SpsMaxLatencyPictures, 0):
            out = self.dpb.bump(False)
            if out is None:
                break
            self._do_output(out)

    def _do_output(self, picture: H265Picture) -> None:
        self.last_output_poc = picture.pic_order_cnt
        self._outputs.append(OutputPicture(
            picture=picture, poc=picture.pic_order_cnt,
            system_frame_number=picture.system_frame_number))

    def _drain_internal(self) -> None:
        while True:
            pic = self.dpb.bump(True)
            if pic is None:
                break
            self._do_output(pic)
        self.dpb.clear()
        self.last_output_poc = MININT32


def _nal_is_ref(t: int) -> bool:
    """gsth265decoder.c:1035-1056 nal_is_ref (sub-layer non-reference
    types are the even-numbered *_N types)."""
    return t not in (hv.NAL_TRAIL_N, hv.NAL_TSA_N, hv.NAL_STSA_N,
                     hv.NAL_RADL_N, hv.NAL_RASL_N, 10, 12, 14)
