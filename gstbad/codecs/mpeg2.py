"""MPEG-2 stateless-decoder base layer
(gst-libs/gst/codecs/gstmpeg2decoder.c + gstmpeg2picture.c).

The MPEG-2 "DPB" is two reference frames plus the in-flight picture
(gstmpeg2picture.c:190-247 dpb_add/_dpb_add_to_reference); output
ordering comes from a synthetic POC derived from the GOP-relative
temporal_sequence_number with 1024-wrap tracking
(gstmpeg2decoder.c:72-152 PTSGenerator: poc = gop_tsn + ovl_tsn*1024 +
lst_tsn).  Bumping outputs the lowest-POC needed-for-output picture
whenever a new picture is pending (gstmpeg2picture.c:250-302).

Field pictures pair via first_field (gstmpeg2decoder.c:760-830
ensure_current_picture); B-frames before the first reference in an
open GOP are marked decode-only (:741-747).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from gstbad.io import mpegvideo as mv


@dataclass(eq=False)
class Mpeg2Picture:
    """gstmpeg2picture.h GstMpeg2Picture."""
    system_frame_number: int = 0
    needed_for_output: bool = False
    first_field: Optional["Mpeg2Picture"] = None
    pic_order_cnt: int = 0
    tsn: int = 0
    pic_type: int = 0
    structure: int = mv.PICTURE_STRUCTURE_FRAME
    interlaced: bool = False
    tff: bool = False
    decode_only: bool = False

    def is_ref(self) -> bool:
        return self.pic_type in (mv.PICTURE_I, mv.PICTURE_P)


class Mpeg2Dpb:
    """gstmpeg2picture.c GstMpeg2Dpb: 2 refs + the new picture."""

    def __init__(self) -> None:
        self.ref_pic_list: List[Optional[Mpeg2Picture]] = [None, None]
        self.num_ref_pictures = 0
        self.new_pic: Optional[Mpeg2Picture] = None

    def clear(self) -> None:
        self.ref_pic_list = [None, None]
        self.num_ref_pictures = 0
        self.new_pic = None

    def _add_to_reference(self, pic: Mpeg2Picture) -> None:
        """gstmpeg2picture.c:190-210."""
        index = -1
        if self.num_ref_pictures == 2:
            index = int(self.ref_pic_list[0].pic_order_cnt
                        > self.ref_pic_list[1].pic_order_cnt)
            if self.ref_pic_list[index].pic_order_cnt > pic.pic_order_cnt:
                return
        if index < 0:
            index = self.num_ref_pictures
            self.num_ref_pictures += 1
        self.ref_pic_list[index] = pic

    def add(self, picture: Mpeg2Picture) -> None:
        """gstmpeg2picture.c:211-235."""
        if not picture.is_ref() or self.num_ref_pictures == 2:
            self.new_pic = picture
        else:
            self._add_to_reference(picture)

    def need_bump(self) -> bool:
        return self.new_pic is not None

    def bump(self) -> Optional[Mpeg2Picture]:
        """gstmpeg2picture.c:257-302."""
        pic: Optional[Mpeg2Picture] = None
        for ref in self.ref_pic_list[:2]:
            if ref is None or not ref.needed_for_output:
                continue
            if pic is None or pic.pic_order_cnt > ref.pic_order_cnt:
                pic = ref
        if (self.new_pic is not None and self.new_pic.needed_for_output
                and (pic is None
                     or pic.pic_order_cnt > self.new_pic.pic_order_cnt)):
            pic = self.new_pic
        # promote the pending picture into the reference list
        if self.new_pic is not None and self.new_pic.is_ref():
            self._add_to_reference(self.new_pic)
            self.new_pic = None
        if pic is not None:
            pic.needed_for_output = False
            if pic is self.new_pic:
                self.new_pic = None
        return pic

    def get_neighbours(self, picture: Mpeg2Picture) \
            -> Tuple[Optional[Mpeg2Picture], Optional[Mpeg2Picture]]:
        """gstmpeg2picture.c:304-348: prev/next refs by POC."""
        prev_pic = next_pic = None
        for ref in self.ref_pic_list[:2]:
            if ref is None:
                continue
            if ref.pic_order_cnt > picture.pic_order_cnt:
                if (next_pic is None
                        or next_pic.pic_order_cnt > ref.pic_order_cnt):
                    next_pic = ref
            else:
                if (prev_pic is None
                        or prev_pic.pic_order_cnt <= ref.pic_order_cnt):
                    prev_pic = ref
        return prev_pic, next_pic


class _PocGenerator:
    """The tsn half of gstmpeg2decoder.c's PTSGenerator (:72-152):
    gop_tsn accumulates across GOPs, ovl_tsn counts 1024-wraps."""

    def __init__(self) -> None:
        self.gop_tsn = 0
        self.max_tsn = 0
        self.ovl_tsn = 0
        self.lst_tsn = 0
        self.started = False

    def sync(self) -> None:
        """New GOP: fold the previous GOP's extent into gop_tsn."""
        if self.started:
            self.gop_tsn += self.ovl_tsn * 1024 + self.max_tsn + 1
        self.max_tsn = 0
        self.ovl_tsn = 0
        self.lst_tsn = 0
        self.started = True

    def eval(self, tsn: int) -> int:
        if self.max_tsn < tsn:
            self.max_tsn = tsn
        elif self.max_tsn == 1023 and tsn < self.lst_tsn:  # wrapped
            self.max_tsn = tsn
            self.ovl_tsn += 1
        self.lst_tsn = tsn
        self.started = True
        return self.gop_tsn + self.ovl_tsn * 1024 + self.lst_tsn


@dataclass
class OutputPicture:
    picture: Mpeg2Picture
    system_frame_number: int


class Mpeg2Decoder:
    """GstMpeg2Decoder over io/mpegvideo.py."""

    def __init__(self) -> None:
        self.dpb = Mpeg2Dpb()
        self.seq_hdr: Optional[mv.SeqHdr] = None
        self.pic_hdr: Optional[mv.PictureHdr] = None
        self.pic_ext = mv.PictureExt()
        self.gop = mv.Gop()
        self.progressive = True
        self.current_picture: Optional[Mpeg2Picture] = None
        self.first_field: Optional[Mpeg2Picture] = None
        self._poc = _PocGenerator()
        self._outputs: List[OutputPicture] = []
        self._frame_counter = 0

    def push_frame(self, data: bytes, system_frame_number: int = -1) \
            -> List[OutputPicture]:
        """One coded picture's worth of ES data
        (gstmpeg2decoder.c:1103-1180 handle_frame)."""
        if system_frame_number < 0:
            system_frame_number = self._frame_counter
        self._frame_counter = max(self._frame_counter,
                                  system_frame_number) + 1
        self._current_sfn = system_frame_number
        codes = mv.split_startcodes(data)
        for k, (off, code) in enumerate(codes):
            payload_start = off + 4
            end = codes[k + 1][0] if k + 1 < len(codes) else len(data)
            payload = data[payload_start:end]
            self._decode_packet(code, payload)
        self._finish_current_picture()
        out, self._outputs = self._outputs, []
        return out

    def drain(self) -> List[OutputPicture]:
        self._finish_current_picture()
        while True:
            pic = self.dpb.bump()
            if pic is None:
                break
            self._do_output(pic)
        self.dpb.clear()
        out, self._outputs = self._outputs, []
        return out

    def flush(self) -> None:
        self.current_picture = None
        self.first_field = None
        self.dpb.clear()
        self._outputs.clear()

    # ---------------------------------------------------------- walk

    def _decode_packet(self, code: int, payload: bytes) -> None:
        """gstmpeg2decoder.c:964-1032 decode_packet."""
        if code == mv.PACKET_PICTURE:
            self._finish_current_field()
            self.pic_hdr = mv.parse_picture_header(payload)
        elif code == mv.PACKET_SEQUENCE:
            self.seq_hdr = mv.parse_sequence_header(payload)
            self.progressive = True
        elif code == mv.PACKET_EXTENSION and payload:
            ext_id = payload[0] >> 4
            if ext_id == 1:  # sequence extension
                if self.seq_hdr is not None:
                    mv.parse_sequence_extension(payload, self.seq_hdr)
                    self.progressive = self.seq_hdr.progressive
            elif ext_id == 8:  # picture coding extension
                pic_ext = mv.parse_picture_ext(payload)
                # gstmpeg2decoder.c:636-651 sanity fixes
                if self.progressive and not pic_ext.progressive_frame:
                    pic_ext.progressive_frame = 1
                if (pic_ext.picture_structure == 0
                        or (pic_ext.progressive_frame
                            and pic_ext.picture_structure
                            != mv.PICTURE_STRUCTURE_FRAME)):
                    pic_ext.picture_structure = \
                        mv.PICTURE_STRUCTURE_FRAME
                self.pic_ext = pic_ext
        elif code == mv.PACKET_GOP:
            self.gop = mv.parse_gop(payload)
            self._poc.sync()
        elif mv.PACKET_SLICE_MIN <= code <= mv.PACKET_SLICE_MAX:
            self._ensure_current_picture()

    def _ensure_current_picture(self) -> None:
        """gstmpeg2decoder.c:760-855."""
        if self.current_picture is not None:
            return
        if self.pic_hdr is None or self.seq_hdr is None:
            return  # headers missing; tolerate
        if (self.progressive or self.pic_ext.picture_structure
                == mv.PICTURE_STRUCTURE_FRAME):
            if self.first_field is not None:
                self.first_field = None  # unmatched first field
            picture = Mpeg2Picture()
            picture.structure = mv.PICTURE_STRUCTURE_FRAME
        else:
            picture = Mpeg2Picture()
            if self.first_field is not None:
                picture.first_field = self.first_field
                picture.interlaced = True
                picture.tff = bool(self.pic_ext.top_field_first)
            picture.structure = self.pic_ext.picture_structure
        picture.needed_for_output = True
        picture.system_frame_number = self._current_sfn
        picture.pic_type = self.pic_hdr.pic_type
        picture.tsn = self.pic_hdr.tsn
        picture.pic_order_cnt = self._poc.eval(picture.tsn)
        # open-GOP leading B without a backward ref: decode-only
        prev_pic, _next = self.dpb.get_neighbours(picture)
        if (picture.pic_type == mv.PICTURE_B and prev_pic is None
                and not self.gop.closed_gop):
            picture.decode_only = True
        self.current_picture = picture

    def _finish_current_field(self) -> None:
        """gstmpeg2decoder.c:855-885."""
        if self.current_picture is None:
            return
        pic = self.current_picture
        if (pic.structure != mv.PICTURE_STRUCTURE_FRAME
                and pic.first_field is None):
            self.first_field = pic
            self.current_picture = None
        else:
            self.current_picture = None  # discard odd state

    def _finish_current_picture(self) -> None:
        """gstmpeg2decoder.c:887-908 + output_current_picture."""
        picture = self.current_picture
        if picture is None and self.first_field is not None:
            # missing second field: output what we have
            picture = self.first_field
            self.first_field = None
        if picture is None:
            return
        if (picture.structure != mv.PICTURE_STRUCTURE_FRAME
                and picture.first_field is None):
            # first field complete; wait for the second
            self.first_field = picture
            self.current_picture = None
            return
        self.current_picture = None
        if picture.first_field is not None:
            self.first_field = None
        if picture.decode_only:
            return
        self.dpb.add(picture)
        while self.dpb.need_bump():
            out = self.dpb.bump()
            if out is None:
                break
            self._do_output(out)

    def _do_output(self, picture: Mpeg2Picture) -> None:
        self._outputs.append(OutputPicture(
            picture, picture.system_frame_number))
