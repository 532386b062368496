"""VP8 stateless-decoder base layer
(gst-libs/gst/codecs/gstvp8decoder.c + gstvp8picture.c).

VP8 has no output reordering; the decoder layer is the three-slot
reference management (last/golden/altref) with the RFC 6386
refresh/copy semantics (gstvp8decoder.c:211-274
gst_vp8_decoder_update_reference), keyframe-wait on startup
(:363-374), and resolution-change detection (:160-199).

The refresh order matters and is reproduced exactly: alternate is
updated BEFORE golden, so copy_buffer_to_golden == 2 can pick up the
NEW altref; refresh_last runs LAST, so copy_buffer_to_* == 1 always
reads the PREVIOUS last frame.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from gstbad.io import vp8 as iovp8


@dataclass(eq=False)
class Vp8Picture:
    """gstvp8picture.h GstVp8Picture."""
    system_frame_number: int = 0
    frame_hdr: Optional[iovp8.FrameHdr] = None
    data: bytes = b""


@dataclass
class OutputPicture:
    picture: Vp8Picture
    system_frame_number: int


class Vp8Decoder:
    """GstVp8Decoder over io/vp8.py's RFC 6386 parser."""

    def __init__(self) -> None:
        self.parser = iovp8.Parser()
        self.last_picture: Optional[Vp8Picture] = None
        self.golden_ref_picture: Optional[Vp8Picture] = None
        self.alt_ref_picture: Optional[Vp8Picture] = None
        self.wait_keyframe = True
        self.width = 0
        self.height = 0
        self._frame_counter = 0

    def push_frame(self, data: bytes, system_frame_number: int = -1) \
            -> List[OutputPicture]:
        """gstvp8decoder.c:330-460 handle_frame."""
        if system_frame_number < 0:
            system_frame_number = self._frame_counter
        self._frame_counter = max(self._frame_counter,
                                  system_frame_number) + 1
        hdr = self.parser.parse_frame_header(data)
        if self.wait_keyframe and not hdr.key_frame:
            return []  # drop until the first keyframe
        self.wait_keyframe = False
        if hdr.key_frame and (self.width != hdr.width
                              or self.height != hdr.height):
            self.width, self.height = hdr.width, hdr.height
        picture = Vp8Picture(system_frame_number=system_frame_number,
                             frame_hdr=hdr, data=data)
        self._update_reference(picture)
        if hdr.show_frame:
            return [OutputPicture(picture, system_frame_number)]
        return []

    def _update_reference(self, picture: Vp8Picture) -> None:
        """gstvp8decoder.c:211-274 (exact ordering)."""
        hdr = picture.frame_hdr
        if hdr.key_frame:
            self.last_picture = picture
            self.golden_ref_picture = picture
            self.alt_ref_picture = picture
            return
        if hdr.refresh_alternate_frame:
            self.alt_ref_picture = picture
        elif hdr.copy_buffer_to_alternate == 1:
            self.alt_ref_picture = self.last_picture
        elif hdr.copy_buffer_to_alternate == 2:
            self.alt_ref_picture = self.golden_ref_picture
        if hdr.refresh_golden_frame:
            self.golden_ref_picture = picture
        elif hdr.copy_buffer_to_golden == 1:
            self.golden_ref_picture = self.last_picture
        elif hdr.copy_buffer_to_golden == 2:
            self.golden_ref_picture = self.alt_ref_picture
        if hdr.refresh_last:
            self.last_picture = picture

    def flush(self) -> None:
        """gstvp8decoder.c:120-135 reset."""
        self.last_picture = None
        self.golden_ref_picture = None
        self.alt_ref_picture = None
        self.wait_keyframe = True
        self.parser = iovp8.Parser()
