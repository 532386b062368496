"""VP9 bitstream parsing (gst/videoparsers/gstvp9parse.c over
codecparsers/gstvp9parser.c).

From-spec (VP9 Bitstream & Decoding Process Specification) pieces the
parser element needs:
  - superframe index parse (marker 0b110 in the LAST byte: frame count
    and per-frame sizes appended after the frames) and splitting;
  - uncompressed frame header: frame marker, profile bits (low+high),
    show_existing_frame, frame_type/show_frame/error_resilient, the
    keyframe sync code 0x498342, color config (bit depth for profiles
    >= 2, color space, subsampling for profiles 1/3) and
    frame_size_minus_1 -> width/height.

Upstream goldens (tests/check/elements/vp9parse.h, webmproject.org
levels vector): 256x144 profile 0, and a 6171-byte superframe that
splits into 5796 + 369 byte frames.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from gstbad.io.h264 import BitReader

FRAME_KEY = 0
FRAME_INTER = 1

CS_RGB = 7


@dataclass
class FrameHdr:
    profile: int = 0
    show_existing_frame: bool = False
    frame_to_show: int = 0
    frame_type: int = FRAME_KEY
    show_frame: bool = True
    error_resilient: bool = False
    bit_depth: int = 8
    color_space: int = 0
    subsampling_x: int = 1
    subsampling_y: int = 1
    width: int = 0
    height: int = 0


def split_superframe(data: bytes) -> List[bytes]:
    """VP9 superframe index: last byte 0b110xxxxx with bytes-per-size
    and frame count; the same byte leads the index."""
    if not data:
        return []
    marker = data[-1]
    if (marker & 0xE0) != 0xC0:
        return [data]
    bytes_per = ((marker >> 3) & 0x3) + 1
    count = (marker & 0x7) + 1
    index_size = 2 + bytes_per * count
    if len(data) < index_size or data[-index_size] != marker:
        return [data]
    sizes = []
    pos = len(data) - index_size + 1
    for _ in range(count):
        sizes.append(int.from_bytes(data[pos:pos + bytes_per],
                                    "little"))
        pos += bytes_per
    frames = []
    off = 0
    for s in sizes:
        frames.append(data[off:off + s])
        off += s
    if off > len(data) - index_size:
        return [data]  # corrupt index
    return frames


def parse_frame_header(data: bytes) -> FrameHdr:
    """6.2 uncompressed_header (the prefix vp9parse consumes)."""
    r = BitReader(data)
    hdr = FrameHdr()
    if r.read(2) != 2:
        raise ValueError("bad vp9 frame marker")
    low = r.read(1)
    high = r.read(1)
    hdr.profile = (high << 1) | low
    if hdr.profile == 3:
        r.read(1)  # reserved
    if r.read(1):  # show_existing_frame
        hdr.show_existing_frame = True
        hdr.frame_to_show = r.read(3)
        return hdr
    hdr.frame_type = r.read(1)
    hdr.show_frame = bool(r.read(1))
    hdr.error_resilient = bool(r.read(1))
    if hdr.frame_type == FRAME_KEY:
        if r.read(24) != 0x498342:
            raise ValueError("bad vp9 sync code")
        _color_config(r, hdr)
        hdr.width = r.read(16) + 1
        hdr.height = r.read(16) + 1
    return hdr


def _color_config(r: BitReader, hdr: FrameHdr) -> None:
    if hdr.profile >= 2:
        hdr.bit_depth = 12 if r.read(1) else 10
    else:
        hdr.bit_depth = 8
    hdr.color_space = r.read(3)
    if hdr.color_space != CS_RGB:
        r.read(1)  # color_range
        if hdr.profile in (1, 3):
            hdr.subsampling_x = r.read(1)
            hdr.subsampling_y = r.read(1)
            r.read(1)  # reserved
        else:
            hdr.subsampling_x = hdr.subsampling_y = 1
    else:
        hdr.subsampling_x = hdr.subsampling_y = 0
        if hdr.profile in (1, 3):
            r.read(1)  # reserved


def chroma_format(hdr: FrameHdr) -> str:
    return {(1, 1): "4:2:0", (1, 0): "4:2:2",
            (0, 0): "4:4:4", (0, 1): "4:4:0"}[
        (hdr.subsampling_x, hdr.subsampling_y)]
