"""H.263 bitstream parsing (gst/videoparsers/gsth263parse.c +
h263parse.c lib).

Picture start code: 22 bits (16 zeros + '1' + 5 more zeros) — byte
aligned in practice: 00 00 followed by a byte whose top 6 bits are
100000 (third byte & 0xFC == 0x80).  The picture header carries TR,
PTYPE (split screen/doc camera/freeze + 3-bit source format) and, for
source format 111, the PLUSPTYPE extension with custom picture formats
(UFEP, CPFMT width/height fields).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from gstbad.io.h264 import BitReader

# source format -> (width, height) (H.263 table 6)
FORMATS = {1: (128, 96), 2: (176, 144), 3: (352, 288),
           4: (704, 576), 5: (1408, 1152)}


@dataclass
class Picture:
    tr: int = 0
    source_format: int = 0
    width: int = 0
    height: int = 0
    intra: bool = False
    plusptype: bool = False


def find_psc(data: bytes, start: int = 0) -> int:
    """Next byte-aligned picture start code offset, or -1."""
    pos = start
    while True:
        pos = data.find(b"\x00\x00", pos)
        if pos < 0 or pos + 2 >= len(data):
            return -1
        if (data[pos + 2] & 0xFC) == 0x80:
            return pos
        pos += 1


def parse_picture(data: bytes) -> Picture:
    """Picture layer header starting at the PSC (5.1)."""
    r = BitReader(data)
    if r.read(22) != 0x20:
        raise ValueError("not an h263 picture start code")
    pic = Picture()
    pic.tr = r.read(8)
    if r.read(1) != 1 or r.read(1) != 0:
        raise ValueError("bad PTYPE marker bits")
    r.read(3)  # split screen, document camera, freeze release
    fmt = r.read(3)
    pic.source_format = fmt
    if fmt in FORMATS:
        pic.width, pic.height = FORMATS[fmt]
        pic.intra = r.read(1) == 0  # picture coding type: 0 = INTRA
    elif fmt == 7:  # PLUSPTYPE (H.263+)
        pic.plusptype = True
        ufep = r.read(3)
        if ufep == 1:
            fmt2 = r.read(3)
            r.read(15)  # OPPTYPE remainder
            ptype_mppt = r.read(3)
            pic.intra = ptype_mppt == 0
            r.read(6)   # MPPTYPE remainder
            r.read(1)   # CPM
            if fmt2 == 6:  # custom picture format -> CPFMT
                r.read(4)  # PAR code
                pic.width = (r.read(9) + 1) * 4
                r.read(1)  # marker
                pic.height = r.read(9) * 4
            elif fmt2 in FORMATS:
                pic.width, pic.height = FORMATS[fmt2]
        else:
            ptype_mppt = r.read(3)
            pic.intra = ptype_mppt == 0
    return pic
