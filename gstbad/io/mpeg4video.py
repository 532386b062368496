"""MPEG-4 part 2 video ES parsing
(gst/videoparsers/gstmpeg4videoparse.c over
codecparsers/gstmpeg4parser.c).

Start codes: 0x00-0x1F video_object, 0x20-0x2F video_object_layer
(VOL), 0xB0 visual_object_sequence (VOS, carries profile_indication),
0xB3 GOP, 0xB5 visual_object, 0xB6 VOP (frame; 2 coding-type bits).
The VOL header parse yields width/height (13-bit fields between marker
bits), PAR and the vop time increment resolution -> framerate.

Upstream golden (tests/check/elements/mpeg4videoparse.c:47-60):
config -> 32x24, mpegversion 4, profile from VOS byte; the config
block is the codec_data.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from gstbad.io.h264 import BitReader

SC_VOL_MIN = 0x20
SC_VOL_MAX = 0x2F
SC_VOS = 0xB0
SC_VOS_END = 0xB1
SC_USER_DATA = 0xB2
SC_GOP = 0xB3
SC_VISUAL_OBJECT = 0xB5
SC_VOP = 0xB6

VOP_I = 0
VOP_P = 1
VOP_B = 2
VOP_S = 3

# Annex G profile_and_level_indication names (the common ones gst maps)
PROFILES = {
    0x01: ("simple", "1"), 0x02: ("simple", "2"), 0x03: ("simple", "3"),
    0x08: ("simple", "0"),
    0x11: ("simple-scalable", "1"), 0x12: ("simple-scalable", "2"),
    0x21: ("core", "1"), 0x22: ("core", "2"),
    0x32: ("main", "2"), 0x33: ("main", "3"), 0x34: ("main", "4"),
    0x42: ("n-bit", "2"),
    0xF0: ("advanced-simple", "0"), 0xF1: ("advanced-simple", "1"),
    0xF2: ("advanced-simple", "2"), 0xF3: ("advanced-simple", "3"),
    0xF4: ("advanced-simple", "4"), 0xF5: ("advanced-simple", "5"),
}

PAR_TABLE = {1: (1, 1), 2: (12, 11), 3: (10, 11), 4: (16, 11),
             5: (40, 33)}


@dataclass
class Vol:
    width: int = 0
    height: int = 0
    par_n: int = 0
    par_d: int = 0
    fps_n: int = 0
    fps_d: int = 0
    profile: Optional[str] = None
    level: Optional[str] = None


def parse_vos(payload: bytes, vol: Vol) -> None:
    code = payload[0]
    prof = PROFILES.get(code)
    if prof:
        vol.profile, vol.level = prof


def parse_vol(payload: bytes, vol: Vol) -> None:
    """6.2.3 VideoObjectLayer (rectangular shape path)."""
    r = BitReader(payload)
    r.read(1)   # random_accessible_vol
    r.read(8)   # video_object_type_indication
    if r.read(1):  # is_object_layer_identifier
        r.read(4)
        r.read(3)
    aspect = r.read(4)
    if aspect == 0xF:  # extended PAR
        vol.par_n = r.read(8)
        vol.par_d = r.read(8)
    elif aspect in PAR_TABLE:
        vol.par_n, vol.par_d = PAR_TABLE[aspect]
    if r.read(1):  # vol_control_parameters
        r.read(2)  # chroma_format
        r.read(1)  # low_delay
        if r.read(1):  # vbv_parameters
            r.read(15)
            r.read(1)
            r.read(15)
            r.read(1)
            r.read(15)
            r.read(1)
            r.read(3)
            r.read(11)
            r.read(1)
            r.read(15)
            r.read(1)
    shape = r.read(2)
    if shape != 0:  # only rectangular parsed
        return
    r.read(1)  # marker
    time_increment_resolution = r.read(16)
    r.read(1)  # marker
    bits = max(1, (time_increment_resolution - 1).bit_length())
    if r.read(1):  # fixed_vop_rate
        fixed_increment = r.read(bits)
        if fixed_increment:
            vol.fps_n = time_increment_resolution
            vol.fps_d = fixed_increment
    r.read(1)  # marker
    vol.width = r.read(13)
    r.read(1)  # marker
    vol.height = r.read(13)


def vop_coding_type(payload: bytes) -> int:
    return (payload[0] >> 6) & 0x3
