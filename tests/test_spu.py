"""VobSub SPU bitstream decode (io/spu.py) + dvdspu element.

The test assembles a real SPU packet byte-for-byte per the DVD subpicture
spec (independent of the parser)."""

import numpy as np
import jax.numpy as jnp

import gstbad as gt
from gstbad.core.frame import FrameBatch
from gstbad.core.pipeline import Pipeline
from gstbad.core.spec import MediaSpec
from gstbad.io import spu as spuio


def _nibbles_to_bytes(nibs):
    if len(nibs) % 2:
        nibs = nibs + [0]
    return bytes((nibs[i] << 4) | nibs[i + 1] for i in range(0, len(nibs), 2))


def _rle(run, color):
    """Encode one run as SPU nibbles."""
    code = (run << 2) | color
    if run == 0:
        return [0, 0, 0, color]           # 4-nibble code with run 0
    if code < 0x10:
        return [code]
    if code < 0x100:
        return [code >> 4, code & 0xF]
    if code < 0x1000:
        return [code >> 8, (code >> 4) & 0xF, code & 0xF]
    return [(code >> 12) & 0xF, (code >> 8) & 0xF, (code >> 4) & 0xF,
            code & 0xF]


def make_spu_packet(top=4, left=8, w=16, h=4):
    """A w x h subpicture: each line = color 1 for w//2, color 2 to end."""
    # pixel data: top field = lines 0,2; bottom field = lines 1,3
    def field_lines(n):
        nibs = []
        lines = []
        for _ in range(n):
            ln = _rle(w // 2, 1) + _rle(0, 2)   # run then fill-to-end
            if len(ln) % 2:
                ln = ln + [0]                  # byte-align per line
            lines.append(ln)
        return [x for ln in lines for x in ln]

    topf = _nibbles_to_bytes(field_lines(2))
    botf = _nibbles_to_bytes(field_lines(2))
    pix0 = 4
    pix1 = pix0 + len(topf)
    dcsqt = pix1 + len(botf)
    cmds = bytearray()
    cmds += bytes([0x03, 0x01, 0x23])          # SET_COLOR idx 3,2,1,0 nibbles
    cmds += bytes([0x04, 0xFF, 0xF0])          # SET_ALPHA a3=15,a2=15,a1=15,a0=0
    right = left + w - 1
    bottom = top + h - 1
    cmds += bytes([0x05, left >> 4, ((left & 0xF) << 4) | (right >> 8),
                   right & 0xFF, top >> 4,
                   ((top & 0xF) << 4) | (bottom >> 8), bottom & 0xFF])
    cmds += bytes([0x06, pix0 >> 8, pix0 & 0xFF, pix1 >> 8, pix1 & 0xFF])
    cmds += bytes([0x01])                      # DSP
    cmds += bytes([0xFF])                      # END
    # second DCSQ: hide after delay 90 ticks
    dcsq2 = dcsqt + 4 + len(cmds)
    pkt = bytearray()
    pkt += b"\x00\x00"                         # total size (patched below)
    pkt += bytes([dcsqt >> 8, dcsqt & 0xFF])
    pkt += topf + botf
    pkt += bytes([0, 0])                       # DCSQ1 delay 0
    pkt += bytes([dcsq2 >> 8, dcsq2 & 0xFF])
    pkt += cmds
    pkt += bytes([0, 90])                      # DCSQ2 delay 90
    pkt += bytes([dcsq2 >> 8, dcsq2 & 0xFF])   # next = self (last)
    pkt += bytes([0x02, 0xFF])                 # STP_DSP, END
    total = len(pkt)
    pkt[0] = total >> 8
    pkt[1] = total & 0xFF
    return bytes(pkt)


def test_parse_and_rle():
    pkt = make_spu_packet()
    pic = spuio.parse_spu(pkt)
    assert pic.rect == (4, 8, 7, 23)
    assert pic.width == 16 and pic.height == 4
    assert pic.main_idx == [3, 2, 1, 0]        # nibbles 0x01,0x23 reversed
    assert pic.main_alpha == [0, 15, 15, 15]
    assert pic.show_ticks == 0 and pic.hide_ticks == 90
    idx = spuio.decode_rle(pic)
    want = np.zeros((4, 16), np.uint8)
    want[:, :8] = 1
    want[:, 8:] = 2
    np.testing.assert_array_equal(idx, want)


def test_spu_to_ayuv_guessed_palette():
    pic = spuio.parse_spu(make_spu_packet())
    ov = spuio.spu_to_ayuv(pic)   # no CLUT -> white/grey ramp
    # colour 1 (alpha 15): first non-transparent = Y 240...
    assert ov[0, 0, 0] == 255     # alpha (15<<4)|15
    assert ov[0, 0, 1] in (240, 128)
    assert (ov[..., 2] == 128).all() and (ov[..., 3] == 128).all()


def test_dvdspu_element_blends_in_window():
    pkt = make_spu_packet()
    el = gt.make("dvdspu")
    clut = np.zeros(16, np.uint32)
    clut[1] = 0x00AA4060   # Y=0xAA V=0x40 U=0x60 for palette entry 1
    clut[2] = 0x00551020
    clut[3] = 0x00111111
    el.push_spu(pkt, pts_ns=0, clut=clut)
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="AYUV", width=32,
                          height=16, framerate=__import__("fractions")
                          .Fraction(30)))
    img = np.full((3, 16, 32, 4), 64, np.uint8)
    hide_ns = 90 * 1024 * 10**9 // 90000
    pts = jnp.asarray([0, hide_ns - 1, hide_ns + 1], jnp.int64)
    outs = p.run(inputs=FrameBatch.make(jnp.asarray(img), pts=pts))
    out = np.concatenate([np.asarray(o.data) for o in outs])
    # frame 0 and 1: inside the display window -> blended at rect.
    # SET_COLOR maps colour i -> CLUT[main_idx[i]]: colour 1 -> clut[2],
    # colour 2 -> clut[1] (gstspu-vobsub.c:148-163 nibble order)
    inside = out[0, 4, 8]     # colour 1, alpha 255 -> pure palette colour
    assert inside[1] == 0x55 and inside[2] == 0x20 and inside[3] == 0x10
    assert out[0, 4, 8 + 8, 1] == 0xAA       # colour 2 region
    np.testing.assert_array_equal(out[0, 0, 0], img[0, 0, 0])  # outside rect
    np.testing.assert_array_equal(out[1, 4, 8], out[0, 4, 8])
    # frame 2: window expired -> untouched
    np.testing.assert_array_equal(out[2], img[2])


def test_chg_colcon_per_line_palettes():
    """CHG_COLCON (gstspu-vobsub.c:55-121, 217-234): lines in [top,
    bottom] re-map colours from each change's left column on."""
    # Build a CHG_COLCON command block: one LN_CTLI covering video lines
    # 5..6 with two changes: cols>=8 palette A, cols>=16 palette B.
    # Palette word: idx nibbles bits 28..16 (c3..c0), alpha 12..0.
    def palword(idx, alpha):
        w = 0
        for i in range(4):
            w |= idx[i] << (16 + 4 * i)
            w |= alpha[i] << (4 * i)
        return w

    ln = bytes([0x00, 5, (2 << 4) | 0x00, 6])     # top=5, n=2, bottom=6
    ch1 = bytes([0x00, 8]) + palword([4, 5, 6, 7],
                                     [15, 15, 15, 15]).to_bytes(4, "big")
    ch2 = bytes([0x00, 16]) + palword([8, 9, 10, 11],
                                      [15, 0, 15, 15]).to_bytes(4, "big")
    body = ln + ch1 + ch2 + (0x0FFFFFFF).to_bytes(4, "big")

    pic = spuio.parse_spu(make_spu_packet())
    pic.line_ctrl = spuio._parse_chg_colcon(body)
    assert len(pic.line_ctrl) == 1
    lc = pic.line_ctrl[0]
    assert (lc.top, lc.bottom) == (5, 6)
    assert lc.changes[0][0] == 8 and lc.changes[1][0] == 16

    clut = np.arange(16, dtype=np.uint32) * 0x00111111
    ov = spuio.spu_to_ayuv(pic, clut)
    base = spuio.spu_to_ayuv(spuio.parse_spu(make_spu_packet()), clut)
    # rows 4 and 7 (video lines 4, 7) unchanged; rows 5-6 remapped
    np.testing.assert_array_equal(ov[0], base[0])
    np.testing.assert_array_equal(ov[3], base[3])
    # pixel colour index at row 1 (video line 5): cols 0..7 are colour 1,
    # cols 8.. are colour 2 (make_spu_packet layout), all cols >= left=8
    # of the rect start -> change 1 palette (idx 4+i) applies at rect
    # x 0..7 (video cols 8..15), change 2 (idx 8+i) at x >= 8
    assert ov[1, 0, 1] == (clut[4 + 1] >> 16) & 0xFF     # colour 1 -> idx 5
    assert ov[1, 8, 1] == (clut[8 + 2] >> 16) & 0xFF     # colour 2 -> idx 10
    assert ov[1, 8, 0] == 0xFF                           # alpha f -> 255
