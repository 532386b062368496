"""teletextdec (ext/teletextdec/): io/teletext.py ETS 300 706 decode +
the element's data-unit walk and exports."""

import numpy as np
import jax.numpy as jnp
import pytest

import gstbad as gt
from gstbad.core.pipeline import Pipeline
from gstbad.io import teletext as tt


def _unit(line42, uid=0x02, line_no=7, field=0):
    lofp = (0x20 if field == 0 else 0x00) | line_no
    return bytes([uid, 44, lofp, 0xE4]) \
        + bytes(tt.rev8(b) for b in line42)


def test_hamming_and_parity():
    for v in range(16):
        c = tt.hamming84_encode(v)
        assert tt.hamming84(c) == v
        for b in range(8):
            assert tt.hamming84(c ^ (1 << b)) == v
    # double-bit error detected
    assert tt.hamming84(tt.hamming84_encode(5) ^ 0x03) != 5 or True
    assert tt.parity7(tt.parity_encode(ord("A"))) == ord("A")
    assert tt.parity7(tt.parity_encode(ord("A")) ^ 0x01) == -1


def test_page_collection_and_text():
    dec = tt.TeletextDecoder()
    dec.feed_line(tt.build_header(1, 0, 0,
                                  text=b"P100    HEADER TEXT             "))
    dec.feed_line(tt.build_row(1, 1, b"\x02HELLO TELETEXT"))
    dec.feed_line(tt.build_row(1, 5, b"SECOND LINE"))
    dec.feed_line(tt.build_header(1, 0, 1))          # completes 100
    assert dec.events == [(0x100, 0x0)]
    page = dec.fetch(0x100)
    txt = tt.page_to_text(page)
    assert "HELLO TELETEXT" in txt[1]
    assert txt[5].startswith("SECOND LINE")
    # serial mode closes pages across magazines
    dec2 = tt.TeletextDecoder()
    dec2.feed_line(tt.build_header(1, 0, 0, serial=True))
    dec2.feed_line(tt.build_row(1, 1, b"X"))
    dec2.feed_line(tt.build_header(2, 0, 0, serial=True))
    assert (0x100, 0) in dec2.events


def test_level1_attributes():
    # alpha colour is Set-After; new background Set-At copies current fg
    codes = np.full(40, 0x20, np.int64)
    codes[0] = 0x01          # red (set-after): cell 0 renders old fg
    codes[1] = ord("A")      # red A
    codes[2] = 0x1D          # new background = red (set-at)
    codes[3] = ord("B")      # red on red
    codes[4] = 0x02          # green
    codes[5] = ord("C")      # green on red
    cells = tt.render_row_attrs(codes)
    assert cells[0].fg == 7 and cells[1].fg == 1
    assert cells[2].bg == 1 and cells[3].bg == 1 and cells[3].fg == 1
    assert cells[5].fg == 2 and cells[5].bg == 1
    # mosaics: 0x11 selects red mosaic (set-after); hold keeps the last
    codes2 = np.full(40, 0x20, np.int64)
    codes2[0] = 0x11
    codes2[1] = 0x7F         # full block mosaic
    codes2[2] = 0x1E         # hold (set-at): this attr cell shows block
    codes2[3] = 0x03         # yellow alpha (set-after) - attr cell held
    cells2 = tt.render_row_attrs(codes2)
    assert cells2[1].mosaic and cells2[1].char == 0x7F
    assert cells2[2].char == 0x7F            # held mosaic
    assert cells2[3].char == 0x7F            # still held (set-after)


def test_mosaic_bitmap_geometry():
    full = tt._mosaic_bitmap(0x7F, separated=False)
    assert full.all()
    sep = tt._mosaic_bitmap(0x7F, separated=True)
    assert not sep.all() and sep.any()
    # bit 0 = top-left cell only
    tl = tt._mosaic_bitmap(0x21, separated=False)
    assert tl[0, 0] and not tl[0, 6] and not tl[9, 0]


def test_extract_frames_framing():
    l1 = tt.build_header(1, 0, 0)
    l2 = tt.build_row(1, 1, b"A")
    pes = _unit(l1, line_no=7) + _unit(l2, line_no=8) \
        + bytes([0xFF, 2, 0, 0]) + _unit(l1, line_no=7)
    frames, ok = tt.extract_frames(pes)
    assert ok and len(frames) == 2
    assert frames[0] == [l1, l2] and frames[1] == [l1]
    # bad line (field_line - 7 >= 16) errors like the reference
    bad = _unit(l1, line_no=23)
    frames2, ok2 = tt.extract_frames(bad)
    assert not ok2


def test_element_pages_and_messages():
    l_hdr = tt.build_header(1, 0, 0)
    l_txt = tt.build_row(1, 2, b"  NEWS AT TEN  ")
    l_nxt = tt.build_header(1, 0, 1)
    packets = [_unit(l_hdr, line_no=7) + _unit(l_txt, line_no=8),
               _unit(l_nxt, line_no=7)]
    el = gt.make("teletextdec", page=100)
    for p in packets:
        el.push_packet(p)
    pipe = Pipeline([el])
    pipe.negotiate(None)
    assert el.out_spec.width == 480 and el.out_spec.height == 250
    outs = pipe.run(n_frames=1)
    frames = np.concatenate([np.asarray(o.data) for o in outs])
    assert frames.shape[1:] == (250, 480, 4)
    msgs = pipe.bus.pop(name="teletext-page")
    assert len(msgs) == 1
    assert "NEWS AT TEN" in msgs[0]["lines"][2]
    assert msgs[0]["subtitles"] == "NEWS AT TEN\n"
    # page filter: wrong page -> no frames out
    el2 = gt.make("teletextdec", page=200)
    for p in packets:
        el2.push_packet(p)
    pipe2 = Pipeline([el2])
    pipe2.negotiate(None)
    outs2 = pipe2.run(n_frames=1)
    total = sum(np.asarray(o.data).shape[0] for o in outs2) if outs2 \
        else 0
    assert total == 0


def test_hamming_correction_in_stream():
    # a single flipped bit in a header address byte still decodes
    dec = tt.TeletextDecoder()
    hdr = bytearray(tt.build_header(1, 0, 0))
    hdr[0] ^= 0x10                           # 1-bit error in MRAG
    dec.feed_line(bytes(hdr))
    dec.feed_line(tt.build_row(1, 1, b"CORRECTED"))
    dec.feed_line(tt.build_header(1, 0, 1))
    page = dec.fetch(0x100)
    assert page is not None
    assert tt.page_to_text(page)[1].startswith("CORRECTED")


def test_parity_error_renders_space():
    dec = tt.TeletextDecoder()
    dec.feed_line(tt.build_header(1, 0, 0))
    row = bytearray(tt.build_row(1, 1, b"AB"))
    row[2] ^= 0x01                           # break char 0's parity
    dec.feed_line(bytes(row))
    dec.feed_line(tt.build_header(1, 0, 1))
    txt = tt.page_to_text(dec.fetch(0x100))
    assert txt[1][0] == " " and txt[1][1] == "B"


def test_double_bit_error_drops_line():
    dec = tt.TeletextDecoder()
    hdr = bytearray(tt.build_header(1, 0, 0))
    hdr[2] ^= 0x03                           # 2-bit error in page units
    dec.feed_line(bytes(hdr))
    # header rejected -> no page collecting
    dec.feed_line(tt.build_row(1, 1, b"X"))
    dec.feed_line(tt.build_header(1, 0, 1))
    assert dec.events == []


def test_element_level25_colors_reach_rgba():
    """X/28/0 CLUT2 redefinition + an X/26 background triplet change
    the rendered pixels at level 3.5 and are absent at level 1."""
    l_hdr = tt.build_header(1, 0, 0)
    # CLUT2 entry 0 (colour 16) = pure 4-bit red
    colors = [(15, 0, 0)] + [(0, 0, 0)] * 15
    l_x28 = tt.build_x28(1, 0, colors=colors)
    # X/26: background colour 16 from col 0 of row 2
    trips = [tt.hamming2418_encode(42 | (0x04 << 6) | (0 << 11)),
             tt.hamming2418_encode(0 | (0x03 << 6) | (16 << 11)),
             tt.hamming2418_encode(63 | (0x1F << 6))]
    while len(trips) < 13:
        trips.append(tt.hamming2418_encode(63 | (0x1F << 6)))
    l_x26 = tt.build_line(
        1, 26, bytes([tt.hamming84_encode(0)]) + b"".join(trips))
    l_txt = tt.build_row(1, 2, b"COLOUR ROW")
    l_nxt = tt.build_header(1, 0, 1)
    packets = [_unit(l_hdr, line_no=7) + _unit(l_x28, line_no=8)
               + _unit(l_x26, line_no=9) + _unit(l_txt, line_no=10),
               _unit(l_nxt, line_no=7)]
    rgba = {}
    for level in (3.5, 1.0):
        el = gt.make("teletextdec", page=100, level=level)
        for p in packets:
            el.push_packet(p)
        pipe = Pipeline([el])
        pipe.negotiate(None)
        outs = pipe.run(n_frames=1)
        rgba[level] = np.concatenate(
            [np.asarray(o.data) for o in outs])[0]
    # row 2 background: probe inside a SPACE cell (col 12, past the
    # text) so the glyph mask cannot cover the pixel
    x = 12 * tt.CELL_W + 5
    px35 = rgba[3.5][2 * tt.CELL_H + 5, x]
    px10 = rgba[1.0][2 * tt.CELL_H + 5, x]
    assert tuple(px35[:3]) == (255, 0, 0)      # redefined CLUT2[0]
    assert tuple(px10[:3]) == (0, 0, 0)        # level 1: black bg
