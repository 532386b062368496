"""Oracle cross-validation: the from-spec ETS 300 706 teletext decoder
(io/teletext.py) against the REAL libzvbi (io/zvbi.py) — the exact
library gstteletextdec.c wraps.  Both decoders consume the same
42-byte packet streams; page text must agree row for row."""

import numpy as np
import pytest

from gstbad.io import teletext as tt
from gstbad.io import zvbi

pytestmark = pytest.mark.skipif(not zvbi.available(),
                                reason="libzvbi not present")


def _ours(lines):
    dec = tt.TeletextDecoder()
    for ln in lines:
        dec.feed_line(ln)
    dec.flush()
    return dec


def _zvbi(frames):
    dec = zvbi.ZvbiDecoder()
    for frame in frames:
        dec.feed_frame(frame)
    return dec


def _compare_page(ours_page, zvbi_rows, rows):
    got = tt.page_to_text(ours_page)
    for r in rows:
        assert got[r].rstrip() == zvbi_rows[r].rstrip(), (
            r, got[r], zvbi_rows[r])


def test_plain_rows_match_zvbi():
    hdr = tt.build_header(1, 0, 0, erase=True)
    rows = [tt.build_row(1, 1, b"HELLO ZVBI ORACLE 123"),
            tt.build_row(1, 3, b"  indented text here"),
            tt.build_row(1, 23, b"last visible row")]
    hdr2 = tt.build_header(1, 0, 1, erase=True)
    ours = _ours([hdr] + rows + [hdr2])
    z = _zvbi([[hdr] + rows, [hdr2]])
    zr = z.fetch_text(0x100)
    assert zr is not None
    page = ours.fetch(0x100)
    assert page is not None
    _compare_page(page, zr, [1, 2, 3, 22, 23])


def test_multiple_pages_and_magazines():
    streams = {
        (1, 0x100): b"magazine one page 100",
        (2, 0x200): b"magazine two page 200",
    }
    frames = []
    lines_all = []
    for (mag, pgno), text in streams.items():
        hdr = tt.build_header(mag, 0, 0, erase=True)
        row = tt.build_row(mag, 2, text)
        frames.append([hdr, row])
        lines_all += [hdr, row]
    # close both magazines with follow-up headers
    closers = [tt.build_header(1, 0, 1), tt.build_header(2, 0, 1)]
    frames.append(closers)
    lines_all += closers
    ours = _ours(lines_all)
    z = _zvbi(frames)
    for (mag, pgno), text in streams.items():
        zr = z.fetch_text(pgno)
        assert zr is not None
        page = ours.fetch(pgno)
        assert page is not None
        _compare_page(page, zr, [2])


def test_page_update_overwrites_rows():
    hdr = tt.build_header(1, 0, 0, erase=True)
    v1 = tt.build_row(1, 5, b"version one")
    hdr_again = tt.build_header(1, 0, 0, erase=True)
    v2 = tt.build_row(1, 5, b"version TWO")
    closer = tt.build_header(1, 0, 1)
    ours = _ours([hdr, v1, hdr_again, v2, closer])
    z = _zvbi([[hdr, v1], [hdr_again, v2], [closer]])
    zr = z.fetch_text(0x100)
    page = ours.fetch(0x100)
    assert page is not None and zr is not None
    assert "version TWO" in zr[5]
    _compare_page(page, zr, [5])


def test_erase_flag_clears_previous_content():
    hdr = tt.build_header(1, 0, 0, erase=True)
    r1 = tt.build_row(1, 4, b"old content to be erased")
    hdr2 = tt.build_header(1, 0, 0, erase=True)   # C4 again
    r2 = tt.build_row(1, 6, b"new content")
    closer = tt.build_header(1, 0, 1)
    ours = _ours([hdr, r1, hdr2, r2, closer])
    z = _zvbi([[hdr, r1], [hdr2, r2], [closer]])
    zr = z.fetch_text(0x100)
    page = ours.fetch(0x100)
    assert page is not None and zr is not None
    # row 4 erased in both decoders
    _compare_page(page, zr, [4, 6])
    assert zr[4].strip() == ""


def test_full_alphabet_rows():
    hdr = tt.build_header(1, 0, 0, erase=True)
    rows = []
    texts = [b"ABCDEFGHIJKLMNOPQRSTUVWXYZ 0123456789",
             b"abcdefghijklmnopqrstuvwxyz !?():;.,+-=",
             b"mixed CASE and    spacing   preserved"]
    for i, t in enumerate(texts):
        rows.append(tt.build_row(1, i + 1, t))
    closer = tt.build_header(1, 0, 1)
    ours = _ours([hdr] + rows + [closer])
    z = _zvbi([[hdr] + rows, [closer]])
    zr = z.fetch_text(0x100)
    page = ours.fetch(0x100)
    assert page is not None and zr is not None
    _compare_page(page, zr, [1, 2, 3])


def test_national_subsets_match_zvbi():
    """All 8 C12-C14 designations: the 13 substituted G0 positions
    render the same unicode as libzvbi (ETS 300 706 table 36)."""
    positions = bytes(tt.NATIONAL_POSITIONS)
    for code in range(8):
        hdr = tt.build_header(1, 0, 0, erase=True, charset=code)
        row = tt.build_row(1, 1, positions)
        closer = tt.build_header(1, 0, 1)
        ours = _ours([hdr, row, closer])
        z = _zvbi([[hdr, row], [closer]])
        zr = z.fetch_text(0x100)
        page = ours.fetch(0x100)
        assert page is not None and zr is not None
        assert page.charset == code
        got = tt.page_to_text(page)[1][:13]
        assert got == zr[1][:13], (code, got, zr[1][:13])


# -- X/26 Level 1.5 enhancements (r3) -----------------------------------------

def _triplet(address, mode, data):
    return tt.hamming2418_encode(address | (mode << 6) | (data << 11))


def _x26_lines(mag, triplets):
    """Pack a triplet stream (+ one terminator) into full X/26 packets
    with sequential designations."""
    stream = list(triplets) + [_triplet(63, 0x1F, 0)]
    while len(stream) % 13:
        stream.append(_triplet(63, 0x1F, 0))
    out = []
    for d in range(len(stream) // 13):
        payload = bytes([tt.hamming84_encode(d)])
        for t in stream[13 * d:13 * (d + 1)]:
            payload += t
        out.append(tt.build_line(mag, 26, payload))
    return out


def test_hamming2418_roundtrip_and_correction():
    rng = np.random.default_rng(3)
    for _ in range(50):
        v = int(rng.integers(0, 1 << 18))
        enc = tt.hamming2418_encode(v)
        assert tt.hamming2418(enc) == v
        # single-bit error corrects
        bit = int(rng.integers(0, 24))
        flipped = bytearray(enc)
        flipped[bit // 8] ^= 1 << (bit % 8)
        assert tt.hamming2418(bytes(flipped)) == v


@pytest.mark.skipif(not zvbi.available(), reason="no zvbi")
def test_x26_diacritics_match_zvbi():
    """G0-with-diacritic triplets: composed output agrees with zvbi's
    level-1.5 rendering for the precomposed Latin combinations."""
    hdr = tt.build_header(1, 0, 0, erase=True)
    base = tt.build_row(1, 1, b"aeonu cEAN")
    trips = [_triplet(41, 0x04, 0),
             _triplet(0, 0x10 + 2, ord("a")),    # á
             _triplet(1, 0x10 + 1, ord("e")),    # è
             _triplet(2, 0x10 + 3, ord("o")),    # ô
             _triplet(3, 0x10 + 4, ord("n")),    # ñ
             _triplet(4, 0x10 + 8, ord("u")),    # ü
             _triplet(6, 0x10 + 11, ord("c")),   # ç
             _triplet(7, 0x10 + 2, ord("E")),    # É
             _triplet(8, 0x10 + 10, ord("A")),   # Å
             _triplet(9, 0x10 + 15, ord("N"))]   # Ň
    enh = _x26_lines(1, trips)
    closer = tt.build_header(1, 0, 1)
    ours = _ours([hdr, base] + enh + [closer])
    z = _zvbi([[hdr, base] + enh, [closer]])
    zr = z.fetch_text(0x100, level=1)
    page = ours.fetch(0x100)
    got = tt.page_to_text(page)[1][:10]
    assert got == "áèôñü çÉÅŇ"
    assert got == zr[1][:10]
    # level < 1.5 leaves the base row
    assert tt.page_to_text(page, level=1.0)[1][:10] == "aeonu cEAN"


@pytest.mark.skipif(not zvbi.available(), reason="no zvbi")
def test_x26_g2_characters_match_zvbi():
    """Full G2 Latin sweep (0x20-0x7F) over three rows agrees with
    zvbi cell-for-cell."""
    hdr = tt.build_header(1, 0, 0, erase=True)
    rows = [tt.build_row(1, r, b"." * 40) for r in (1, 2, 3)]
    trips = []
    vals = list(range(0x20, 0x80))
    idx = 0
    for r in (1, 2, 3):
        trips.append(_triplet(40 + r, 0x04, 0))
        for c in range(40):
            if idx >= len(vals):
                break
            trips.append(_triplet(c, 0x0F, vals[idx]))
            idx += 1
    enh = _x26_lines(1, trips)
    closer = tt.build_header(1, 0, 1)
    ours = _ours([hdr] + rows + enh + [closer])
    z = _zvbi([[hdr] + rows + enh, [closer]])
    zr = z.fetch_text(0x100, level=1)
    page = ours.fetch(0x100)
    got = tt.page_to_text(page)
    for r in (1, 2, 3):
        assert got[r] == zr[r], (r, got[r], zr[r])


@pytest.mark.skipif(not zvbi.available(), reason="no zvbi")
def test_x26_addressing_quirks_match_zvbi():
    """address 40 = row 24; backward column addresses clamp to the
    active column (both calibrated against zvbi)."""
    hdr = tt.build_header(1, 0, 0, erase=True)
    rows = [tt.build_row(1, r, b"." * 40) for r in range(1, 25)]
    trips = [_triplet(40, 0x04, 0), _triplet(0, 0x0F, 0x23),   # row 24
             _triplet(41, 0x04, 0),
             _triplet(8, 0x0F, 0x23),     # col 8
             _triplet(2, 0x0F, 0x24),     # backward -> applies at 8
             _triplet(12, 0x0F, 0x25)]
    enh = _x26_lines(1, trips)
    closer = tt.build_header(1, 0, 1)
    ours = _ours([hdr] + rows + enh + [closer])
    z = _zvbi([[hdr] + rows + enh, [closer]])
    zr = z.fetch_text(0x100, level=1)
    got = tt.page_to_text(ours.fetch(0x100))
    assert got[24][:2] == zr[24][:2] == "£."
    assert got[1][:16] == zr[1][:16] == "........$...¥..."


# -- Level 2.5: X/28 / M/29 extensions + X/26 colours (r3) --------------------
#
# zvbi exposes the full vbi_page (per-cell fg/bg CLUT indices, the
# 40-entry colour map, screen colour) through io/zvbi.py fetch_page;
# every semantic below is validated cell-for-cell against it.

def _cells(page, level):
    rp = tt.render_cells(page, level=level)
    fg = [[c.fg for c in row] for row in rp.cells]
    bg = [[c.bg for c in row] for row in rp.cells]
    return rp, fg, bg


def test_x28_clut_redefinition_matches_zvbi():
    colors = [(i, (i + 5) & 0xF, (i + 10) & 0xF) for i in range(16)]
    hdr = tt.build_header(1, 0, 0, erase=True)
    x28 = tt.build_x28(1, 0, colors=colors)
    rows = [tt.build_row(1, 1, b"COLORTEST")]
    closer = tt.build_header(1, 0, 1)
    ours = _ours([hdr, x28] + rows + [closer])
    z = _zvbi([[hdr, x28] + rows, [closer]])
    zp = z.fetch_page(0x100, level=zvbi.VBI_WST_LEVEL_2p5)
    rp, _fg, _bg = _cells(ours.fetch(0x100), 2.5)
    ext = tt.page_extension(ours.fetch(0x100), 2.5)
    assert [ext.color_map[i] for i in range(16, 32)] \
        == zp["color_map"][16:32]
    # 12-bit components scale x17 (probe-verified)
    assert ext.color_map[16] == 0xFF000000 | (10 * 17 << 16) \
        | (5 * 17 << 8) | 0
    # zvbi applies X/28/0 at EVERY fetch level (probe-verified): so
    # does page_extension
    zp1 = z.fetch_page(0x100, level=zvbi.VBI_WST_LEVEL_1)
    ext15 = tt.page_extension(ours.fetch(0x100), 1.5)
    assert [ext15.color_map[i] for i in range(16, 32)] \
        == zp1["color_map"][16:32]


def test_x28_remap_matches_zvbi():
    row_text = b"AB\x01CD\x1dEF\x1cGH"
    for remap in (1, 2, 3, 4, 5, 6, 7):
        hdr = tt.build_header(1, 0, 0, erase=True)
        x28 = tt.build_x28(1, 0, remap=remap)
        lines = [hdr, x28, tt.build_row(1, 1, row_text)]
        closer = tt.build_header(1, 0, 1)
        ours = _ours(lines + [closer])
        z = _zvbi([lines, [closer]])
        zp = z.fetch_page(0x100, level=zvbi.VBI_WST_LEVEL_2p5)
        _rp, fg, bg = _cells(ours.fetch(0x100), 2.5)
        assert fg[1] == zp["fg"][1][:40], remap
        assert bg[1] == zp["bg"][1][:40], remap


def test_x28_default_screen_color_matches_zvbi():
    hdr = tt.build_header(1, 0, 0, erase=True)
    x28 = tt.build_x28(1, 0, screen_color=7, row_color=8)
    lines = [hdr, x28, tt.build_row(1, 1, b"SCREEN")]
    closer = tt.build_header(1, 0, 1)
    ours = _ours(lines + [closer])
    z = _zvbi([lines, [closer]])
    zp = z.fetch_page(0x100, level=zvbi.VBI_WST_LEVEL_2p5)
    rp, _fg, _bg = _cells(ours.fetch(0x100), 2.5)
    assert rp.screen_color == zp["screen_color"] == 7
    assert rp.ext.def_row_color == 8
    # zvbi applies the extension's screen colour at every level
    zp1 = z.fetch_page(0x100, level=zvbi.VBI_WST_LEVEL_1p5)
    rp1, _f, _b = _cells(ours.fetch(0x100), 1.5)
    assert rp1.screen_color == zp1["screen_color"] == 7


def test_x26_color_triplets_match_zvbi():
    # fg from col 5 persists to the spacing colour attr; bg from
    # col 10 persists through it; 5-bit CLUT2/3 values allowed
    hdr = tt.build_header(1, 0, 0, erase=True)
    trips = [_triplet(41, 0x04, 0),
             _triplet(5, 0x00, 20),     # fg CLUT2 entry 4 at col 5
             _triplet(10, 0x03, 27),    # bg CLUT3 entry 3 at col 10
             _triplet(43, 0x04, 0),
             _triplet(2, 0x00, 9),
             _triplet(6, 0x00, 12)]     # later fg overrides from col 6
    enh = _x26_lines(1, trips)
    rows = [tt.build_row(1, 1, b"ABCDEFGHIJKLM\x02NOPQ"),
            tt.build_row(1, 3, b"ABCDEFGHIJ")]
    closer = tt.build_header(1, 0, 1)
    lines = [hdr] + enh + rows
    ours = _ours(lines + [closer])
    z = _zvbi([lines, [closer]])
    zp = z.fetch_page(0x100, level=zvbi.VBI_WST_LEVEL_2p5)
    _rp, fg, bg = _cells(ours.fetch(0x100), 2.5)
    for r in (1, 3):
        assert fg[r] == zp["fg"][r][:40], r
        assert bg[r] == zp["bg"][r][:40], r
    # level 1.5 drops the colours but keeps Level 1 attributes
    zp1 = z.fetch_page(0x100, level=zvbi.VBI_WST_LEVEL_1p5)
    _rp1, fg1, bg1 = _cells(ours.fetch(0x100), 1.5)
    for r in (1, 3):
        assert fg1[r] == zp1["fg"][r][:40], r
        assert bg1[r] == zp1["bg"][r][:40], r


def test_x26_full_screen_color_matches_zvbi():
    hdr = tt.build_header(1, 0, 0, erase=True)
    enh = _x26_lines(1, [_triplet(41, 0x00, 5)])
    lines = [hdr] + enh + [tt.build_row(1, 1, b"X")]
    closer = tt.build_header(1, 0, 1)
    ours = _ours(lines + [closer])
    z = _zvbi([lines, [closer]])
    zp = z.fetch_page(0x100, level=zvbi.VBI_WST_LEVEL_2p5)
    rp, _fg, _bg = _cells(ours.fetch(0x100), 2.5)
    assert rp.screen_color == zp["screen_color"] == 5


def test_m29_magazine_default_and_x28_override():
    colors_a = [(1, 2, 3)] * 16
    colors_b = [(4, 5, 6)] * 16
    hdr = tt.build_header(1, 0, 0, erase=True)
    m29 = tt.build_x28(1, 0, colors=colors_a, row=29)
    lines = [m29, hdr, tt.build_row(1, 1, b"M29")]
    closer = tt.build_header(1, 0, 1)
    ours = _ours(lines + [closer])
    z = _zvbi([lines, [closer]])
    zp = z.fetch_page(0x100, level=zvbi.VBI_WST_LEVEL_2p5)
    ext = tt.page_extension(ours.fetch(0x100), 2.5)
    assert [ext.color_map[i] for i in range(16, 32)] \
        == zp["color_map"][16:32]
    assert ext.color_map[16] == 0xFF000000 | (3 * 17 << 16) \
        | (2 * 17 << 8) | (1 * 17)
    # a page-level X/28 wins over the magazine default
    hdr2 = tt.build_header(1, 0, 0, erase=True)
    x28 = tt.build_x28(1, 0, colors=colors_b)
    lines2 = [m29, hdr2, x28, tt.build_row(1, 1, b"X28")]
    ours2 = _ours(lines2 + [closer])
    z2 = _zvbi([lines2, [closer]])
    zp2 = z2.fetch_page(0x100, level=zvbi.VBI_WST_LEVEL_2p5)
    ext2 = tt.page_extension(ours2.fetch(0x100), 2.5)
    assert [ext2.color_map[i] for i in range(16, 32)] \
        == zp2["color_map"][16:32]
    assert ext2.color_map[16] == 0xFF000000 | (6 * 17 << 16) \
        | (5 * 17 << 8) | (4 * 17)


def test_x28_4_clut01_matches_zvbi_incl_quirks():
    """X/28/4 redefines CLUT 0/1 at every level in zvbi, with its
    CLUT 1 quirks: entry 8 kept, 13 aliases transmitted 11, 14 takes
    12's R/G over its default B/alpha (all reproduced verbatim)."""
    colors = [((i + 3) & 0xF, i, (i + 7) & 0xF) for i in range(16)]
    hdr = tt.build_header(1, 0, 0, erase=True)
    x28_4 = tt.build_x28(1, 4, colors=colors)
    lines = [hdr, x28_4, tt.build_row(1, 1, b"CLUT01")]
    closer = tt.build_header(1, 0, 1)
    ours = _ours(lines + [closer])
    z = _zvbi([lines, [closer]])
    for zlvl, olvl in ((zvbi.VBI_WST_LEVEL_3p5, 3.5),
                       (zvbi.VBI_WST_LEVEL_2p5, 2.5),
                       (zvbi.VBI_WST_LEVEL_1, 1.0)):
        zp = z.fetch_page(0x100, level=zlvl)
        ext = tt.page_extension(ours.fetch(0x100), olvl)
        assert [ext.color_map[i] for i in range(0, 16)] \
            == zp["color_map"][0:16], olvl
