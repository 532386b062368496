"""libzvbi ctypes binding — the ORACLE for the from-spec teletext
decoder (io/teletext.py).

The reference teletextdec IS a zvbi wrapper (gstteletextdec.c:298-312
vbi_decoder_new + vbi_event_handler_register(VBI_EVENT_TTX_PAGE),
:536-553 vbi_decode with 0.04 s frame steps, :762-796
vbi_fetch_vt_page + vbi_print_page_region).  This environment ships
libzvbi.so.0, so tests can drive the EXACT library the reference uses
against this repo's ETS 300 706 implementation and compare page text.

Byte order: sliced data bytes are the 42 teletext-packet bytes in the
same MSB-first convention the repo's builders emit (the reference
rev8s raw DVB stream bytes into this form, gstteletextdec.c:1105).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

VBI_SLICED_TELETEXT_B = 0x00000003
VBI_EVENT_TTX_PAGE = 0x0002
VBI_ANY_SUBNO = 0x3F7F
VBI_WST_LEVEL_1 = 0
VBI_WST_LEVEL_1p5 = 1
VBI_WST_LEVEL_2p5 = 2
VBI_WST_LEVEL_3p5 = 3

_lib = None
_tried = False


class Sliced(ctypes.Structure):
    _fields_ = [("id", ctypes.c_uint32), ("line", ctypes.c_uint32),
                ("data", ctypes.c_uint8 * 56)]


_HANDLER = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p)


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL("libzvbi.so.0")
    except OSError:
        return None
    lib.vbi_decoder_new.restype = ctypes.c_void_p
    lib.vbi_decoder_delete.argtypes = [ctypes.c_void_p]
    lib.vbi_decode.argtypes = [ctypes.c_void_p, ctypes.POINTER(Sliced),
                               ctypes.c_int, ctypes.c_double]
    lib.vbi_event_handler_register.restype = ctypes.c_int
    lib.vbi_event_handler_register.argtypes = [
        ctypes.c_void_p, ctypes.c_int, _HANDLER, ctypes.c_void_p]
    lib.vbi_fetch_vt_page.restype = ctypes.c_int
    lib.vbi_fetch_vt_page.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int]
    lib.vbi_print_page_region.restype = ctypes.c_int
    lib.vbi_print_page_region.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.vbi_unref_page.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


class ZvbiDecoder:
    """vbi_decoder driven exactly like gstteletextdec.c does."""

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError("libzvbi not available")
        self._lib = lib
        self._dec = lib.vbi_decoder_new()
        if not self._dec:
            raise RuntimeError("vbi_decoder_new failed")
        self.pages = []        # (pgno, subno) from TTX_PAGE events

        def on_event(ev, user):
            # vbi_event: {int type; network; ev.ttx_page {pgno, subno,
            # ...}} — layout: type at 0, network ptr at 8,
            # then the union; pgno/subno are the union's first ints
            typ = ctypes.cast(ev, ctypes.POINTER(ctypes.c_int))[0]
            if typ == VBI_EVENT_TTX_PAGE:
                ints = ctypes.cast(ev + 16,
                                   ctypes.POINTER(ctypes.c_int))
                self.pages.append((ints[0], ints[1]))

        self._cb = _HANDLER(on_event)    # keep alive
        lib.vbi_event_handler_register(self._dec, VBI_EVENT_TTX_PAGE,
                                       self._cb, None)
        self._ts = 0.0

    def __del__(self):
        dec = getattr(self, "_dec", None)
        if dec:
            self._lib.vbi_decoder_delete(dec)
            self._dec = None

    def feed_frame(self, lines: List[bytes],
                   vbi_lines: Optional[List[int]] = None) -> None:
        """One video frame's worth of 42-byte teletext lines
        (vbi_decode + the reference's 0.04 s step)."""
        arr = (Sliced * max(len(lines), 1))()
        for i, data in enumerate(lines):
            arr[i].id = VBI_SLICED_TELETEXT_B
            arr[i].line = (vbi_lines[i] if vbi_lines else 7 + i)
            for j, b in enumerate(data):
                arr[i].data[j] = b
        self._lib.vbi_decode(self._dec, arr, len(lines), self._ts)
        self._ts += 0.04

    def fetch_text(self, pgno: int, subno: int = VBI_ANY_SUBNO,
                   level: int = VBI_WST_LEVEL_1) -> Optional[List[str]]:
        """vbi_fetch_vt_page + vbi_print_page_region(table=TRUE) ->
        25 rows of 40 chars, or None when uncached.  pgno is BCD
        (page 100 = 0x100), like the reference's vbi_bin2bcd walk."""
        page = ctypes.create_string_buffer(1 << 19)
        ok = self._lib.vbi_fetch_vt_page(self._dec, page, pgno, subno,
                                         level, 25, 0)
        if not ok:
            return None
        try:
            buf = ctypes.create_string_buffer(25 * 41 * 4)
            n = self._lib.vbi_print_page_region(
                page, buf, len(buf), b"UTF-8", 1, 0, 0, 0, 40, 25)
            if n <= 0:
                return None
            return buf.raw[:n].decode("utf-8").split("\n")
        finally:
            self._lib.vbi_unref_page(page)

    def fetch_page(self, pgno: int, subno: int = VBI_ANY_SUBNO,
                   level: int = VBI_WST_LEVEL_3p5) -> Optional[dict]:
        """Full vbi_page snapshot: per-cell unicode / foreground /
        background CLUT indices, the 40-entry colour map (reflecting
        X/28 / M/29 CLUT redefinitions at level >= 2.5), screen colour
        and opacity.  This is the Level 2.5 colour ORACLE.

        struct offsets are calibrated empirically at first use
        (_page_layout) — libzvbi ships no dev header here."""
        import struct
        lay = _page_layout()
        page = ctypes.create_string_buffer(1 << 19)
        ok = self._lib.vbi_fetch_vt_page(self._dec, page, pgno, subno,
                                         level, 25, 0)
        if not ok:
            return None
        try:
            raw = page.raw
            rows = struct.unpack_from("<i", raw, lay["rows"])[0]
            cols = struct.unpack_from("<i", raw, lay["columns"])[0]
            text, fg, bg, opac = [], [], [], []
            for r in range(rows):
                trow, frow, brow, orow = [], [], [], []
                for c in range(cols):
                    off = lay["text"] + (r * cols + c) * lay["cell"]
                    cell = raw[off:off + lay["cell"]]
                    frow.append(cell[3])
                    brow.append(cell[4])
                    orow.append(cell[2])
                    trow.append(chr(cell[6] | (cell[7] << 8)))
                text.append("".join(trow))
                fg.append(frow)
                bg.append(brow)
                opac.append(orow)
            cmap = list(struct.unpack_from("<40I", raw, lay["color_map"]))
            scol, sopa = struct.unpack_from("<2i", raw,
                                            lay["screen_color"])
            return {"rows": rows, "columns": cols, "text": text,
                    "fg": fg, "bg": bg, "opacity": opac,
                    "color_map": cmap, "screen_color": scol,
                    "screen_opacity": sopa}
        finally:
            self._lib.vbi_unref_page(page)


# -- vbi_page layout calibration ---------------------------------------------

_LAYOUT: Optional[dict] = None


def _page_layout() -> dict:
    """Empirically derive vbi_page field offsets for THIS libzvbi
    build: feed a throwaway decoder a known page, fetch it, scan the
    raw struct for the head ints / text cells / default colour map.
    Calibrated once per process; raises if any anchor is missing."""
    global _LAYOUT
    if _LAYOUT is not None:
        return _LAYOUT
    import struct
    from gstbad.io import teletext as _tt
    lib = _load()
    if lib is None:
        raise RuntimeError("libzvbi not available")
    dec = ZvbiDecoder()
    probe = "LAYOUTPROBE"
    lines = [_tt.build_header(1, 0, 0),
             _tt.build_row(1, 1, probe.encode())]
    for _ in range(2):
        dec.feed_frame(lines)
        dec.feed_frame([_tt.build_header(1, 0, 1)])
    page = ctypes.create_string_buffer(1 << 19)
    ok = lib.vbi_fetch_vt_page(dec._dec, page, 0x100, VBI_ANY_SUBNO,
                               VBI_WST_LEVEL_1, 25, 0)
    if not ok:
        raise RuntimeError("zvbi layout probe: fetch failed")
    raw = page.raw
    try:
        lib.vbi_unref_page(page)
    except Exception:  # noqa: BLE001
        pass
    # head: ...pgno(0x100), subno, rows(25), columns at fixed int slots
    head = struct.unpack_from("<8i", raw, 0)
    try:
        pg_idx = head.index(0x100)
    except ValueError:
        raise RuntimeError("zvbi layout probe: pgno anchor missing")
    rows_off = (pg_idx + 2) * 4
    cols_off = (pg_idx + 3) * 4
    rows, cols = struct.unpack_from("<2i", raw, rows_off)
    if rows != 25 or not (40 <= cols <= 64):
        raise RuntimeError("zvbi layout probe: rows/columns mismatch")
    # text array: find the probe string as 16-bit unicode, stride 8
    text_off = cell = None
    for off in range(cols_off + 4, 4096):
        s = "".join(chr(struct.unpack_from("<H", raw, off + i * 8)[0])
                    for i in range(len(probe)))
        if s == probe:
            # probe is at row 1 col 0; unicode lives at cell byte 6
            cell = 8
            text_off = off - 6 - cols * cell
            break
    if text_off is None:
        raise RuntimeError("zvbi layout probe: text anchor missing")
    # colour map: the default CLUT0 pattern (black..white, opaque)
    pat = struct.pack("<8I", 0xFF000000, 0xFF0000FF, 0xFF00FF00,
                      0xFF00FFFF, 0xFFFF0000, 0xFFFF00FF, 0xFFFFFF00,
                      0xFFFFFFFF)
    cmap_off = raw.find(pat, text_off)
    if cmap_off < 0:
        raise RuntimeError("zvbi layout probe: colour-map anchor missing")
    _LAYOUT = {"rows": rows_off, "columns": cols_off, "text": text_off,
               "cell": cell, "color_map": cmap_off,
               "screen_color": cmap_off - 8}
    return _LAYOUT


# -- raw VBI bit slicer (the line21 waveform oracle) --------------------------

VBI_SLICED_CAPTION_525 = 0x00000060
VBI_SLICED_CAPTION_525_F1 = 0x00000020
VBI_PIXFMT_YUV420 = 1


class _RawDecoder(ctypes.Structure):
    # public head of vbi_raw_decoder (libzvbi.h) + private slack
    _fields_ = [("scanning", ctypes.c_int),
                ("sampling_format", ctypes.c_int),
                ("sampling_rate", ctypes.c_int),
                ("bytes_per_line", ctypes.c_int),
                ("offset", ctypes.c_int),
                ("start", ctypes.c_int * 2),
                ("count", ctypes.c_int * 2),
                ("interlaced", ctypes.c_int),
                ("synchronous", ctypes.c_int),
                ("_private", ctypes.c_uint8 * 65536)]


def _load_raw():
    lib = _load()
    if lib is None:
        return None
    if not hasattr(lib.vbi_raw_decoder_init, "_patched"):
        lib.vbi_raw_decoder_init.argtypes = [ctypes.c_void_p]
        lib.vbi_raw_decoder_destroy.argtypes = [ctypes.c_void_p]
        lib.vbi_raw_decoder_add_services.restype = ctypes.c_uint
        lib.vbi_raw_decoder_add_services.argtypes = [
            ctypes.c_void_p, ctypes.c_uint, ctypes.c_int]
        lib.vbi_raw_decode.restype = ctypes.c_int
        lib.vbi_raw_decode.argtypes = [ctypes.c_void_p,
                                       ctypes.c_char_p,
                                       ctypes.POINTER(Sliced)]
        lib.vbi_raw_decoder_init._patched = True
    return lib


def slice_caption_line(luma720) -> Optional[Tuple[int, int]]:
    """Run zvbi's REAL adaptive bit slicer on one 720-sample line-21
    luma waveform (the gstline21enc/dec sampling grid: 13.5 MHz,
    offset 122) -> the two CC bytes, or None when the slicer rejects
    the line.  This is the oracle for golden/line21 + ops/line21."""
    import numpy as np
    lib = _load_raw()
    if lib is None:
        raise RuntimeError("libzvbi not available")
    rd = _RawDecoder()
    lib.vbi_raw_decoder_init(ctypes.byref(rd))
    try:
        rd.scanning = 525
        rd.sampling_format = VBI_PIXFMT_YUV420
        rd.sampling_rate = 13500000
        rd.bytes_per_line = 720
        rd.offset = 122
        rd.start[0] = 21
        rd.count[0] = 1
        rd.interlaced = 0
        rd.synchronous = 1
        got = lib.vbi_raw_decoder_add_services(
            ctypes.byref(rd), VBI_SLICED_CAPTION_525, 0)
        if not (got & VBI_SLICED_CAPTION_525_F1):
            raise RuntimeError("zvbi: caption service rejected")
        raw = np.ascontiguousarray(luma720, np.uint8).tobytes()
        sliced = (Sliced * 4)()
        n = lib.vbi_raw_decode(ctypes.byref(rd), raw, sliced)
        if n < 1:
            return None
        return int(sliced[0].data[0]), int(sliced[0].data[1])
    finally:
        lib.vbi_raw_decoder_destroy(ctypes.byref(rd))
