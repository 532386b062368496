"""CEA-708 DTVCC caption decoding (ext/closedcaption/gstcea708decoder.c
+ the cc_data packet assembly from gstceaccoverlay.c).

The service-level state machine is transcribed: cc_data triplets
accumulate DTVCC packets (type 3 starts a packet and flushes the
previous one, type 2 continues, an invalid type-2 ends one —
gstceaccoverlay.c:1549-1568), packets carry service blocks (extended
service numbers included), and the per-byte dispatch handles C0
(NUL/ETX/BS/FF/CR/HCR, EXT1, the unsupported 0x11-0x1F skip counts),
G0 text with the 0x7F music note, G1 Latin-1, and every C1 command with
its exact parameter skip count: CW0-7, CLW/DSW/HDW/TGW/DLW windowmaps,
DLY/DLC, RST, SPA/SPC/SPL, SWA, DF0-7 with the full parameter layout
(gstcea708dec_define_window).  Windows keep 15x32 character grids with
the reference's pen-wrap/scroll semantics and anchor-point placement
math (gstceaccoverlay.c:1308-1360).

Rendering (r3): render_overlay_pango runs the reference's ACTUAL
Pango/Cairo path — per-char pen snapshots (SPA/SPC with the
minimum-color map) drive show_pango_window's span-markup walk,
render_text's 'serif 36' font desc + justify alignment, and
render_pangocairo's shadow+outline composite; placement and AYUV
conversion transcribe create_and_push_buffer/image_to_ayuv exactly
(incl. the never-assigned h_anchor quirk in window-h-pos=auto).
render_overlay keeps the library-free bitmap face (monochrome
white-on-black via data/cc_font.npz) as the fallback.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

MAX_WINDOWS = 8
WINDOW_MAX_ROWS = 15
WINDOW_MAX_COLS = 42
MUSIC_NOTE = 0x266A      # rendered via the atlas's music-note glyph

CCTYPE_608_CC1 = 0
CCTYPE_608_CC2 = 1
CCTYPE_708_ADD = 2
CCTYPE_708_START = 3

# C1 command codes (gstcea708decoder.h)
CMD_CW0 = 0x80
CMD_CLW = 0x88
CMD_DSW = 0x89
CMD_HDW = 0x8A
CMD_TGW = 0x8B
CMD_DLW = 0x8C
CMD_DLY = 0x8D
CMD_DLC = 0x8E
CMD_RST = 0x8F
CMD_SPA = 0x90
CMD_SPC = 0x91
CMD_SPL = 0x92
CMD_SWA = 0x97
CMD_DF0 = 0x98


# CEA-708 minimum color list constants (gstcea708decoder.h:123-131)
COLOR_INVALID = 0xFF
COLOR_BLACK = 0x00
COLOR_WHITE = 0x2A
COLOR_RED = 0x20
COLOR_GREEN = 0x08
COLOR_BLUE = 0x02
COLOR_YELLOW = 0x28
COLOR_MAGENTA = 0x22
COLOR_CYAN = 0x0A
OPACITY_TRANSPARENT = 3        # gstcea708decoder.h:166-169

COLOR_NAMES = {COLOR_BLACK: "black", COLOR_WHITE: "white",
               COLOR_RED: "red", COLOR_GREEN: "green",
               COLOR_BLUE: "blue", COLOR_YELLOW: "yellow",
               COLOR_MAGENTA: "magenta", COLOR_CYAN: "cyan"}

FONT_NAMES = ("serif", "courier", "times new roman", "helvetica",
              "Arial", "Dom Casual", "Coronet", "Gothic")
PEN_SIZE_NAMES = ("30", "36", "42")


def map_minimum_color(color: int) -> int:
    """gst_cea708dec_map_minimum_color: quantize each 2-bit channel
    to the spec's minimum color list (1 -> 0, 3 -> 2)."""
    r = (color & 0x30) >> 4
    if r == 1:
        color &= 0x0F
    elif r == 3:
        color &= 0x2F
    g = (color & 0x0C) >> 2
    if g == 1:
        color &= 0x33
    elif g == 3:
        color &= 0x3B
    b = color & 0x3
    if b == 1:
        color &= 0x3C
    elif b == 3:
        color &= 0x3E
    return color


@dataclass(frozen=True)
class PenState:
    """cea708char's pen snapshot (pen_color + pen_attributes),
    defaults per gst_cea708dec_init_window."""
    fg_color: int = COLOR_WHITE
    fg_opacity: int = 0                 # SOLID
    bg_color: int = COLOR_BLACK
    bg_opacity: int = 0
    edge_color: int = COLOR_BLACK
    pen_size: int = 1                   # PEN_SIZE_STANDARD
    font_style: int = 0                 # FONT_STYLE_DEFAULT
    italics: bool = False
    underline: bool = False
    edge_type: int = 0
    text_tag: int = 0
    offset: int = 0


@dataclass
class Window:
    deleted: bool = True
    visible: bool = False
    updated: bool = False
    row_count: int = WINDOW_MAX_ROWS
    column_count: int = WINDOW_MAX_COLS
    pen_row: int = 0
    pen_col: int = 0
    anchor_point: int = 0
    relative_position: bool = False
    screen_vertical: float = 0.0
    screen_horizontal: float = 0.0
    print_direction: int = 0          # LEFT_TO_RIGHT
    scroll_direction: int = 3         # BOTTOM_TO_TOP (the 708 default)
    justify_mode: int = 0
    pen_color: int = 0
    pen_attributes: int = 0
    pen: PenState = field(default_factory=PenState)
    text: List[List[int]] = field(default_factory=lambda: [
        [0x20] * WINDOW_MAX_COLS for _ in range(WINDOW_MAX_ROWS)])
    pens: List[List[PenState]] = field(default_factory=lambda: [
        [PenState()] * WINDOW_MAX_COLS for _ in range(WINDOW_MAX_ROWS)])

    def clear_text(self):
        # clear_window_text stamps the CURRENT pen into every cell
        # (gstcea708decoder.c:1297-1311)
        for r in range(WINDOW_MAX_ROWS):
            for c in range(WINDOW_MAX_COLS):
                self.text[r][c] = 0x20
                self.pens[r][c] = self.pen
        self.pen_row = 0
        self.pen_col = 0


class Cea708Decoder:
    """Cea708Dec: 8 windows + the byte-level dispatch."""

    def __init__(self, desired_service: int = 1):
        self.windows = [Window() for _ in range(MAX_WINDOWS)]
        self.current_window = 0
        self.desired_service = desired_service
        self.output_ignore = 0
        self._dtvcc = bytearray()

    # -- cc_data triplet assembly (gstceaccoverlay.c:1549-1568) ------------

    def feed_cc_data(self, cc_data: bytes) -> bool:
        """Returns True when any window updated (need render)."""
        need = False
        for i in range(len(cc_data) // 3):
            b = cc_data[3 * i]
            d0, d1 = cc_data[3 * i + 1], cc_data[3 * i + 2]
            valid = bool(b & 0x04)
            cc_type = b & 0x03
            if cc_type in (CCTYPE_708_ADD, CCTYPE_708_START):
                if valid:
                    if cc_type == CCTYPE_708_START:
                        need |= self._flush_packet()
                    self._dtvcc += bytes([d0, d1])
                elif cc_type == CCTYPE_708_ADD:
                    need |= self._flush_packet()
        return need

    def _flush_packet(self) -> bool:
        if not self._dtvcc:
            return False
        buf = bytes(self._dtvcc)
        self._dtvcc = bytearray()
        return self.process_dtvcc_packet(buf)

    # -- packet / service blocks ------------------------------------------

    def process_dtvcc_packet(self, buf: bytes) -> bool:
        """gst_cea708dec_process_dtvcc_packet: one service block of the
        desired service is processed per packet (like the reference)."""
        if len(buf) < 2:
            return False
        i = 1
        block_size = buf[i] & 0x1F
        service = (buf[i] & 0xE0) >> 5
        i += 1
        if service == 7:
            service = buf[i] & 0x3F
            i += 1
        if service != self.desired_service:
            return False
        for j in range(block_size):
            if i + j < len(buf):
                self._process_byte(buf, i + j)
        need = any(w.updated for w in self.windows if not w.deleted)
        for w in self.windows:
            w.updated = False
        return need

    # -- byte dispatch (gst_cea708dec_process_dtvcc_byte) ------------------

    def _process_byte(self, buf: bytes, index: int):
        c = buf[index]
        if self.output_ignore:
            self.output_ignore -= 1
            return
        if c <= 0x1F:                                   # C0
            if c == 0x03:                               # ETX
                self._command(buf, index)
            elif c in (0x00, 0x08, 0x0C, 0x0D, 0x0E):
                self._add_char(c)
            elif c == 0x10:                             # EXT1
                nc = buf[index + 1] if index + 1 < len(buf) else 0
                self.output_ignore = 1
                if 0x20 <= nc <= 0x7F:                  # G2
                    self._add_char(self._g2_char(nc))
                elif nc <= 0x1F:                        # C2: skip widths
                    self.output_ignore = 1 + (0 if nc < 0x08 else
                                              1 if nc < 0x10 else
                                              2 if nc < 0x18 else 3)
                elif 0x80 <= nc <= 0x9F:                # C3
                    self.output_ignore = 1 + (4 if nc <= 0x87 else 5)
                else:                                   # G3
                    self._add_char(0x5F)                # underscore stand-in
            elif 0x10 < c < 0x18:
                self.output_ignore = 1
            elif c >= 0x18:                             # P16
                self.output_ignore = 2
        elif 0x20 <= c <= 0x7F:                         # G0
            self._add_char(MUSIC_NOTE if c == 0x7F else c)
        elif 0x80 <= c <= 0x9F:                         # C1
            self._command(buf, index)
        else:                                           # G1
            self._add_char(c)

    @staticmethod
    def _g2_char(c: int) -> int:
        table = {0x20: 0x20, 0x21: 0x20, 0x25: 0x2026, 0x2A: 0x160,
                 0x2C: 0x152, 0x30: 0x2588, 0x31: 0x27, 0x32: 0x27,
                 0x33: 0x27, 0x34: 0x27, 0x35: 0x2022, 0x39: 0x2122,
                 0x3A: 0x161, 0x3C: 0x153, 0x3D: 0x2120, 0x76: 0x215B,
                 0x77: 0x215C, 0x78: 0x215D, 0x79: 0x215E}
        return table.get(c, 0x20)

    def _for_each(self, window_list: int, fn):
        for wid in range(MAX_WINDOWS):
            if window_list & (1 << wid):
                fn(wid)

    def _command(self, buf: bytes, index: int):
        c = buf[index]
        win = self.windows[self.current_window]
        arg = buf[index + 1] if index + 1 < len(buf) else 0
        if c == 0x03:                                   # ETX
            win.visible = True
            win.updated = True
        elif CMD_CW0 <= c <= CMD_CW0 + 7:
            self.current_window = c & 0x07
        elif c == CMD_CLW:
            self.output_ignore = 1
            self._for_each(arg, lambda wid:
                           self.windows[wid].clear_text())
            self._for_each(arg, lambda wid: setattr(
                self.windows[wid], "updated", True))
        elif c == CMD_DSW:
            self.output_ignore = 1

            def show(wid):
                self.windows[wid].visible = True
                self.windows[wid].updated = True
            self._for_each(arg, show)
        elif c == CMD_HDW:
            self.output_ignore = 1

            def hide(wid):
                self.windows[wid].visible = False
                self.windows[wid].updated = True
            self._for_each(arg, hide)
        elif c == CMD_TGW:
            self.output_ignore = 1

            def tog(wid):
                self.windows[wid].visible = \
                    not self.windows[wid].visible
                self.windows[wid].updated = True
            self._for_each(arg, tog)
        elif c == CMD_DLW:
            self.output_ignore = 1

            def delete(wid):
                self.windows[wid] = Window()
                self.windows[wid].updated = True
            self._for_each(arg, delete)
        elif c == CMD_DLY:
            self.output_ignore = 1
        elif c == CMD_DLC:
            pass
        elif c == CMD_RST:
            for wid in range(MAX_WINDOWS):
                self.windows[wid] = Window()
            self.current_window = 0
        elif c == CMD_SPA:
            self.output_ignore = 2
            b2 = buf[index + 2] if index + 2 < len(buf) else 0
            win.pen_attributes = (arg << 8) | b2
            # gst_cea708dec_set_pen_attributes field layout
            from dataclasses import replace as _rep
            win.pen = _rep(win.pen,
                           pen_size=arg & 0x3,
                           text_tag=(arg & 0xF0) >> 4,
                           offset=(arg & 0xC0) >> 2,
                           font_style=b2 & 0x7,
                           italics=bool(b2 & 0x80),
                           underline=bool(b2 & 0x40),
                           edge_type=(b2 & 0x38) >> 3)
        elif c == CMD_SPC:
            self.output_ignore = 3
            b2 = buf[index + 2] if index + 2 < len(buf) else 0
            b3 = buf[index + 3] if index + 3 < len(buf) else 0
            # gst_cea708dec_set_pen_color + minimum-color mapping
            from dataclasses import replace as _rep
            win.pen = _rep(win.pen,
                           fg_color=map_minimum_color(arg & 0x3F),
                           fg_opacity=(arg & 0xC0) >> 6,
                           bg_color=map_minimum_color(b2 & 0x3F),
                           bg_opacity=(b2 & 0xC0) >> 6,
                           edge_color=map_minimum_color(b3 & 0x3F))
        elif c == CMD_SPL:
            self.output_ignore = 2
            win.pen_row = arg & 0x0F
            win.pen_col = (buf[index + 2] if index + 2 < len(buf)
                           else 0) & 0x3F
        elif c == CMD_SWA:
            self.output_ignore = 4
            win.justify_mode = arg & 0x03
            win.print_direction = (arg >> 2) & 0x03
            win.scroll_direction = (arg >> 4) & 0x03
        elif CMD_DF0 <= c <= CMD_DF0 + 7:
            self.output_ignore = 6
            self.current_window = c & 0x07
            self._define_window(buf, index + 1)

    def _define_window(self, buf: bytes, i: int):
        """gst_cea708dec_define_window parameter layout."""
        win = self.windows[self.current_window]
        if i + 5 >= len(buf) + 1:
            pass
        b = [buf[i + k] if i + k < len(buf) else 0 for k in range(6)]
        if win.deleted:
            win.pen_row = 0
            win.pen_col = 0
            win.deleted = False
        win.visible = bool(b[0] & 0x20)
        win.relative_position = bool(b[1] & 0x80)
        anchor_vertical = b[1] & 0x7F
        anchor_horizontal = b[2]
        win.anchor_point = (b[3] & 0xF0) >> 4
        win.row_count = min((b[3] & 0x0F) + 1, WINDOW_MAX_ROWS)
        win.column_count = min((b[4] & 0x3F) + 1, WINDOW_MAX_COLS)
        sv, sh = float(anchor_vertical), float(anchor_horizontal)
        if not win.relative_position:
            # absolute coords scale to percent (74/209 for 16:9, 74/159
            # for 4:3 — the element passes its caps size; we normalize
            # with the 16:9 grid like the reference's common path)
            sv = sv * 100.0 / 74.0
            sh = sh * 100.0 / 209.0
        win.screen_vertical = min(sv, 100.0)
        win.screen_horizontal = min(sh, 100.0)
        win.updated = True

    # -- text entry (gst_cea708dec_window_add_char) ------------------------

    def _add_char(self, c: int):
        win = self.windows[self.current_window]
        if c == 0x00:
            return
        if c == 0x0E:                                   # HCR
            for col in range(win.pen_col, -1, -1):
                win.text[win.pen_row][col] = 0x20
            win.pen_col = 0
            return
        if c == 0x08:                                   # BS
            if win.print_direction == 0 and win.pen_col:
                win.pen_col -= 1
            win.text[win.pen_row][win.pen_col] = 0x20
            return
        if c == 0x0C:                                   # FF
            win.clear_text()
            return
        if c == 0x0D:                                   # CR
            win.pen_col = 0
            win.pen_row += 1
        if win.pen_col >= win.column_count:
            win.pen_col = 0
            win.pen_row += 1
        if win.pen_row >= win.row_count:
            if win.scroll_direction == 3:               # BOTTOM_TO_TOP
                win.text = win.text[1:] + [[0x20] * WINDOW_MAX_COLS]
                win.pens = win.pens[1:] + [[win.pen] * WINDOW_MAX_COLS]
            win.pen_row = win.row_count - 1
        if c != 0x0D:
            win.text[win.pen_row][win.pen_col] = c
            # each cell snapshots the current pen as it is written
            # (gstcea708dec window_add_char)
            win.pens[win.pen_row][win.pen_col] = win.pen
            win.updated = True
            if win.print_direction == 0:
                win.pen_col += 1


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

_FONT = None


def _font():
    global _FONT
    if _FONT is None:
        path = os.path.join(os.path.dirname(__file__), "..", "data",
                            "cc_font.npz")
        _FONT = np.load(os.path.normpath(path))
    return _FONT


def render_overlay(decoder: Cea708Decoder, width: int, height: int
                   ) -> np.ndarray:
    """Visible windows -> [height, width, 4] AYUV overlay (alpha 0
    elsewhere).  White-on-black monochrome raster (divergence note in
    the module docstring); anchor placement per
    gstceaccoverlay.c:1308-1360."""
    font = _font()
    atlas = font["atlas"]
    ch, cw = int(font["cell"][0]), int(font["cell"][1])
    first = int(font["first"])
    music = int(font["music_note_index"])
    canvas = np.zeros((height, width, 4), np.uint8)
    for win in decoder.windows:
        if win.deleted or not win.visible:
            continue
        rows = [r for r in range(win.row_count)
                if any(win.text[r][c] != 0x20
                       for c in range(win.column_count))]
        if not rows:
            continue
        iw = win.column_count * cw
        ih = win.row_count * ch
        img = np.zeros((ih, iw), np.uint8)
        for r in range(win.row_count):
            for col in range(win.column_count):
                cc = win.text[r][col]
                if cc == 0x20:
                    continue
                gi = music if cc == MUSIC_NOTE else \
                    (cc - first if first <= cc < first + 95 else None)
                if gi is None:
                    continue
                img[r * ch:(r + 1) * ch,
                    col * cw:(col + 1) * cw] = atlas[gi]
        v_anchor = int(win.screen_vertical * height / 100)
        h_anchor = int(win.screen_horizontal * width / 100)
        ap = win.anchor_point
        if ap in (0, 3, 6):                   # left column anchors
            x0 = h_anchor
        elif ap in (1, 4, 7):                 # center
            x0 = h_anchor - iw // 2
        else:                                 # right
            x0 = h_anchor - iw
        if ap in (0, 1, 2):                   # top row anchors
            y0 = v_anchor
        elif ap in (3, 4, 5):                 # middle
            y0 = v_anchor - ih // 2
        else:                                 # bottom
            y0 = v_anchor - ih
        x0 = max(min(x0, width - iw), 0)
        y0 = max(min(y0, height - ih), 0)
        ys = slice(y0, min(y0 + ih, height))
        xs = slice(x0, min(x0 + iw, width))
        patch = img[:ys.stop - ys.start, :xs.stop - xs.start]
        # black box + white text: A=255 over the window, Y from glyphs
        canvas[ys, xs, 0] = 255
        canvas[ys, xs, 1] = np.maximum(canvas[ys, xs, 1], patch)
        canvas[ys, xs, 2] = 128
        canvas[ys, xs, 3] = 128
    return canvas


# -- the reference's Pango render path (r3) ----------------------------------
# gst_cea708dec_show_pango_window -> render_text -> render_pangocairo
# (gstcea708decoder.c:983-1280, 415-483) over the real Pango/Cairo.

_CC_LAYOUT = None


def _cc_layout():
    """A dedicated PangoLayout for the CC renderer (alignment state is
    per-layout; don't disturb the ttml renderer's shared one)."""
    global _CC_LAYOUT
    if _CC_LAYOUT is None:
        from gstbad.io import pangocairo
        _CC_LAYOUT = pangocairo.Layout()
    return _CC_LAYOUT


def pango_available() -> bool:
    from gstbad.io import pangocairo
    return pangocairo.available()


_ESCAPES = {0x26: "&amp;", 0x3C: "&lt;", 0x3E: "&gt;",
            0x27: "&apos;", 0x22: "&quot;"}


class _SpanControl:
    """cea708PangoSpanControl (init per gstcea708decoder.c:919-928)."""

    def __init__(self):
        self.size = 1                    # PEN_SIZE_STANDARD
        self.fg_color = COLOR_WHITE
        self.bg_color = COLOR_INVALID
        self.font_style = 0              # FONT_STYLE_DEFAULT
        self.underline = False
        self.italics = False
        self.start_flag = False
        self.end_flag = False
        self.txt_flag = False
        self.next_flag = False

    def differs(self, pen: PenState) -> bool:
        return (pen.underline != self.underline
                or pen.italics != self.italics
                or pen.font_style != self.font_style
                or pen.pen_size != self.size
                or pen.fg_color != self.fg_color
                or pen.bg_color != self.bg_color)

    def dirty(self) -> bool:
        return (self.underline or self.italics or self.font_style != 0
                or self.size != 1 or self.fg_color != COLOR_WHITE
                or self.bg_color != COLOR_INVALID)


def window_markup(win: Window,
                  default_font_desc: Optional[str] = None
                  ) -> Optional[str]:
    """show_pango_window's line_buffer walk: per-row pango markup with
    span transitions on (underline, italics, font_style, pen_size,
    fg, bg); colors gated on bg_opacity != TRANSPARENT (the
    reference's quirk — it tests bg_opacity for the foreground too)."""
    display = any(win.text[r][c] != 0x20
                  for r in range(win.row_count)
                  for c in range(win.column_count))
    if not display:
        return None
    out: List[str] = []
    for row in range(win.row_count):
        had_text = False
        for col in range(win.column_count):
            if win.text[row][col] == 0x20:
                continue
            had_text = True
            buf: List[str] = []
            ctrl = _SpanControl()
            right_index = WINDOW_MAX_COLS - 1
            for i in range(WINDOW_MAX_COLS - 1, col - 1, -1):
                if win.text[row][i] != 0x20:
                    right_index = i
                    break
            for i in range(right_index + 1):
                pen = win.pens[row][i]
                c = win.text[row][i]
                while True:
                    if ctrl.differs(pen):
                        if not ctrl.next_flag:
                            # end current span, re-check vs defaults
                            if ctrl.start_flag and not ctrl.end_flag:
                                buf.append("</span>")
                                ctrl.start_flag = False
                                ctrl.txt_flag = False
                                ctrl.end_flag = True
                            if ctrl.end_flag:
                                ctrl = _SpanControl()
                                ctrl.next_flag = True
                                continue
                        if not ctrl.start_flag:
                            buf.append("<span")
                            ctrl.start_flag = True
                            ctrl.end_flag = False
                        if pen.underline:
                            buf.append(" underline='single'")
                            ctrl.underline = True
                        if pen.italics:
                            buf.append(" style='italic'")
                            ctrl.italics = True
                        if default_font_desc is None:
                            font = FONT_NAMES[pen.font_style & 0x7]
                            size_name = PEN_SIZE_NAMES[
                                min(pen.pen_size, 2)]
                            buf.append(f" font_desc='{font} "
                                       f"{size_name}'")
                        ctrl.font_style = pen.font_style
                        ctrl.size = pen.pen_size
                        if pen.bg_opacity != OPACITY_TRANSPARENT:
                            fg = COLOR_NAMES.get(pen.fg_color, "black")
                            buf.append(f" foreground='{fg}'")
                            ctrl.fg_color = pen.fg_color
                            bg = COLOR_NAMES.get(pen.bg_color, "black")
                            buf.append(f" background='{bg}'")
                            ctrl.bg_color = pen.bg_color
                        if ctrl.start_flag and not ctrl.txt_flag:
                            buf.append(">")
                            ctrl.txt_flag = True
                    ctrl.next_flag = False
                    break
                buf.append(_ESCAPES.get(c, chr(c)))
            if ctrl.dirty():
                if ctrl.start_flag and not ctrl.end_flag:
                    buf.append("</span>")
            if row != win.row_count - 1:
                buf.append("\n")
            out.append("".join(buf))
            break
        if not had_text and row != win.row_count - 1:
            out.append("\n")
    return "".join(out) if out else None


def render_window_pango(win: Window,
                        default_font_desc: Optional[str] = None
                        ) -> Optional[np.ndarray]:
    """One window -> premultiplied B,G,R,A text image via the
    reference's exact layout walk (render_text + render_pangocairo:
    justify alignment, 'serif 36' default font desc, shadow =
    size/13, outline = max(size/15, 1))."""
    from gstbad.io import pangocairo as pc
    markup = window_markup(win, default_font_desc)
    if not markup:
        return None
    lay = _cc_layout()
    # JUSTIFY_LEFT/FULL -> PANGO_ALIGN_LEFT, RIGHT -> 2, CENTER -> 1
    lay.set_alignment({0: 0, 1: 2, 2: 1}.get(win.justify_mode, 0))
    lay.set_markup(markup)
    lay.set_width(-1)
    desc = default_font_desc or f"{FONT_NAMES[0]} {PEN_SIZE_NAMES[1]}"
    size = lay.set_font_description(desc)
    if size is None:
        return None
    font_size = size / pc.PANGO_SCALE
    shadow_offset = font_size / 13.0
    outline_offset = max(font_size / 15.0, 1.0)
    return lay.render_cc_window(shadow_offset, outline_offset)


def _unpremultiply_argb(img: np.ndarray) -> np.ndarray:
    """CAIRO_UNPREMULTIPLY (gstceaccoverlay.c:1216): c*255/a with the
    +a/2 rounding."""
    a = img[..., 3].astype(np.uint32)
    out = img.copy()
    for ch in range(3):
        c = img[..., ch].astype(np.uint32)
        out[..., ch] = np.where(
            a > 0, np.minimum((c * 255 + a // 2) // np.maximum(a, 1),
                              255), 0).astype(np.uint8)
    return out


def render_overlay_pango(decoder: Cea708Decoder, width: int,
                         height: int, window_h_pos: str = "center",
                         default_font_desc: Optional[str] = None
                         ) -> np.ndarray:
    """Visible windows -> [height, width, 4] AYUV overlay through the
    reference's Pango path: per-window text images placed with the
    create_and_push_buffer anchor walk (v from screen_vertical;
    horizontal per window-h-pos, default center like
    DEFAULT_PROP_WINDOW_H_POS; the reference's `auto` mode reads an
    h_anchor variable that is never assigned — quirk kept) and
    converted with image_to_ayuv's exact fixed-point matrix."""
    canvas = np.zeros((height, width, 4), np.uint8)
    for win in decoder.windows:
        if win.deleted or not win.visible:
            continue
        img = render_window_pango(win, default_font_desc)
        if img is None:
            continue
        ih, iw = img.shape[:2]
        v_anchor = int(win.screen_vertical * height / 100)
        h_anchor = 0                   # gstceaccoverlay.c:1274 (unset)
        if window_h_pos == "left":
            h_offset = 0
        elif window_h_pos == "center":
            h_offset = (width - iw) // 2
        elif window_h_pos == "right":
            h_offset = width - iw
        else:                          # auto: the reference quirk
            ap = win.anchor_point
            if ap in (0, 3, 6):
                h_offset = h_anchor
            elif ap in (1, 4, 7):
                h_offset = h_anchor - iw // 2
            else:
                h_offset = h_anchor - iw
        if win.anchor_point in (0, 1, 2):
            v_offset = v_anchor
        elif win.anchor_point in (3, 4, 5):
            v_offset = v_anchor - ih // 2
        else:
            v_offset = v_anchor - ih
        # clip to frame
        x0, y0 = h_offset, v_offset
        sx0, sy0 = max(0, -x0), max(0, -y0)
        dx0, dy0 = max(0, x0), max(0, y0)
        w = min(iw - sx0, width - dx0)
        h = min(ih - sy0, height - dy0)
        if w <= 0 or h <= 0:
            continue
        sub = _unpremultiply_argb(img[sy0:sy0 + h, sx0:sx0 + w])
        b = sub[..., 0].astype(np.int32)
        g = sub[..., 1].astype(np.int32)
        r = sub[..., 2].astype(np.int32)
        a = sub[..., 3]
        y = np.clip((19595 * r >> 16) + (38470 * g >> 16)
                    + (7471 * b >> 16), 0, 255)
        u = np.clip(-(11059 * r >> 16) - (21709 * g >> 16)
                    + (32768 * b >> 16) + 128, 0, 255)
        v = np.clip((32768 * r >> 16) - (27439 * g >> 16)
                    - (5329 * b >> 16) + 128, 0, 255)
        patch = np.stack([a, y.astype(np.uint8), u.astype(np.uint8),
                          v.astype(np.uint8)], axis=-1).astype(np.uint8)
        region = canvas[dy0:dy0 + h, dx0:dx0 + w]
        mask = a > 0
        region[mask] = patch[mask]
        canvas[dy0:dy0 + h, dx0:dx0 + w] = region
    return canvas
