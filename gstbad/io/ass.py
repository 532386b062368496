"""SSA/ASS subtitle support (ext/assrender/gstassrender.c).

The reference hands everything to libass: codec_data goes through
ass_process_codec_private, stream chunks through ass_process_chunk,
and the returned ASS_Image list is composited by the element's own
blit_bgra_premultiplied (gstassrender.c:679-744) — THAT math is
transcribed exactly here (k = src*alpha/255; first-touch writes k and
k*c/255; subsequent touches blend k + (255-k)*dst/255 into a
premultiplied BGRA buffer).

libass itself is absent; parse + layout are implemented from the SSA/
ASS format spec:
- [Script Info] PlayResX/PlayResY;
- [V4+ Styles] / [V4 Styles] Format-driven style lines (Fontsize,
  PrimaryColour/SecondaryColour/OutlineColour/BackColour in &HAABBGGRR
  with inverted alpha, Bold/Italic/Underline/StrikeOut flags,
  ScaleX/ScaleY/Spacing, Alignment incl. the legacy SSA +4/+8
  encoding, MarginL/R/V, Outline, Shadow, BorderStyle);
- [Events] Format-driven Dialogue lines (h:mm:ss.cc times, Layer
  compositing order) and Matroska ASS chunks ("ReadOrder,Layer,Style,
  Name,MarginL,MarginR,MarginV,Effect,Text" with buffer pts/duration,
  the ass_process_chunk shape);
- the override-tag machine, applied per span in document order like
  libass' render state:
    \\N \\n \\h               line breaks / hard space
    \\an \\a                  alignment (numpad / legacy SSA codes)
    \\pos \\move              positioning (+ time-interpolated move)
    \\org \\frz \\fr          z-rotation about an origin (nearest-
                              neighbour bitmap rotation)
    \\frx \\fry \\fax \\fay   3D rotations + shears: the glyph plane
                              through shear, Rz-Rx-Ry and the
                              20000-unit perspective projection is ONE
                              homography, inverse-warped per image
    \\t                       tag animation: rendering is per-time-
                              snapshot, so the machine applies the
                              inner tags to a scratch state and lerps
                              the animatable fields by the
                              ((t-t1)/(t2-t1))^accel progress
    \\fad \\fade              alpha fades (simple + 7-argument form)
    \\b \\i \\u \\s           bold / italic / underline / strikeout
    \\fs \\fs+ \\fs- \\fscx \\fscy \\fsp   size, scales, letter spacing
    \\c \\1c \\2c \\3c \\4c   fill / karaoke / outline / back colours
    \\alpha \\1a \\2a \\3a \\4a           the matching alphas
    \\bord \\shad             outline width / shadow offset
    \\be \\blur               edge blur (box-blur rounds)
    \\k \\K \\kf \\ko         karaoke: \\k flips secondary->primary at
                              the syllable start, \\kf/\\K sweep the
                              fill boundary left-to-right over the
                              syllable's duration (two split images),
                              \\ko hides the outline until the start
    \\r \\rStyle              reset to the event's / a named style
    \\clip \\iclip            rectangular clips
    \\q                       wrap style override (with [Script Info]
                              WrapStyle): 0/3 smart balanced wrapping
                              (upper resp. lower lines wider), 1
                              greedy end-of-line, 2 no wrapping
    \\p \\pbo                 vector drawings: m/n/l/b + s/p/c uniform
                              b-splines flattened to beziers,
                              nonzero-winding supersampled fill, bbox
                              bottom-anchored with the \\pbo lift (the
                              libass asc/desc baseline split is the
                              one documented simplification); \\clip
                              and \\iclip accept ([scale,] drawing)
                              vector masks alongside rectangles
  (glyph rasterization under face=fixed is a documented
  divergence — the
  default face=pango shapes with real fonts, same family as
  ttml/ceaccoverlay; inside \\t only libass' animatable set moves —
  booleans/fonts/karaoke are ignored there);
- layout: numpad alignment 1-9 against PlayRes with margins, per-event
  Layer ordering, events stacked bottom-up for bottom alignments like
  libass' collision handling, glyphs from the framework's bitmap face
  with an Outline-width square dilate in the outline colour and a
  Shadow-offset back-colour copy."""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

RGBA = Tuple[int, int, int, int]


def parse_ass_color(s: str) -> RGBA:
    """&HAABBGGRR (alpha inverted: 00 = opaque) -> (r, g, b, a)."""
    s = s.strip().lstrip("&Hh").rstrip("&")
    try:
        v = int(s, 16)
    except ValueError:
        return (255, 255, 255, 255)
    b = (v >> 16) & 0xFF
    g = (v >> 8) & 0xFF
    r = v & 0xFF
    a = 255 - ((v >> 24) & 0xFF)
    return (r, g, b, a)


def _parse_tag_color(s: str) -> Optional[Tuple[int, int, int]]:
    """\\c&HBBGGRR& (no alpha byte) -> (r, g, b)."""
    m = re.match(r"&?[Hh]?([0-9a-fA-F]{1,8})", s.strip().lstrip("&"))
    if not m:
        return None
    v = int(m.group(1), 16)
    return (v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF)


def _parse_tag_alpha(s: str) -> Optional[int]:
    """\\alpha&HAA& -> plain alpha (inverted on parse like colours)."""
    m = re.match(r"&?[Hh]?([0-9a-fA-F]{1,2})", s.strip().lstrip("&"))
    if not m:
        return None
    return 255 - int(m.group(1), 16)


def parse_ass_time(s: str) -> int:
    """h:mm:ss.cc -> ns."""
    m = re.match(r"(\d+):(\d+):(\d+)[.:](\d+)", s.strip())
    if not m:
        return 0
    h, mi, sec, cs = (int(g) for g in m.groups())
    return ((h * 3600 + mi * 60 + sec) * 100 + cs) * 10 ** 7


@dataclass
class AssStyle:
    name: str = "Default"
    font_name: str = "Arial"
    fontsize: float = 20.0
    primary: RGBA = (255, 255, 255, 255)
    secondary: RGBA = (255, 0, 0, 255)
    outline_color: RGBA = (0, 0, 0, 255)
    back: RGBA = (0, 0, 0, 128)
    bold: bool = False
    italic: bool = False
    underline: bool = False
    strikeout: bool = False
    scale_x: float = 100.0
    scale_y: float = 100.0
    spacing: float = 0.0
    outline: float = 2.0
    shadow: float = 0.0
    border_style: int = 1
    alignment: int = 2
    margin_l: int = 10
    margin_r: int = 10
    margin_v: int = 10


@dataclass
class SpanState:
    """The per-span render state the tag machine mutates (libass
    render_context analog)."""
    font_name: str = "Arial"
    font_size: float = 20.0
    scale_x: float = 100.0
    scale_y: float = 100.0
    spacing: float = 0.0
    bold: bool = False
    italic: bool = False
    underline: bool = False
    strikeout: bool = False
    primary: RGBA = (255, 255, 255, 255)
    secondary: RGBA = (255, 0, 0, 255)
    outline_color: RGBA = (0, 0, 0, 255)
    back: RGBA = (0, 0, 0, 128)
    border: float = 2.0
    shadow: float = 0.0
    blur: float = 0.0
    k_start_cs: int = -1      # highlight start (cs from event start); -1 = none
    k_outline: bool = False   # \ko: outline hidden until k_start
    k_dur_cs: int = 0         # syllable duration (cs)
    k_sweep: bool = False     # \kf/\K: left-to-right fill sweep
    p_scale: int = 0          # \p drawing mode (0 = text)
    pbo: float = 0.0          # \pbo baseline offset (drawing px)

    @classmethod
    def from_style(cls, st: AssStyle) -> "SpanState":
        return cls(font_name=st.font_name,
                   font_size=st.fontsize, scale_x=st.scale_x,
                   scale_y=st.scale_y, spacing=st.spacing, bold=st.bold,
                   italic=st.italic, underline=st.underline,
                   strikeout=st.strikeout, primary=st.primary,
                   secondary=st.secondary, outline_color=st.outline_color,
                   back=st.back, border=st.outline, shadow=st.shadow)


@dataclass
class Span:
    text: str
    state: SpanState


@dataclass
class EventLayout:
    """Event-level tag results (first occurrence wins, like libass)."""
    align: Optional[int] = None
    pos: Optional[Tuple[float, float]] = None
    move: Optional[Tuple[float, ...]] = None   # x1,y1,x2,y2[,t1,t2] (ms)
    org: Optional[Tuple[float, float]] = None
    frz: float = 0.0
    frx: float = 0.0                           # 3D rotation about screen x
    fry: float = 0.0                           # 3D rotation about screen y
    fax: float = 0.0                           # x-by-y shear factor
    fay: float = 0.0                           # y-by-x shear factor
    fad: Optional[Tuple[float, float]] = None            # ms in, ms out
    fade: Optional[Tuple[float, ...]] = None   # a1,a2,a3,t1,t2,t3,t4
    clip: Optional[Tuple[float, float, float, float]] = None
    iclip: Optional[Tuple[float, float, float, float]] = None
    clip_path: Optional[Tuple[int, str]] = None    # \clip([scale,]draw)
    iclip_path: Optional[Tuple[int, str]] = None
    wrap: Optional[int] = None                 # \q 0-3 (None = script)


@dataclass
class AssEvent:
    start: int
    end: int
    style: str
    text: str                      # tag-stripped plain text (messages/tests)
    raw_text: str = ""             # original text, tags included
    layer: int = 0
    margin_l: int = 0
    margin_r: int = 0
    margin_v: int = 0
    alignment_override: Optional[int] = None
    pos: Optional[Tuple[float, float]] = None
    read_order: int = -1


def _legacy_alignment(a: int) -> int:
    """SSA \\a codes: 1-3 bottom, +4 top (5-7), +8 mid (9-11)."""
    sub = a & 0x3
    if a & 0x4:
        return {1: 7, 2: 8, 3: 9}.get(sub, 8)
    if a & 0x8:
        return {1: 4, 2: 5, 3: 6}.get(sub, 5)
    return sub if sub else 2


def _floats(argstr: str) -> List[float]:
    return [float(x) for x in re.findall(r"-?[\d.]+", argstr)]


def _split_tags(block: str) -> List[str]:
    """Split an override block's contents on backslashes at paren depth 0
    (a naive split would shred \\t(...\\fscx200...)'s inner tags)."""
    toks, cur, depth = [], [], 0
    for ch in block:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(0, depth - 1)
        if ch == "\\" and depth == 0:
            if cur:
                toks.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    if cur:
        toks.append("".join(cur))
    return [t.strip() for t in toks if t.strip()]


# SpanState fields \t interpolates (libass' animatable set; booleans,
# fonts and karaoke are not animatable and are ignored inside \t)
_ANIM_FLOATS = ("font_size", "scale_x", "scale_y", "spacing", "border",
                "shadow", "blur")
_ANIM_COLORS = ("primary", "secondary", "outline_color", "back")
_ANIM_LAY = ("frz", "frx", "fry", "fax", "fay")


def _apply_tag(tok: str, st: SpanState, base: AssStyle,
               styles: Dict[str, AssStyle], lay: EventLayout,
               k_acc: List[int],
               anim: Optional[Tuple[float, float]] = None) -> SpanState:
    """One override token (no leading backslash) -> new span state.
    Mutates `lay` for event-level tags.  k_acc is the single-element
    karaoke clock (centiseconds accumulated so far).  anim =
    (rel_ms, dur_ms) gives \\t its clock; None renders \\t inert
    (tag-stripping / untimed surfaces)."""

    def num(rest: str, default=None):
        m = re.match(r"[-+]?[\d.]+", rest.strip())
        return float(m.group(0)) if m else default

    def paren(rest: str) -> str:
        m = re.match(r"\s*\(([^)]*)\)?", rest)
        return m.group(1) if m else ""

    # longest-prefix-first dispatch
    if tok.startswith("alpha"):
        a = _parse_tag_alpha(tok[5:])
        if a is None:
            a = base.primary[3]
        st = replace(st, primary=st.primary[:3] + (a,),
                     secondary=st.secondary[:3] + (a,),
                     outline_color=st.outline_color[:3] + (a,),
                     back=st.back[:3] + (a,))
    elif tok.startswith("an"):
        m = re.match(r"an(\d)", tok)
        if m and lay.align is None:
            lay.align = int(m.group(1))
    elif tok.startswith("a") and re.match(r"a\d", tok):
        if lay.align is None:
            lay.align = _legacy_alignment(int(re.match(r"a(\d+)",
                                                       tok).group(1)))
    elif tok.startswith("blur"):
        st = replace(st, blur=num(tok[4:], 0.0) or 0.0)
    elif tok.startswith("bord"):
        st = replace(st, border=max(0.0, num(tok[4:], base.outline)))
    elif tok.startswith("be"):
        st = replace(st, blur=float(num(tok[2:], 0.0) or 0.0))
    elif tok.startswith("b") and re.match(r"b[-+\d]", tok):
        v = num(tok[1:], 0)
        st = replace(st, bold=bool(v) and v != 0)
    elif tok.startswith("fscx"):
        st = replace(st, scale_x=num(tok[4:], base.scale_x)
                     or base.scale_x)
    elif tok.startswith("fscy"):
        st = replace(st, scale_y=num(tok[4:], base.scale_y)
                     or base.scale_y)
    elif tok.startswith("fsp"):
        st = replace(st, spacing=num(tok[3:], base.spacing) or 0.0)
    elif tok.startswith("fs"):
        rest = tok[2:].strip()
        if rest.startswith("+") or rest.startswith("-"):
            st = replace(st, font_size=max(1.0, st.font_size
                                           + (num(rest, 0.0) or 0.0)))
        else:
            v = num(rest, None)
            st = replace(st, font_size=v if v else base.fontsize)
    elif tok.startswith("frz") or re.match(r"fr(?![xy])", tok):
        off = 3 if tok.startswith("frz") else 2
        lay.frz = num(tok[off:], 0.0) or 0.0
    elif tok.startswith("frx"):
        lay.frx = num(tok[3:], 0.0) or 0.0
    elif tok.startswith("fry"):
        lay.fry = num(tok[3:], 0.0) or 0.0
    elif tok.startswith("fax"):
        lay.fax = num(tok[3:], 0.0) or 0.0
    elif tok.startswith("fay"):
        lay.fay = num(tok[3:], 0.0) or 0.0
    elif tok.startswith("fade"):
        args = _floats(paren(tok[4:]))
        if len(args) >= 7 and lay.fade is None:
            lay.fade = tuple(args[:7])
    elif tok.startswith("fad"):
        args = _floats(paren(tok[3:]))
        if len(args) >= 2 and lay.fad is None:
            lay.fad = (args[0], args[1])
    elif tok.startswith("fn"):
        # \fn<name> selects the font family (empty = style's font);
        # honored by the pango face, base glyph under face=fixed
        name = tok[2:].strip()
        st = replace(st, font_name=name or base.font_name)
    elif tok.startswith("fe"):
        pass                       # font encoding: single-face build
    elif tok.startswith("iclip"):
        inner = paren(tok[5:])
        if any(ch.isalpha() for ch in inner):
            if lay.iclip_path is None:
                lay.iclip_path = _split_clip_drawing(inner)
        else:
            args = _floats(inner)
            if len(args) >= 4 and lay.iclip is None:
                lay.iclip = tuple(args[:4])
    elif tok.startswith("i") and re.match(r"i[01\d]", tok):
        st = replace(st, italic=bool(num(tok[1:], 0)))
    elif tok.startswith("ko") or tok.startswith("K") \
            or tok.startswith("kf") or tok.startswith("k"):
        off = 2 if tok.startswith(("ko", "kf")) else 1
        dur = int(num(tok[off:], 0) or 0)
        st = replace(st, k_start_cs=k_acc[0],
                     k_outline=tok.startswith("ko"),
                     k_dur_cs=dur,
                     # \K is libass' alias for \kf: both sweep
                     k_sweep=tok.startswith(("kf", "K")))
        k_acc[0] += dur
    elif tok.startswith("move"):
        args = _floats(paren(tok[4:]))
        if len(args) >= 4 and lay.move is None and lay.pos is None:
            lay.move = tuple(args[:6])
    elif tok.startswith("org"):
        args = _floats(paren(tok[3:]))
        if len(args) >= 2 and lay.org is None:
            lay.org = (args[0], args[1])
    elif tok.startswith("pos"):
        args = _floats(paren(tok[3:]))
        if len(args) >= 2 and lay.pos is None and lay.move is None:
            lay.pos = (args[0], args[1])
    elif tok.startswith("q"):
        q = int(num(tok[1:], 0) or 0)
        if lay.wrap is None and 0 <= q <= 3:
            lay.wrap = q
    elif tok.startswith("pbo"):
        st = replace(st, pbo=float(num(tok[3:], 0.0) or 0.0))
    elif tok.startswith("p"):
        st = replace(st, p_scale=max(0, int(num(tok[1:], 0) or 0)))
    elif tok.startswith("r"):
        name = tok[1:].strip()
        target = styles.get(name, base) if name else base
        keep = dict(k_start_cs=st.k_start_cs, k_outline=st.k_outline,
                    k_dur_cs=st.k_dur_cs, k_sweep=st.k_sweep)
        st = replace(SpanState.from_style(target), **keep)
    elif tok.startswith("shad"):
        st = replace(st, shadow=max(0.0, num(tok[4:], base.shadow)))
    elif tok.startswith("s") and re.match(r"s[01\d]", tok):
        st = replace(st, strikeout=bool(num(tok[1:], 0)))
    elif tok.startswith("u") and re.match(r"u[01\d]", tok):
        st = replace(st, underline=bool(num(tok[1:], 0)))
    elif tok.startswith("clip"):
        inner = paren(tok[4:])
        if any(ch.isalpha() for ch in inner):
            if lay.clip_path is None:
                lay.clip_path = _split_clip_drawing(inner)
        else:
            args = _floats(inner)
            if len(args) >= 4 and lay.clip is None:
                lay.clip = tuple(args[:4])
    elif tok.startswith("t") and "(" in tok:
        # \t([t1,t2,][accel,]tags): animate the listed tags.  Rendering
        # is per-time-snapshot here, so the interpolation happens right
        # in the tag machine: apply the inner tags to a scratch state,
        # then lerp the animatable fields by k = ((t-t1)/(t2-t1))^accel
        # (the VSFilter/libass progress curve).
        if anim is None:
            return st
        inner = tok[tok.index("(") + 1:]
        if inner.endswith(")"):
            inner = inner[:-1]
        cut = inner.find("\\")
        nums = _floats(inner[:cut] if cut >= 0 else inner)
        tags = inner[cut:] if cut >= 0 else ""
        rel_ms, dur_ms = anim
        t1, t2, accel = 0.0, dur_ms, 1.0
        if len(nums) >= 2:
            t1, t2 = nums[0], nums[1]
            if len(nums) >= 3:
                accel = nums[2]
        elif len(nums) == 1:
            accel = nums[0]
        if rel_ms <= t1:
            k = 0.0
        elif rel_ms >= t2 or t2 <= t1:
            k = 1.0
        else:
            k = ((rel_ms - t1) / (t2 - t1)) ** max(1e-6, accel)
        st_t, lay_t, k_t = st, replace(lay), [k_acc[0]]
        for itok in _split_tags(tags):
            st_t = _apply_tag(itok, st_t, base, styles, lay_t, k_t, anim)

        def lerp(a, b):
            return a + (b - a) * k

        st = replace(st, **{
            f: lerp(getattr(st, f), getattr(st_t, f))
            for f in _ANIM_FLOATS})
        st = replace(st, **{
            f: tuple(int(round(lerp(getattr(st, f)[i],
                                    getattr(st_t, f)[i])))
                     for i in range(4))
            for f in _ANIM_COLORS})
        for f in _ANIM_LAY:
            setattr(lay, f, lerp(getattr(lay, f), getattr(lay_t, f)))
        if lay_t.clip is not None:
            lay.clip = (lay_t.clip if lay.clip is None else
                        tuple(lerp(a, b)
                              for a, b in zip(lay.clip, lay_t.clip)))
        if lay_t.iclip is not None:
            lay.iclip = (lay_t.iclip if lay.iclip is None else
                         tuple(lerp(a, b)
                               for a, b in zip(lay.iclip, lay_t.iclip)))
    elif re.match(r"[1-4]c", tok):
        n = int(tok[0])
        c = _parse_tag_color(tok[2:])
        if c is not None:
            attr = {1: "primary", 2: "secondary", 3: "outline_color",
                    4: "back"}[n]
            cur = getattr(st, attr)
            st = replace(st, **{attr: c + (cur[3],)})
    elif re.match(r"[1-4]a", tok):
        n = int(tok[0])
        a = _parse_tag_alpha(tok[2:])
        if a is not None:
            attr = {1: "primary", 2: "secondary", 3: "outline_color",
                    4: "back"}[n]
            cur = getattr(st, attr)
            st = replace(st, **{attr: cur[:3] + (a,)})
    elif tok.startswith("c"):
        c = _parse_tag_color(tok[1:])
        if c is not None:
            st = replace(st, primary=c + (st.primary[3],))
    return st


def parse_dialogue_text(text: str, base: AssStyle,
                        styles: Dict[str, AssStyle],
                        rel_ms: Optional[float] = None,
                        dur_ms: float = 0.0
                        ) -> Tuple[List[List[Span]], EventLayout]:
    """The tag machine: text with {\\...} blocks -> lines of styled
    spans + the event-level layout overrides.  rel_ms (time since event
    start) gives \\t its clock; without it \\t is inert."""
    lay = EventLayout()
    st = SpanState.from_style(base)
    k_acc = [0]
    anim = None if rel_ms is None else (rel_ms, dur_ms)
    lines: List[List[Span]] = [[]]
    for part in re.split(r"(\{[^}]*\})", text):
        if not part:
            continue
        if part.startswith("{") and part.endswith("}"):
            for tok in _split_tags(part[1:-1]):
                st = _apply_tag(tok, st, base, styles, lay, k_acc, anim)
            continue
        run = part.replace("\\h", " ")
        pieces = re.split(r"\\[Nn]", run)
        for i, piece in enumerate(pieces):
            if i:
                lines.append([])
            if piece:
                lines[-1].append(Span(piece, st))
    return lines, lay


def strip_override_tags(text: str
                        ) -> Tuple[str, Optional[int],
                                   Optional[Tuple[float, float]]]:
    """Back-compat surface: plain text + \\an/\\a alignment + \\pos."""
    lines, lay = parse_dialogue_text(text, AssStyle(), {})
    plain = "\n".join("".join(s.text for s in line) for line in lines)
    return plain, lay.align, lay.pos


class AssTrack:
    """ass_track analog: headers via process_codec_private, events via
    process_chunk / full-script dialogue lines."""

    def __init__(self):
        self.play_res_x = 384
        self.play_res_y = 288
        self.wrap_style = 0           # [Script Info] WrapStyle default
        self.styles: Dict[str, AssStyle] = {"Default": AssStyle()}
        self.events: List[AssEvent] = []
        self._style_format: Optional[List[str]] = None
        self._event_format: Optional[List[str]] = None

    # -- header / script parsing -------------------------------------------

    def process_codec_private(self, data: str) -> None:
        self.process_script(data, events=False)

    def process_script(self, data: str, events: bool = True) -> None:
        section = ""
        for raw in data.splitlines():
            line = raw.strip().lstrip("﻿")
            if not line or line.startswith(";"):
                continue
            if line.startswith("["):
                section = line.strip("[]").lower()
                continue
            key, _, value = line.partition(":")
            key = key.strip()
            value = value.strip()
            if section == "script info":
                if key == "PlayResX":
                    self.play_res_x = int(float(value))
                elif key == "PlayResY":
                    self.play_res_y = int(float(value))
                elif key == "WrapStyle":
                    try:
                        self.wrap_style = max(0, min(3,
                                                     int(float(value))))
                    except ValueError:
                        pass
            elif section in ("v4+ styles", "v4 styles"):
                if key == "Format":
                    self._style_format = [f.strip() for f in
                                          value.split(",")]
                elif key == "Style" and self._style_format:
                    self._add_style(value, section == "v4 styles")
            elif section == "events":
                if key == "Format":
                    self._event_format = [f.strip() for f in
                                          value.split(",")]
                elif key == "Dialogue" and events and self._event_format:
                    self._add_dialogue(value)

    def _add_style(self, value: str, legacy: bool) -> None:
        fields = value.split(",", len(self._style_format) - 1)
        d = {k: v.strip() for k, v in zip(self._style_format, fields)}
        st = AssStyle(name=d.get("Name", "Default"))
        if "Fontname" in d and d["Fontname"]:
            st.font_name = d["Fontname"].lstrip("@")
        if "Fontsize" in d:
            st.fontsize = float(d["Fontsize"])
        if "PrimaryColour" in d:
            st.primary = parse_ass_color(d["PrimaryColour"])
        if "SecondaryColour" in d:
            st.secondary = parse_ass_color(d["SecondaryColour"])
        if "OutlineColour" in d:
            st.outline_color = parse_ass_color(d["OutlineColour"])
        elif "TertiaryColour" in d:                  # SSA name
            st.outline_color = parse_ass_color(d["TertiaryColour"])
        if "BackColour" in d:
            st.back = parse_ass_color(d["BackColour"])
        if "Bold" in d:
            st.bold = d["Bold"] not in ("0", "")
        if "Italic" in d:
            st.italic = d["Italic"] not in ("0", "")
        if "Underline" in d:
            st.underline = d["Underline"] not in ("0", "")
        if "StrikeOut" in d:
            st.strikeout = d["StrikeOut"] not in ("0", "")
        for key, attr in (("ScaleX", "scale_x"), ("ScaleY", "scale_y"),
                          ("Spacing", "spacing"), ("Outline", "outline"),
                          ("Shadow", "shadow")):
            if key in d:
                try:
                    setattr(st, attr, float(d[key]))
                except ValueError:
                    pass
        if "BorderStyle" in d:
            try:
                st.border_style = int(float(d["BorderStyle"]))
            except ValueError:
                pass
        if "Alignment" in d:
            a = int(float(d["Alignment"]))
            st.alignment = _legacy_alignment(a) if legacy else a
        for key, attr in (("MarginL", "margin_l"), ("MarginR",
                          "margin_r"), ("MarginV", "margin_v")):
            if key in d:
                try:
                    setattr(st, attr, int(float(d[key])))
                except ValueError:
                    pass
        self.styles[st.name] = st

    def _add_dialogue(self, value: str) -> None:
        fields = value.split(",", len(self._event_format) - 1)
        d = {k: v for k, v in zip(self._event_format, fields)}
        raw = d.get("Text", "")
        text, align, pos = strip_override_tags(raw)
        try:
            layer = int(float(d.get("Layer", "0") or 0))
        except ValueError:
            layer = 0
        self.events.append(AssEvent(
            start=parse_ass_time(d.get("Start", "0:00:00.00")),
            end=parse_ass_time(d.get("End", "0:00:00.00")),
            style=d.get("Style", "Default").strip(),
            text=text, raw_text=raw, layer=layer,
            margin_l=int(float(d.get("MarginL", "0") or 0)),
            margin_r=int(float(d.get("MarginR", "0") or 0)),
            margin_v=int(float(d.get("MarginV", "0") or 0)),
            alignment_override=align, pos=pos))

    def process_chunk(self, data: str, pts_ns: int,
                      duration_ns: int) -> None:
        """Matroska ASS chunk: ReadOrder,Layer,Style,Name,MarginL,
        MarginR,MarginV,Effect,Text (ass_process_chunk analog;
        duplicate ReadOrders are dropped like libass)."""
        fields = data.split(",", 8)
        if len(fields) < 9:
            return
        read_order = int(fields[0] or 0)
        if any(e.read_order == read_order for e in self.events):
            return
        text, align, pos = strip_override_tags(fields[8])
        try:
            layer = int(fields[1] or 0)
        except ValueError:
            layer = 0
        self.events.append(AssEvent(
            start=pts_ns, end=pts_ns + duration_ns,
            style=fields[2].strip(), text=text, raw_text=fields[8],
            layer=layer,
            margin_l=int(fields[4] or 0), margin_r=int(fields[5] or 0),
            margin_v=int(fields[6] or 0),
            alignment_override=align, pos=pos,
            read_order=read_order))


# -- rendering --------------------------------------------------------------

def _glyph(ch: int, h: int, w: int) -> np.ndarray:
    from gstbad.io.ttml import _glyph as g
    return g(ch, h, w)


_AA_CACHE: Dict[tuple, np.ndarray] = {}


def _glyph_aa(ch: int, h: int, w: int) -> np.ndarray:
    """Antialiased fixed-face glyph: the atlas glyph supersampled 4x and
    box-reduced to fractional u8 coverage — the fixed face then feeds
    the same coverage-domain outline/blur/sweep pipeline as the pango
    face instead of hard 0/255 steps (r5 ledger close: 'face=fixed
    glyph shapes')."""
    key = (ch, h, w)
    hit = _AA_CACHE.get(key)
    if hit is not None:
        return hit
    from gstbad.io import ttml as _ttml
    if _ttml._ATLAS is None:
        _ttml._glyph(ord("A"), 8, 8)          # prime the atlas
    atlas, first = _ttml._ATLAS
    idx = ch - first
    if idx < 0 or idx >= atlas.shape[0]:
        idx = 0
    g = atlas[idx]
    k = 4
    ys = (np.arange(h * k) * g.shape[0]) // (h * k)
    xs = (np.arange(w * k) * g.shape[1]) // (w * k)
    big = g[np.ix_(ys, xs)].astype(np.float32)
    cov = big.reshape(h, k, w, k).mean(axis=(1, 3))
    out = np.clip(np.round(cov * 255.0), 0, 255).astype(np.uint8)
    if len(_AA_CACHE) > 8192:
        _AA_CACHE.clear()
    _AA_CACHE[key] = out
    return out


def _span_metrics(st: SpanState, sy: float, sx: float
                  ) -> Tuple[int, int, int]:
    """(font_h, char_w, advance) in output pixels."""
    font_h = max(4, int(st.font_size * sy * st.scale_y / 100.0))
    char_w = max(2, int(st.font_size * sy * (14 / 26)
                        * st.scale_x / 100.0))
    adv = char_w + int(round(st.spacing * sx))
    return font_h, char_w, adv


def _span_bitmap(span: Span, line_h: int, sy: float,
                 sx: float) -> np.ndarray:
    """Rasterize one span onto a line-height bitmap (u8 coverage —
    antialiased glyphs since r5), applying bold / italic / underline /
    strikeout."""
    st = span.state
    font_h, char_w, adv = _span_metrics(st, sy, sx)
    n = len(span.text)
    shear = font_h // 4 if st.italic else 0
    w = max(1, n * adv - (adv - char_w) if n else 1) + shear
    bm = np.zeros((line_h, w), np.uint8)
    y0 = line_h - font_h                      # baseline-align at bottom
    for ci, ch in enumerate(span.text):
        if ch == " ":
            continue
        g = _glyph_aa(ord(ch) if ord(ch) < 128 else ord("?"),
                      font_h, char_w)
        x = ci * adv
        np.maximum(bm[y0:y0 + font_h, x:x + char_w], g,
                   out=bm[y0:y0 + font_h, x:x + char_w])
    if st.bold:
        bm[:, 1:] = np.maximum(bm[:, 1:], bm[:, :-1])
    if shear:
        out = np.zeros_like(bm)
        for r in range(y0, line_h):
            off = int(shear * (line_h - 1 - r) / max(1, font_h - 1))
            if off:
                out[r, off:] = bm[r, :-off]
            else:
                out[r] = bm[r]
        bm = out
    if st.underline and font_h >= 4:
        bm[line_h - 2:line_h, :max(1, n * adv - (adv - char_w))] = 255
    if st.strikeout and font_h >= 4:
        mid = y0 + font_h * 5 // 9
        bm[mid:mid + max(1, font_h // 10),
           :max(1, n * adv - (adv - char_w))] = 255
    return bm


_PANGO_CACHE: Dict[tuple, Tuple[np.ndarray, int]] = {}


def pango_available() -> bool:
    from gstbad.io import pangocairo
    return pangocairo.available()


def _pango_span(st: SpanState, text: str, sy: float, sx: float
                ) -> Tuple[np.ndarray, int]:
    """Real-font span coverage via Pango shaping (the libass-FreeType
    analog this environment can actually provide): -> (coverage u8
    [h, w], advance width).  \\fscx applies as a horizontal resample;
    \\fsp maps to pango letter_spacing."""
    from xml.sax.saxutils import escape
    font_px = max(4, int(st.font_size * sy * st.scale_y / 100.0))
    spacing = int(round(st.spacing * sx * 1024))
    key = (st.font_name, font_px, st.bold, st.italic, st.underline,
           st.strikeout, round(st.scale_x, 2), spacing, text)
    hit = _PANGO_CACHE.get(key)
    if hit is not None:
        return hit
    from gstbad.io import pangocairo as pc
    fam = escape(st.font_name, {'"': "&quot;"})
    attrs = [f'font_family="{fam}"', f'font="{font_px}px"',
             f'font_weight="{"bold" if st.bold else "normal"}"',
             f'font_style="{"italic" if st.italic else "normal"}"']
    if st.underline:
        attrs.append('underline="single"')
    if st.strikeout:
        attrs.append('strikethrough="true"')
    if spacing:
        attrs.append(f'letter_spacing="{spacing}"')
    markup = "<span " + " ".join(attrs) + ">" + escape(text) + "</span>"
    lay = pc.shared_layout()
    lay.set_markup(markup)
    lay.set_width(-1)
    ink, logical = lay.pixel_extents()
    w = max(1, logical.x + logical.width, ink.x + ink.width)
    h = max(1, logical.y + logical.height, ink.y + ink.height)
    cov = lay.show(w, h)[..., 3]
    if st.scale_x != 100.0 and cov.shape[1] > 1:
        new_w = max(1, int(round(cov.shape[1] * st.scale_x / 100.0)))
        i0 = np.minimum((np.arange(new_w) * cov.shape[1]
                         // max(new_w, 1)).astype(np.int64),
                        cov.shape[1] - 1)
        cov = cov[:, i0]
    ret = (cov, cov.shape[1])
    if len(_PANGO_CACHE) > 4096:
        _PANGO_CACHE.clear()
    _PANGO_CACHE[key] = ret
    return ret


def _grow(bm: np.ndarray, r: int) -> np.ndarray:
    """Square dilate by r px with a r-px border (libass outline analog)."""
    h, w = bm.shape
    out = np.zeros((h + 2 * r, w + 2 * r), np.uint8)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            np.maximum(out[dy:dy + h, dx:dx + w], bm,
                       out=out[dy:dy + h, dx:dx + w])
    return out


def _box_blur(bm: np.ndarray, rounds: int) -> np.ndarray:
    """\\be / \\blur analog: `rounds` passes of a 3x3 box mean."""
    x = bm.astype(np.float32)
    for _ in range(rounds):
        p = np.pad(x, 1, mode="constant")
        x = sum(p[dy:dy + bm.shape[0], dx:dx + bm.shape[1]]
                for dy in (0, 1, 2) for dx in (0, 1, 2)) / 9.0
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def _rotate_image(im: dict, deg: float, ox: float, oy: float) -> dict:
    """Nearest-neighbour rotation of an image's coverage bitmap about the
    global point (ox, oy) (libass \\frz; screen y grows down so positive
    angles turn counter-clockwise like libass)."""
    bm = im["bitmap"]
    h, w = bm.shape
    th = math.radians(deg)
    c, s = math.cos(th), math.sin(th)
    # corners relative to the origin
    xs, ys = [], []
    for (cy, cx) in ((0, 0), (0, w), (h, 0), (h, w)):
        dx = im["dst_x"] + cx - ox
        dy = im["dst_y"] + cy - oy
        xs.append(ox + dx * c + dy * s)
        ys.append(oy - dx * s + dy * c)
    nx0, ny0 = int(math.floor(min(xs))), int(math.floor(min(ys)))
    nx1, ny1 = int(math.ceil(max(xs))), int(math.ceil(max(ys)))
    nh, nw = ny1 - ny0, nx1 - nx0
    if nh <= 0 or nw <= 0:
        return im
    yy, xx = np.mgrid[ny0:ny1, nx0:nx1]
    dx = xx - ox
    dy = yy - oy
    sxp = ox + dx * c - dy * s - im["dst_x"]
    syp = oy + dx * s + dy * c - im["dst_y"]
    sxi = np.rint(sxp).astype(np.int64)
    syi = np.rint(syp).astype(np.int64)
    ok = (sxi >= 0) & (sxi < w) & (syi >= 0) & (syi < h)
    out = np.zeros((nh, nw), np.uint8)
    out[ok] = bm[syi[ok], sxi[ok]]
    return {**im, "bitmap": out, "dst_x": nx0, "dst_y": ny0}


def _transform_image(im: dict, lay: EventLayout, ox: float, oy: float,
                     dist: float, fw: int, fh: int) -> dict:
    """Full 3D transform (\\frx/\\fry/\\frz about the \\org origin +
    \\fax/\\fay shear) of an image's coverage bitmap.

    The glyph plane z=0 through shear, the three rotations and the
    perspective projection X = x*d/(d+z) composes to ONE homography;
    the bitmap is inverse-warped through it (nearest neighbour, same
    sampling as _rotate_image).  Rotation order Rz then Rx then Ry and
    the 20000-unit projection distance follow the VSFilter/libass
    convention (screen y grows down; libass itself is absent, so the
    convention choice is documented rather than oracled)."""
    bm = im["bitmap"]
    h, w = bm.shape
    rx, ry, rz = (math.radians(getattr(lay, f))
                  for f in ("frx", "fry", "frz"))
    cz, sz = math.cos(rz), math.sin(rz)
    cx_, sx_ = math.cos(rx), math.sin(rx)
    cy_, sy_ = math.cos(ry), math.sin(ry)
    Rz = np.array([[cz, sz, 0.0], [-sz, cz, 0.0], [0.0, 0.0, 1.0]])
    Rx = np.array([[1.0, 0.0, 0.0], [0.0, cx_, sx_], [0.0, -sx_, cx_]])
    Ry = np.array([[cy_, 0.0, sy_], [0.0, 1.0, 0.0], [-sy_, 0.0, cy_]])
    R = Ry @ Rx @ Rz
    shear = np.array([[1.0, lay.fax], [lay.fay, 1.0]])
    C = R[:, :2] @ shear                       # (x, y) -> 3D point
    H = np.array([[C[0, 0], C[0, 1], 0.0],
                  [C[1, 0], C[1, 1], 0.0],
                  [C[2, 0] / dist, C[2, 1] / dist, 1.0]])
    if abs(np.linalg.det(H)) < 1e-12:          # edge-on: nothing visible
        return {**im, "bitmap": np.zeros((1, 1), np.uint8)}
    # forward-map the corners for the output bounding box
    xs, ys = [], []
    for (cy2, cx2) in ((0, 0), (0, w), (h, 0), (h, w)):
        dx = im["dst_x"] + cx2 - ox
        dy = im["dst_y"] + cy2 - oy
        v = H @ (dx, dy, 1.0)
        if v[2] <= 1e-6:                       # behind the camera plane
            continue
        xs.append(ox + v[0] / v[2])
        ys.append(oy + v[1] / v[2])
    if not xs:
        return {**im, "bitmap": np.zeros((1, 1), np.uint8)}
    # the blit clips to the frame anyway; bound the box to it so a
    # near-edge-on projection cannot explode the raster
    nx0 = max(int(math.floor(min(xs))), -w - fw)
    ny0 = max(int(math.floor(min(ys))), -h - fh)
    nx1 = min(int(math.ceil(max(xs))), 2 * fw)
    ny1 = min(int(math.ceil(max(ys))), 2 * fh)
    nh, nw = ny1 - ny0, nx1 - nx0
    if nh <= 0 or nw <= 0:
        return {**im, "bitmap": np.zeros((1, 1), np.uint8)}
    Hinv = np.linalg.inv(H)
    yy, xx = np.mgrid[ny0:ny1, nx0:nx1]
    u = Hinv[0, 0] * (xx - ox) + Hinv[0, 1] * (yy - oy) + Hinv[0, 2]
    v = Hinv[1, 0] * (xx - ox) + Hinv[1, 1] * (yy - oy) + Hinv[1, 2]
    wdiv = Hinv[2, 0] * (xx - ox) + Hinv[2, 1] * (yy - oy) + Hinv[2, 2]
    front = wdiv > 1e-6
    wsafe = np.where(front, wdiv, 1.0)
    sxp = u / wsafe + ox - im["dst_x"]
    syp = v / wsafe + oy - im["dst_y"]
    sxi = np.rint(sxp).astype(np.int64)
    syi = np.rint(syp).astype(np.int64)
    ok = front & (sxi >= 0) & (sxi < w) & (syi >= 0) & (syi < h)
    out = np.zeros((nh, nw), np.uint8)
    out[ok] = bm[syi[ok], sxi[ok]]
    return {**im, "bitmap": out, "dst_x": nx0, "dst_y": ny0}


def _bezier(p0, p1, p2, p3, n: int = 24):
    """Flatten one cubic to n line segments (returns points after p0)."""
    ts = [(i + 1) / n for i in range(n)]
    out = []
    for t in ts:
        u = 1.0 - t
        out.append((u * u * u * p0[0] + 3 * u * u * t * p1[0]
                    + 3 * u * t * t * p2[0] + t * t * t * p3[0],
                    u * u * u * p0[1] + 3 * u * u * t * p1[1]
                    + 3 * u * t * t * p2[1] + t * t * t * p3[1]))
    return out


def _parse_drawing(text: str, scale: int) -> List[List[Tuple[float,
                                                             float]]]:
    """ASS drawing commands -> closed contours in script pixels.
    Coordinates divide by 2^(scale-1) (the \\p level).  Commands: m/n
    (move, m closes the open contour), l (lines), b (cubic beziers),
    s (uniform cubic b-spline, converted per segment to beziers), p
    (extend spline), c (close spline)."""
    div = float(1 << max(0, scale - 1))
    toks = text.replace(",", " ").split()
    vals: List[float] = []
    cmds: List[Tuple[str, List[float]]] = []
    cmd = ""
    for t in toks:
        if t.isalpha():
            if cmd:
                cmds.append((cmd, vals))
            cmd, vals = t.lower(), []
        else:
            try:
                vals.append(float(t) / div)
            except ValueError:
                pass
    if cmd:
        cmds.append((cmd, vals))

    paths: List[List[Tuple[float, float]]] = []
    cur: List[Tuple[float, float]] = []
    pos = (0.0, 0.0)
    spline: List[Tuple[float, float]] = []

    def close():
        nonlocal cur
        if len(cur) >= 3:
            paths.append(cur)
        cur = []

    def flush_spline():
        nonlocal pos, spline
        if len(spline) >= 4:
            for j in range(len(spline) - 3):
                q = spline[j:j + 4]
                # b-spline segment -> bezier control points
                b0 = ((q[0][0] + 4 * q[1][0] + q[2][0]) / 6,
                      (q[0][1] + 4 * q[1][1] + q[2][1]) / 6)
                b1 = ((2 * q[1][0] + q[2][0]) / 3,
                      (2 * q[1][1] + q[2][1]) / 3)
                b2 = ((q[1][0] + 2 * q[2][0]) / 3,
                      (q[1][1] + 2 * q[2][1]) / 3)
                b3 = ((q[1][0] + 4 * q[2][0] + q[3][0]) / 6,
                      (q[1][1] + 4 * q[2][1] + q[3][1]) / 6)
                if not cur:
                    cur.append(b0)
                cur.extend(_bezier(b0, b1, b2, b3))
            pos = cur[-1]
        spline = []

    for c, v in cmds:
        pairs = [(v[i], v[i + 1]) for i in range(0, len(v) - 1, 2)]
        if c == "m":
            flush_spline()
            close()
            if pairs:
                pos = pairs[-1]
                cur = [pos]
        elif c == "n":
            # move WITHOUT closing (libass ass_drawing.c TOKEN_MOVE_NC):
            # the open contour keeps its points and continues from the new
            # position — filling connects across the jump (ADVICE r4)
            flush_spline()
            if pairs:
                pos = pairs[-1]
                if cur:
                    cur.append(pos)
                else:
                    cur = [pos]
        elif c == "l":
            flush_spline()
            if not cur:
                cur = [pos]
            cur.extend(pairs)
            if pairs:
                pos = pairs[-1]
        elif c == "b":
            flush_spline()
            if not cur:
                cur = [pos]
            for i in range(0, len(pairs) - 2, 3):
                cur.extend(_bezier(pos, pairs[i], pairs[i + 1],
                                   pairs[i + 2]))
                pos = pairs[i + 2]
        elif c == "s":
            spline = [pos] + pairs
        elif c == "p":
            spline.extend(pairs)
        elif c == "c":
            if len(spline) >= 3:
                spline.extend(spline[1:4])
            flush_spline()
    flush_spline()
    close()
    return paths


def _fill_polygons(paths, scale_x: float, scale_y: float,
                   ss: int = 4) -> Tuple[np.ndarray, int, int]:
    """Nonzero-winding scanline fill with ss x ss supersampling.
    Returns (coverage u8 [h, w], x_offset, y_offset) — offsets are the
    floor of the scaled bbox min (negative coordinates draw up/left of
    the origin)."""
    pts = [(x * scale_x, y * scale_y) for p in paths for (x, y) in p]
    if not pts:
        return np.zeros((1, 1), np.uint8), 0, 0
    minx = int(np.floor(min(x for x, _ in pts)))
    miny = int(np.floor(min(y for _, y in pts)))
    maxx = int(np.ceil(max(x for x, _ in pts)))
    maxy = int(np.ceil(max(y for _, y in pts)))
    w = max(1, maxx - minx)
    h = max(1, maxy - miny)
    if w * h > 16_000_000:                       # runaway guard
        return np.zeros((1, 1), np.uint8), 0, 0
    # edge list in bitmap coords
    e = []
    for p in paths:
        sp = [((x * scale_x) - minx, (y * scale_y) - miny)
              for (x, y) in p]
        for a, b in zip(sp, sp[1:] + sp[:1]):
            if a[1] != b[1]:
                e.append((a[0], a[1], b[0], b[1]))
    if not e:
        return np.zeros((h, w), np.uint8), minx, miny
    ee = np.asarray(e, np.float64)
    x0, y0, x1, y1 = ee[:, 0], ee[:, 1], ee[:, 2], ee[:, 3]
    ylo = np.minimum(y0, y1)
    yhi = np.maximum(y0, y1)
    direc = np.where(y1 > y0, 1, -1)
    cov = np.zeros((h, w), np.float64)
    for row in range(h):
        acc = np.zeros(w * ss, np.float64)
        for sub in range(ss):
            yc = row + (sub + 0.5) / ss
            sel = (ylo <= yc) & (yc < yhi)
            if not sel.any():
                continue
            xs = x0[sel] + (yc - y0[sel]) * (x1[sel] - x0[sel]) \
                / (y1[sel] - y0[sel])
            order = np.argsort(xs, kind="stable")
            xs = xs[order]
            ds = direc[sel][order]
            wind = np.cumsum(ds)
            inside = wind != 0
            for i in range(len(xs) - 1):
                if inside[i]:
                    a = max(0, int(round(xs[i] * ss)))
                    b = min(w * ss, int(round(xs[i + 1] * ss)))
                    if b > a:
                        acc[a:b] += 1.0
        cov[row] = acc.reshape(w, ss).sum(axis=1) / (ss * ss)
    return np.clip(cov * 255.0, 0, 255).astype(np.uint8), minx, miny


def _drawing_bitmap(st: SpanState, text: str, sx: float, sy: float
                    ) -> Tuple[np.ndarray, int]:
    """Coverage bitmap for a \\p drawing span plus the row index of the
    drawing's y=0 line inside it.  libass splits a drawing into
    ascent = -yMin - pbo above the text baseline and
    descent = yMax + pbo below it (ass_drawing.c drawing asc/desc);
    the layout anchors the y=0 row at the line baseline (r5 ledger
    close — the old model bottom-anchored the bbox)."""
    paths = _parse_drawing(text, st.p_scale)
    cov, _ox, oy = _fill_polygons(
        paths, sx * st.scale_x / 100.0, sy * st.scale_y / 100.0)
    return cov, -oy


def _split_clip_drawing(inner: str) -> Tuple[int, str]:
    """\\clip([scale,] drawing): the optional first argument is the
    coordinate scale (like \\p's), default 1."""
    head, _, rest = inner.partition(",")
    head = head.strip()
    if rest and head.lstrip("+-").isdigit():
        return max(1, int(head)), rest
    return 1, inner


def _mask_image(im: dict, mask: np.ndarray, inverse: bool
                ) -> Optional[dict]:
    """Multiply an image's coverage by a full-frame vector-clip mask
    (inverse keeps what the drawing does NOT cover)."""
    h, w = mask.shape
    bm = im["bitmap"]
    bh, bw = bm.shape
    x0, y0 = im["dst_x"], im["dst_y"]
    sub = np.zeros((bh, bw), np.uint8)
    ax0, ay0 = max(0, x0), max(0, y0)
    ax1, ay1 = min(w, x0 + bw), min(h, y0 + bh)
    if ax1 > ax0 and ay1 > ay0:
        sub[ay0 - y0:ay1 - y0, ax0 - x0:ax1 - x0] = \
            mask[ay0:ay1, ax0:ax1]
    if inverse:
        sub = 255 - sub
    out = (bm.astype(np.uint16) * sub // 255).astype(np.uint8)
    if not out.any():
        return None
    return {**im, "bitmap": out}


def _clip_image(im: dict, rect, inverse: bool) -> Optional[dict]:
    x1, y1, x2, y2 = (int(round(v)) for v in rect)
    bm = im["bitmap"].copy()
    h, w = bm.shape
    gy, gx = im["dst_y"], im["dst_x"]
    if inverse:
        iy0 = max(0, y1 - gy)
        iy1 = min(h, y2 - gy)
        ix0 = max(0, x1 - gx)
        ix1 = min(w, x2 - gx)
        if iy1 > iy0 and ix1 > ix0:
            bm[iy0:iy1, ix0:ix1] = 0
    else:
        mask = np.zeros_like(bm, bool)
        iy0 = max(0, y1 - gy)
        iy1 = min(h, y2 - gy)
        ix0 = max(0, x1 - gx)
        ix1 = min(w, x2 - gx)
        if iy1 > iy0 and ix1 > ix0:
            mask[iy0:iy1, ix0:ix1] = True
        bm[~mask] = 0
    if not bm.any():
        return None
    return {**im, "bitmap": bm}


def _fade_mult(lay: EventLayout, rel_ms: float, dur_ms: float) -> float:
    """\\fad/\\fade alpha multiplier in [0, 1] at rel_ms."""
    if lay.fade is not None:
        a1, a2, a3, t1, t2, t3, t4 = lay.fade
        if rel_ms < t1:
            a = a1
        elif rel_ms < t2:
            a = a1 + (a2 - a1) * (rel_ms - t1) / max(1e-9, t2 - t1)
        elif rel_ms < t3:
            a = a2
        elif rel_ms < t4:
            a = a2 + (a3 - a2) * (rel_ms - t3) / max(1e-9, t4 - t3)
        else:
            a = a3
        return 1.0 - min(255.0, max(0.0, a)) / 255.0
    if lay.fad is not None:
        t_in, t_out = lay.fad
        m = 1.0
        if t_in > 0 and rel_ms < t_in:
            m = min(m, rel_ms / t_in)
        if t_out > 0 and rel_ms > dur_ms - t_out:
            m = min(m, max(0.0, (dur_ms - rel_ms) / t_out))
        return max(0.0, min(1.0, m))
    return 1.0


def _color_field(rgb_a: RGBA, fade: float) -> int:
    """(r,g,b,a) + fade multiplier -> libass 0xRRGGBBAA inverted-alpha."""
    a = int(round(rgb_a[3] * fade))
    return ((rgb_a[0] << 24) | (rgb_a[1] << 16) | (rgb_a[2] << 8)
            | (255 - max(0, min(255, a))))


def _wrap_lines(lines: List[List[Span]], avail: float, mode: int,
                measure) -> List[List[Span]]:
    """Soft line wrapping (libass wrap_lines_smart): \\q2 never wraps;
    \\q1 breaks greedily at spaces; \\q0/\\q3 keep the greedy line
    count but re-break to even the lines out, biased so upper (\\q0)
    resp. lower (\\q3) lines end up wider.  Explicit \\N breaks (the
    incoming `lines` structure) are preserved."""
    if mode == 2 or avail <= 0:
        return lines
    out: List[List[Span]] = []
    for line in lines:
        if any(sp.state.p_scale for sp in line):
            out.append(line)          # drawings never wrap
            continue
        # tokenize into (state, word) + inter-word space widths
        toks: List[Tuple[SpanState, str]] = []
        for sp in line:
            for t in re.findall(r"\S+|\s+", sp.text):
                toks.append((sp.state, t))
        words: List[Tuple[SpanState, str]] = []
        sep_txt: List[str] = []           # whitespace before word i
        pend = ""
        for stt, t in toks:
            if t.isspace():
                pend += t
            else:
                words.append((stt, t))
                sep_txt.append(pend if words[1:] else "")
                pend = ""
        if not words:
            out.append(line)
            continue
        # the rebuild below attaches each inter-word gap to the PRECEDING
        # span, so measure it with that span's state — measuring with the
        # following word's state skews wrap widths when font size changes
        # at a span boundary (ADVICE r4)
        seps = [measure(words[i - 1][0] if i else words[i][0], sep_txt[i])
                if sep_txt[i] else 0.0
                for i in range(len(words))]
        wlens = [measure(stt, t) for stt, t in words]
        if sum(wlens) + sum(seps) <= avail:
            out.append(line)
            continue

        # greedy pass -> number of lines
        breaks = []                       # index of first word per line
        cur = 0.0
        for i, wl in enumerate(wlens):
            add = wl + (seps[i] if cur > 0 else 0.0)
            if cur > 0 and cur + add > avail:
                breaks.append(i)
                cur = wl
            else:
                cur += add
        k = len(breaks) + 1
        if mode in (0, 3) and k > 1:
            # DP re-break into exactly k lines minimizing squared
            # slack; a small width bias prefers wider upper (q0) or
            # lower (q3) lines — libass' equalization pass
            n = len(words)
            INF = float("inf")

            def seg_w(a, b):              # words[a:b]
                return (sum(wlens[a:b])
                        + sum(seps[a + 1:b]))

            cost = [[INF] * (k + 1) for _ in range(n + 1)]
            back = [[0] * (k + 1) for _ in range(n + 1)]
            cost[0][0] = 0.0
            for j in range(1, k + 1):
                for b in range(j, n + 1):
                    for a in range(j - 1, b):
                        if cost[a][j - 1] is INF:
                            continue
                        w = seg_w(a, b)
                        over = 0.0 if w <= avail else (w - avail) * 1e6
                        bias = (j if mode == 3 else (k + 1 - j)) \
                            * w * 1e-3
                        c = cost[a][j - 1] + (avail - w) ** 2 \
                            + over - bias
                        if c < cost[b][j]:
                            cost[b][j] = c
                            back[b][j] = a
            # recover break indices
            bseq = []
            b = n
            for j in range(k, 0, -1):
                a = back[b][j]
                if a > 0:
                    bseq.append(a)
                b = a
            breaks = sorted(bseq)

        # rebuild span lines, merging same-state runs; the original
        # whitespace text survives inside lines, break points trim it
        start = 0
        for b in breaks + [len(words)]:
            spans: List[Span] = []
            for wi in range(start, b):
                stt, t = words[wi]
                gap = sep_txt[wi] if wi > start else ""
                if spans and spans[-1].state is stt:
                    spans[-1] = Span(spans[-1].text + gap + t, stt)
                else:
                    if spans and gap:
                        spans[-1] = Span(spans[-1].text + gap,
                                         spans[-1].state)
                    spans.append(Span(t, stt))
            out.append(spans)
            start = b
    return out


def render_events(track: AssTrack, time_ns: int, width: int,
                  height: int, face: str = "fixed") -> List[dict]:
    """ASS_Image-list analog: [{'bitmap': [h, w] u8, 'dst_x', 'dst_y',
    'color': 0xRRGGBBAA with INVERTED alpha byte like libass}] for the
    events active at @time_ns.  Events composite in (layer, order).
    face='pango' shapes glyphs with real fonts (_pango_span);
    'fixed' keeps the fixed-advance bitmap face."""
    use_pango = face == "pango"
    images: List[dict] = []
    sx = width / track.play_res_x
    sy = height / track.play_res_y
    bottom_stack = height
    active = [ev for ev in track.events if ev.start <= time_ns < ev.end]
    for ev in sorted(active, key=lambda e: e.layer):
        style = track.styles.get(ev.style,
                                 track.styles.get("Default", AssStyle()))
        rel_ms = (time_ns - ev.start) / 1e6
        dur_ms = (ev.end - ev.start) / 1e6
        lines, lay = parse_dialogue_text(ev.raw_text or ev.text, style,
                                         track.styles, rel_ms=rel_ms,
                                         dur_ms=dur_ms)
        align = lay.align or style.alignment
        fade = _fade_mult(lay, rel_ms, dur_ms)
        if fade <= 0.0:
            continue
        rel_cs = rel_ms / 10.0
        ml = (ev.margin_l or style.margin_l) * sx
        mr = (ev.margin_r or style.margin_r) * sx
        mv = (ev.margin_v or style.margin_v) * sy

        def _measure(stt, txt):
            if not txt:
                return 0.0
            if use_pango:
                return float(_pango_span(stt, txt, sy, sx)[1])
            fh, cw, adv = _span_metrics(stt, sy, sx)
            shear = fh // 4 if stt.italic else 0
            return float(len(txt) * adv - (adv - cw) + shear)

        wrap_mode = lay.wrap if lay.wrap is not None \
            else track.wrap_style
        lines = _wrap_lines(lines, width - ml - mr, wrap_mode,
                            _measure)

        # metrics: per-line ascent/descent (libass' line model): text
        # spans contribute (asc=span height, desc=0); drawings split at
        # their y=0 row shifted by \pbo (asc = -yMin - pbo,
        # desc = yMax + pbo — ass_drawing.c).  Line height = max asc +
        # max desc; the baseline sits asc below the line top.
        dcache: Dict[int, Tuple[np.ndarray, int]] = {}
        for line in lines:
            for s in line:
                if s.state.p_scale and s.text.strip():
                    dcache[id(s)] = _drawing_bitmap(s.state, s.text,
                                                    sx, sy)

        def _span_asc_desc(s) -> Tuple[int, int, int]:
            """(asc, desc, width) of one span."""
            if id(s) in dcache:
                cov, y0row = dcache[id(s)]
                pb = int(round(s.state.pbo * sy))
                return y0row - pb, cov.shape[0] - y0row + pb, cov.shape[1]
            if use_pango:
                cov, w = _pango_span(s.state, s.text, sy, sx)
                return cov.shape[0], 0, w
            fh, cw, adv = _span_metrics(s.state, sy, sx)
            n = len(s.text)
            shear = fh // 4 if s.state.italic else 0
            return fh, 0, (n * adv - (adv - cw) if n else 0) + shear

        line_dims: List[Tuple[int, int, List[Tuple[Span, int]]]] = []
        for line in lines:
            line = [s for s in line
                    if not (s.state.p_scale and id(s) not in dcache)]
            if not line:
                fh = max(4, int(style.fontsize * sy))
                line_dims.append((fh, fh, []))
                continue
            metrics = [(s,) + _span_asc_desc(s) for s in line]
            asc_line = max(1, max(a for _, a, _d, _w in metrics))
            desc_line = max(0, max(d for _, _a, d, _w in metrics))
            widths = [(s, w) for s, _a, _d, w in metrics]
            line_dims.append((asc_line + desc_line, asc_line, widths))
        text_h = sum(lh for lh, _asc, _ in line_dims)
        line_ws = [sum(w for _, w in ws) for _, _asc, ws in line_dims]
        max_w = max(line_ws) if line_ws else 1

        pos = lay.pos
        if lay.move is not None:
            x1, y1, x2, y2 = lay.move[:4]
            t1, t2 = (lay.move[4], lay.move[5]) \
                if len(lay.move) >= 6 else (0.0, dur_ms)
            if t2 <= t1:
                f = 1.0 if rel_ms >= t2 else 0.0
            else:
                f = max(0.0, min(1.0, (rel_ms - t1) / (t2 - t1)))
            pos = (x1 + (x2 - x1) * f, y1 + (y2 - y1) * f)

        col = (align - 1) % 3                # 0 left, 1 center, 2 right
        rowp = (align - 1) // 3              # 0 bottom, 1 mid, 2 top
        if pos is not None:
            px, py = pos[0] * sx, pos[1] * sy
            x0 = px - (0, max_w / 2, max_w)[col]
            y0 = py - (text_h, text_h / 2, 0)[rowp]
        else:
            if col == 0:
                x0 = ml
            elif col == 1:
                x0 = (width - max_w) / 2
            else:
                x0 = width - mr - max_w
            if rowp == 2:
                y0 = mv
            elif rowp == 1:
                y0 = (height - text_h) / 2
            else:
                y0 = bottom_stack - mv - text_h
                bottom_stack = y0

        if lay.org is not None:
            org = (lay.org[0] * sx, lay.org[1] * sy)
        elif pos is not None:
            org = (pos[0] * sx, pos[1] * sy)
        else:
            org = (x0 + max_w / 2, y0 + text_h / 2)

        ev_images: List[dict] = []
        ly = y0
        for (lh, asc_line, widths), lw in zip(line_dims, line_ws):
            if col == 1:
                lx = x0 + (max_w - lw) / 2
            elif col == 2:
                lx = x0 + (max_w - lw)
            else:
                lx = x0
            for span, w_span in widths:
                st = span.state
                if not span.text or w_span <= 0:
                    lx += w_span
                    continue
                if id(span) in dcache:
                    # \p drawing: y=0 row anchored at the line baseline,
                    # \pbo shifting it down (libass asc/desc split)
                    cov, y0row = dcache[id(span)]
                    bm = np.zeros((lh, cov.shape[1]), np.uint8)
                    pb = int(round(st.pbo * sy))
                    top = asc_line - (y0row - pb)
                    c0 = max(0, -top)
                    top = max(0, top)
                    hcut = min(cov.shape[0] - c0, lh - top)
                    if hcut > 0:
                        bm[top:top + hcut] = cov[c0:c0 + hcut]
                elif use_pango:
                    cov, _w = _pango_span(st, span.text, sy, sx)
                    bm = np.zeros((lh, cov.shape[1]), np.uint8)
                    top = max(0, asc_line - cov.shape[0])
                    hcut = min(cov.shape[0], lh - top)
                    bm[top:top + hcut] = cov[:hcut]
                else:
                    bm = np.zeros((lh, 1), np.uint8)
                    sb = _span_bitmap(span, asc_line, sy, sx)
                    if sb.shape[1] > 1 or sb.any():
                        bm = np.zeros((lh, sb.shape[1]), np.uint8)
                        bm[:asc_line] = sb
                k_on = (st.k_start_cs < 0 or rel_cs >= st.k_start_cs)
                fill = st.primary if (st.k_start_cs < 0 or k_on
                                      or st.k_outline) else st.secondary
                if st.k_start_cs >= 0 and not st.k_outline and not k_on:
                    fill = st.secondary
                blur_n = int(round(st.blur))
                shad = int(round(st.shadow * sy))
                bord = int(round(st.border * sy)) \
                    if st.border > 0 else 0
                show_outline = bord > 0 and (not st.k_outline or k_on)
                if shad > 0:
                    sb = _grow(bm, bord) if show_outline else bm
                    if blur_n:
                        sb = _box_blur(sb, blur_n)
                    ev_images.append({
                        "bitmap": sb,
                        "dst_x": int(lx) + shad - (bord
                                                   if show_outline
                                                   else 0),
                        "dst_y": int(ly) + shad - (bord
                                                   if show_outline
                                                   else 0),
                        "color": _color_field(st.back, fade)})
                if show_outline:
                    ob = _grow(bm, bord)
                    if blur_n:
                        ob = _box_blur(ob, blur_n)
                    ev_images.append({
                        "bitmap": ob, "dst_x": int(lx) - bord,
                        "dst_y": int(ly) - bord,
                        "color": _color_field(st.outline_color, fade)})
                fb = _box_blur(bm, blur_n) \
                    if (blur_n and not show_outline) else bm
                sweeping = (st.k_sweep and st.k_start_cs >= 0
                            and not st.k_outline and st.k_dur_cs > 0
                            and st.k_start_cs <= rel_cs
                            < st.k_start_cs + st.k_dur_cs)
                if sweeping:
                    # \kf/\K: the fill boundary moves left to right
                    # across the syllable over its duration (libass'
                    # sweep); primary left of the cut, secondary right
                    frac = (rel_cs - st.k_start_cs) / st.k_dur_cs
                    cut = int(round(fb.shape[1] * frac))
                    if cut > 0:
                        ev_images.append({
                            "bitmap": fb[:, :cut],
                            "dst_x": int(lx), "dst_y": int(ly),
                            "color": _color_field(st.primary, fade)})
                    if cut < fb.shape[1]:
                        ev_images.append({
                            "bitmap": fb[:, cut:],
                            "dst_x": int(lx) + cut, "dst_y": int(ly),
                            "color": _color_field(st.secondary, fade)})
                else:
                    ev_images.append({
                        "bitmap": fb, "dst_x": int(lx),
                        "dst_y": int(ly),
                        "color": _color_field(fill, fade)})
                lx += w_span
            ly += lh

        if lay.frx or lay.fry or lay.fax or lay.fay:
            ev_images = [_transform_image(im, lay, org[0], org[1],
                                          20000.0 * sy, width, height)
                         for im in ev_images]
        elif lay.frz:
            ev_images = [_rotate_image(im, lay.frz, org[0], org[1])
                         for im in ev_images]
        clip_rect = None
        if lay.clip is not None:
            clip_rect = tuple(v * (sx if i % 2 == 0 else sy)
                              for i, v in enumerate(lay.clip))
        iclip_rect = None
        if lay.iclip is not None:
            iclip_rect = tuple(v * (sx if i % 2 == 0 else sy)
                               for i, v in enumerate(lay.iclip))

        def _clip_mask(spec):
            cscale, dtext = spec
            cov, ox, oy = _fill_polygons(_parse_drawing(dtext, cscale),
                                         sx, sy)
            mask = np.zeros((height, width), np.uint8)
            mx0, my0 = max(0, ox), max(0, oy)
            mx1 = min(width, ox + cov.shape[1])
            my1 = min(height, oy + cov.shape[0])
            if mx1 > mx0 and my1 > my0:
                mask[my0:my1, mx0:mx1] = cov[my0 - oy:my1 - oy,
                                             mx0 - ox:mx1 - ox]
            return mask

        clip_mask = (_clip_mask(lay.clip_path)
                     if lay.clip_path is not None else None)
        iclip_mask = (_clip_mask(lay.iclip_path)
                      if lay.iclip_path is not None else None)
        for im in ev_images:
            if clip_rect is not None:
                im = _clip_image(im, clip_rect, False)
                if im is None:
                    continue
            if iclip_rect is not None:
                im = _clip_image(im, iclip_rect, True)
                if im is None:
                    continue
            if clip_mask is not None:
                im = _mask_image(im, clip_mask, False)
                if im is None:
                    continue
            if iclip_mask is not None:
                im = _mask_image(im, iclip_mask, True)
                if im is None:
                    continue
            if (im["color"] & 0xFF) == 0xFF:
                continue                     # fully transparent
            images.append(im)
    return images


def blit_bgra_premultiplied(images: List[dict], width: int,
                            height: int) -> np.ndarray:
    """gstassrender.c:679-744 transcribed: premultiplied BGRA
    composite of the image list; returns [height, width, 4] u8 in
    B,G,R,A byte order."""
    data = np.zeros((height, width, 4), np.uint8)
    for im in images:
        dst_x, dst_y = im["dst_x"], im["dst_y"]
        bm = im["bitmap"]
        src_y0 = max(0, -dst_y)
        src_x0 = max(0, -dst_x)
        dst_y0 = max(0, dst_y)
        dst_x0 = max(0, dst_x)
        w = min(bm.shape[1] - src_x0, width - dst_x0)
        h = min(bm.shape[0] - src_y0, height - dst_y0)
        if w <= 0 or h <= 0:
            continue
        alpha = 255 - (im["color"] & 0xFF)
        if not alpha:
            continue
        r = (im["color"] >> 24) & 0xFF
        g = (im["color"] >> 16) & 0xFF
        b = (im["color"] >> 8) & 0xFF
        src = bm[src_y0:src_y0 + h, src_x0:src_x0 + w].astype(np.int32)
        dst = data[dst_y0:dst_y0 + h, dst_x0:dst_x0 + w].astype(np.int32)
        k = src * alpha // 255
        on = src > 0
        first = on & (dst[..., 3] == 0)
        blend = on & ~first
        for ch, c in ((3, None), (2, r), (1, g), (0, b)):
            if c is None:
                dst[..., 3] = np.where(
                    first, k, np.where(
                        blend, k + (255 - k) * dst[..., 3] // 255,
                        dst[..., 3]))
            else:
                dst[..., ch] = np.where(
                    first, k * c // 255, np.where(
                        blend, (k * c + (255 - k) * dst[..., ch]) // 255,
                        dst[..., ch]))
        data[dst_y0:dst_y0 + h, dst_x0:dst_x0 + w] = \
            dst.astype(np.uint8)
    return data
