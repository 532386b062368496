"""ttmlrender over real Pango (io/ttml_pango.py — the
gstttmlrender.c:1185-2760 transcription): markup generation, font-size
search, line wrapping via pango_layout_xy_to_index, block metrics,
whitespace strips, alignment geometry, and the element blend.

TTML styling here is referential (<style> in <head> + style="id"),
because the reference's ttml_parse_element only collects style sets on
style/region nodes (ttmlparse.c:373-381) — inline tts: attributes on
p/span are dropped, a quirk this repo reproduces."""

import math

import numpy as np
import pytest

import gstbad as gt
from gstbad.core.harness import Harness
from gstbad.core.spec import MediaSpec
from gstbad.io import pangocairo, ttml

pytestmark = pytest.mark.skipif(not pangocairo.available(),
                                reason="pango/cairo not present")

from gstbad.io import ttml_pango  # noqa: E402


def _doc(body, style_attrs="", region_attrs=""):
    return f'''<?xml version="1.0" encoding="utf-8"?>
<tt xmlns="http://www.w3.org/ns/ttml"
    xmlns:tts="http://www.w3.org/ns/ttml#styling"
    xmlns:ebutts="urn:ebu:tt:style"
    xmlns:ttp="http://www.w3.org/ns/ttml#parameter"
    ttp:cellResolution="40 24">
 <head>
  <styling><style xml:id="s1" {style_attrs}/></styling>
  <layout>
   <region xml:id="r1" tts:origin="10% 60%" tts:extent="80% 30%"
           {region_attrs}/>
  </layout>
 </head>
 <body><div region="r1">{body}</div></body>
</tt>'''


def _scene(doc):
    scenes, consumed = ttml.ttml_parse(doc)
    assert consumed > 0 and scenes
    return scenes[0]


def test_markup_is_the_reference_span():
    ss = ttml.StyleSet()
    ss.color = (255, 255, 0, 128)
    ss.font_style = "italic"
    ss.text_decoration = "underline"
    got = ttml_pango.generate_pango_markup(ss, 24, 'a<b>&"')
    assert got == ('<span fgcolor="#ffff0080" font="24px" '
                   'font_family="TiresiasScreenfont,Liberation Mono,'
                   'Courier New,monospace" font_style="italic" '
                   'font_weight="normal" underline="single" >'
                   "a&lt;b&gt;&amp;&quot;</span>")


def test_font_size_search_converges_to_desired_height():
    """gstttmlrender.c:1458-1476: the chosen px size renders the probe
    string no taller than the desired pixel height, and one size up
    would exceed it."""
    r = ttml_pango.PangoRenderer(640, 360)
    ss = ttml.StyleSet()
    ss.font_size = 48 / 360          # desired = 48 px
    size = r.pango_font_size(ss)
    h, _ = r.font_metrics(ss, size)
    assert h <= 48
    h_up, _ = r.font_metrics(ss, size + 1)
    assert h_up > 48


def test_line_ranges_wrap_at_breakpoints():
    r = ttml_pango.PangoRenderer(640, 360)
    block = ttml.Block(ttml.StyleSet(), [
        ttml.SubElement(ttml.StyleSet(), "aaaa bbbb cccc dddd", True)])
    block.style.font_size = 20 / 360
    block.elements[0].style.font_size = 20 / 360
    ub = r.unify_block(block)
    ranges = r.line_char_ranges(ub, 80, wrap=True)
    assert len(ranges) > 1
    joined = ub.joined_text
    # every break lands on a space (the nearest-breakpoint walk)
    for first, last in ranges[:-1]:
        assert joined[last:last + 1] == b" "
    # ranges tile the text
    assert ranges[0][0] == 0
    for (f1, l1), (f2, _l2) in zip(ranges, ranges[1:]):
        assert f2 == l1 + 1
    assert ranges[-1][1] == len(joined) - 1


def test_hard_breaks_split_ranges():
    r = ttml_pango.PangoRenderer(640, 360)
    block = ttml.Block(ttml.StyleSet(), [
        ttml.SubElement(ttml.StyleSet(), "one\ntwo", True)])
    ub = r.unify_block(block)
    ranges = r.line_char_ranges(ub, 10000, wrap=True)
    assert ranges == [(0, 2), (4, 6)]


def test_whitespace_strip_at_line_breaks():
    ub = ttml_pango.UnifiedBlock(ttml.StyleSet(), [
        ttml_pango.UnifiedElement(ttml.StyleSet(), True, 10, 10, 8,
                                  b"  hello "),
        ttml_pango.UnifiedElement(ttml.StyleSet(), True, 10, 10, 8,
                                  b"   ")])
    out = ttml_pango.PangoRenderer.handle_whitespace([ub])
    assert len(out) == 1
    assert out[0].elements[0].text == b"hello"
    assert len(out[0].elements) == 1
    # xml:space="preserve" elements keep their spaces
    ub2 = ttml_pango.UnifiedBlock(ttml.StyleSet(), [
        ttml_pango.UnifiedElement(ttml.StyleSet(), False, 10, 10, 8,
                                  b"  kept  ")])
    out2 = ttml_pango.PangoRenderer.handle_whitespace([ub2])
    assert out2[0].elements[0].text == b"  kept  "


def test_block_metrics_normal_vs_percentage():
    r = ttml_pango.PangoRenderer(640, 360)
    block = ttml.Block(ttml.StyleSet(), [
        ttml.SubElement(ttml.StyleSet(), "Xg", True)])
    block.style.font_size = 24 / 360
    block.elements[0].style.font_size = 24 / 360
    ub = r.unify_block(block)
    # lineHeight normal: 125% of tallest text height
    lh, _base = r.block_metrics(ub)
    assert lh == math.ceil(ub.elements[0].metrics_height * 1.25)
    # percentage: relative to the block font size
    ub.style.line_height = 2.0
    lh2, _ = r.block_metrics(ub)
    assert lh2 == math.ceil(24 * 2.0)


def test_render_scene_wraps_and_stacks_lines():
    doc = _doc('<p begin="00:00:00" end="00:00:05" style="s1">'
               "word word word word word word word word word</p>",
               style_attrs='tts:fontSize="150%" '
                           'tts:backgroundColor="#202020"')
    sc = _scene(doc)
    ov = ttml_pango.render_scene(sc, 320, 240)
    rows = (ov[..., 3] > 0).any(axis=1)
    ys = np.nonzero(rows)[0]
    assert len(ys) > 0
    # region window starts at 60% of 240 = 144
    assert ys.min() >= 144
    # wrapped into >1 line: text taller than a single line height
    r = ttml_pango.PangoRenderer(320, 240)
    ub = r.unify_block(sc.regions[0].blocks[0])
    lh, _ = r.block_metrics(ub)
    assert ys.max() - ys.min() + 1 > lh


def test_display_align_after_bottom_edge():
    doc = _doc('<p begin="0s" end="5s">bottom text</p>',
               region_attrs='tts:displayAlign="after"')
    sc = _scene(doc)
    ov = ttml_pango.render_scene(sc, 320, 240)
    ys = np.nonzero((ov[..., 3] > 0).any(axis=1))[0]
    # region spans 60%..90% of 240 = 144..216; after-aligned block
    # bottom sits at the region bottom
    r = ttml_pango.PangoRenderer(320, 240)
    ri = r.render_region(sc.regions[0])
    assert ri.y + ri.height == 216
    assert ys.max() <= 216


def test_text_align_center_and_right():
    left = _doc('<p begin="0s" end="5s">x</p>')
    ov_l = ttml_pango.render_scene(_scene(left), 320, 240)
    center = _doc('<p begin="0s" end="5s" style="s1">x</p>',
                  style_attrs='tts:textAlign="center"')
    ov_c = ttml_pango.render_scene(_scene(center), 320, 240)
    right = _doc('<p begin="0s" end="5s" style="s1">x</p>',
                 style_attrs='tts:textAlign="end"')
    ov_r = ttml_pango.render_scene(_scene(right), 320, 240)
    xl = np.nonzero((ov_l[..., 3] > 0).any(axis=0))[0]
    xc = np.nonzero((ov_c[..., 3] > 0).any(axis=0))[0]
    xr = np.nonzero((ov_r[..., 3] > 0).any(axis=0))[0]
    assert xl.min() < xc.min() < xr.min()
    # window is 10%..90% of 320 = 32..288
    assert xl.min() == 32
    assert xr.max() <= 288


def test_line_padding_extends_background():
    base = _doc('<p begin="0s" end="5s" style="s1">pad</p>',
                style_attrs='tts:backgroundColor="#400000"')
    padded = _doc('<p begin="0s" end="5s" style="s1">pad</p>',
                  style_attrs='tts:backgroundColor="#400000" '
                              'ebutts:linePadding="2c"')
    sc0, sc1 = _scene(base), _scene(padded)
    r = ttml_pango.PangoRenderer(320, 240)
    b0 = r.render_text_block(sc0.regions[0].blocks[0], 256)
    b1 = r.render_text_block(sc1.regions[0].blocks[0], 256)
    lp = math.ceil(sc1.regions[0].blocks[0].style.line_padding * 320)
    assert lp > 0
    assert b1.width == b0.width + 2 * lp


def test_fill_line_gap_background_heights():
    base = _doc('<p begin="0s" end="5s" style="s1">gap</p>',
                style_attrs='tts:backgroundColor="#400000" '
                            'tts:fontSize="200%"')
    filled = _doc('<p begin="0s" end="5s" style="s1">gap</p>',
                  style_attrs='tts:backgroundColor="#400000" '
                              'tts:fontSize="200%" '
                              'ebutts:fillLineGap="true"')
    sc0, sc1 = _scene(base), _scene(filled)
    # element-level bg: font-metrics height vs the full line height
    r = ttml_pango.PangoRenderer(320, 240)
    ub0 = r.unify_block(sc0.regions[0].blocks[0])
    lh, _ = r.block_metrics(ub0)
    assert not sc0.regions[0].blocks[0].style.fill_line_gap
    assert sc1.regions[0].blocks[0].style.fill_line_gap


def test_overflow_hidden_crops_to_window():
    doc = _doc('<p begin="0s" end="5s" style="s1">'
               "waaaaaaay too much text to fit in this region at this "
               "enormous font size honestly</p>",
               style_attrs='tts:fontSize="400%"',
               region_attrs='tts:overflow="hidden"')
    ov = ttml_pango.render_scene(_scene(doc), 320, 240)
    ys = np.nonzero((ov[..., 3] > 0).any(axis=1))[0]
    assert ys.max() <= 216 and ys.min() >= 144   # window rows only


def test_element_pango_blend():
    doc = _doc('<p begin="00:00:00" end="00:00:10" style="s1">RED</p>',
               style_attrs='tts:color="#ff0000" tts:fontSize="200%"')
    el = gt.make("ttmlrender")
    el.push_ttml(doc)
    h = Harness(el)
    h.set_src_spec(MediaSpec(kind="video", format="RGBx",
                             width=320, height=240))
    frames = np.full((2, 240, 320, 4), 32, np.uint8)
    out = h.push_pull(frames)
    assert el._pango
    # red text: strong R, low G where glyph cores landed
    strong = (out[..., 0].astype(int) > 180) & (out[..., 1] < 90)
    assert strong.any()


def test_element_face_bitmap_still_works():
    doc = _doc('<p begin="00:00:00" end="00:00:10">BITMAP</p>')
    el = gt.make("ttmlrender", face="bitmap")
    el.push_ttml(doc)
    h = Harness(el)
    h.set_src_spec(MediaSpec(kind="video", format="RGBx",
                             width=320, height=240))
    frames = np.zeros((1, 240, 320, 4), np.uint8)
    out = h.push_pull(frames)
    assert not el._pango
    assert (out != frames).any()
