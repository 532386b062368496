"""ttml (ext/ttml/): io/ttml.py parse pipeline + ttmlrender element."""

import fractions

import numpy as np
import jax.numpy as jnp
import pytest

import gstbad as gt
from gstbad.core.frame import FrameBatch
from gstbad.core.pipeline import Pipeline
from gstbad.core.spec import MediaSpec
from gstbad.io import ttml

DOC = '''<?xml version="1.0" encoding="UTF-8"?>
<tt xmlns="http://www.w3.org/ns/ttml"
    xmlns:tts="http://www.w3.org/ns/ttml#styling"
    xmlns:ttp="http://www.w3.org/ns/ttml#parameter"
    ttp:cellResolution="40 24" xml:lang="en">
  <head>
    <styling>
      <style xml:id="s_white" tts:color="#FFFFFF" tts:fontSize="100%"
             tts:backgroundColor="#000000AA" tts:textAlign="center"/>
      <style xml:id="s_yellow" tts:color="#FFFF00"/>
    </styling>
    <layout>
      <region xml:id="r_bottom" tts:origin="10% 80%" tts:extent="80% 15%"
              tts:displayAlign="after"/>
      <region xml:id="r_top" tts:origin="10% 5%" tts:extent="80% 15%"/>
    </layout>
  </head>
  <body>
    <div>
      <p xml:id="p1" region="r_bottom" style="s_white"
         begin="00:00:01.000" end="00:00:03.500">Hello
        <span style="s_yellow">world</span><br/>second line</p>
      <p xml:id="p2" region="r_top" style="s_white"
         begin="00:00:02" end="00:00:04">Top text</p>
    </div>
  </body>
</tt>'''


def test_timecode_parse():
    assert ttml.parse_timecode("00:00:01.000") == 10 ** 9
    assert ttml.parse_timecode("01:02:03") == (3600 + 123) * 10 ** 9
    # fraction digit scaling: .5 -> 500 ms, .25 -> 250 ms
    assert ttml.parse_timecode("00:00:00.5") == 500 * 10 ** 6
    assert ttml.parse_timecode("00:00:00.25") == 250 * 10 ** 6
    assert ttml.parse_timecode("bad") is None


def test_colorstring():
    assert ttml.parse_colorstring("#FF8000") == (255, 128, 0, 255)
    assert ttml.parse_colorstring("#FF8000AA") == (255, 128, 0, 170)
    assert ttml.parse_colorstring("red") == (0, 0, 0, 0)


def test_parse_scenes_and_styles():
    scenes, consumed = ttml.ttml_parse(DOC)
    assert consumed == DOC.find("</tt>") + 5
    # transitions at 1.0, 2.0, 3.5, 4.0 -> 3 scenes
    assert [(s.begin, s.end) for s in scenes] == [
        (10 ** 9, 2 * 10 ** 9), (2 * 10 ** 9, 3_500_000_000),
        (3_500_000_000, 4 * 10 ** 9)]
    s0 = scenes[0]
    r = next(r for r in s0.regions if r.blocks)
    assert (r.style.origin_x, r.style.origin_y) == (0.1, 0.8)
    assert (r.style.extent_w, r.style.extent_h) == (0.8, 0.15)
    assert r.style.display_align == "after"
    b = r.blocks[0]
    assert b.style.text_align == "center"
    assert b.style.background_color == (0, 0, 0, 170)
    texts = [e.text for e in b.elements]
    assert texts == ["Hello ", "world", "\nsecond line"]
    assert b.elements[1].style.color == (255, 255, 0, 255)
    # fontSize 100% / cellres_y 24
    assert abs(b.elements[0].style.font_size - 1 / 24) < 1e-9
    # middle scene shows both regions
    both = [r for r in scenes[1].regions if r.blocks]
    assert len(both) == 2


def test_whitespace_and_inheritance():
    doc = DOC.replace('ttp:cellResolution="40 24"', "")
    scenes, _ = ttml.ttml_parse(doc)
    b = next(r for r in scenes[0].regions if r.blocks).blocks[0]
    # default cellres 32x15
    assert abs(b.elements[0].style.font_size - 1 / 15) < 1e-9
    # newline + indentation in "Hello\n        <span>" collapsed
    assert b.elements[0].text == "Hello "


def test_relative_font_size():
    # inline tts: attributes on content elements are ignored (the
    # reference parses style sets only on style/region elements);
    # relative sizing flows through referenced styles
    doc = DOC.replace(
        '<style xml:id="s_yellow" tts:color="#FFFF00"/>',
        '<style xml:id="s_yellow" tts:color="#FFFF00"/>'
        '<style xml:id="s_half" tts:fontSize="50%"/>')
    doc = doc.replace('<span style="s_yellow">',
                      '<span style="s_yellow s_half">')
    scenes, _ = ttml.ttml_parse(doc)
    b = next(r for r in scenes[0].regions if r.blocks).blocks[0]
    # nested %: 50% of parent's 100% -> 0.5 / cellres_y
    assert abs(b.elements[1].style.font_size - 0.5 / 24) < 1e-9


def test_framing_needs_more_data():
    assert ttml.ttml_parse("<?xml incomplete") == ([], 0)
    assert ttml.ttml_parse("no xml at all") == ([], 0)


def test_render_scene_geometry():
    scenes, _ = ttml.ttml_parse(DOC)
    W, H = 320, 240
    ov = ttml.render_scene(scenes[0], W, H)
    assert ov.shape == (H, W, 4)
    # bottom region only in scene 0: rows 192..228 get content
    assert (ov[:48, :, 3] == 0).all()        # top region inactive
    ys, xs = np.where(ov[..., 3] > 0)
    assert ys.min() >= int(0.8 * H) - 1
    # white and yellow glyph pixels present
    on = ov[ov[..., 3] == 255]
    assert ((on[:, 0] == 255) & (on[:, 1] == 255) & (on[:, 2] == 0)
            ).any(), "yellow"
    assert ((on[:, 0] == 255) & (on[:, 1] == 255) & (on[:, 2] == 255)
            ).any(), "white"
    # middle scene renders the top region too
    ov1 = ttml.render_scene(scenes[1], W, H)
    assert (ov1[:48, :, 3] > 0).any()


def test_ttmlrender_element():
    W, H = 320, 240
    el = gt.make("ttmlrender")
    el.push_ttml(DOC)
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="RGBx", width=W, height=H,
                          framerate=fractions.Fraction(2)))
    img = np.full((4, H, W, 4), 60, np.uint8)
    pts = jnp.asarray([0, 10 ** 9, 2 * 10 ** 9, 5 * 10 ** 9], jnp.int64)
    out = np.asarray(p.run(inputs=FrameBatch.make(jnp.asarray(img),
                                                  pts=pts))[0].data)
    # frame 0: before any scene -> untouched
    np.testing.assert_array_equal(out[0], img[0])
    # frame 1 (t=1s): bottom caption blended
    assert (out[1] != img[1]).any()
    assert (out[1][:48] == img[1][:48]).all()
    # frame 2 (t=2s): top text visible too
    assert (out[2][:48] != img[2][:48]).any()
    # frame 3 (t=5s): past everything -> untouched
    np.testing.assert_array_equal(out[3], img[3])


def test_ttmlparse_element_messages():
    el = gt.make("ttmlparse")
    el.push_ttml(DOC)
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="RGBx", width=64,
                          height=48, framerate=fractions.Fraction(25)))
    img = np.zeros((1, 48, 64, 4), np.uint8)
    p.run(inputs=FrameBatch.make(jnp.asarray(img)))
    msgs = p.bus.pop(name="ttml-scene")
    assert [(m["begin"], m["end"]) for m in msgs] == [
        (10 ** 9, 2 * 10 ** 9), (2 * 10 ** 9, 3_500_000_000),
        (3_500_000_000, 4 * 10 ** 9)]
    assert any("Hello world" in t for t in msgs[0]["texts"])
