"""assrender (ext/assrender/): io/ass.py parse/blit + the element."""

import fractions

import numpy as np
import jax.numpy as jnp
import pytest

import gstbad as gt
from gstbad.core.frame import FrameBatch
from gstbad.core.pipeline import Pipeline
from gstbad.core.spec import MediaSpec
from gstbad.io import ass

SCRIPT = """[Script Info]
PlayResX: 640
PlayResY: 480

[V4+ Styles]
Format: Name, Fontname, Fontsize, PrimaryColour, OutlineColour, BackColour, Bold, Italic, Outline, Alignment, MarginL, MarginR, MarginV
Style: Default,Arial,40,&H00FFFFFF,&H00000000,&H80000000,0,0,2,2,20,20,30
Style: Top,Arial,30,&H0000FFFF,&H00000000,&H80000000,0,0,1,8,20,20,15

[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
Dialogue: 0,0:00:01.00,0:00:03.50,Default,,0,0,0,,Hello world\\Nsecond line
Dialogue: 0,0:00:02.00,0:00:04.00,Top,,0,0,0,,{\\b1}Top text{\\b0}
"""


def test_color_and_time_parsing():
    # &HAABBGGRR with inverted alpha
    assert ass.parse_ass_color("&H00FF8040") == (0x40, 0x80, 0xFF, 255)
    assert ass.parse_ass_color("&H80FF8040") == (0x40, 0x80, 0xFF, 127)
    assert ass.parse_ass_time("0:00:01.00") == 10 ** 9
    assert ass.parse_ass_time("1:02:03.25") == \
        ((3600 + 123) * 100 + 25) * 10 ** 7


def test_override_tags():
    text, align, pos = ass.strip_override_tags(
        "{\\an7}{\\pos(100,200)}A\\Nb{\\i1}c")
    assert text == "A\nbc"
    assert align == 7 and pos == (100.0, 200.0)
    # legacy \a codes: 6 -> top-center (numpad 8)
    _, align2, _ = ass.strip_override_tags("{\\a6}x")
    assert align2 == 8


def test_script_parse():
    t = ass.AssTrack()
    t.process_script(SCRIPT)
    assert (t.play_res_x, t.play_res_y) == (640, 480)
    assert t.styles["Default"].fontsize == 40
    assert t.styles["Default"].alignment == 2
    assert t.styles["Top"].alignment == 8
    assert t.styles["Top"].primary == (255, 255, 0, 255)  # &H0000FFFF
    assert len(t.events) == 2
    assert t.events[0].text == "Hello world\nsecond line"
    assert t.events[0].start == 10 ** 9
    assert t.events[1].text == "Top text"


def test_chunk_parse_dedupe():
    t = ass.AssTrack()
    t.process_codec_private(SCRIPT.split("[Events]")[0])
    t.process_chunk("1,0,Default,,0,0,0,,Chunk text", 10 ** 9, 10 ** 9)
    t.process_chunk("1,0,Default,,0,0,0,,Chunk text", 10 ** 9, 10 ** 9)
    assert len(t.events) == 1                # duplicate ReadOrder
    assert t.events[0].text == "Chunk text"


def test_render_and_blit():
    t = ass.AssTrack()
    t.process_script(SCRIPT)
    W, H = 320, 240
    imgs = ass.render_events(t, int(1.5e9), W, H)
    assert imgs                               # event 1 active
    ov = ass.blit_bgra_premultiplied(imgs, W, H)
    assert ov.shape == (H, W, 4)
    ys, xs = np.where(ov[..., 3] > 0)
    assert ys.max() > H * 0.6                 # bottom aligned
    # white glyph pixels premultiplied: B=G=R where alpha=255
    solid = ov[ov[..., 3] == 255]
    assert (solid[:, :3] == 255).any()
    # at t=2.5 both events active; Top style yellow at the top
    imgs2 = ass.render_events(t, int(2.5e9), W, H)
    ov2 = ass.blit_bgra_premultiplied(imgs2, W, H)
    top = ov2[:60]
    sel = top[top[..., 3] == 255]
    # yellow = B 0, G 255, R 255 premultiplied at full alpha
    assert ((sel[:, 0] == 0) & (sel[:, 1] == 255)
            & (sel[:, 2] == 255)).any()


def test_blit_math_first_touch_and_blend():
    # two overlapping images exercise both branches of the blit
    bm = np.full((2, 2), 128, np.uint8)
    img1 = {"bitmap": bm, "dst_x": 0, "dst_y": 0,
            "color": 0xFF000000}             # red, alpha 255 (byte 0)
    img2 = {"bitmap": bm, "dst_x": 0, "dst_y": 0,
            "color": 0x00FF0000}             # green
    out = ass.blit_bgra_premultiplied([img1, img2], 2, 2)
    # first: k=128 -> a=128, r=128*255//255=128
    # second: k=128 over a=128: a' = 128 + 127*128//255 = 191
    px = out[0, 0]
    assert px[3] == 128 + (255 - 128) * 128 // 255
    assert px[2] == (128 * 0 + (255 - 128) * 128) // 255  # red decays
    assert px[1] == (128 * 255 + (255 - 128) * 0) // 255  # green lands


def test_assrender_element():
    W, H = 320, 240
    el = gt.make("assrender")
    el.push_script(SCRIPT)
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="BGRx", width=W, height=H,
                          framerate=fractions.Fraction(2)))
    img = np.full((4, H, W, 4), 100, np.uint8)
    pts = jnp.asarray([0, int(1.5e9), int(2.5e9), int(5e9)], jnp.int64)
    out = np.asarray(p.run(inputs=FrameBatch.make(
        jnp.asarray(img), pts=pts))[0].data)
    np.testing.assert_array_equal(out[0], img[0])     # before events
    assert (out[1] != img[1]).any()                   # event 1
    assert (out[2][:60] != img[2][:60]).any()         # Top event
    np.testing.assert_array_equal(out[3], img[3])     # after events
    # enable=false passes through
    el2 = gt.make("assrender", enable=False)
    el2.push_script(SCRIPT)
    p2 = Pipeline([el2])
    p2.negotiate(MediaSpec(kind="video", format="BGRx", width=W,
                           height=H, framerate=fractions.Fraction(2)))
    out2 = np.asarray(p2.run(inputs=FrameBatch.make(
        jnp.asarray(img), pts=pts))[0].data)
    np.testing.assert_array_equal(out2, img)


# -- the override-tag machine (io/ass.py parse_dialogue_text) ---------------

def _track(script=SCRIPT):
    t = ass.AssTrack()
    t.process_script(script)
    return t


def _spans(text, style=None, styles=None):
    return ass.parse_dialogue_text(text, style or ass.AssStyle(),
                                   styles or {})


def test_tag_spans_colors_and_sizes():
    lines, lay = _spans(r"Red{\c&H0000FF&\fs30}Big{\r}Back")
    (l,) = lines
    assert [s.text for s in l] == ["Red", "Big", "Back"]
    assert l[0].state.primary[:3] == (255, 255, 255)
    assert l[1].state.primary[:3] == (255, 0, 0)       # &H0000FF = red
    assert l[1].state.font_size == 30
    # \r resets to the base style
    assert l[2].state.primary[:3] == (255, 255, 255)
    assert l[2].state.font_size == 20


def test_tag_named_reset():
    styles = {"Big": ass.AssStyle(name="Big", fontsize=44,
                                  primary=(0, 255, 0, 255))}
    lines, _ = _spans(r"a{\rBig}b", styles=styles)
    (l,) = lines
    assert l[1].state.font_size == 44
    assert l[1].state.primary[:3] == (0, 255, 0)


def test_tag_bold_italic_underline_strike():
    lines, _ = _spans(r"{\b1\i1\u1\s1}x{\b0\i0\u0\s0}y")
    (l,) = lines
    assert l[0].state.bold and l[0].state.italic
    assert l[0].state.underline and l[0].state.strikeout
    assert not (l[1].state.bold or l[1].state.italic
                or l[1].state.underline or l[1].state.strikeout)


def test_tag_scales_spacing_relative_fs():
    lines, _ = _spans(r"{\fscx150\fscy50\fsp3\fs+4}x")
    st = lines[0][0].state
    assert st.scale_x == 150 and st.scale_y == 50 and st.spacing == 3
    assert st.font_size == 24      # 20 + 4


def test_tag_component_colors_and_alphas():
    lines, _ = _spans(
        r"{\3c&HFF0000&\4c&H00FF00&\2a&H80&\alpha&H40&}x")
    st = lines[0][0].state
    assert st.outline_color[:3] == (0, 0, 255)   # &HFF0000 = blue
    assert st.back[:3] == (0, 255, 0)
    # \alpha overwrote every component alpha: 255 - 0x40 = 191
    assert st.primary[3] == 191 and st.outline_color[3] == 191


def test_tag_pos_move_first_wins():
    _, lay = _spans(r"{\pos(10,20)}a{\pos(99,99)}b")
    assert lay.pos == (10.0, 20.0)
    _, lay2 = _spans(r"{\move(0,0,100,50)}x")
    assert lay2.move == (0.0, 0.0, 100.0, 50.0)
    # \pos and \move are mutually exclusive — first wins
    _, lay3 = _spans(r"{\pos(1,2)\move(0,0,9,9)}x")
    assert lay3.pos == (1.0, 2.0) and lay3.move is None


def test_tag_fad_fade_org_frz_clip():
    _, lay = _spans(r"{\fad(200,300)\org(5,6)\frz45"
                    r"\clip(0,0,50,60)}x")
    assert lay.fad == (200.0, 300.0)
    assert lay.org == (5.0, 6.0)
    assert lay.frz == 45.0
    assert lay.clip == (0.0, 0.0, 50.0, 60.0)
    _, lay2 = _spans(r"{\fade(255,0,255,0,100,900,1000)\iclip(1,2,3,4)}x")
    assert lay2.fade == (255.0, 0.0, 255.0, 0.0, 100.0, 900.0, 1000.0)
    assert lay2.iclip == (1.0, 2.0, 3.0, 4.0)


def test_tag_karaoke_clock():
    lines, _ = _spans(r"{\k50}one{\k30}two{\ko20}three")
    (l,) = lines
    assert l[0].state.k_start_cs == 0
    assert l[1].state.k_start_cs == 50
    assert l[2].state.k_start_cs == 80
    assert l[2].state.k_outline and not l[1].state.k_outline


def test_render_move_interpolates():
    script = SCRIPT.split("[Events]")[0] + """[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
Dialogue: 0,0:00:00.00,0:00:10.00,Default,,0,0,0,,{\\an7\\move(0,0,100,0,0,10000)}mv
"""
    t = _track(script)
    xs = []
    for tm in (0, int(5e9)):
        imgs = ass.render_events(t, tm, 640, 480)
        xs.append(min(im["dst_x"] for im in imgs))
    assert xs[1] > xs[0] + 30      # moved right ~50 PlayRes px


def test_render_fad_scales_alpha():
    script = SCRIPT.split("[Events]")[0] + """[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
Dialogue: 0,0:00:00.00,0:00:10.00,Default,,0,0,0,,{\\fad(1000,0)}f
"""
    t = _track(script)
    a_early = [255 - (im["color"] & 0xFF)
               for im in ass.render_events(t, int(0.25e9), 640, 480)]
    a_late = [255 - (im["color"] & 0xFF)
              for im in ass.render_events(t, int(5e9), 640, 480)]
    assert max(a_early) < 80       # 25% through the 1 s fade-in
    assert max(a_late) == 255


def test_render_karaoke_secondary_until_start():
    script = SCRIPT.split("[Events]")[0] + """[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
Dialogue: 0,0:00:00.00,0:00:10.00,Default,,0,0,0,,{\\k200}aa{\\k100}bb
"""
    t = _track(script)

    def fills(tm):
        return {(im["color"] >> 8) & 0xFFFFFF
                for im in ass.render_events(t, tm, 640, 480)
                if im["color"] >> 8 != 0}  # skip black outline
    # style secondary defaults to red; at t=1s "bb" still unhighlighted
    assert 0xFF0000 in fills(int(1e9))     # red present (secondary)
    assert 0xFF0000 not in fills(int(4e9))  # all highlighted by t=4s


def test_render_clip_crops():
    head = SCRIPT.split("[Events]")[0]
    t_all = _track(head + """[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
Dialogue: 0,0:00:00.00,0:00:10.00,Default,,0,0,0,,{\\an7\\pos(0,0)}wide text
""")
    t_clip = _track(head + """[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
Dialogue: 0,0:00:00.00,0:00:10.00,Default,,0,0,0,,{\\an7\\pos(0,0)\\clip(0,0,30,480)}wide text
""")
    ov_all = ass.blit_bgra_premultiplied(
        ass.render_events(t_all, int(1e9), 640, 480), 640, 480)
    ov_clip = ass.blit_bgra_premultiplied(
        ass.render_events(t_clip, int(1e9), 640, 480), 640, 480)
    assert (ov_all[..., 3] > 0).any(axis=0)[60:].any()   # text past x=60
    assert not (ov_clip[..., 3] > 0).any(axis=0)[60:].any()  # clipped
    assert (ov_clip[..., 3] > 0).any()                   # but not empty


def test_render_frz_rotates():
    head = SCRIPT.split("[Events]")[0]
    ev = ("Dialogue: 0,0:00:00.00,0:00:10.00,Default,,0,0,0,,"
          "{{\\pos(320,240){}}}IIIIIIII\n")
    fmt = ("[Events]\nFormat: Layer, Start, End, Style, Name, MarginL, "
           "MarginR, MarginV, Effect, Text\n")
    t0 = _track(head + fmt + ev.format(""))
    t90 = _track(head + fmt + ev.format("\\frz90"))
    ov0 = ass.blit_bgra_premultiplied(
        ass.render_events(t0, int(1e9), 640, 480), 640, 480)
    ov90 = ass.blit_bgra_premultiplied(
        ass.render_events(t90, int(1e9), 640, 480), 640, 480)
    ys0, xs0 = np.where(ov0[..., 3] > 0)
    ys9, xs9 = np.where(ov90[..., 3] > 0)
    # a wide flat run becomes tall and narrow under 90 degrees
    assert np.ptp(xs0) > 2.5 * np.ptp(ys0)
    assert np.ptp(ys9) > 2.5 * np.ptp(xs9)


def _pos_event_track(tags):
    head = SCRIPT.split("[Events]")[0]
    fmt = ("[Events]\nFormat: Layer, Start, End, Style, Name, MarginL, "
           "MarginR, MarginV, Effect, Text\n")
    ev = ("Dialogue: 0,0:00:00.00,0:00:10.00,Default,,0,0,0,,"
          "{\\pos(320,240)" + tags + "}IIIIIIII\n")
    return _track(head + fmt + ev)


def _alpha_extent(t, tm=int(1e9)):
    ov = ass.blit_bgra_premultiplied(
        ass.render_events(t, tm, 640, 480), 640, 480)
    ys, xs = np.where(ov[..., 3] > 0)
    return ys, xs


def test_render_frx_fry_foreshorten():
    """3D rotations: \\frx tilts about the screen x-axis (vertical
    extent shrinks ~cos), \\fry about y (horizontal shrinks)."""
    ys0, xs0 = _alpha_extent(_pos_event_track(""))
    ysx, xsx = _alpha_extent(_pos_event_track("\\frx75"))
    ysy, xsy = _alpha_extent(_pos_event_track("\\fry75"))
    assert np.ptp(ysx) < 0.6 * np.ptp(ys0)      # cos75 ~ 0.26 + rounding
    assert abs(np.ptp(xsx) - np.ptp(xs0)) <= max(4, 0.15 * np.ptp(xs0))
    assert np.ptp(xsy) < 0.6 * np.ptp(xs0)
    assert abs(np.ptp(ysy) - np.ptp(ys0)) <= max(4, 0.15 * np.ptp(ys0))


def test_render_fax_shears():
    """\\fax shears x by y: row centroids drift with height; the
    bounding box widens by ~|fax| * text height."""
    ys0, xs0 = _alpha_extent(_pos_event_track(""))
    ysf, xsf = _alpha_extent(_pos_event_track("\\fax1"))
    h0 = np.ptp(ys0)
    assert np.ptp(xsf) > np.ptp(xs0) + 0.6 * h0
    top_cx = xsf[ysf <= ysf.min() + 1].mean()
    bot_cx = xsf[ysf >= ysf.max() - 1].mean()
    assert abs(top_cx - bot_cx) > 0.5 * h0


def test_tag_t_animation_interpolates():
    """\\t lerps the animatable fields by ((t-t1)/(t2-t1))^accel."""
    style = ass.AssStyle()
    text = "{\\t(2000,4000,\\fscx300\\bord8)}x"

    def state_at(rel):
        lines, _ = ass.parse_dialogue_text(text, style, {}, rel_ms=rel,
                                           dur_ms=10000.0)
        return lines[0][0].state

    assert state_at(0.0).scale_x == 100.0       # before t1
    mid = state_at(3000.0)                      # k = 0.5
    assert abs(mid.scale_x - 200.0) < 1e-6
    assert abs(mid.border - 5.0) < 1e-6         # 2 -> 8 at k=0.5
    assert state_at(9000.0).scale_x == 300.0    # after t2
    # acceleration: k = 0.5^2 = 0.25
    text2 = "{\\t(2000,4000,2,\\fscx300)}x"
    lines, _ = ass.parse_dialogue_text(text2, style, {}, rel_ms=3000.0,
                                       dur_ms=10000.0)
    assert abs(lines[0][0].state.scale_x - 150.0) < 1e-6
    # colors lerp per channel: white -> red at k=0.5
    text3 = "{\\t(\\1c&H0000FF&)}x"
    lines, _ = ass.parse_dialogue_text(text3, style, {}, rel_ms=5000.0,
                                       dur_ms=10000.0)
    assert lines[0][0].state.primary == (255, 128, 128, 255)
    # without a clock (strip surface) \t is inert
    lines, _ = ass.parse_dialogue_text(text, style, {})
    assert lines[0][0].state.scale_x == 100.0


def test_tag_t_animates_rotation_render():
    """\\t(\\frz...) animates layout rotation: mid-event the glyph run
    is partly rotated, at the end fully vertical."""
    t = _pos_event_track("\\t(0,10000,\\frz90)")
    ys_mid, xs_mid = _alpha_extent(t, tm=int(5e9))
    ys_end, xs_end = _alpha_extent(t, tm=int(9.99e9))
    ys0, xs0 = _alpha_extent(_pos_event_track(""))
    assert np.ptp(ys_end) > 2.5 * np.ptp(xs_end)   # fully rotated
    assert np.ptp(xs0) > 2.5 * np.ptp(ys0)         # baseline flat
    # mid-rotation (45 deg): extents comparable
    assert 0.4 < np.ptp(ys_mid) / max(1, np.ptp(xs_mid)) < 2.5


def test_element_animates_within_event():
    """\\t reaches the ELEMENT level: animated events are sampled at
    animation-fps inside their active range, so the device overlay bank
    rotates the run across frames (the reference re-renders per frame;
    animation-fps=video rate gives frame-exact parity)."""
    script = SCRIPT.split("[Events]")[0] + (
        "[Events]\n"
        "Format: Layer, Start, End, Style, Name, MarginL, MarginR, "
        "MarginV, Effect, Text\n"
        "Dialogue: 0,0:00:00.00,0:00:04.00,Default,,0,0,0,,"
        "{\\pos(320,240)\\t(0,4000,\\frz90)}HELLOHELLO\n")

    def run(with_sub):
        p = gt.parse_launch(
            "videotestsrc pattern=black width=640 height=480 "
            "format=BGRx framerate=2/1 "
            "! assrender name=ar animation-fps=2 face=fixed ! fakesink")
        if with_sub:
            p.get_by_name("ar").push_script(script)
        outs = p.run(n_frames=8, window=4)
        return np.concatenate([np.asarray(o.data) for o in outs])

    base, sub = run(False), run(True)
    d = np.abs(sub[..., :3].astype(int)
               - base[..., :3].astype(int)).sum(-1) > 0
    ys0, xs0 = np.where(d[0])
    ys7, xs7 = np.where(d[7])
    assert np.ptp(xs0) > 2.0 * np.ptp(ys0)      # starts flat
    assert np.ptp(ys7) > 2.0 * np.ptp(xs7)      # ends vertical


def test_render_underline_layers_shadow():
    head = SCRIPT.split("[Events]")[0]
    t = _track(head + """[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
Dialogue: 1,0:00:00.00,0:00:10.00,Default,,0,0,0,,{\\u1\\shad3\\bord0}под
Dialogue: 0,0:00:00.00,0:00:10.00,Default,,0,0,0,,base
""")
    imgs = ass.render_events(t, int(1e9), 640, 480)
    assert imgs
    # layer 0 composites before layer 1 regardless of script order
    # (shadow image of the layer-1 event uses the back colour)
    backs = [im for im in imgs if (im["color"] >> 8) & 0xFFFFFF == 0]
    assert backs                   # shadow/outline images present


# -- pango face (r3): real-font glyph shaping --------------------------------

needs_pango = pytest.mark.skipif(not ass.pango_available(),
                                 reason="pango not present")


@needs_pango
def test_pango_span_shapes_real_glyphs():
    st = ass.SpanState(font_name="DejaVu Sans", font_size=40)
    cov, w = ass._pango_span(st, "Hello", 1.0, 1.0)
    assert cov.ndim == 2 and w == cov.shape[1]
    assert (cov > 0).any()
    # antialiased coverage, not a binary mask
    assert len(np.unique(cov)) > 2
    # bold is wider/denser than regular at the same size
    cov_b, w_b = ass._pango_span(
        ass.SpanState(font_name="DejaVu Sans", font_size=40, bold=True),
        "Hello", 1.0, 1.0)
    assert cov_b.astype(int).sum() > cov.astype(int).sum()
    # italic differs from regular
    cov_i, _ = ass._pango_span(
        ass.SpanState(font_name="DejaVu Sans", font_size=40,
                      italic=True), "Hello", 1.0, 1.0)
    assert cov_i.shape != cov.shape or (cov_i != cov).any()


@needs_pango
def test_pango_span_fscx_and_fsp():
    st = ass.SpanState(font_name="DejaVu Sans", font_size=30)
    cov, w = ass._pango_span(st, "abc", 1.0, 1.0)
    wide, w2 = ass._pango_span(
        ass.SpanState(font_name="DejaVu Sans", font_size=30,
                      scale_x=200.0), "abc", 1.0, 1.0)
    assert abs(w2 - 2 * w) <= 2
    spaced, w3 = ass._pango_span(
        ass.SpanState(font_name="DejaVu Sans", font_size=30,
                      spacing=6.0), "abc", 1.0, 1.0)
    assert w3 > w


@needs_pango
def test_fn_tag_changes_font():
    t = _track(SCRIPT.replace(
        "{\\b1}Top text{\\b0}",
        "{\\fnDejaVu Serif}serif{\\fn}sans"))
    lines, _ = ass.parse_dialogue_text(t.events[1].raw_text,
                                       t.styles["Top"], t.styles)
    spans = [s for line in lines for s in line]
    assert spans[0].state.font_name == "DejaVu Serif"
    assert spans[1].state.font_name == "Arial"     # \fn resets to style


@needs_pango
def test_render_events_pango_face():
    t = _track()
    imgs = ass.render_events(t, int(1.5e9), 640, 480, face="pango")
    assert imgs
    # fill + outline + shadow-free images present, coverage antialiased
    assert any(len(np.unique(im["bitmap"])) > 2 for im in imgs)
    over = ass.blit_bgra_premultiplied(imgs, 640, 480)
    assert (over[..., 3] > 0).any()


@needs_pango
def test_element_pango_face_default(tmp_path):
    el = gt.make("assrender")
    el.push_script(SCRIPT)
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="RGBx", width=640,
                          height=480,
                          framerate=fractions.Fraction(1, 1)))
    frames = np.zeros((2, 480, 640, 4), np.uint8)
    pts = np.asarray([int(1.5e9), int(2.5e9)], np.int64)
    outs = p.run(inputs=FrameBatch.make(jnp.asarray(frames),
                                        pts=jnp.asarray(pts)))
    out = np.asarray(outs[0].data)
    assert el._face == "pango"
    assert (out != frames).any()
    # fixed face still selectable and renders differently
    el2 = gt.make("assrender", face="fixed")
    el2.push_script(SCRIPT)
    p2 = Pipeline([el2])
    p2.negotiate(MediaSpec(kind="video", format="RGBx", width=640,
                           height=480,
                           framerate=fractions.Fraction(1, 1)))
    outs2 = p2.run(inputs=FrameBatch.make(jnp.asarray(frames),
                                          pts=jnp.asarray(pts)))
    out2 = np.asarray(outs2[0].data)
    assert el2._face == "fixed"
    assert (out2 != frames).any()
    assert (out != out2).any()


def test_render_kf_sweep_splits_fill():
    script = SCRIPT.split("[Events]")[0] + """[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
Dialogue: 0,0:00:00.00,0:00:10.00,Default,,0,0,0,,{\\kf400}sweep
"""
    t = _track(script)

    def fill_images(tm):
        return [im for im in ass.render_events(t, tm, 640, 480)
                if (im["color"] >> 8) & 0xFFFFFF in
                (0xFFFFFF, 0xFF0000)]

    # mid-syllable (t=2s of a 4s sweep): the span splits into a
    # primary (white) left part and secondary (red) right part at
    # adjacent x positions
    ims = fill_images(int(2e9))
    cols = {(im["color"] >> 8) & 0xFFFFFF for im in ims}
    assert cols == {0xFFFFFF, 0xFF0000}
    white = next(im for im in ims
                 if (im["color"] >> 8) & 0xFFFFFF == 0xFFFFFF)
    red = next(im for im in ims
               if (im["color"] >> 8) & 0xFFFFFF == 0xFF0000)
    assert red["dst_x"] == white["dst_x"] + white["bitmap"].shape[1]
    total_w = white["bitmap"].shape[1] + red["bitmap"].shape[1]
    # the cut tracks progress (~50% +- rounding)
    assert abs(white["bitmap"].shape[1] / total_w - 0.5) < 0.1
    # at the syllable start the cut is at 0: all secondary; after the
    # syllable: all primary
    assert {(im["color"] >> 8) & 0xFFFFFF
            for im in fill_images(0)} == {0xFF0000}
    assert {(im["color"] >> 8) & 0xFFFFFF
            for im in fill_images(int(5e9))} == {0xFFFFFF}


def test_render_big_k_is_sweep_alias():
    script = SCRIPT.split("[Events]")[0] + """[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
Dialogue: 0,0:00:00.00,0:00:10.00,Default,,0,0,0,,{\\K400}x
"""
    t = _track(script)
    ims = [im for im in ass.render_events(t, int(2e9), 640, 480)
           if (im["color"] >> 8) & 0xFFFFFF in (0xFFFFFF, 0xFF0000)]
    assert {(im["color"] >> 8) & 0xFFFFFF for im in ims} \
        == {0xFFFFFF, 0xFF0000}


def test_wrap_lines_modes_unit():
    st = ass.SpanState()
    meas = lambda _st, t: float(len(t))
    mk = lambda txt: [[ass.Span(txt, st)]]

    def widths(lines):
        return [sum(meas(s.state, s.text) for s in ln) for ln in lines]

    text = "aaaa bbbb cccc dddd"          # 19 cols
    # q2: never wraps
    assert widths(ass._wrap_lines(mk(text), 10, 2, meas)) == [19.0]
    # q1: greedy fill
    w1 = widths(ass._wrap_lines(mk(text), 10, 1, meas))
    assert w1 == [9.0, 9.0]
    # fits: untouched
    assert widths(ass._wrap_lines(mk(text), 30, 0, meas)) == [19.0]
    # symmetric tie: "aaa bb aaa" at avail 6 splits (6,3) or (3,6) with
    # equal slack — the mode bias decides: q0 upper wider, q3 lower
    w0 = widths(ass._wrap_lines(mk("aaa bb aaa"), 6, 0, meas))
    assert w0 == [6.0, 3.0]
    w3 = widths(ass._wrap_lines(mk("aaa bb aaa"), 6, 3, meas))
    assert w3 == [3.0, 6.0]
    # explicit \N structure preserved: two input lines stay two
    two = [[ass.Span("aa", st)], [ass.Span("bb", st)]]
    assert widths(ass._wrap_lines(two, 10, 0, meas)) == [2.0, 2.0]


def test_render_soft_wrap_and_q2():
    head = SCRIPT.split("[Events]")[0]
    long_text = "word " * 30
    t_wrap = _track(head + f"""[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
Dialogue: 0,0:00:00.00,0:00:10.00,Default,,0,0,0,,{long_text}
""")
    t_nowrap = _track(head + f"""[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
Dialogue: 0,0:00:00.00,0:00:10.00,Default,,0,0,0,,{{\\q2}}{long_text}
""")
    ims_w = ass.render_events(t_wrap, int(1e9), 640, 480)
    ims_n = ass.render_events(t_nowrap, int(1e9), 640, 480)
    # wrapped: every image stays inside the frame; unwrapped overflows
    assert max(im["dst_x"] + im["bitmap"].shape[1] for im in ims_w) \
        <= 660
    assert max(im["dst_x"] + im["bitmap"].shape[1] for im in ims_n) \
        > 660
    # wrapped output spans more vertical space (multiple lines)
    ys_w = {im["dst_y"] for im in ims_w}
    ys_n = {im["dst_y"] for im in ims_n}
    assert len(ys_w) > len(ys_n)


def test_wrapstyle_script_info():
    head = SCRIPT.split("[Events]")[0].replace(
        "[Script Info]", "[Script Info]\nWrapStyle: 2")
    t = _track(head + """[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
Dialogue: 0,0:00:00.00,0:00:10.00,Default,,0,0,0,,""" +
               "word " * 30 + "\n")
    assert t.wrap_style == 2
    ims = ass.render_events(t, int(1e9), 640, 480)
    assert max(im["dst_x"] + im["bitmap"].shape[1] for im in ims) > 660


# -- \p drawings and vector clips -------------------------------------------

def test_drawing_square_renders_at_size():
    head = SCRIPT.split("[Events]")[0]
    t = _track(head + """[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
Dialogue: 0,0:00:00.00,0:00:10.00,Default,,0,0,0,,{\\an7\\pos(50,40)\\bord0\\p1}m 0 0 l 100 0 100 100 0 100{\\p0}
""")
    ov = ass.blit_bgra_premultiplied(
        ass.render_events(t, int(1e9), 640, 480), 640, 480)
    ys, xs = np.where(ov[..., 3] > 128)
    assert (xs.min(), xs.max() + 1) == (50, 150)
    assert ys.max() - ys.min() + 1 == 100
    # \p2 halves the coordinates
    t2 = _track(head + """[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
Dialogue: 0,0:00:00.00,0:00:10.00,Default,,0,0,0,,{\\an7\\pos(50,40)\\bord0\\p2}m 0 0 l 100 0 100 100 0 100{\\p0}
""")
    ov2 = ass.blit_bgra_premultiplied(
        ass.render_events(t2, int(1e9), 640, 480), 640, 480)
    xs2 = np.where(ov2[..., 3] > 128)[1]
    assert xs2.max() - xs2.min() + 1 == 50


def test_drawing_nonzero_winding_hole_and_bezier():
    paths = ass._parse_drawing(
        "m 0 0 l 100 0 100 100 0 100 m 30 30 l 30 70 70 70 70 30", 1)
    cov, _, _ = ass._fill_polygons(paths, 1.0, 1.0)
    assert cov[50, 50] == 0 and cov[10, 10] == 255     # donut
    circ = ass._parse_drawing(
        "m 50 0 b 78 0 100 22 100 50 b 100 78 78 100 50 100 "
        "b 22 100 0 78 0 50 b 0 22 22 0 50 0", 1)
    cov2, _, _ = ass._fill_polygons(circ, 1.0, 1.0)
    area = (cov2.astype(float) / 255).sum()
    assert abs(area - np.pi * 50 * 50) / (np.pi * 2500) < 0.02
    spl = ass._parse_drawing("m 0 0 s 100 0 100 100 0 100 c", 1)
    cov3, _, _ = ass._fill_polygons(spl, 1.0, 1.0)
    assert (cov3 > 0).sum() > 100


def test_drawing_commands_not_rendered_as_text():
    head = SCRIPT.split("[Events]")[0]
    t = _track(head + """[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
Dialogue: 0,0:00:00.00,0:00:10.00,Default,,0,0,0,,{\\an7\\pos(0,0)\\bord0\\p1}m 0 0 l 40 0 40 40 0 40{\\p0}
""")
    ov = ass.blit_bgra_premultiplied(
        ass.render_events(t, int(1e9), 640, 480), 640, 480)
    ys, xs = np.where(ov[..., 3] > 128)
    # a filled 40x40 square, not a long run of glyphs
    assert xs.max() < 60
    filled = (ov[..., 3] > 128).sum()
    assert filled > 0.9 * 40 * 40


def test_vector_clip_and_iclip():
    head = SCRIPT.split("[Events]")[0]
    body = """[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
Dialogue: 0,0:00:00.00,0:00:10.00,Default,,0,0,0,,{\\an7\\pos(0,0)%s}wide wide text
"""
    clip = "\\clip(m 0 0 l 40 0 40 480 0 480)"
    t_c = _track(head + body % clip)
    t_i = _track(head + body % clip.replace("clip", "iclip"))
    t_n = _track(head + body % "")
    ov_c = ass.blit_bgra_premultiplied(
        ass.render_events(t_c, int(1e9), 640, 480), 640, 480)
    ov_i = ass.blit_bgra_premultiplied(
        ass.render_events(t_i, int(1e9), 640, 480), 640, 480)
    ov_n = ass.blit_bgra_premultiplied(
        ass.render_events(t_n, int(1e9), 640, 480), 640, 480)
    assert (ov_n[..., 3] > 0).any(axis=0)[60:].any()
    assert not (ov_c[..., 3] > 0).any(axis=0)[60:].any()   # clipped
    assert (ov_c[..., 3] > 0).any()
    # iclip keeps only what's OUTSIDE the drawing
    assert not (ov_i[..., 3] > 0).any(axis=0)[:38].any()
    assert (ov_i[..., 3] > 0).any(axis=0)[60:].any()
    # scaled form: \clip(2, drawing) halves coordinates
    clip2 = "\\clip(2, m 0 0 l 160 0 160 960 0 960)"
    t_s = _track(head + body % clip2)
    ov_s = ass.blit_bgra_premultiplied(
        ass.render_events(t_s, int(1e9), 640, 480), 640, 480)
    cols = (ov_s[..., 3] > 0).any(axis=0)
    assert cols[:78].any() and not cols[90:].any()


def test_assrender_element_draws_vector_shape():
    W, H = 320, 240
    el = gt.make("assrender")
    el.push_script(SCRIPT.split("[Events]")[0] + """[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
Dialogue: 0,0:00:00.00,0:00:10.00,Default,,0,0,0,,{\\an7\\pos(20,20)\\bord0\\p1}m 0 0 l 80 0 80 80 0 80{\\p0}
""")
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="BGRx", width=W, height=H,
                          framerate=fractions.Fraction(2)))
    img = np.zeros((1, H, W, 4), np.uint8)
    out = np.asarray(p.run(inputs=FrameBatch.make(
        jnp.asarray(img), pts=jnp.asarray([int(1e9)], jnp.int64)))[0].data)
    diff = (out[0] != img[0]).any(axis=-1)
    ys, xs = np.where(diff)
    # PlayRes 640x480 -> frame 320x240 halves pos(20,20) to (10,10)
    # and the 80-unit square to 40 px
    assert 8 <= xs.min() <= 12 and 36 <= xs.max() - xs.min() <= 44
    assert 36 <= ys.max() - ys.min() <= 44


def test_render_soft_wrap_pango_face():
    if not ass.pango_available():
        pytest.skip("no pango")
    head = SCRIPT.split("[Events]")[0]
    long_text = "word " * 30
    t = _track(head + f"""[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
Dialogue: 0,0:00:00.00,0:00:10.00,Default,,0,0,0,,{long_text}
""")
    ims = ass.render_events(t, int(1e9), 640, 480, face="pango")
    assert max(im["dst_x"] + im["bitmap"].shape[1] for im in ims) <= 660
    assert len({im["dst_y"] for im in ims}) > 1      # wrapped lines
