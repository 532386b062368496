"""rsvgoverlay / rsvgdec (ext/rsvg/) over the real librsvg: the device
OVER composite is byte-exact vs cairo rendering directly onto the frame
(the reference's own path), offsets/dimensions follow the
gstrsvgoverlay.c applied-value walk, and rsvgdec splits documents at
</svg> like the reference's parse()."""

import numpy as np
import pytest

import gstbad as gt
from gstbad.core.harness import Harness
from gstbad.core.pipeline import Pipeline
from gstbad.core.spec import MediaSpec
from gstbad.io import rsvg as iorsvg

pytestmark = pytest.mark.skipif(not iorsvg.available(),
                                reason="librsvg/cairo not present")

SVG = '''<svg xmlns="http://www.w3.org/2000/svg" width="24" height="16">
  <rect x="2" y="2" width="10" height="8" fill="#20ff80"
        fill-opacity="0.6"/>
  <circle cx="18" cy="10" r="4" fill="#ff4020"/>
</svg>'''

OVERLAPPING = '''<svg xmlns="http://www.w3.org/2000/svg" width="24"
  height="16">
  <rect x="2" y="2" width="14" height="10" fill="blue"
        fill-opacity="0.5"/>
  <rect x="8" y="4" width="14" height="10" fill="red"
        fill-opacity="0.5"/>
</svg>'''


def _spec(w=48, h=32, fmt="BGRA"):
    return MediaSpec(kind="video", format=fmt, width=w, height=h)


def _frames(n=2, w=48, h=32, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, h, w, 4), np.uint8)


def _cairo_over(frames, svg_text, **kw):
    svg = iorsvg.Svg(svg_text.encode())
    h, w = frames.shape[1:3]
    return np.stack([svg.render(w, h, onto=f, **kw) for f in frames])


def test_overlay_byte_exact_vs_cairo():
    frames = _frames()
    h = Harness("rsvgoverlay", data=SVG)
    h.set_src_spec(_spec())
    out = h.push_pull(frames)
    np.testing.assert_array_equal(out, _cairo_over(frames, SVG))


def test_overlay_overlapping_translucency_within_1lsb():
    """OVER is associative in exact math but not in u8: where
    semi-transparent shapes overlap, the flattened-overlay composite is
    <=1 LSB from cairo's per-draw-op compositing (documented)."""
    frames = _frames(seed=5)
    h = Harness("rsvgoverlay", data=OVERLAPPING)
    h.set_src_spec(_spec())
    out = h.push_pull(frames)
    want = _cairo_over(frames, OVERLAPPING)
    diff = np.abs(out.astype(int) - want.astype(int))
    assert diff.max() <= 1


def _assert_1lsb(out, want):
    """Byte-equal except isolated antialiased-edge pixels, where
    pixman's fused src-IN-mask-OVER-dst rounds <=1 LSB differently
    than flatten-then-OVER (documented divergence)."""
    diff = np.abs(out.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01


def test_overlay_offsets_absolute_and_relative():
    frames = _frames(n=1)
    h = Harness("rsvgoverlay", data=SVG, x=10, y=6)
    h.set_src_spec(_spec())
    out = h.push_pull(frames)
    np.testing.assert_array_equal(
        out, _cairo_over(frames, SVG, tx=10, ty=6))
    # relative offsets apply only while absolute are 0
    # (gstrsvgoverlay.c:391-397)
    h2 = Harness("rsvgoverlay", data=SVG,
                 **{"x-relative": 0.25, "y-relative": 0.5})
    h2.set_src_spec(_spec())
    out2 = h2.push_pull(frames)
    _assert_1lsb(out2, _cairo_over(frames, SVG, tx=0.25 * 48,
                                   ty=0.5 * 32))


def test_overlay_dimension_scaling():
    frames = _frames(n=1)
    # absolute width, natural height kept (gstrsvgoverlay.c:411-424)
    h = Harness("rsvgoverlay", data=SVG, width=48)
    h.set_src_spec(_spec())
    out = h.push_pull(frames)
    _assert_1lsb(out, _cairo_over(frames, SVG, sx=48 / 24, sy=1.0))
    # fit-to-frame = width/height-relative 1.0 shorthand
    h2 = Harness("rsvgoverlay", data=SVG, **{"fit-to-frame": True})
    h2.set_src_spec(_spec())
    out2 = h2.push_pull(frames)
    np.testing.assert_array_equal(
        out2, _cairo_over(frames, SVG, sx=2.0, sy=2.0))


def test_overlay_formats_permuted():
    frames = _frames(n=1)
    base = Harness("rsvgoverlay", data=SVG)
    base.set_src_spec(_spec())
    want_bgra = base.push_pull(frames)
    # RGBA frame with the same logical pixel values
    rgba = frames[..., [2, 1, 0, 3]]
    h = Harness("rsvgoverlay", data=SVG)
    h.set_src_spec(_spec(fmt="RGBA"))
    out = h.push_pull(rgba)
    np.testing.assert_array_equal(out, want_bgra[..., [2, 1, 0, 3]])


def test_overlay_no_svg_is_passthrough():
    frames = _frames(n=1)
    h = Harness("rsvgoverlay")
    h.set_src_spec(_spec())
    np.testing.assert_array_equal(h.push_pull(frames), frames)


def test_overlay_data_pad_feed():
    frames = _frames(n=1)
    el = gt.make("rsvgoverlay")
    el.push_data(SVG.encode()[:30])
    el.push_data(SVG.encode()[30:])
    p = Pipeline([el])
    p.negotiate(_spec())
    import jax.numpy as jnp
    from gstbad.core.frame import FrameBatch
    outs = p.run(inputs=FrameBatch.make(jnp.asarray(frames)))
    np.testing.assert_array_equal(np.asarray(outs[0].data),
                                  _cairo_over(frames, SVG))


def test_rsvgdec_natural_size_and_split():
    el = gt.make("rsvgdec")
    el.push_data((SVG + SVG).encode())   # two docs, one byte stream
    p = Pipeline([el])
    p.negotiate(None)
    outs = p.run(window=2)
    out = np.asarray(outs[0].data)
    assert out.shape == (2, 16, 24, 4)
    assert el.out_spec.format == "BGRA"
    svg = iorsvg.Svg(SVG.encode())
    want = svg.render(24, 16)
    np.testing.assert_array_equal(out[0], want)
    np.testing.assert_array_equal(out[1], want)


def test_rsvgdec_later_docs_scale_to_first():
    small = SVG.replace('width="24" height="16"',
                        'width="12" height="8"')
    el = gt.make("rsvgdec")
    el.push_packet(SVG.encode())
    el.push_packet(small.encode())
    p = Pipeline([el])
    p.negotiate(None)
    outs = p.run(window=2)
    out = np.asarray(outs[0].data)
    assert out.shape == (2, 16, 24, 4)
    svg2 = iorsvg.Svg(small.encode())
    np.testing.assert_array_equal(out[1],
                                  svg2.render(24, 16, sx=2.0, sy=2.0))


def test_faceoverlay_svg_location(tmp_path):
    """faceoverlay renders SVG overlay files through librsvg."""
    d = np.load("gstbad/data/face_fixture.npz")
    g = d["frame"]
    img = np.repeat(g[..., None], 3, -1)
    rgba = np.concatenate([img, np.full(g.shape + (1,), 255, np.uint8)],
                          -1)[None]
    loc = tmp_path / "ov.svg"
    loc.write_text('<svg xmlns="http://www.w3.org/2000/svg" width="8" '
                   'height="8"><rect width="8" height="8" '
                   'fill="lime"/></svg>')
    h = Harness("faceoverlay", location=str(loc), detector="haar",
                profile="/usr/share/opencv4/haarcascades/"
                        "haarcascade_frontalface_alt2.xml",
                **{"scale-factor": 1.1})
    h.set_src_spec(MediaSpec(kind="video", format="RGBA",
                             width=img.shape[1], height=img.shape[0]))
    out = h.push_pull(rgba)
    assert h.bus.pop(name="face")
    assert (out != rgba).any()
    # lime pixels landed
    lime = (out[..., 1] == 255) & (out[..., 0] == 0)
    assert lime.any()
