"""webpdec / webpenc (ext/webp) over the real libwebp binding."""

import numpy as np
import jax.numpy as jnp
import pytest

import gstbad as gt
from gstbad.core.pipeline import Pipeline, parse_launch
from gstbad.io import webp

pytestmark = pytest.mark.skipif(not webp.available(),
                                reason="libwebp not present")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _gradient_rgba(h=48, w=64):
    img = np.zeros((h, w, 4), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    img[..., 0] = (xx * 4) % 256
    img[..., 1] = (yy * 5) % 256
    img[..., 2] = ((xx + yy) * 3) % 256
    img[..., 3] = 255
    return img


def test_binding_lossless_roundtrip_exact(rng):
    img = rng.integers(0, 256, (32, 40, 4), np.uint8)
    img[..., 3] = np.maximum(img[..., 3], 1)   # see element test note
    data = webp.encode(img, lossless=True)
    assert data[:4] == b"RIFF" and data[8:12] == b"WEBP"
    out = webp.decode(data, webp.MODE_RGBA)
    assert np.array_equal(out, img)
    # RGB path
    rgb = np.ascontiguousarray(img[..., :3])
    out3 = webp.decode(webp.encode(rgb, lossless=True), webp.MODE_RGB)
    assert np.array_equal(out3, rgb)


def test_binding_features_and_options():
    img = _gradient_rgba()
    lossy = webp.encode(img, quality=75)
    w, h, alpha = webp.features(lossy)
    assert (w, h) == (64, 48) and not alpha   # opaque alpha drops
    # translucent pixels keep the alpha channel
    img2 = img.copy()
    img2[..., 3] = 128
    _w, _h, alpha2 = webp.features(webp.encode(img2, quality=75))
    assert alpha2
    # decoder options change the upsampling result (real effect)
    a = webp.decode(lossy, webp.MODE_RGB)
    b = webp.decode(lossy, webp.MODE_RGB, no_fancy_upsampling=True)
    assert not np.array_equal(a, b)
    assert webp.features(b"not a webp stream") is None


def test_webpenc_element_posts_images():
    pipe = parse_launch(
        "videotestsrc pattern=gradient width=64 height=48 format=RGBA "
        "! webpenc lossless=true ! fakesink")
    pipe.negotiate()
    pipe.run(n_frames=3)
    msgs = pipe.bus.pop(name="webp-image")
    assert len(msgs) == 3
    enc = pipe.elements[1]
    assert len(enc.packets) == 3
    for _pts, data in enc.packets:
        assert data[:4] == b"RIFF" and data[8:12] == b"WEBP"


def test_webpenc_i420_path():
    pipe = parse_launch(
        "videotestsrc pattern=bars width=64 height=48 format=I420 "
        "! webpenc quality=80 ! fakesink")
    pipe.negotiate()
    pipe.run(n_frames=2)
    enc = pipe.elements[1]
    assert len(enc.packets) == 2
    w, h, _ = webp.features(enc.packets[0][1])
    assert (w, h) == (64, 48)


def test_webpdec_element_roundtrip_lossless(rng):
    # alpha stays >= 1: libwebp's default config.exact=0 (the
    # reference leaves it too) may alter RGB under fully transparent
    # pixels even in lossless mode
    frames = []
    for _ in range(3):
        f = rng.integers(0, 256, (24, 32, 4), np.uint8)
        f[..., 3] = np.maximum(f[..., 3], 1)
        frames.append(f)
    el = gt.make("webpdec")
    for f in frames:
        el.push_packet(webp.encode(f, lossless=True))
    pipe = Pipeline([el])
    pipe.negotiate(None)
    assert el.out_spec.format == "ARGB"
    outs = pipe.run(n_frames=3)
    got = np.concatenate([np.asarray(o.data) for o in outs])[:3]
    for i, f in enumerate(frames):
        argb = np.concatenate([f[..., 3:4], f[..., :3]], axis=-1)
        assert np.array_equal(got[i], argb), i


def test_webpdec_rgb_when_no_alpha():
    img = _gradient_rgba()[..., :3]
    el = gt.make("webpdec")
    el.push_packet(webp.encode(img, lossless=True))
    pipe = Pipeline([el])
    pipe.negotiate(None)
    assert el.out_spec.format == "RGB"
    outs = pipe.run(n_frames=1)
    got = np.concatenate([np.asarray(o.data) for o in outs])[0]
    assert np.array_equal(got, img)


def test_webp_transcode_chain(rng):
    """webpdec -> videoconvert -> filters: the decoder feeds a real
    graph."""
    img = _gradient_rgba(32, 48)
    el = gt.make("webpdec")
    el.push_packet(webp.encode(img, lossless=True))
    pipe = Pipeline([el, gt.make("videoconvert", format="BGRx"),
                     gt.make("solarize"), gt.make("fakesink")])
    pipe.negotiate(None)
    outs = pipe.run(n_frames=1)
    assert np.concatenate(
        [np.asarray(o.data) for o in outs]).shape == (1, 32, 48, 4)
