"""Fidelity: coloreffects presets + chromahold vs golden (bit-exact)."""

import numpy as np
import pytest

from gstbad.core.harness import Harness
from gstbad.core.spec import MediaSpec, VideoFormat
from gstbad.golden import coloreffects as golden


def _img(rng, h=21, w=37):
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    img[0, 0] = 0
    img[0, 1] = 255
    return img


def _run(name, img, fmt, **props):
    h = Harness(name, **props)
    h.set_src_spec(MediaSpec(kind="video", format=fmt,
                             width=img.shape[1], height=img.shape[0]))
    return h.push_pull(img[None])[0]


@pytest.mark.parametrize("preset", ["heat", "sepia", "xray", "xpro",
                                    "yellowblue"])
@pytest.mark.parametrize("fmt", [VideoFormat.BGRx, VideoFormat.RGBA,
                                 VideoFormat.ARGB])
def test_coloreffects_rgb(rng, preset, fmt):
    img = _img(rng)
    got = _run("coloreffects", img, fmt, preset=preset)
    want = golden.coloreffects_rgb(img, preset,
                                   VideoFormat.rgb_offsets(fmt)[:3])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("preset", ["heat", "sepia", "xpro"])
def test_coloreffects_ayuv(rng, preset):
    img = _img(rng)
    got = _run("coloreffects", img, VideoFormat.AYUV, preset=preset)
    np.testing.assert_array_equal(got, golden.coloreffects_ayuv(img, preset))


def test_coloreffects_none_passthrough(rng):
    img = _img(rng)
    got = _run("coloreffects", img, VideoFormat.BGRx, preset="none")
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("target,tol", [
    ((255, 0, 0), 30), ((0, 255, 0), 10), ((10, 10, 10), 30),
    ((128, 128, 128), 50), ((255, 0, 0), 180)])
def test_chromahold(rng, target, tol):
    img = _img(rng)
    # add achromatic and near-target pixels
    img[1, 0] = [100, 100, 100, 7]
    img[1, 1] = [0, 0, 255, 9]  # BGRx red
    got = _run("chromahold", img, VideoFormat.BGRx,
               **{"target-r": target[0], "target-g": target[1],
                  "target-b": target[2], "tolerance": tol})
    want = golden.chromahold(img, *target, tol,
                             VideoFormat.rgb_offsets(VideoFormat.BGRx)[:3])
    np.testing.assert_array_equal(got, want)
