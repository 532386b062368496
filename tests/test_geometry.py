"""Fidelity: the 16 geometric warps vs golden maps + remap (bit-exact,
since the maps are built by the same float64 host code and sampling is an
integer gather)."""

import numpy as np
import pytest

from gstbad.core.harness import Harness
from gstbad.core.spec import MediaSpec, VideoFormat
from gstbad.golden import geometric as golden

W, H = 40, 30

SIMPLE = ["fisheye", "twirl", "perspective", "rotate", "bulge", "pinch",
          "sphere", "kaleidoscope", "circle", "waterripple", "stretch",
          "tunnel", "square", "mirror"]


def _img(rng):
    return rng.integers(0, 256, (H, W, 4), dtype=np.uint8)


def _run(name, img, fmt=VideoFormat.BGRx, **props):
    h = Harness(name, **props)
    h.set_src_spec(MediaSpec(kind="video", format=fmt, width=W, height=H))
    return h.push_pull(img[None])[0]


@pytest.mark.parametrize("name", SIMPLE)
def test_warp_defaults(rng, name):
    img = _img(rng)
    got = _run(name, img)
    mp = golden.MAP_BUILDERS[name](W, H)
    want = golden.remap(img, mp, "ignore")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("off_edge", ["ignore", "clamp", "wrap"])
def test_off_edge_modes(rng, off_edge):
    img = _img(rng)
    got = _run("rotate", img, angle=0.7, **{"off-edge-pixels": off_edge})
    want = golden.remap(img, golden.rotate_map(W, H, 0.7), off_edge)
    np.testing.assert_array_equal(got, want)


def test_ayuv_background(rng):
    img = _img(rng)
    got = _run("rotate", img, fmt=VideoFormat.AYUV, angle=1.0)
    want = golden.remap(img, golden.rotate_map(W, H, 1.0), "ignore",
                        is_ayuv=True)
    np.testing.assert_array_equal(got, want)


def test_perspective_matrix(rng):
    img = _img(rng)
    mat = [1.1, 0.1, -2.0, 0.0, 0.9, 1.0, 0.0001, 0.0, 1.0]
    got = _run("perspective", img, matrix=",".join(map(str, mat)))
    want = golden.remap(img, golden.perspective_map(W, H, mat), "ignore")
    np.testing.assert_array_equal(got, want)


def test_perspective_identity_is_passthrough(rng):
    img = _img(rng)
    got = _run("perspective", img)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("mode", ["left", "right", "top", "bottom"])
def test_mirror_modes(rng, mode):
    img = _img(rng)
    got = _run("mirror", img, mode=mode)
    want = golden.remap(img, golden.mirror_map(W, H, mode), "ignore")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["diffuse", "marble"])
def test_random_warps(rng, name):
    """diffuse/marble draw from a seeded RNG; element and golden must agree
    when seeded identically."""
    img = _img(rng)
    got = _run(name, img, seed=7)
    rng2 = np.random.default_rng(7)
    mp = golden.MAP_BUILDERS[name](W, H, rng=rng2)
    want = golden.remap(img, mp, "ignore")
    np.testing.assert_array_equal(got, want)
