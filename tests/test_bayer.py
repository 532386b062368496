"""Fidelity: bayer2rgb / rgb2bayer vs golden (bit-exact)."""

import numpy as np
import pytest

import gstbad as gt
from gstbad.core.harness import Harness
from gstbad.core.spec import MediaSpec, VideoFormat
from gstbad.golden import bayer as golden

H, W = 16, 24


@pytest.mark.parametrize("fmt", ["bggr", "gbrg", "grbg", "rggb"])
@pytest.mark.parametrize("out_fmt", ["RGBA", "BGRA", "ARGB", "ABGR"])
def test_bayer2rgb(rng, fmt, out_fmt):
    raw = rng.integers(0, 256, (H, W), dtype=np.uint8)
    h = Harness("bayer2rgb", format=out_fmt)
    h.set_src_spec(MediaSpec(kind="bayer", format=fmt, width=W, height=H))
    got = h.push_pull(raw[None])[0]
    want = golden.bayer2rgb(raw, fmt, out_fmt)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", ["bggr", "gbrg", "grbg", "rggb"])
def test_rgb2bayer(rng, fmt):
    img = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    h = Harness("rgb2bayer", format=fmt)
    h.set_src_spec(MediaSpec(kind="video", format=VideoFormat.ARGB,
                             width=W, height=H))
    got = h.push_pull(img[None])[0]
    np.testing.assert_array_equal(got, golden.rgb2bayer(img, fmt))


def test_roundtrip_pipeline():
    """rgb2bayer ! bayer2rgb on a smooth gradient stays close to the
    original (demosaic interpolation error only)."""
    p = gt.parse_launch(
        "videotestsrc pattern=gradient width=32 height=16 format=ARGB "
        "! rgb2bayer ! bayer2rgb format=ARGB ! fakesink")
    spec = p.negotiate()
    assert spec.format == "ARGB"
    outs = p.run(n_frames=1, window=1)
    out = outs[0].data[0]
    # gradient: interior reconstruction error small
    src = np.asarray(p.elements[0]._bg_rgb)
    got_rgb = out[2:-2, 2:-2, 1:4].astype(int)
    want_rgb = np.stack([src[..., 0], src[..., 1], src[..., 2]], -1)[
        2:-2, 2:-2].astype(int)
    assert np.abs(got_rgb - want_rgb).mean() < 8
