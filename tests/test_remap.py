"""The warp elements' one path: the XLA flat-gather remap (ops/remap.py)
vs the golden C transcription (golden/geometric.remap)."""

import numpy as np
import jax.numpy as jnp
import pytest

from gstbad.golden import geometric as golden
from gstbad.ops.remap import fix_map, remap

H, W = 64, 256


def _remap(img, mp, w, h, off_edge="ignore"):
    flat, valid = fix_map(mp, w, h, off_edge)
    return np.asarray(remap(jnp.asarray(img), jnp.asarray(flat),
                            jnp.asarray(valid), jnp.zeros(4, jnp.uint8)))


def _golden(img, mp, off_edge="ignore"):
    return np.stack([golden.remap(f, mp, off_edge) for f in img])


@pytest.mark.parametrize("name", ["fisheye", "twirl", "rotate", "mirror"])
def test_remap_matches_golden(rng, name):
    kwargs = {"angle": 0.4} if name == "rotate" else {}
    mp = golden.MAP_BUILDERS[name](W, H, **kwargs)
    img = rng.integers(0, 256, (2, H, W, 4), dtype=np.uint8)
    np.testing.assert_array_equal(_remap(img, mp, W, H), _golden(img, mp))


def test_remap_wild_map(rng):
    """A random map reads from anywhere in the frame: one gather still
    serves it, including the off-frame (background) pixels."""
    h2, w2 = 64, 128
    mp = np.stack([rng.random((h2, w2)) * w2 * 1.2 - 0.1 * w2,
                   rng.random((h2, w2)) * h2 * 1.2 - 0.1 * h2], -1)
    img = rng.integers(0, 256, (2, h2, w2, 4), dtype=np.uint8)
    np.testing.assert_array_equal(_remap(img, mp, w2, h2),
                                  _golden(img, mp))


def test_fisheye_element_matches_golden(rng):
    """The element path (Pipeline.run over fisheye) == golden remap."""
    import gstbad as gt
    from gstbad.core.frame import FrameBatch
    from gstbad.core.pipeline import Pipeline
    from gstbad.core.spec import MediaSpec

    img = rng.integers(0, 256, (2, H, W, 4), dtype=np.uint8)
    p = Pipeline([gt.make("fisheye")])
    p.negotiate(MediaSpec(kind="video", format="RGBA", width=W, height=H))
    res = p.run(inputs=FrameBatch.make(jnp.asarray(img)))
    np.testing.assert_array_equal(
        np.asarray(res[0].data),
        _golden(img, golden.fisheye_map(W, H)))


def test_remap_magnifying_patch(rng):
    """A violently magnifying patch (rows spread across the whole
    frame) stays exact."""
    h2, w2 = 256, 512
    mp = golden.MAP_BUILDERS["rotate"](w2, h2, angle=0.1).copy()
    mp[:8, :128, 0] = np.arange(128)[None, :].astype(np.float64)
    mp[:8, :128, 1] = (np.arange(8 * 128).reshape(8, 128) * 7.9) % h2
    img = rng.integers(0, 256, (2, h2, w2, 4), dtype=np.uint8)
    np.testing.assert_array_equal(_remap(img, mp, w2, h2),
                                  _golden(img, mp))


def test_remap_near_quarter_turn(rng):
    """A near-90-degree rotation (source rows become columns)."""
    h2, w2 = 256, 512
    mp = golden.MAP_BUILDERS["rotate"](w2, h2, angle=1.45)
    img = rng.integers(0, 256, (2, h2, w2, 4), dtype=np.uint8)
    np.testing.assert_array_equal(_remap(img, mp, w2, h2),
                                  _golden(img, mp))


@pytest.mark.parametrize("off_edge", ["ignore", "clamp", "wrap"])
def test_remap_heavy_twirl(rng, off_edge):
    """A hard twirl (the config-4 shape) under each off-edge policy."""
    h2, w2 = 256, 512
    mp = golden.MAP_BUILDERS["twirl"](w2, h2, angle=2 * np.pi)
    img = rng.integers(0, 256, (1, h2, w2, 4), dtype=np.uint8)
    np.testing.assert_array_equal(_remap(img, mp, w2, h2, off_edge),
                                  _golden(img, mp, off_edge))


def test_jaxfilter_element(rng):
    import gstbad as gt
    from gstbad.core.pipeline import Pipeline
    from gstbad.core.spec import MediaSpec
    el = gt.make("jaxfilter", fn=lambda x: 255 - x)
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="GRAY8", width=16, height=16))
    from gstbad.core.frame import FrameBatch
    img = rng.integers(0, 256, (2, 16, 16), dtype=np.uint8)
    outs = p.run(inputs=FrameBatch.make(jnp.asarray(img)))
    np.testing.assert_array_equal(np.asarray(outs[0].data), 255 - img)
