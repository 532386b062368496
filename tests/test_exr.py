"""openexrdec (ext/openexr) over the real OpenEXRCore binding.

The from-spec numpy EXR writer (io/exr.write_exr) and the library
decoder (native/exrdec.c over libOpenEXRCore-3_1) cross-validate each
other: every file the writer emits must decode bit-exact through the
system OpenEXR."""

import numpy as np
import pytest

import gstbad as gt
from gstbad.core.pipeline import Pipeline
from gstbad.io import exr
from gstbad.io.typefind import find_type

pytestmark = pytest.mark.skipif(not exr.available(),
                                reason="OpenEXRCore not available")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _expect_rgba(planes):
    def chan(c, default):
        if c in planes:
            return planes[c].astype(np.float16).astype(np.float32)
        some = next(iter(planes.values()))
        return np.full(some.shape, default, np.float32)
    return np.stack([chan(c, 1.0 if c == "A" else 0.0)
                     for c in "RGBA"], -1)


@pytest.mark.parametrize("comp", [exr.COMPRESSION_NONE,
                                  exr.COMPRESSION_ZIPS,
                                  exr.COMPRESSION_ZIP])
def test_writer_decoder_roundtrip(rng, comp):
    h, w = 13, 21
    planes = {c: rng.random((h, w)).astype(np.float32) for c in "RGBA"}
    rgba, par = exr.decode_exr(exr.write_exr(None, planes,
                                             compression=comp))
    assert par == 1.0
    np.testing.assert_array_equal(rgba, _expect_rgba(planes))


def test_float_pixels(rng):
    planes = {c: rng.random((7, 9)).astype(np.float32) for c in "RGB"}
    rgba, _ = exr.decode_exr(
        exr.write_exr(None, planes, pixel_type=exr.PIXEL_FLOAT))
    np.testing.assert_array_equal(
        rgba[..., :3], np.stack([planes[c] for c in "RGB"], -1))


def test_missing_channels_fill(rng):
    """RgbaInputFile semantics: missing RGB read 0, missing A reads 1."""
    planes = {"R": rng.random((5, 6)).astype(np.float32)}
    rgba, _ = exr.decode_exr(exr.write_exr(None, planes))
    assert np.all(rgba[..., 1] == 0) and np.all(rgba[..., 2] == 0)
    assert np.all(rgba[..., 3] == 1.0)


def test_luma_replicates(rng):
    y = rng.random((5, 6)).astype(np.float32)
    rgba, _ = exr.decode_exr(exr.write_exr(None, {"Y": y}))
    np.testing.assert_array_equal(rgba[..., 0],
                                  y.astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(rgba[..., 0], rgba[..., 1])
    np.testing.assert_array_equal(rgba[..., 0], rgba[..., 2])


def test_tiled_roundtrip(rng):
    h, w = 37, 53  # partial edge tiles
    planes = {c: rng.random((h, w)).astype(np.float32) for c in "RGBA"}
    for comp in (exr.COMPRESSION_NONE, exr.COMPRESSION_ZIP):
        blob = exr.write_exr(None, planes, compression=comp,
                             tile_size=16)
        rgba, _ = exr.decode_exr(blob)
        np.testing.assert_array_equal(rgba, _expect_rgba(planes))


def test_pixel_aspect_ratio(rng):
    blob = exr.write_exr(None, {"R": rng.random((4, 4))},
                         pixel_aspect=1.5)
    _, par = exr.decode_exr(blob)
    assert par == pytest.approx(1.5)


def test_to_argb64_reference_quirk():
    """CLAMP(v * 65536, 0, 65535) — 65536, not 65535
    (gstopenexrdec.cpp:434-437): 1.0 clamps to 65535, 0.5 -> 32768."""
    rgba = np.array([[[0.5, 1.0, 0.0, 2.0]]], np.float32)
    out = exr.to_argb64(rgba)
    assert out[0, 0].tolist() == [65535, 32768, 65535, 0]  # A,R,G,B


def test_split_exr_stream(rng):
    blob = exr.write_exr(None, {"R": rng.random((4, 4))})
    stream = blob * 3
    parts = exr.split_exr_stream(stream)
    assert len(parts) == 3 and all(p == blob for p in parts)
    # a magic with bad flags (deep+multipart bits) is not a split point
    fake = exr.MAGIC_BYTES + (0x1A02).to_bytes(4, "little")
    assert len(exr.split_exr_stream(blob + fake)) == 1


def test_typefind_exr(rng):
    blob = exr.write_exr(None, {"R": rng.random((4, 4))})
    assert find_type(blob) == "image/x-exr"


def test_openexrdec_element(rng):
    h, w = 12, 16
    imgs = [{c: rng.random((h, w)).astype(np.float32) for c in "RGBA"}
            for _ in range(3)]
    el = gt.make("openexrdec")
    for planes in imgs:
        el.push_packet(exr.write_exr(None, planes))
    pipe = Pipeline([el])
    pipe.negotiate(None)
    assert el.out_spec.format == "ARGB64"
    outs = pipe.run(n_frames=3)
    got = np.concatenate([np.asarray(o.data) for o in outs])[:3]
    assert got.dtype == np.uint16
    for i, planes in enumerate(imgs):
        np.testing.assert_array_equal(
            got[i], exr.to_argb64(_expect_rgba(planes)))


def test_openexrdec_push_bytes_stream(rng):
    """Raw concatenated stream splits like the reference's parse."""
    blobs = [exr.write_exr(None,
                           {"R": rng.random((6, 8)).astype(np.float32)})
             for _ in range(2)]
    el = gt.make("openexrdec")
    stream = b"".join(blobs)
    el.push_bytes(stream[:len(stream) // 2])
    el.push_bytes(stream[len(stream) // 2:])
    el.event_eos()
    pipe = Pipeline([el])
    pipe.negotiate(None)
    outs = pipe.run(n_frames=2)
    got = np.concatenate([np.asarray(o.data) for o in outs])
    assert got.shape == (2, 6, 8, 4)


def test_exr_chain_to_8bit(rng):
    """openexrdec -> videoconvert ARGB64->RGBA -> a filter graph."""
    planes = {c: rng.random((16, 24)).astype(np.float32) for c in "RGBA"}
    el = gt.make("openexrdec")
    el.push_packet(exr.write_exr(None, planes))
    pipe = Pipeline([el, gt.make("videoconvert", format="RGBA"),
                     gt.make("fakesink")])
    pipe.negotiate(None)
    outs = pipe.run(n_frames=1)
    got = np.concatenate([np.asarray(o.data) for o in outs])[0]
    expect = exr.to_argb64(_expect_rgba(planes))
    # ARGB64 -> RGBA = high byte, no YUV round trip
    np.testing.assert_array_equal(got[..., 0], expect[..., 1] >> 8)
    np.testing.assert_array_equal(got[..., 3], expect[..., 0] >> 8)


def test_videoconvert_argb64_roundtrip(rng):
    """8-bit RGBA -> ARGB64 -> RGBA is lossless ((v*257) >> 8 == v)."""
    img = rng.integers(0, 256, (2, 8, 10, 4), np.uint8)
    import jax.numpy as jnp
    from gstbad.core.frame import FrameBatch
    from gstbad.core.spec import MediaSpec

    src = gt.make("videotestsrc", pattern="solid-color", format="RGBA",
                  width=10, height=8)
    up = gt.make("videoconvert", format="ARGB64")
    down = gt.make("videoconvert", format="RGBA")
    pipe = Pipeline([src, up, down, gt.make("fakesink")])
    pipe.negotiate()
    outs = pipe.run(n_frames=2)
    got = np.concatenate([np.asarray(o.data) for o in outs])
    assert got.dtype == np.uint8 and got.shape[-1] == 4
