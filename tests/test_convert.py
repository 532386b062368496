"""videoconvert: permutation exactness + YUV roundtrip sanity."""

import jax.numpy as jnp
import numpy as np
import pytest

import gstbad as gt
from gstbad.core.harness import Harness
from gstbad.core.spec import MediaSpec, VideoFormat


def _run(img, src, dst):
    h = Harness("videoconvert", format=dst)
    h.set_src_spec(MediaSpec(kind="video", format=src,
                             width=img.shape[-2] if img.ndim == 3
                             else img.shape[2 if isinstance(img, dict) else 2],
                             height=16))
    return h.push(img[None] if not isinstance(img, dict) else img)


@pytest.mark.parametrize("src,dst", [("BGRx", "RGBA"), ("RGBA", "ABGR"),
                                     ("ARGB", "BGRx")])
def test_rgb_permutation_exact(rng, src, dst):
    img = rng.integers(0, 256, (16, 24, 4), dtype=np.uint8)
    h = Harness("videoconvert", format=dst)
    h.set_src_spec(MediaSpec(kind="video", format=src, width=24, height=16))
    got = h.push_pull(img[None])[0]
    s_off = VideoFormat.rgb_offsets(src)
    d_off = VideoFormat.rgb_offsets(dst)
    for i in range(3):
        np.testing.assert_array_equal(got[..., d_off[i]], img[..., s_off[i]])
    if d_off[3] is not None:
        if VideoFormat.has_alpha(src):
            np.testing.assert_array_equal(got[..., d_off[3]],
                                          img[..., s_off[3]])
        else:
            assert (got[..., d_off[3]] == 255).all()


def test_rgb_yuv_roundtrip_close(rng):
    img = rng.integers(16, 240, (1, 16, 24, 4), dtype=np.uint8)
    img[..., 3] = 255
    p = gt.parse_launch("videoconvert format=AYUV "
                        "! videoconvert format=BGRx ! fakesink")
    p.negotiate(MediaSpec(kind="video", format="BGRx", width=24, height=16))
    from gstbad.core.frame import FrameBatch
    import jax.numpy as jnp
    outs = p.run(inputs=FrameBatch.make(jnp.asarray(img)))
    got = np.asarray(outs[0].data).astype(int)
    # fixed-point 8-bit SDTV round trip loses a little precision
    assert np.abs(got[..., :3] - img[..., :3].astype(int)).max() <= 8


def test_i420_ayuv_roundtrip(rng):
    y = rng.integers(0, 256, (1, 16, 24), dtype=np.uint8)
    u = rng.integers(0, 256, (1, 8, 12), dtype=np.uint8)
    v = rng.integers(0, 256, (1, 8, 12), dtype=np.uint8)
    from gstbad.core.frame import FrameBatch
    import jax.numpy as jnp
    p = gt.parse_launch("videoconvert format=AYUV "
                        "! videoconvert format=I420 ! fakesink")
    p.negotiate(MediaSpec(kind="video", format="I420", width=24, height=16))
    outs = p.run(inputs=FrameBatch.make(
        {"y": jnp.asarray(y), "u": jnp.asarray(u), "v": jnp.asarray(v)}))
    np.testing.assert_array_equal(np.asarray(outs[0].data["y"]), y)
    # chroma upsample(nearest)+downsample(avg of identical) is exact
    np.testing.assert_array_equal(np.asarray(outs[0].data["u"]), u)
    np.testing.assert_array_equal(np.asarray(outs[0].data["v"]), v)


# -- 16-bit packed RGB (RGB16/BGR16/RGB15/BGR15) ----------------------------

def test_rgb16_pack_unpack_bit_replication(rng):
    """8-bit -> 565 -> 8-bit uses truncating pack and bit-replicating
    expand (GStreamer video-format.c), so round-tripped values match the
    replication of their truncated fields exactly."""
    import gstbad as gt
    from gstbad.core.frame import FrameBatch
    from gstbad.core.pipeline import Pipeline
    from gstbad.core.spec import MediaSpec

    img = rng.integers(0, 256, (2, 8, 16, 4), dtype=np.uint8)
    for fmt, bits in (("RGB16", (5, 6, 5)), ("BGR16", (5, 6, 5)),
                      ("RGB15", (5, 5, 5)), ("BGR15", (5, 5, 5))):
        p = Pipeline([gt.make("videoconvert", format=fmt)])
        p.negotiate(MediaSpec(kind="video", format="RGBx",
                              width=16, height=8))
        p16 = np.asarray(p.run(
            inputs=FrameBatch.make(jnp.asarray(img)))[0].data)
        assert p16.dtype == np.uint16 and p16.shape == (2, 8, 16)
        p2 = Pipeline([gt.make("videoconvert", format="RGBx")])
        p2.negotiate(MediaSpec(kind="video", format=fmt,
                               width=16, height=8))
        back = np.asarray(p2.run(
            inputs=FrameBatch.make(jnp.asarray(p16)))[0].data)
        for c, nb in enumerate(bits):
            field = img[..., c].astype(np.uint16) >> (8 - nb)
            want = ((field << (8 - nb)) | (field >> (2 * nb - 8))
                    ).astype(np.uint8)
            np.testing.assert_array_equal(back[..., c], want)
        np.testing.assert_array_equal(back[..., 3], 255)


def test_rgb16_testsrc_and_yuv_path(rng):
    """videotestsrc renders RGB16 directly; converting to AYUV matches
    the BGRx source converted to AYUV within 5/6-bit quantization."""
    import gstbad as gt

    outs = {}
    for fmt in ("RGB16", "BGRx"):
        p = gt.parse_launch(
            f"videotestsrc pattern=bars width=64 height=16 format={fmt} "
            "! videoconvert format=AYUV ! fakesink")
        p.negotiate()
        p.compile(2)
        outs[fmt] = np.asarray(p.run(n_frames=2, window=2)[0].data)
    diff = np.abs(outs["RGB16"].astype(int) - outs["BGRx"].astype(int))
    assert diff.max() <= 12          # 5-bit step = 8, plus matrix rounding
