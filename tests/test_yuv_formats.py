"""YUV format breadth (VERDICT r2 Missing #4): NV12/NV21/YUY2/UYVY/Y42B/
Y444/Y41B/YV12 across spec, videotestsrc, videoconvert and the luma-filter
family.  Done-gate: zebrastripe passes on all reference formats
(gstzebrastripe.c:81-82)."""

import numpy as np
import jax.numpy as jnp
import pytest

import gstbad as gt
from gstbad.core.frame import FrameBatch
from gstbad.core.spec import MediaSpec, VideoFormat
from gstbad.golden import videofilters as g_vf

ZEBRA_FORMATS = list(VideoFormat.YUV_WITH_LUMA)  # the reference caps list


def _make_input(rng, fmt, b=3, h=16, w=32):
    """Random well-formed data for `fmt` plus its luma plane."""
    y = rng.integers(0, 256, (b, h, w), dtype=np.uint8)
    if fmt == VideoFormat.AYUV:
        data = rng.integers(0, 256, (b, h, w, 4), dtype=np.uint8)
        data[..., 1] = y
    elif fmt in VideoFormat.PACKED_YUV422:
        data = rng.integers(0, 256, (b, h, 2 * w), dtype=np.uint8)
        if fmt == VideoFormat.YUY2:
            data[..., 0::2] = y
        else:
            data[..., 1::2] = y
    elif fmt in VideoFormat.SEMIPLANAR_YUV:
        data = {"y": y,
                "uv": rng.integers(0, 256, (b, h // 2, w), dtype=np.uint8)}
    elif fmt == VideoFormat.Y444:
        data = {"y": y,
                "u": rng.integers(0, 256, (b, h, w), dtype=np.uint8),
                "v": rng.integers(0, 256, (b, h, w), dtype=np.uint8)}
    elif fmt == VideoFormat.Y42B:
        data = {"y": y,
                "u": rng.integers(0, 256, (b, h, w // 2), dtype=np.uint8),
                "v": rng.integers(0, 256, (b, h, w // 2), dtype=np.uint8)}
    elif fmt == VideoFormat.Y41B:
        data = {"y": y,
                "u": rng.integers(0, 256, (b, h, w // 4), dtype=np.uint8),
                "v": rng.integers(0, 256, (b, h, w // 4), dtype=np.uint8)}
    else:  # I420 / YV12
        data = {"y": y,
                "u": rng.integers(0, 256, (b, h // 2, w // 2),
                                  dtype=np.uint8),
                "v": rng.integers(0, 256, (b, h // 2, w // 2),
                                  dtype=np.uint8)}
    return data, y


def _tree(data):
    if isinstance(data, dict):
        return {k: jnp.asarray(v) for k, v in data.items()}
    return jnp.asarray(data)


@pytest.mark.parametrize("fmt", ZEBRA_FORMATS)
def test_zebrastripe_all_reference_formats(rng, fmt):
    """The stripe edit must hit exactly the luma component in every
    reference format, matching the golden luma math bit for bit, and the
    chroma must pass through untouched."""
    data, y = _make_input(rng, fmt)
    p = gt.parse_launch("zebrastripe ! fakesink")
    p.negotiate(MediaSpec(kind="video", format=fmt, width=32, height=16))
    out = p.run(inputs=FrameBatch.make(_tree(data)))[0].data

    want_y = np.stack([g_vf.zebrastripe_y(y[i], 90, i)
                       for i in range(y.shape[0])])
    got_y = np.asarray(VideoFormat.luma_view(fmt, out))
    np.testing.assert_array_equal(got_y, want_y)

    # chroma passthrough
    if isinstance(data, dict):
        for k in data:
            if k != "y":
                np.testing.assert_array_equal(np.asarray(out[k]), data[k])
    elif fmt == VideoFormat.AYUV:
        np.testing.assert_array_equal(
            np.asarray(out)[..., [0, 2, 3]], data[..., [0, 2, 3]])
    elif fmt == VideoFormat.YUY2:
        np.testing.assert_array_equal(np.asarray(out)[..., 1::2],
                                      data[..., 1::2])
    elif fmt == VideoFormat.UYVY:
        np.testing.assert_array_equal(np.asarray(out)[..., 0::2],
                                      data[..., 0::2])


@pytest.mark.parametrize("fmt", ZEBRA_FORMATS)
def test_videoconvert_roundtrip_to_ayuv(rng, fmt):
    """fmt -> AYUV -> fmt preserves luma exactly (chroma is subsampled
    lossily where the format subsamples)."""
    data, y = _make_input(rng, fmt)
    p = gt.parse_launch("videoconvert format=AYUV ! fakesink")
    p.negotiate(MediaSpec(kind="video", format=fmt, width=32, height=16))
    ayuv = p.run(inputs=FrameBatch.make(_tree(data)))[0].data
    np.testing.assert_array_equal(np.asarray(ayuv)[..., 1], y)

    p2 = gt.parse_launch(f"videoconvert format={fmt} ! fakesink")
    p2.negotiate(MediaSpec(kind="video", format=VideoFormat.AYUV,
                           width=32, height=16))
    back = p2.run(inputs=FrameBatch.make(jnp.asarray(ayuv)))[0].data
    np.testing.assert_array_equal(
        np.asarray(VideoFormat.luma_view(fmt, back)), y)


@pytest.mark.parametrize("fmt", [VideoFormat.NV12, VideoFormat.YUY2,
                                 VideoFormat.UYVY, VideoFormat.Y42B,
                                 VideoFormat.YV12, VideoFormat.NV21])
def test_videotestsrc_generates_new_formats(fmt):
    p = gt.parse_launch(
        f"videotestsrc pattern=bars width=64 height=16 format={fmt} "
        "! zebrastripe ! fakesink")
    p.negotiate()
    out = p.run(n_frames=2, window=2)
    data = out[0].data
    if isinstance(data, dict):
        assert data["y"].shape == (2, 16, 64)
    else:
        assert data.shape == (2, 16, 128)


@pytest.mark.parametrize("fmt", [VideoFormat.Y444, VideoFormat.Y42B,
                                 VideoFormat.Y41B])
def test_videodiff_scenechange_wide_formats(rng, fmt):
    """videodiff/scenechange accept the reference's planar format list
    (gstvideodiff.c:51, gstscenechange.c:107)."""
    data, y = _make_input(rng, fmt)
    p = gt.parse_launch("videodiff ! scenechange ! fakesink")
    p.negotiate(MediaSpec(kind="video", format=fmt, width=32, height=16))
    out = p.run(inputs=FrameBatch.make(_tree(data)))[0].data
    assert np.asarray(out["y"]).shape == y.shape


@pytest.mark.parametrize("fmt", [VideoFormat.NV12, VideoFormat.YUY2,
                                 VideoFormat.Y42B, VideoFormat.Y444,
                                 VideoFormat.YV12, VideoFormat.UYVY])
def test_interlace_wide_formats_static_weave(fmt):
    """interlace pattern=2:2 on a STATIC source: weaving two fields of
    identical frames reproduces the frame in every plane — exercises the
    plane-generic field machinery (gstinterlace.c:1070-1171) on the wide
    format list."""
    p = gt.parse_launch(
        f"videotestsrc pattern=bars width=64 height=16 format={fmt} "
        "! interlace pattern=2:2 ! fakesink")
    p.negotiate()
    out = p.run(n_frames=4, window=4)
    ref = gt.parse_launch(
        f"videotestsrc pattern=bars width=64 height=16 format={fmt} "
        "! fakesink")
    ref.negotiate()
    want = ref.run(n_frames=1, window=1)[0].data
    got = out[0].data
    if isinstance(want, dict):
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k][1]),
                                          np.asarray(want[k][0]))
    else:
        np.testing.assert_array_equal(np.asarray(got[1]),
                                      np.asarray(want[0]))
