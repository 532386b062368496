"""openjpegenc / openjpegdec (ext/openjpeg) over libopenjp2."""

import numpy as np
import pytest

import gstbad as gt
from gstbad.core.pipeline import Pipeline, parse_launch
from gstbad.elements.video import jpeg2000

pytestmark = pytest.mark.skipif(not jpeg2000.available(),
                                reason="libopenjp2 not present")


@pytest.fixture
def rng():
    return np.random.default_rng(3)


def test_enc_element_j2c_and_jp2():
    pipe = parse_launch(
        "videotestsrc pattern=gradient width=64 height=48 format=RGB "
        "! openjpegenc ! fakesink")
    pipe.negotiate()
    pipe.run(n_frames=2)
    packets = pipe.elements[1].packets
    assert len(packets) == 2
    # raw codestream signature (image/x-j2c default)
    assert packets[0][1][:4] == bytes.fromhex("ff4fff51")

    pipe2 = parse_launch(
        "videotestsrc pattern=gradient width=64 height=48 format=RGB "
        "! openjpegenc container=jp2 ! fakesink")
    pipe2.negotiate()
    pipe2.run(n_frames=1)
    jp2 = pipe2.elements[1].packets[0][1]
    assert jp2[:8] == bytes.fromhex("0000000c6a502020")


def test_roundtrip_lossless_rgb(rng):
    img = rng.integers(0, 256, (32, 40, 3), np.uint8)
    el = gt.make("openjpegdec")
    enc = gt.make("openjpegenc")
    # drive the encoder statically through its own hook
    enc.out_spec = None

    class Spec:
        kind, format, width, height = "video", "RGB", 40, 32
    from gstbad.core.spec import MediaSpec, VideoFormat
    import fractions
    spec = MediaSpec(kind="video", format=VideoFormat.RGB, width=40,
                     height=32, framerate=fractions.Fraction(30, 1))
    enc.negotiate(spec)
    data = enc._encode(img)
    el.push_packet(data)
    pipe = Pipeline([el, gt.make("fakesink")])
    pipe.negotiate(None)
    assert el.out_spec.format == "RGB"
    outs = pipe.run(n_frames=1)
    got = np.concatenate([np.asarray(o.data) for o in outs])[0]
    assert np.array_equal(got, img)     # 5/3 lossless


def test_progression_and_tiling_change_stream():
    import fractions
    from gstbad.core.spec import MediaSpec, VideoFormat
    spec = MediaSpec(kind="video", format=VideoFormat.RGB, width=64,
                     height=64, framerate=fractions.Fraction(30, 1))
    img = np.tile(np.arange(64, dtype=np.uint8), (64, 1))
    img = np.stack([img, img.T, img ^ 255], -1)

    def enc_with(**props):
        e = gt.make("openjpegenc", **props)
        e.negotiate(spec)
        return e._encode(img)

    base = enc_with()
    rpcl = enc_with(**{"progression-order": "RPCL"})
    tiled = enc_with(**{"tile-width": 32, "tile-height": 32})
    layers = enc_with(**{"num-layers": 3})
    assert base != rpcl and base != tiled and base != layers
    # all decode back to the same lossless pixels
    from PIL import Image
    import io as _io
    for d in (base, rpcl, tiled, layers):
        back = np.asarray(Image.open(_io.BytesIO(d)))
        assert np.array_equal(back, img)


def test_gray8_path(rng):
    img = rng.integers(0, 256, (24, 32), np.uint8)
    import fractions
    from gstbad.core.spec import MediaSpec, VideoFormat
    spec = MediaSpec(kind="video", format=VideoFormat.GRAY8, width=32,
                     height=24, framerate=fractions.Fraction(30, 1))
    enc = gt.make("openjpegenc", **{"num-resolutions": 5})
    enc.negotiate(spec)
    data = enc._encode(img)
    dec = gt.make("openjpegdec")
    dec.push_packet(data)
    pipe = Pipeline([dec, gt.make("fakesink")])
    pipe.negotiate(None)
    assert dec.out_spec.format == "GRAY8"
    outs = pipe.run(n_frames=1)
    got = np.concatenate([np.asarray(o.data) for o in outs])[0]
    assert np.array_equal(got.reshape(24, 32), img)
