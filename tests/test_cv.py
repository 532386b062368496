"""Fidelity: the opencv element family vs OpenCV itself (cv2 is in this
environment and is exactly the library the reference wraps).

Tolerance policy (golden/cv.py): bit-exact everywhere except GaussianBlur
with explicit sigma (±1, cv's softdouble kernel) and bilateral
(approximate, documented divergence).
"""

import numpy as np
import pytest

from gstbad.core.harness import Harness
from gstbad.core.spec import MediaSpec, VideoFormat
from gstbad.golden import cv as golden


def _rgb(rng, h=48, w=64):
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    img[0, 0] = 0
    img[0, 1] = 255
    return img


def _run(name, img, fmt=VideoFormat.RGB, **props):
    h = Harness(name, **props)
    h.set_src_spec(MediaSpec(kind="video", format=fmt,
                             width=img.shape[1], height=img.shape[0]))
    return h.push_pull(img[None])[0]


@pytest.mark.parametrize("xo,yo,ap,mask", [
    (1, 0, 3, True), (0, 1, 3, False), (1, 1, 5, True), (2, 0, 7, False),
])
def test_cvsobel(rng, xo, yo, ap, mask):
    img = _rgb(rng)
    got = _run("cvsobel", img, **{"x-order": xo, "y-order": yo,
                                  "aperture-size": ap, "mask": mask})
    np.testing.assert_array_equal(got, golden.cvsobel(img, xo, yo, ap, mask))


@pytest.mark.parametrize("ap,scale,shift,mask", [
    (3, 1.0, 0.0, True), (3, 2.0, 10.0, False), (5, 0.5, 128.0, False),
])
def test_cvlaplace(rng, ap, scale, shift, mask):
    img = _rgb(rng)
    got = _run("cvlaplace", img, **{"aperture-size": ap, "scale": scale,
                                    "shift": shift, "mask": mask})
    np.testing.assert_array_equal(
        got, golden.cvlaplace(img, ap, scale, shift, mask))


@pytest.mark.parametrize("kind,kw,kh,color,tol", [
    ("blur", 3, 3, 0.0, 0),
    ("blur", 5, 7, 0.0, 0),
    ("gaussian", 3, 3, 0.0, 0),
    ("gaussian", 7, 7, 0.0, 0),
    ("gaussian", 9, 9, 2.0, 1),
    ("median", 3, 3, 0.0, 0),
    ("median", 5, 5, 0.0, 0),
    ("bilateral", 3, 3, 30.0, 16),  # documented approximate divergence:
    # ours follows the classic OpenCV<=4 bilateral (radius=round(1.5*sigma)
    # disk, gaussian space/color weights); cv2 5.0 ships a reworked
    # implementation whose exact quantization is not reproduced
])
def test_cvsmooth(rng, kind, kw, kh, color, tol):
    img = _rgb(rng)
    got = _run("cvsmooth", img, **{"type": kind, "kernel-width": kw,
                                   "kernel-height": kh, "color": color})
    want = golden.cvsmooth(img, kind, kw, kh, color)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= tol, diff.max()
    if kind == "bilateral":
        assert diff.mean() <= 1.0, diff.mean()


def test_cvsmooth_roi(rng):
    """The reference smooths only the position/width/height ROI in place."""
    img = _rgb(rng)
    got = _run("cvsmooth", img, **{"type": "gaussian", "position-x": 8,
                                   "position-y": 4, "width": 20,
                                   "height": 16})
    want = golden.cvsmooth(img, "gaussian", 3, 3, 0.0, px=8, py=4,
                           rw=20, rh=16)
    np.testing.assert_array_equal(got, want)


def test_cvsmooth_roi_outside(rng):
    img = _rgb(rng)
    got = _run("cvsmooth", img, **{"position-x": 1000})
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("it", [1, 3])
def test_cvdilate_cverode(rng, it):
    img = _rgb(rng)
    np.testing.assert_array_equal(
        _run("cvdilate", img, iterations=it), golden.cvdilate(img, it))
    np.testing.assert_array_equal(
        _run("cverode", img, iterations=it), golden.cverode(img, it))


def test_cvdilate_gray(rng):
    img = rng.integers(0, 256, (32, 40), dtype=np.uint8)
    got = _run("cvdilate", img, fmt=VideoFormat.GRAY8)
    np.testing.assert_array_equal(got, golden.cvdilate(img))


def test_cvequalizehist(rng):
    img = rng.integers(0, 200, (40, 56), dtype=np.uint8)
    got = _run("cvequalizehist", img, fmt=VideoFormat.GRAY8)
    np.testing.assert_array_equal(got, golden.cvequalizehist(img))


def test_cvequalizehist_constant(rng):
    img = np.full((16, 16), 42, np.uint8)
    got = _run("cvequalizehist", img, fmt=VideoFormat.GRAY8)
    np.testing.assert_array_equal(got, golden.cvequalizehist(img))


@pytest.mark.parametrize("t1,t2,ap,mask", [
    (50, 150, 3, True), (30, 90, 3, False), (150, 50, 5, True),
])
def test_edgedetect(rng, t1, t2, ap, mask):
    # smooth first so there are real edge chains to trace
    import cv2
    img = _rgb(rng)
    img = cv2.GaussianBlur(img, (5, 5), 1.5)
    got = _run("edgedetect", img, **{"threshold1": t1, "threshold2": t2,
                                     "aperture-size": ap, "mask": mask})
    np.testing.assert_array_equal(
        got, golden.edgedetect(img, t1, t2, ap, mask))


@pytest.mark.parametrize("method,kw", [
    ("basic", {"sigma": 3.0}),
    ("multiscale", {"scales": 2}),
])
def test_retinex(rng, method, kw):
    img = _rgb(rng, h=64, w=72)
    got = _run("retinex", img, method=method, **kw)
    if method == "basic":
        want = golden.retinex_basic(img, sigma=kw["sigma"])
    else:
        want = golden.retinex_multiscale(img, scales=kw["scales"])
    diff = np.abs(got.astype(int) - want.astype(int))
    # f32 log + blur: ±1 LSB at rounding boundaries
    assert diff.max() <= 1, diff.max()


@pytest.mark.parametrize("method", ["sqdiff", "sqdiff-normed", "ccorr",
                                    "ccorr-normed", "ccoeff",
                                    "ccoeff-normed"])
def test_templatematch(rng, method):
    from gstbad.core.pipeline import parse_launch
    from gstbad.core.frame import FrameBatch
    import jax.numpy as jnp

    img = _rgb(rng, h=40, w=56)
    templ = img[12:24, 30:46].copy()
    h = Harness("templatematch", method=method, display=False)
    h.element.set_template(templ)
    h.set_src_spec(MediaSpec(kind="video", format=VideoFormat.RGB,
                             width=img.shape[1], height=img.shape[0]))
    out = h.push_pull(img[None])
    msgs = h.bus.pop(name="template_match")
    assert len(msgs) == 1
    want_res, (wx, wy) = golden.template_match(img, templ, method)
    m = msgs[0].fields
    assert (m["x"], m["y"]) == (wx, wy)
    assert m["width"] == templ.shape[1] and m["height"] == templ.shape[0]
    np.testing.assert_allclose(m["result"], want_res, rtol=1e-4, atol=1e-5)
    # exact template: the match must be where we cut it from
    assert (wx, wy) == (30, 12)


def test_templatematch_display_draws_rectangle(rng):
    img = _rgb(rng, h=40, w=56)
    templ = img[8:20, 10:26].copy()
    h = Harness("templatematch", method="ccorr-normed", display=True)
    h.element.set_template(templ)
    h.set_src_spec(MediaSpec(kind="video", format=VideoFormat.RGB,
                             width=img.shape[1], height=img.shape[0]))
    out = h.push_pull(img[None])[0]
    assert not np.array_equal(out, img)  # rectangle drawn
    # red-ish border pixel on the rectangle top edge
    assert out[8, 12, 0] == 255


def test_cv_elements_in_launch_string(rng):
    """Launch-string integration: videotestsrc RGB -> cv chain."""
    import gstbad as gt
    p = gt.parse_launch(
        "videotestsrc pattern=gradient width=64 height=48 format=RGB "
        "! cvsmooth type=blur ! cvsobel ! fakesink")
    outs = p.run(n_frames=2, window=2)
    assert outs[0].data.shape == (2, 48, 64, 3)


@pytest.mark.parametrize("method,post", [
    ("hsv", True), ("hsv", False), ("rgb", True), ("rgb", False),
])
def test_skindetect(rng, method, post):
    # skin-ish colors mixed with noise so both branches fire
    img = _rgb(rng)
    img[10:20, 10:20] = (200, 120, 90)  # skin-tone patch
    got = _run("skindetect", img, method=method, postprocess=post)
    np.testing.assert_array_equal(got, golden.skindetect(img, method, post))


def test_cameraundistort(rng):
    img = _rgb(rng, h=48, w=64)
    K = [[60.0, 0, 32], [0, 60, 24], [0, 0, 1]]
    dist = [-0.2, 0.05, 0.001, -0.001, 0.0]
    km = " ".join(str(v) for row in K for v in row)
    dm = " ".join(str(v) for v in dist)
    got = _run("cameraundistort", img,
               **{"camera-matrix": km, "distortion-coeffs": dm,
                  "alpha": 0.0})
    want = golden.cameraundistort(img, K, dist, 0.0)
    # the map is float-identical to cv2's within 1e-5 px; quantized to 1/32
    # the same way — bit-exact except where a coordinate falls within that
    # 1e-5 of a 1/64 rounding boundary
    diff = np.abs(got.astype(int) - want.astype(int))
    assert (diff > 0).mean() < 0.01
    assert np.percentile(diff, 99.9) <= 1


def test_cameraundistort_passthrough(rng):
    img = _rgb(rng)
    got = _run("cameraundistort", img)  # no calibration set
    np.testing.assert_array_equal(got, img)


def test_dewarp_panorama(rng):
    img = rng.integers(0, 256, (64, 96, 4), dtype=np.uint8)
    got = _run("dewarp", img, fmt=VideoFormat.RGBA,
               **{"inner-radius": 0.1, "outer-radius": 0.35})
    want = golden.dewarp_panorama(img, 0.5, 0.5, 0.1, 0.35)
    assert got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert (diff > 0).mean() < 0.01 and diff.max() <= 16  # f32 map-build ulps
    # at 1/32-boundaries


def test_dewarp_display_modes(rng):
    img = rng.integers(0, 256, (64, 96, 4), dtype=np.uint8)
    pano = _run("dewarp", img, fmt=VideoFormat.RGBA,
                **{"inner-radius": 0.1, "outer-radius": 0.35})
    dbl = _run("dewarp", img, fmt=VideoFormat.RGBA,
               **{"inner-radius": 0.1, "outer-radius": 0.35,
                  "display-mode": "double-panorama"})
    # double-panorama = panorama split in half and stacked
    # (gstdewarp.cpp:667-681); map dims differ (out_w*2 x out_h/2), so just
    # shape-check plus the quad variant
    assert dbl.shape[0] == pano.shape[0] * 2 or dbl.size == pano.size
    quad = _run("dewarp", img, fmt=VideoFormat.RGBA,
                **{"inner-radius": 0.1, "outer-radius": 0.35,
                   "display-mode": "quad-view"})
    assert quad.size == dbl.size


def test_dewarp_passthrough(rng):
    img = rng.integers(0, 256, (32, 32, 4), dtype=np.uint8)
    got = _run("dewarp", img, fmt=VideoFormat.RGBA)  # radii equal -> pass
    np.testing.assert_array_equal(got, img)


def test_motioncells_detects_moving_block(rng):
    import gstbad as gt
    from gstbad.core.frame import FrameBatch
    import jax.numpy as jnp
    from gstbad.core.registry import make

    h, w = 80, 80
    frames = np.zeros((6, h, w, 3), np.uint8)
    for i in range(6):
        frames[i, 8 + 8 * i:24 + 8 * i, 8:24] = 255  # block moving down

    el = make("motioncells", display=False)
    hns = Harness(el)
    hns.set_src_spec(MediaSpec(kind="video", format=VideoFormat.RGB,
                               width=w, height=h))
    hns.push_pull(frames)
    msgs = hns.bus.pop(name="motion")
    assert msgs, "moving block must post motion messages"
    grid = np.asarray(msgs[-1]["cells"])
    assert grid.shape == (10, 10)
    assert grid.any()
    # motion is confined to the left-ish columns of the grid
    assert not grid[:, 6:].any()
    idx = el.indices_string(grid)
    assert ":" in idx

    # static frames -> no motion messages
    el2 = make("motioncells", display=False)
    hns2 = Harness(el2)
    hns2.set_src_spec(MediaSpec(kind="video", format=VideoFormat.RGB,
                                width=w, height=h))
    static = np.broadcast_to(frames[0], frames.shape).copy()
    hns2.push_pull(static)
    assert not hns2.bus.pop(name="motion")


# ---------------------------------------------------------------------------
# lcms (ext/colormanagement) — oracle: lcms2 itself via PIL.ImageCms
# ---------------------------------------------------------------------------


def _pil_transform(img_rgb, src_bytes, dst_bytes, intent=0):
    import io as _io
    from PIL import Image, ImageCms
    t = ImageCms.buildTransform(_io.BytesIO(src_bytes), _io.BytesIO(dst_bytes),
                                "RGB", "RGB", renderingIntent=intent)
    return np.asarray(ImageCms.applyTransform(
        Image.fromarray(img_rgb, "RGB"), t))


def _wide_profile_bytes():
    from gstbad.io import icc
    wide = icc.IccProfile(
        matrix=np.array([[0.60974, 0.20528, 0.14919],
                         [0.31111, 0.62567, 0.06322],
                         [0.01947, 0.06087, 0.74457]]),
        trc=[icc.Curve("gamma", gamma=2.19921875)] * 3,
        white=np.array([0.9642, 1.0, 0.8249]))
    return icc.write_icc(wide, "wide-test")


def test_lcms_identity_srgb(rng):
    """Default profiles are sRGB on both ends -> near-identity."""
    img = _rgb(rng)
    got = _run("lcms", img)
    diff = np.abs(got.astype(int) - img.astype(int))
    assert diff.max() <= 1


def test_lcms_srgb_to_wide_matches_lcms2(rng, tmp_path):
    from PIL import ImageCms
    img = _rgb(rng)
    wide = _wide_profile_bytes()
    srgb = ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()
    p = tmp_path / "wide.icc"
    p.write_bytes(wide)
    got = _run("lcms", img, **{"dest-profile": str(p)})
    want = _pil_transform(img, srgb, wide)
    diff = np.abs(got.astype(int) - want.astype(int))
    # lcms2 runs 16-bit fixed point internally
    assert diff.max() <= 2, diff.max()
    assert (diff > 1).mean() < 0.01


def test_lcms_wide_to_srgb_matches_lcms2(rng, tmp_path):
    from PIL import ImageCms
    img = _rgb(rng)
    wide = _wide_profile_bytes()
    srgb = ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()
    p = tmp_path / "wide.icc"
    p.write_bytes(wide)
    got = _run("lcms", img, **{"input-profile": str(p)})
    want = _pil_transform(img, wide, srgb)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 2, diff.max()


def test_lcms_preserve_black(rng):
    img = _rgb(rng)
    img[0, 0] = 0
    got = _run("lcms", img, **{"preserve-black": True})
    assert (got[0, 0] == 0).all()


def test_lcms_parses_own_roundtrip(tmp_path):
    from gstbad.io import icc
    wide = _wide_profile_bytes()
    prof = icc.parse_icc(wide)
    assert prof.trc[0].kind == "gamma"
    np.testing.assert_allclose(prof.trc[0].gamma, 2.19921875, atol=1e-2)
