"""facedetect / faceblur (ext/opencv/gstfacedetect.cpp, gstfaceblur.cpp):
new-format cascade parsing, the data-driven evaluator vs the unrolled
one, and the elements over the REAL OpenCV face models with the
gradient-optimized fixture (tools/gen_face_fixture.py)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

import gstbad as gt
from gstbad.core.harness import Harness
from gstbad.core.spec import MediaSpec
from gstbad.io.haarcascade import parse_cascade, HaarCascade
from gstbad.ops import haar

HAAR_DIR = "/usr/share/opencv4/haarcascades/"
ALT2 = HAAR_DIR + "haarcascade_frontalface_alt2.xml"
FIXTURE = os.path.join(os.path.dirname(__file__), "..", "gstbad",
                       "data", "face_fixture.npz")

pytestmark = pytest.mark.skipif(
    not os.path.exists(ALT2), reason="opencv4 haarcascades not present")


def test_new_format_cascade_parse():
    c = parse_cascade(ALT2)
    assert c.window == (20, 20)
    assert len(c.stages) == 20
    assert c.n_features == 2094
    # alt2 is 2-node trees; leaves and children resolved
    t0 = c.stages[0].trees[0]
    assert len(t0.nodes) == 2
    n0 = t0.nodes[0]
    assert (n0.left_node is not None) or (n0.left_val is not None)


def test_array_evaluator_matches_unrolled(rng):
    img = jnp.asarray(rng.integers(0, 256, (64, 80)).astype(np.float32))
    for name in ("frontalface_alt2", "frontalface_alt"):
        c = parse_cascade(HAAR_DIR + f"haarcascade_{name}.xml")
        trunc = HaarCascade(c.window, c.stages[:3])
        p1, s1 = haar.eval_cascade(img, trunc)
        p2, s2 = haar.eval_cascade_arrays(img, haar.compile_arrays(trunc))
        np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
        np.testing.assert_allclose(np.asarray(s1), np.asarray(s2),
                                   atol=1e-4)


def _fixture_rgb():
    d = np.load(FIXTURE)
    g = d["frame"]
    return (np.repeat(g[..., None], 3, axis=-1)[None].copy(),
            tuple(d["face_xy"]), int(d["face_n"]))


@pytest.fixture
def face_frame():
    if not os.path.exists(FIXTURE):
        pytest.skip("face fixture not generated")
    return _fixture_rgb()


def _spec(w, h):
    return MediaSpec(kind="video", format="RGB", width=w, height=h)


def test_facedetect_element_finds_fixture(face_frame):
    img, (fx, fy), n = face_frame
    h = Harness("facedetect", profile=ALT2,
                **{"min-neighbors": 1, "min-size-width": 36,
                   "min-size-height": 36, "display": False,
                   "scale-factor": 1.1})
    h.set_src_spec(_spec(img.shape[2], img.shape[1]))
    out = h.push_pull(img)
    np.testing.assert_array_equal(out, img)          # display=false
    msgs = h.bus.pop(name="facedetect")
    assert msgs and int(msgs[0]["n_faces"]) >= 1
    x = int(msgs[0]["x"][0])
    y = int(msgs[0]["y"][0])
    w_ = int(msgs[0]["width"][0])
    assert abs(x - fx) <= 8 and abs(y - fy) <= 8
    assert abs(w_ - n) <= 12                          # ~40px face


def test_facedetect_display_draws_ellipse(face_frame):
    img, _, _ = face_frame
    h = Harness("facedetect", profile=ALT2,
                **{"min-neighbors": 1, "min-size-width": 36,
                   "min-size-height": 36, "display": True,
                   "scale-factor": 1.1})
    h.set_src_spec(_spec(img.shape[2], img.shape[1]))
    out = h.push_pull(img)
    assert (out != img).any()


def test_faceblur_element_blurs_fixture(face_frame):
    img, (fx, fy), n = face_frame
    h = Harness("faceblur", profile=ALT2,
                **{"min-neighbors": 1, "min-size-width": 36,
                   "min-size-height": 36, "scale-factor": 1.1})
    h.set_src_spec(_spec(img.shape[2], img.shape[1]))
    out = h.push_pull(img)
    inner = (slice(None), slice(fy + 4, fy + n - 4),
             slice(fx + 4, fx + n - 4))
    assert (out[inner] != img[inner]).any()           # face blurred
    # far corner untouched
    np.testing.assert_array_equal(out[:, :16, -16:], img[:, :16, -16:])


def test_facedetect_updates_modes(face_frame):
    img, _, _ = face_frame
    blank = np.full_like(img, 128)
    seq = np.concatenate([img, img, blank])
    for mode, want in (("every-frame", [True, True, True]),
                       ("on-change", [True, False, True]),
                       ("on-face", [True, True, False]),
                       ("none", [False, False, False])):
        h = Harness("facedetect", profile=ALT2, updates=mode,
                    **{"min-neighbors": 1, "min-size-width": 36,
                       "min-size-height": 36, "display": False,
                       "scale-factor": 1.1})
        h.set_src_spec(_spec(img.shape[2], img.shape[1]))
        h.push_pull(seq)
        msgs = h.bus.pop(name="facedetect")
        assert len(msgs) == sum(want), (mode, len(msgs))


def test_facedetect_missing_profile_raises():
    with pytest.raises(Exception, match="profile"):
        h = Harness("facedetect", profile="/nonexistent.xml")
        h.set_src_spec(_spec(64, 64))
        h.push_pull(np.zeros((1, 64, 64, 3), np.uint8))


def test_faceoverlay_haar_detection(face_frame, tmp_path):
    from PIL import Image
    img, (fx, fy), n = face_frame
    ov = np.zeros((16, 16, 4), np.uint8)
    ov[..., 1] = 255
    ov[..., 3] = 255
    loc = str(tmp_path / "ov.png")
    Image.fromarray(ov, "RGBA").save(loc)
    rgba = np.zeros(img.shape[:3] + (4,), np.uint8)
    rgba[..., :3] = img
    rgba[..., 3] = 255
    h = Harness("faceoverlay", location=loc, detector="haar",
                profile=ALT2, **{"scale-factor": 1.1})
    h.set_src_spec(MediaSpec(kind="video", format="RGBA",
                             width=img.shape[2], height=img.shape[1]))
    out = h.push_pull(rgba)
    msgs = h.bus.pop(name="face")
    assert msgs                                   # a face was found
    assert abs(int(msgs[0]["x"]) - fx) <= 8
    assert (out != rgba).any()                    # overlay composited
