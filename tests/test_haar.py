"""Haar cascade engine (ops/haar.py, io/haarcascade.py) + handdetect.

cv2.integral3 is the oracle for the rotated integral; detection logic is
validated with hand-computed synthetic cascades (cv2 5.0 has no
objdetect, so detectMultiScale itself cannot be an oracle — the engine's
documented spec is tested instead)."""

import fractions

import numpy as np
import jax.numpy as jnp
import pytest

import gstbad as gt
from gstbad.core.frame import FrameBatch
from gstbad.core.pipeline import Pipeline
from gstbad.core.spec import MediaSpec
from gstbad.io.haarcascade import parse_cascade
from gstbad.ops import haar

cv2 = pytest.importorskip("cv2")


def test_tilted_integral_matches_cv2():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (20, 26)).astype(np.uint8)
    _, _, t_cv = cv2.integral3(img)
    t_my = np.asarray(haar.tilted_integral(jnp.asarray(img)))
    sub = t_my[:, haar.TILT_PAD:haar.TILT_PAD + t_cv.shape[1]]
    np.testing.assert_allclose(sub, t_cv)


def test_tilted_rect_sum_matches_onehot_coefficients():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (18, 22)).astype(np.uint8)
    H, W = img.shape
    tii = haar.tilted_integral(jnp.asarray(img))
    for (rx, ry, rw, rh) in ((5, 2, 3, 2), (8, 1, 4, 3), (3, 0, 2, 2)):
        want = 0
        for py in range(H):
            for px in range(W):
                one = np.zeros((H, W), np.uint8)
                one[py, px] = 1
                _, _, tt = cv2.integral3(one)
                tt = tt.astype(np.int64)

                def g(Y, X):
                    if 0 <= Y < tt.shape[0] and 0 <= X < tt.shape[1]:
                        return tt[Y, X]
                    return 0
                c = (g(ry, rx) - g(ry + rh, rx - rh)
                     - g(ry + rw, rx + rw)
                     + g(ry + rw + rh, rx + rw - rh))
                want += c * int(img[py, px])
        got = int(np.asarray(haar._tilted_sum(tii, 1, 1, rx, ry, rw,
                                              rh))[0, 0])
        assert got == want


SYNTH = """<?xml version="1.0"?>
<opencv_storage>
<cascade type_id="opencv-haar-classifier">
  <size>24 24</size>
  <stages>
    <_>
      <trees>
        <_>
          <_>
            <feature>
              <rects>
                <_>0 0 24 24 -1.</_>
                <_>0 0 24 12 2.</_></rects>
              <tilted>0</tilted></feature>
            <threshold>0.2</threshold>
            <left_val>-5.0</left_val>
            <right_val>5.0</right_val></_></_></trees>
      <stage_threshold>0.0</stage_threshold>
    </_>
  </stages></cascade>
</opencv_storage>
"""


def _patterned(h, w, x0, y0):
    """Bright-top/dark-bottom 24x24 patch at (x0, y0) on mid grey."""
    img = np.full((h, w), 125, np.uint8)
    img[y0:y0 + 12, x0:x0 + 24] = 200
    img[y0 + 12:y0 + 24, x0:x0 + 24] = 50
    return img


def test_synthetic_cascade_hand_computed():
    casc = parse_cascade(SYNTH)
    assert casc.window == (24, 24) and casc.n_features == 1
    img = _patterned(48, 64, 20, 12)
    passed, _ = haar.eval_cascade(jnp.asarray(img), casc)
    p = np.asarray(passed)
    # the aligned window (x=20, y=12) -> grid (y=6, x=10) must fire:
    # fval = (top - bottom) / area = 75, vnorm = 75 -> 75 >= 0.2*75
    assert p[6, 10]
    # uniform windows: fval 0 < 0.2 * vnorm(=1) -> left (-5) -> reject
    assert not p[0, 0]
    noise = np.random.default_rng(3).integers(0, 256, (48, 64)
                                              ).astype(np.uint8)
    pn = np.asarray(haar.eval_cascade(jnp.asarray(noise), casc)[0])
    assert pn.sum() <= 2                       # essentially rejects


TREE = SYNTH.replace(
    """            <threshold>0.2</threshold>
            <left_val>-5.0</left_val>
            <right_val>5.0</right_val></_></_></trees>""",
    """            <threshold>0.2</threshold>
            <left_val>-5.0</left_val>
            <right_node>1</right_node></_>
          <_>
            <feature>
              <rects>
                <_>0 0 12 24 -1.</_>
                <_>12 0 12 24 1.</_></rects>
              <tilted>0</tilted></feature>
            <threshold>10.0</threshold>
            <left_val>5.0</left_val>
            <right_val>-5.0</right_val></_></_></trees>""")


def test_tree_traversal():
    """right_node chains into a second node (the palm.xml layout)."""
    casc = parse_cascade(TREE)
    assert len(casc.stages[0].trees[0].nodes) == 2
    img = _patterned(48, 64, 20, 12)
    passed, _ = haar.eval_cascade(jnp.asarray(img), casc)
    # node 0 goes right (75 >= 15) -> node 1: left-right halves equal ->
    # fval 0 < 10*vnorm -> left_val 5 -> stage passes
    assert np.asarray(passed)[6, 10]


def test_real_cascades_load_and_reject_noise():
    for name, stages, feats in (("fist.xml", 17, 142),
                                ("palm.xml", 5, 112)):
        casc = parse_cascade(f"gstbad/data/{name}")
        assert len(casc.stages) == stages
        assert casc.n_features == feats
    fist = parse_cascade("gstbad/data/fist.xml")
    noise = np.random.default_rng(0).integers(0, 256, (64, 96)
                                              ).astype(np.uint8)
    passed, _ = haar.eval_cascade(jnp.asarray(noise), fist)
    assert int(np.asarray(passed).sum()) == 0


def test_handdetect_element(tmp_path):
    xml = tmp_path / "synth.xml"
    xml.write_text(SYNTH)
    nofire = tmp_path / "nofire.xml"
    nofire.write_text(SYNTH.replace("<right_val>5.0</right_val>",
                                    "<right_val>-5.0</right_val>"))
    b, h, w = 3, 48, 64
    frames = np.zeros((b, h, w, 3), np.uint8)
    for i in range(b):
        g = _patterned(h, w, 20, 12)
        frames[i] = g[..., None]
    frames[2] = 125                                 # no pattern

    el = gt.make("handdetect", profile_fist=str(xml),
                 profile_palm=str(nofire))
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="RGB", width=w, height=h,
                          framerate=fractions.Fraction(30)))
    outs = p.run(inputs=FrameBatch.make(jnp.asarray(frames)))
    out = np.concatenate([np.asarray(o.data) for o in outs])
    msgs = p.bus.pop(name="hand-gesture")
    assert len(msgs) == 2                           # frames 0, 1 only
    for m in msgs:
        assert int(m["gesture"]) == 1               # fist
        # the best pick is the confirmed window nearest the carried
        # prev point (origin on frame 0), so the center may sit anywhere
        # over the patch — assert the detected rect OVERLAPS the patch
        cx, cy = int(m["x"]), int(m["y"])
        hw, hh2 = int(m["width"]) / 2, int(m["height"]) / 2
        assert cx + hw > 20 and cx - hw < 44
        assert cy + hh2 > 12 and cy - hh2 < 36
    # display circle: some pixel on the ring is the CV_RGB(0,0,200) blue
    blue = (out[0] == [0, 0, 200]).all(axis=-1)
    assert blue.any()
    assert not (out[2] == [0, 0, 200]).all(axis=-1).any()


def test_handdetect_roi_gating(tmp_path):
    xml = tmp_path / "synth.xml"
    xml.write_text(SYNTH)
    b, h, w = 1, 48, 64
    frames = np.repeat(_patterned(h, w, 20, 12)[..., None], 3,
                       axis=-1)[None]
    el = gt.make("handdetect", profile_fist=str(xml),
                 profile_palm=str(xml), **{"roi-x": 1, "roi-y": 1, "roi-width": 5,
                    "roi-height": 5}, display=False)
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="RGB", width=w, height=h,
                          framerate=fractions.Fraction(30)))
    p.run(inputs=FrameBatch.make(jnp.asarray(frames)))
    assert not p.bus.pop(name="hand-gesture")       # center outside ROI
