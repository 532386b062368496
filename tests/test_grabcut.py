"""grabcut (ext/opencv/gstgrabcut.cpp): ops core vs the cv2.grabCut
oracle (present in this cv2 build) and the element's mask/bbox/test-mode
semantics."""

import fractions

import numpy as np
import jax.numpy as jnp
import pytest

import gstbad as gt
from gstbad.core.frame import FrameBatch
from gstbad.core.pipeline import Pipeline
from gstbad.core.spec import MediaSpec
from gstbad.ops import grabcut as gc

cv2 = pytest.importorskip("cv2")

H, W = 48, 64
RECT = (16, 8, 38, 34)
BLOB = (slice(12, 36), slice(20, 48))


def _scene(seed=0):
    rng = np.random.default_rng(seed)
    img = np.full((H, W, 3), 40, np.uint8)
    img += rng.integers(0, 12, (H, W, 3)).astype(np.uint8)
    img[BLOB] = np.clip(np.array([200, 60, 60])
                        + rng.integers(-10, 10, (24, 28, 3)),
                        0, 255).astype(np.uint8)
    return img


def _iou(a, b):
    return (a & b).sum() / max((a | b).sum(), 1)


def test_rect_init_vs_cv2_oracle():
    img = _scene()
    mask0 = gc.init_mask_from_rect(H, W, RECT)
    out = np.asarray(gc.grabcut(jnp.asarray(img), mask0, iterations=2))
    my_fg = (out == gc.GC_FGD) | (out == gc.GC_PR_FGD)

    m = np.zeros((H, W), np.uint8)
    bgd = np.zeros((1, 65)); fgd = np.zeros((1, 65))
    cv2.grabCut(img, m, RECT, bgd, fgd, 2, cv2.GC_INIT_WITH_RECT)
    cv_fg = (m == 1) | (m == 3)
    true_fg = np.zeros((H, W), bool)
    true_fg[BLOB] = True
    # the ICM stand-in must land where the min-cut lands on a separable
    # scene (divergence documented in ops/grabcut.py)
    assert _iou(my_fg, cv_fg) > 0.9
    assert _iou(my_fg, true_fg) > 0.9
    # hard background stays background
    assert not my_fg[0, 0] and not my_fg[-1, -1]


def test_mask_init():
    img = _scene(1)
    mask0 = np.full((H, W), gc.GC_PR_BGD, np.uint8)
    mask0[10:38, 18:50] = gc.GC_PR_FGD
    mask0[:4] = gc.GC_BGD
    out = np.asarray(gc.grabcut(jnp.asarray(img), jnp.asarray(mask0),
                                iterations=2))
    my_fg = (out == gc.GC_FGD) | (out == gc.GC_PR_FGD)
    true_fg = np.zeros((H, W), bool)
    true_fg[BLOB] = True
    assert _iou(my_fg, true_fg) > 0.85
    assert (out[:4] == gc.GC_BGD).all()            # hard labels kept


def _run(frames, **props):
    el = gt.make("grabcut", **props)
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="RGBA", width=W, height=H,
                          framerate=fractions.Fraction(30)))
    outs = p.run(inputs=FrameBatch.make(jnp.asarray(frames)))
    return np.concatenate([np.asarray(o.data) for o in outs]), p


def test_element_bbox_and_test_mode():
    img = _scene(2)
    rgba = np.dstack([img, np.zeros((H, W), np.uint8)])[None]
    # facepos formula (gstgrabcut.cpp:300-303) with scale=1.0:
    # (x, y, w*0.9, h*1.1)
    out, p = _run(rgba, **{"test-mode": True, "scale": 1.0,
                           "bbox-x": 16, "bbox-y": 6, "bbox-width": 42,
                           "bbox-height": 34})
    msgs = p.bus.pop(name="grabcut")
    assert len(msgs) == 1 and int(msgs[0]["fg-pixels"]) > 400
    true_fg = np.zeros((H, W), bool)
    true_fg[BLOB] = True
    kept = (out[0, :, :, :3] > 0).any(axis=-1)
    # the magenta rectangle also has nonzero pixels; exclude its rows
    inner = kept.copy()
    inner[6, :] = inner[6 + int(34 * 1.1), :] = False
    inner[:, 16] = inner[:, 16 + int(42 * 0.9)] = False
    assert _iou(inner, true_fg) > 0.8
    # magenta bbox border drawn
    assert (out[0, 6, 20, :3] == [255, 0, 255]).all()
    # alpha untouched (the reference never writes the mask back)
    assert (out[0, :, :, 3] == 0).all()


def test_element_alpha_mask_path_and_skip():
    img = _scene(3)
    # alpha carries the seed mask; 0 (= hard BGD) outside keeps the
    # reference's 0 < countNonZero < w*h mask-path gate true
    mask = np.zeros((H, W), np.uint8)
    mask[10:38, 18:50] = gc.GC_PR_FGD
    rgba = np.dstack([img, mask])[None]
    out, p = _run(rgba, **{"test-mode": True})
    assert p.bus.pop(name="grabcut")
    true_fg = np.zeros((H, W), bool)
    true_fg[BLOB] = True
    kept = (out[0, :, :, :3] > 0).any(axis=-1)
    assert _iou(kept, true_fg) > 0.8

    # neither mask nor bbox: passthrough, no message
    rgba2 = np.dstack([img, np.zeros((H, W), np.uint8)])[None]
    out2, p2 = _run(rgba2, **{"test-mode": True})
    np.testing.assert_array_equal(out2[0], rgba2[0])
    assert not p2.bus.pop(name="grabcut")
