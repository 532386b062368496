"""faceoverlay: detector=skin window search + overlay compositing
(gstfaceoverlay.c positioning semantics; the synthetic skin-blob frame
is below Haar detection, so these pin detector="skin" — the Haar
default path is covered by tests/test_facedetect.py)."""

import numpy as np
import jax.numpy as jnp
import pytest

import gstbad as gt
from gstbad.core.frame import FrameBatch
from gstbad.core.pipeline import Pipeline
from gstbad.core.spec import MediaSpec


def _frame_with_face(h=64, w=96, fy=16, fx=40, fh=28, fw=22):
    """Blue background with a skin-colored rectangle (HSV rules: hue in
    (10,20], sat>48, val>80 — e.g. RGB(200,140,90))."""
    img = np.zeros((h, w, 4), np.uint8)
    img[..., 2] = 180  # blue-ish background (RGBx: byte2 = B)
    img[fy:fy + fh, fx:fx + fw, 0] = 200
    img[fy:fy + fh, fx:fx + fw, 1] = 140
    img[fy:fy + fh, fx:fx + fw, 2] = 90
    return img


def _overlay_png(tmp_path):
    from PIL import Image
    o = np.zeros((16, 16, 4), np.uint8)
    o[..., 1] = 255   # green
    o[..., 3] = 255   # opaque
    p = tmp_path / "over.png"
    Image.fromarray(o, "RGBA").save(p)
    return str(p)


def test_face_message_and_overlay(rng, tmp_path):
    loc = _overlay_png(tmp_path)
    el = gt.make("faceoverlay", location=loc, detector="skin")
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="RGBx", width=96, height=64))
    img = np.stack([_frame_with_face()] * 2)
    outs = p.run(inputs=FrameBatch.make(jnp.asarray(img)))
    out = np.asarray(outs[0].data)
    msgs = p.bus.pop(element="faceoverlay")
    assert msgs, "face message expected"
    m = msgs[0]
    # the detected box overlaps the skin rectangle
    assert m["x"] < 40 + 22 and m["x"] + m["width"] > 40
    assert m["y"] < 16 + 28 and m["y"] + m["height"] > 16
    # the overlay painted green pixels in/near the face region
    green = (out[0, :, :, 1] == 255) & (out[0, :, :, 0] == 0)
    assert green.any()
    ys, xs = np.nonzero(green)
    assert xs.min() >= m["x"] - 1 and ys.min() >= m["y"] - 1


def test_no_face_no_overlay(rng, tmp_path):
    loc = _overlay_png(tmp_path)
    el = gt.make("faceoverlay", location=loc, detector="skin")
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="RGBx", width=96, height=64))
    img = np.zeros((1, 64, 96, 4), np.uint8)  # no skin anywhere
    outs = p.run(inputs=FrameBatch.make(jnp.asarray(img)))
    out = np.asarray(outs[0].data)
    np.testing.assert_array_equal(out, img)
    assert not p.bus.pop(element="faceoverlay")


def test_offsets_scale_overlay(rng, tmp_path):
    """w/h scale the overlay relative to the face box
    (gstfaceoverlay.c:242-246)."""
    loc = _overlay_png(tmp_path)
    el = gt.make("faceoverlay", location=loc, detector="skin", w=0.5, h=0.5)
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="RGBx", width=96, height=64))
    img = np.stack([_frame_with_face()])
    outs = p.run(inputs=FrameBatch.make(jnp.asarray(img)))
    out = np.asarray(outs[0].data)
    m = p.bus.pop(element="faceoverlay")[0]
    green = (out[0, :, :, 1] == 255) & (out[0, :, :, 0] == 0)
    ys, xs = np.nonzero(green)
    assert len(xs)
    assert xs.max() - xs.min() + 1 <= int(0.5 * m["width"]) + 1
