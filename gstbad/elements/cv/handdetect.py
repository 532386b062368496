"""handdetect (ext/opencv/gsthanddetect.cpp) — Haar-cascade hand gesture
detection with the reference's OWN in-tree fist/palm models
(gstbad/data/fist.xml, palm.xml — see data/README.md).

Per frame (gsthanddetect.cpp transform_ip): gray conversion, FIST
cascade first; only when no fist is found, PALM; the best detection is
the one nearest (top-left distance) to the previous frame's best
(carried scan state); a `hand-gesture` message posts when the gesture
center falls in the ROI (or the ROI is the 0,0,0,0 default); display
draws the CV_RGB(0,0,200) circle of radius (w+h)/4 at the center.

Divergences (documented): detection uses ops/haar.py's engine —
image-pyramid scale-factor 1.1 sweep, stride-2 windows, 3x3
neighbor-count confirmation in place of cv::groupRectangles (cv2 5.0
removed objdetect, so OpenCV's exact stepping cannot be cross-checked
here); the best candidate is an individual confirmed window rather than
a cluster average; the circle rasterizes as a |dist - r| <= 0.5 ring
rather than Bresenham's; messages carry gesture ids (1 = fist,
2 = palm)."""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from gstbad.core.element import Property, VideoFilter
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import VideoFormat
from gstbad.io.haarcascade import parse_cascade
from gstbad.ops import cv as cvops
from gstbad.ops import haar

_DATA = os.path.join(os.path.dirname(__file__), "..", "..", "data")
MIN_NEIGHBORS = 2          # detectMultiScale(..., 1.1, 2, ...)


@register
class HandDetect(VideoFilter):
    NAME = "handdetect"
    FORMATS = (VideoFormat.RGB,)
    PROPERTIES = (
        # the reference spells these profile_fist/ROI_X etc. (a marked
        # FIXME in gsthanddetect.cpp); set_property normalizes _ to -
        Property("display", bool, True, static=True),
        Property("profile-fist", str,
                 os.path.normpath(os.path.join(_DATA, "fist.xml")),
                 static=True),
        Property("profile-palm", str,
                 os.path.normpath(os.path.join(_DATA, "palm.xml")),
                 static=True),
        Property("roi-x", int, 0, 0, None, static=True),
        Property("roi-y", int, 0, 0, None, static=True),
        Property("roi-width", int, 0, 0, None, static=True),
        Property("roi-height", int, 0, 0, None, static=True),
    )

    def prepare(self):
        self._fist = parse_cascade(self.props["profile-fist"])
        self._palm = parse_cascade(self.props["profile-palm"])

    def init_state(self, window: int):
        # prev_r starts as Rect(0, 0, 0, 0) (gsthanddetect.cpp temp_r)
        return jnp.zeros(2, jnp.float32)

    def process(self, params, state, batch: FrameBatch):
        img = batch.data
        b, h, w, _ = img.shape
        gray = cvops.rgb2gray_u8(img)

        def all_scales(g, cascade):
            scales = haar.detect_multi_scale(g, cascade,
                                             min_neighbors=MIN_NEIGHBORS)
            cand = []
            for s in scales:
                ok = s["passed"] & (s["counts"] >= MIN_NEIGHBORS)
                ny, nx = ok.shape
                f = s["factor"]
                ww, wh = s["size"]
                ygrid, xgrid = np.meshgrid(
                    np.arange(ny) * haar.STRIDE * f,
                    np.arange(nx) * haar.STRIDE * f, indexing="ij")
                cand.append((ok.reshape(-1),
                             jnp.asarray(xgrid.reshape(-1), jnp.float32),
                             jnp.asarray(ygrid.reshape(-1), jnp.float32),
                             float(ww), float(wh)))
            valid = jnp.concatenate([c[0] for c in cand])
            cx = jnp.concatenate([c[1] for c in cand])
            cy = jnp.concatenate([c[2] for c in cand])
            cw = jnp.concatenate([jnp.full(c[0].shape, c[3]) for c in cand])
            ch = jnp.concatenate([jnp.full(c[0].shape, c[4]) for c in cand])
            return valid, cx, cy, cw, ch

        fist = jax.vmap(lambda g: all_scales(g, self._fist))(gray)
        palm = jax.vmap(lambda g: all_scales(g, self._palm))(gray)

        def step(prev, inp):
            (fv, fx, fy, fw, fh), (pv, px, py, pw, ph) = inp
            has_fist = fv.any()
            has_palm = pv.any()

            def best(valid, x, y, ww, hh):
                d2 = (x - prev[0]) ** 2 + (y - prev[1]) ** 2
                d2 = jnp.where(valid, d2, jnp.inf)
                i = jnp.argmin(d2)
                return x[i], y[i], ww[i], hh[i]

            bx, by, bw, bh = lax.cond(
                has_fist, lambda: best(fv, fx, fy, fw, fh),
                lambda: best(pv, px, py, pw, ph))
            found = has_fist | has_palm
            gesture = jnp.where(has_fist, 1, jnp.where(has_palm, 2, 0))
            new_prev = jnp.where(found, jnp.stack([bx, by]), prev)
            return new_prev, (gesture.astype(jnp.int32), bx, by, bw, bh,
                              found)

        state, (gesture, bx, by, bw, bh, found) = lax.scan(
            step, state, (fist, palm))

        cx = bx + bw * 0.5
        cy = by + bh * 0.5
        rx, ry = self.props["roi-x"], self.props["roi-y"]
        rw, rh = self.props["roi-width"], self.props["roi-height"]
        roi_default = rx == 0 and ry == 0 and rw == 0 and rh == 0
        in_roi = ((cx >= rx) & (cx <= rx + rw)
                  & (cy >= ry) & (cy <= ry + rh)) | bool(roi_default)
        emit = found & in_roi
        msgs = {"hand-gesture": {
            "gesture": gesture,
            "x": (bx + bw * 0.5).astype(jnp.int32),
            "y": (by + bh * 0.5).astype(jnp.int32),
            "width": bw.astype(jnp.int32),
            "height": bh.astype(jnp.int32),
            "_emit": emit,
        }}

        out = img
        if self.props["display"]:
            yy = jnp.arange(h, dtype=jnp.float32)[None, :, None]
            xx = jnp.arange(w, dtype=jnp.float32)[None, None, :]
            cxr = jnp.round(cx)[:, None, None]
            cyr = jnp.round(cy)[:, None, None]
            radius = jnp.round((bw + bh) * 0.25)[:, None, None]
            dist = jnp.sqrt((xx - cxr) ** 2 + (yy - cyr) ** 2)
            ring = (jnp.abs(dist - radius) <= 0.5) & \
                found[:, None, None]
            marker = jnp.asarray([0, 0, 200], jnp.uint8)
            out = jnp.where(ring[..., None], marker, img)
        return state, batch.with_data(out), msgs
