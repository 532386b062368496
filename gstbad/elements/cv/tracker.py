"""cvtracker (ext/opencv/gstcvtracker.cpp) over the MOSSE engine
(ops/mosse.py).

Reference behavior (gst_cvtracker_transform_ip): the first frame
initializes the tracker on the object-initial-* box; every later frame
updates it — on success an `object` element message posts the box (the
RegionOfInterest meta analog is the same payload) and draw-rect paints
the cv::Scalar(255, 0, 0) rectangle with thickness 2; on a lost track
nothing posts (and the tracker keeps trying).

The reference's algorithm enum (boosting/csrt/kcf/medianflow/mil/mosse/
tld) maps onto opencv_contrib classes that are absent from this cv2
build; `algorithm` here accepts only "mosse" (our deterministic
from-paper engine — ops/mosse.py documents the divergences).  The box
size stays fixed (MOSSE does not estimate scale; neither does the
reference's MOSSE)."""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from gstbad.core.element import Property, VideoFilter
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import VideoFormat, require
from gstbad.ops import cv as cvops
from gstbad.ops import mosse


@register
class CvTracker(VideoFilter):
    NAME = "cvtracker"
    FORMATS = (VideoFormat.RGB,)
    PROPERTIES = (
        Property("object-initial-x", int, 50, 0, None, static=True),
        Property("object-initial-y", int, 50, 0, None, static=True),
        Property("object-initial-width", int, 50, 1, None, static=True),
        Property("object-initial-height", int, 50, 1, None, static=True),
        Property("algorithm", str, "mosse", static=True),
        Property("draw-rect", bool, True, static=True),
    )

    def negotiate(self, in_spec):
        require(self.props["algorithm"] == "mosse",
                "cvtracker: only the mosse algorithm is available here "
                "(the reference's other trackers are opencv_contrib "
                "classes absent from this environment)")
        return super().negotiate(in_spec)

    def _box(self):
        return (self.props["object-initial-x"],
                self.props["object-initial-y"],
                self.props["object-initial-width"],
                self.props["object-initial-height"])

    def init_state(self, window: int):
        x, y, w, h = self._box()
        return {
            "a": jnp.zeros((h, w), jnp.complex64),
            "b": jnp.zeros((h, w), jnp.complex64),
            "cy": jnp.float32(0), "cx": jnp.float32(0),
            "ok": jnp.bool_(True),
            "inited": jnp.bool_(False),
        }

    def process(self, params, state, batch: FrameBatch):
        img = batch.data
        b, ih, iw, _ = img.shape
        x, y, w, h = self._box()
        gray = cvops.rgb2gray_u8(img)

        def step(st, g):
            inited = st["inited"]

            def do_init():
                s0 = mosse.init_state(g, (x, y, w, h))
                return ({**s0, "inited": jnp.bool_(True)},
                        (jnp.bool_(False), s0["cy"], s0["cx"]))

            def do_update():
                model = {k: st[k] for k in ("a", "b", "cy", "cx", "ok")}
                s1, ok, cy, cx = mosse.update(model, g, h, w)
                return ({**s1, "inited": jnp.bool_(True)},
                        (ok, cy, cx))

            return lax.cond(inited, do_update, do_init)

        state, (ok, cy, cx) = lax.scan(step, state, gray)

        bx = (cx - w / 2).astype(jnp.int32)
        by = (cy - h / 2).astype(jnp.int32)
        msgs = {"object": {"x": bx, "y": by,
                           "width": jnp.full(b, w, jnp.int32),
                           "height": jnp.full(b, h, jnp.int32),
                           "_emit": ok}}

        out = img
        if self.props["draw-rect"]:
            yy = jnp.arange(ih, dtype=jnp.int32)[None, :, None]
            xx = jnp.arange(iw, dtype=jnp.int32)[None, None, :]
            x0 = bx[:, None, None]
            y0 = by[:, None, None]
            x1 = x0 + w
            y1 = y0 + h
            # thickness-2 rectangle (cv::rectangle .., 2, ..)
            near_v = ((jnp.abs(xx - x0) <= 1) | (jnp.abs(xx - x1) <= 1)) \
                & (yy >= y0 - 1) & (yy <= y1 + 1)
            near_h = ((jnp.abs(yy - y0) <= 1) | (jnp.abs(yy - y1) <= 1)) \
                & (xx >= x0 - 1) & (xx <= x1 + 1)
            border = (near_v | near_h) & ok[:, None, None]
            color = jnp.asarray([255, 0, 0], jnp.uint8)
            out = jnp.where(border[..., None], color, img)
        return state, batch.with_data(out), msgs
