"""grabcut element (ext/opencv/gstgrabcut.cpp) over ops/grabcut.py.

Reference behavior (gst_grabcut_transform_ip): RGBA in; the alpha plane
IS the GrabCut seed mask when it has content (values clamped to
GC_PR_FGD=3, compose_matrix_from_image); otherwise a bounding box (the
reference reads a face RegionOfInterest meta and grows it by `scale`;
here the bbox arrives via properties — our message/meta analog) seeds
GC_INIT_WITH_RECT; with neither, the frame passes through untouched.
test-mode ANDs the (FGD|PR_FGD) mask into the RGB channels and draws the
CV_RGB(255,0,255) bbox rectangle.  The refined mask is NOT written back
to the alpha channel — matching the reference, whose 4-channel merge
leaves the buffer's alpha as it was.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gstbad.core.element import Property, VideoFilter
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import VideoFormat, require
from gstbad.ops import grabcut as gcops


@register
class GrabCut(VideoFilter):
    NAME = "grabcut"
    FORMATS = (VideoFormat.RGBA,)
    PROPERTIES = (
        Property("test-mode", bool, False, static=True),
        Property("scale", float, 1.6, 1.0, 4.0, static=True),
        # bbox analog of the RegionOfInterest meta (x, y, w, h)
        Property("bbox-x", int, 0, 0, None, static=True),
        Property("bbox-y", int, 0, 0, None, static=True),
        Property("bbox-width", int, 0, 0, None, static=True),
        Property("bbox-height", int, 0, 0, None, static=True),
    )

    def _facepos(self):
        """The scale-grown box (gstgrabcut.cpp:300-303)."""
        s = self.props["scale"]
        mx, my = self.props["bbox-x"], self.props["bbox-y"]
        mw, mh = self.props["bbox-width"], self.props["bbox-height"]
        return (int(mx - (s - 1) * mw / 2), int(my - (s - 1) * mh / 2),
                int(mw * s * 0.9), int(mh * s * 1.1))

    def process(self, params, state, batch: FrameBatch):
        img = batch.data
        b, h, w, _ = img.shape
        rgb = img[..., :3]
        alpha = img[..., 3]
        fx, fy, fw, fh = self._facepos()
        have_bbox = abs(fw) > 2 and abs(fh) > 2
        rect_mask = (gcops.init_mask_from_rect(h, w, (fx, fy, fw, fh))
                     if have_bbox else None)

        def per_frame(frame_rgb, frame_alpha):
            alpha_mask = jnp.minimum(frame_alpha, gcops.GC_PR_FGD
                                     ).astype(jnp.uint8)
            n_alpha = jnp.count_nonzero(frame_alpha)
            use_alpha = (n_alpha > 0) & (n_alpha < h * w)
            if rect_mask is None:
                init = alpha_mask
                runnable = use_alpha
            else:
                init = jnp.where(use_alpha, alpha_mask, rect_mask)
                runnable = jnp.bool_(True)
            refined = gcops.grabcut(frame_rgb, init, iterations=1)
            fgmask = ((refined & 1) == 1) & runnable
            return fgmask, runnable

        fgmask, ran = jax.vmap(per_frame)(rgb, alpha)

        out = img
        if self.props["test-mode"]:
            keep = fgmask[..., None]
            new_rgb = jnp.where(keep, rgb, 0).astype(jnp.uint8)
            out = out.at[..., :3].set(
                jnp.where(ran[:, None, None, None], new_rgb, rgb))
            if have_bbox:
                yy = jnp.arange(h)[None, :, None]
                xx = jnp.arange(w)[None, None, :]
                on_edge = (((yy == fy) | (yy == fy + fh))
                           & (xx >= fx) & (xx <= fx + fw)) | \
                          (((xx == fx) | (xx == fx + fw))
                           & (yy >= fy) & (yy <= fy + fh))
                magenta = jnp.asarray([255, 0, 255], jnp.uint8)
                out = out.at[..., :3].set(
                    jnp.where(on_edge[..., None], magenta, out[..., :3]))
        msgs = {"grabcut": {"fg-pixels": fgmask.sum(axis=(1, 2))
                            .astype(jnp.int32),
                            "_emit": ran}}
        return state, batch.with_data(out), msgs
