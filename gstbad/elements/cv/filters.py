"""opencv element family (reference: /root/reference/ext/opencv/).

The reference wraps OpenCV behind GstOpencvVideoFilter; here each element is
the same composition (gray conversion, the cv op, the mask/display logic)
over ops/cv.py's JAX implementations — which are verified against cv2
itself in tests/test_cv.py (OpenCV is present in this environment and is
the oracle, exactly the library the reference calls).

Caps follow the reference: the gray-analysis elements take RGB
(gstcvsobel.cpp:66-76), equalizehist takes GRAY8
(gstcvequalizehist.cpp:69-76); dilate/erode/smooth accept any packed video.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from gstbad.core.element import Element, Property, VideoFilter
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import VideoFormat
from gstbad.ops import cv as cvops


class _RGBFilter(VideoFilter):
    FORMATS = (VideoFormat.RGB,)


@register
class CvSobel(_RGBFilter):
    """cvsobel (gstcvsobel.cpp:258-273): RGB -> gray -> cv::Sobel(CV_8U)
    -> mask ? img.copyTo(out, sobel) : gray2rgb(sobel)."""

    NAME = "cvsobel"
    PROPERTIES = (
        Property("x-order", int, 1, 0, 2, static=True),
        Property("y-order", int, 0, 0, 2, static=True),
        Property("aperture-size", int, 3, 1, 7, static=True,
                 doc="1, 3, 5 or 7 (gstcvsobel.cpp:156)"),
        Property("mask", bool, True, static=True),
    )

    def process(self, params, state, batch: FrameBatch):
        gray = cvops.rgb2gray_u8(batch.data)
        edge = cvops.sobel_u8(gray, self.props["x-order"],
                              self.props["y-order"],
                              self.props["aperture-size"])
        if self.props["mask"]:
            out = cvops.apply_mask_rgb(batch.data, edge)
        else:
            out = cvops.gray2rgb(edge)
        return state, batch.with_data(out)


@register
class CvLaplace(_RGBFilter):
    """cvlaplace (gstcvlaplace.cpp:261-280): gray -> Laplacian(CV_16S)
    -> convertTo(CV_8U, scale, shift) -> mask/gray2rgb."""

    NAME = "cvlaplace"
    PROPERTIES = (
        Property("aperture-size", int, 3, 1, 7, static=True),
        Property("scale", float, 1.0, controllable=True),
        Property("shift", float, 0.0, controllable=True),
        Property("mask", bool, True, static=True),
    )

    def process(self, params, state, batch: FrameBatch):
        gray = cvops.rgb2gray_u8(batch.data)
        lap = cvops.laplacian_i16(gray, self.props["aperture-size"])
        lap8 = jnp.clip(jnp.round(lap.astype(jnp.float32)
                                  * params["scale"] + params["shift"]),
                        0, 255).astype(jnp.uint8)
        if self.props["mask"]:
            out = cvops.apply_mask_rgb(batch.data, lap8)
        else:
            out = cvops.gray2rgb(lap8)
        return state, batch.with_data(out)


@register
class CvSmooth(VideoFilter):
    """cvsmooth (gstcvsmooth.cpp:385-430): blur/gaussian/median/bilateral,
    optionally restricted to a position/width/height ROI (the reference
    smooths the ROI in place and leaves the rest untouched)."""

    NAME = "cvsmooth"
    FORMATS = VideoFormat.PACKED_RGB4 + VideoFormat.PACKED_RGB3 + (
        VideoFormat.GRAY8,)
    PROPERTIES = (
        Property("type", str, "gaussian", static=True,
                 doc="blur | gaussian | median | bilateral"),
        Property("kernel-width", int, 3, 1, None, static=True),
        Property("kernel-height", int, 3, 0, None, static=True),
        Property("color", float, 0.0, 0.0, None, static=True),
        Property("spatial", float, 0.0, 0.0, None, static=True),
        Property("position-x", int, 0, 0, None, static=True),
        Property("position-y", int, 0, 0, None, static=True),
        Property("width", int, 1 << 30, 0, None, static=True),
        Property("height", int, 1 << 30, 0, None, static=True),
    )

    def _smooth(self, img):
        kind = self.props["type"]
        kw = self.props["kernel-width"]
        kh = self.props["kernel-height"]
        if kind == "blur":
            return cvops.box_blur_u8(img, kw, kh)
        if kind == "gaussian":
            return cvops.gaussian_blur_u8(img, kw, kh, self.props["color"])
        if kind == "median":
            return cvops.median_blur_u8(img, kw)
        if kind == "bilateral":
            return cvops.bilateral_u8(img, self.props["color"],
                                      self.props["spatial"])
        raise ValueError(f"cvsmooth: unknown type {kind!r}")

    def process(self, params, state, batch: FrameBatch):
        img = batch.data
        gray = img.ndim == 3  # GRAY8 [B, H, W]
        if gray:
            img = img[..., None]
        h, w = img.shape[1], img.shape[2]
        px, py = self.props["position-x"], self.props["position-y"]
        rw = min(self.props["width"], w - px)
        rh = min(self.props["height"], h - py)
        full_roi = px == 0 and py == 0 and rw == w and rh == h
        if px >= w or py >= h or rw <= 0 or rh <= 0:
            out = img  # effect entirely outside (gstcvsmooth.cpp:394-400)
        elif full_roi:
            out = self._smooth(img)
        else:
            # the reference smooths the ROI as its own Mat view: borders
            # reflect at the ROI edges, not the frame edges
            roi = img[:, py:py + rh, px:px + rw]
            sm = self._smooth(roi)
            out = img.at[:, py:py + rh, px:px + rw].set(sm)
        if gray:
            out = out[..., 0]
        return state, batch.with_data(out)


@register
class CvDilate(VideoFilter):
    """cvdilate (gstcvdilate.cpp:104-111): cv::dilate, default 3x3 kernel."""

    NAME = "cvdilate"
    FORMATS = VideoFormat.PACKED_RGB4 + VideoFormat.PACKED_RGB3 + (
        VideoFormat.GRAY8,)
    PROPERTIES = (Property("iterations", int, 1, 1, 64, static=True),)
    _OP = staticmethod(cvops.dilate_u8)

    def process(self, params, state, batch: FrameBatch):
        img = batch.data
        gray = img.ndim == 3
        if gray:
            img = img[..., None]
        out = self._OP(img, self.props["iterations"])
        if gray:
            out = out[..., 0]
        return state, batch.with_data(out)


@register
class CvErode(CvDilate):
    """cverode (gstcverode.cpp): cv::erode."""

    NAME = "cverode"
    _OP = staticmethod(cvops.erode_u8)


@register
class CvEqualizeHist(VideoFilter):
    """cvequalizehist (gstcvequalizehist.cpp:117-121): cv::equalizeHist on
    GRAY8."""

    NAME = "cvequalizehist"
    FORMATS = (VideoFormat.GRAY8,)

    def process(self, params, state, batch: FrameBatch):
        return state, batch.with_data(cvops.equalize_hist_u8(batch.data))


@register
class EdgeDetect(_RGBFilter):
    """edgedetect (gstedgedetect.cpp:259-276): gray -> cv::Canny ->
    mask/gray2rgb.  threshold1/2 defaults 50/150 (gstedgedetect.cpp:184-185).
    """

    NAME = "edgedetect"
    PROPERTIES = (
        Property("threshold1", int, 50, 0, 1000, static=True),
        Property("threshold2", int, 150, 0, 1000, static=True),
        Property("aperture-size", int, 3, 3, 7, static=True),
        Property("mask", bool, True, static=True),
    )

    def process(self, params, state, batch: FrameBatch):
        gray = cvops.rgb2gray_u8(batch.data)
        edge = cvops.canny_u8(gray, self.props["threshold1"],
                              self.props["threshold2"],
                              self.props["aperture-size"])
        if self.props["mask"]:
            out = cvops.apply_mask_rgb(batch.data, edge)
        else:
            out = cvops.gray2rgb(edge)
        return state, batch.with_data(out)


@register
class Retinex(_RGBFilter):
    """retinex (gstretinex.cpp:333-411): basic (single-scale) or multiscale
    log-domain enhancement; multiscale uses weights 1/scales and sigmas
    10+4*scales as the reference computes them (:374-386)."""

    NAME = "retinex"
    PROPERTIES = (
        Property("method", str, "basic", static=True,
                 doc="basic | multiscale"),
        Property("scales", int, 3, 1, 4, static=True),
        Property("sigma", float, 14.0, 0.0, None, static=True),
        Property("gain", int, 128, 0, None, static=True),
        Property("offset", int, 128, 0, None, static=True),
    )

    def process(self, params, state, batch: FrameBatch):
        if self.props["method"] == "multiscale":
            out = cvops.retinex_multiscale(batch.data, self.props["scales"],
                                           self.props["gain"],
                                           self.props["offset"])
        else:
            out = cvops.retinex_basic(batch.data, self.props["sigma"],
                                      self.props["gain"],
                                      self.props["offset"])
        return state, batch.with_data(out)


@register
class TemplateMatch(_RGBFilter):
    """templatematch (gsttemplatematch.cpp:289-386): cv::matchTemplate +
    minMaxLoc per frame, posts a `template_match` message {x, y, width,
    height, result}; display draws a 3px rectangle at the best match.

    The template property is an image path (loaded with cv2.imread like the
    reference's PROP_TEMPLATE setter) or a .npy of shape [th, tw, 3]; tests
    use set_template(ndarray).
    """

    NAME = "templatematch"
    PROPERTIES = (
        Property("method", str, "ccorr-normed", static=True,
                 doc="sqdiff | sqdiff-normed | ccorr | ccorr-normed | "
                     "ccoeff | ccoeff-normed (gsttemplatematch.cpp:212-233)"),
        Property("template", str, "", static=True),
        Property("display", bool, True, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._templ: np.ndarray | None = None
        if self.props["template"]:
            self.set_template(self._load(self.props["template"]))

    @staticmethod
    def _load(path: str) -> np.ndarray:
        if path.endswith(".npy"):
            return np.load(path)
        import cv2
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(f"templatematch: cannot read {path!r}")
        return img[..., ::-1]  # BGR -> RGB

    def set_template(self, templ: np.ndarray) -> None:
        if templ.ndim != 3 or templ.shape[-1] != 3:
            raise ValueError("template must be [th, tw, 3] u8")
        self._templ = templ.astype(np.uint8)

    def process(self, params, state, batch: FrameBatch):
        if self._templ is None:
            return state, batch
        method = self.props["method"].replace("-", "_")
        img = batch.data
        b, h, w, _ = img.shape
        score = cvops.match_template(img, jnp.asarray(self._templ), method)
        th, tw, _ = self._templ.shape
        flat = score.reshape(b, -1)
        if method.startswith("sqdiff"):
            idx = jnp.argmin(flat, axis=1)
        else:
            idx = jnp.argmax(flat, axis=1)
        best = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0]
        if method == "sqdiff_normed":
            best = 1.0 - best  # gsttemplatematch.cpp:299-301
        sw = score.shape[2]
        ys = (idx // sw).astype(jnp.int32)
        xs = (idx % sw).astype(jnp.int32)
        out = img
        if self.props["display"]:
            # cv::rectangle(img, best_pos, best_pos+templ_size, color, 3):
            # a 3px border centered on the rectangle edges
            ii = jnp.arange(h)[None, :, None]
            jj = jnp.arange(w)[None, None, :]
            y0 = ys[:, None, None]
            x0 = xs[:, None, None]
            y1 = y0 + th
            x1 = x0 + tw
            on_h = ((jnp.abs(ii - y0) <= 1) | (jnp.abs(ii - y1) <= 1)) & \
                   (jj >= x0 - 1) & (jj <= x1 + 1)
            on_v = ((jnp.abs(jj - x0) <= 1) | (jnp.abs(jj - x1) <= 1)) & \
                   (ii >= y0 - 1) & (ii <= y1 + 1)
            border = on_h | on_v
            if method.endswith("_normed"):
                # yellow growing redder as certainty -> 1 (":365-369")
                g = jnp.clip(255.0 - jnp.power(255.0, best), 0, 255
                             ).astype(jnp.uint8)
            else:
                g = jnp.full((b,), 32, jnp.uint8)
            color = jnp.stack([jnp.full((b,), 255, jnp.uint8), g,
                               jnp.full((b,), 32, jnp.uint8)], -1)
            out = jnp.where(border[..., None], color[:, None, None, :], img)
        msgs = {"template_match": {
            "x": xs, "y": ys,
            "width": jnp.full((b,), tw, jnp.int32),
            "height": jnp.full((b,), th, jnp.int32),
            "result": best.astype(jnp.float64),
        }}
        return state, batch.with_data(out), msgs
