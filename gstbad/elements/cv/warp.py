"""Remap-engine clients of the opencv family: cameraundistort + dewarp.

Both precompute float maps on the host at caps time (the reference builds
CV_16SC2 fixed-point maps, gstcameraundistort.cpp:341-357 /
gstdewarp.cpp:438-478) and run one bilinear remap per frame on device
(ops/remap.remap_bilinear — bit-exact vs cv2's CV_16SC2 INTER_LINEAR path).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from gstbad.core.element import Property, VideoFilter
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import MediaSpec, VideoFormat
from gstbad.ops import remap as remap_ops


@register
class CameraUndistort(VideoFilter):
    """cameraundistort (gstcameraundistort.cpp): lens-distortion correction.

    The reference receives its calibration as a serialized GstStructure
    ("settings", from cameracalibrate's event); here the calibration is
    given directly as camera-matrix ("fx 0 cx 0 fy cy 0 0 1") and
    distortion-coeffs ("k1 k2 p1 p2 k3") properties, or via
    set_calibration(K, dist).  alpha blends the inscribed/bounding
    rectangles of getOptimalNewCameraMatrix; crop draws the valid-pixel ROI
    rectangle (the reference only draws it too — gstcameraundistort.cpp:
    330-334 "TODO do the cropping").
    """

    NAME = "cameraundistort"
    FORMATS = VideoFormat.PACKED_RGB4 + VideoFormat.PACKED_RGB3 + (
        VideoFormat.GRAY8,)
    PROPERTIES = (
        Property("show-undistorted", bool, True, static=True),
        Property("alpha", float, 0.0, 0.0, 1.0, static=True),
        Property("crop", bool, False, static=True),
        Property("camera-matrix", str, "", static=True),
        Property("distortion-coeffs", str, "", static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._K = None
        self._dist = None
        if self.props["camera-matrix"]:
            vals = [float(v) for v in
                    self.props["camera-matrix"].replace(",", " ").split()]
            if len(vals) != 9:
                raise ValueError("camera-matrix needs 9 values")
            K = np.array(vals).reshape(3, 3)
            d = [float(v) for v in
                 self.props["distortion-coeffs"].replace(",", " ").split()
                 ] if self.props["distortion-coeffs"] else [0.0] * 5
            self.set_calibration(K, d)

    def set_calibration(self, K: np.ndarray, dist) -> None:
        """The cameracalibrate-event analog."""
        self._K = np.asarray(K, np.float64)
        self._dist = list(dist)
        self._maps = None

    def prepare(self):
        self._maps = None
        if self._K is None or not self.props["show-undistorted"]:
            return
        spec = self.out_spec
        size = (spec.width, spec.height)
        newK = remap_ops.get_optimal_new_camera_matrix(
            self._K, self._dist, size, self.props["alpha"])
        self._maps = remap_ops.init_undistort_map(
            self._K, self._dist, newK, size)
        # valid-pixel ROI from the inner rectangle mapped through newK
        inner, _ = remap_ops._get_rectangles(self._K, self._dist, size)
        x0 = int(np.ceil(inner[0] * newK[0, 0] + newK[0, 2]))
        y0 = int(np.ceil(inner[1] * newK[1, 1] + newK[1, 2]))
        x1 = int(np.floor((inner[0] + inner[2]) * newK[0, 0] + newK[0, 2]))
        y1 = int(np.floor((inner[1] + inner[3]) * newK[1, 1] + newK[1, 2]))
        self._roi = (max(x0, 0), max(y0, 0),
                     min(x1, spec.width - 1), min(y1, spec.height - 1))

    def process(self, params, state, batch: FrameBatch):
        if self._maps is None:
            return state, batch  # passthrough (gstcameraundistort.cpp:336)
        img = batch.data
        gray = img.ndim == 3
        if gray:
            img = img[..., None]
        mx, my = self._maps
        out = remap_ops.remap_bilinear(img, mx.astype(np.float32),
                                       my.astype(np.float32))
        if self.props["crop"]:
            # green valid-ROI rectangle (CROP_COLOR, :331-333)
            x0, y0, x1, y1 = self._roi
            h, w = out.shape[1], out.shape[2]
            ii = jnp.arange(h)[None, :, None]
            jj = jnp.arange(w)[None, None, :]
            border = (((ii == y0) | (ii == y1)) & (jj >= x0) & (jj <= x1)) | \
                     (((jj == x0) | (jj == x1)) & (ii >= y0) & (ii <= y1))
            color = np.zeros(out.shape[-1], np.uint8)
            if out.shape[-1] >= 3:
                color[1] = 255
            else:
                color[0] = 255
            out = jnp.where(border[..., None], jnp.asarray(color), out)
        if gray:
            out = out[..., 0]
        return state, batch.with_data(out)


def _round_up_8(v: int) -> int:
    return (v + 7) & ~7


@register
class Dewarp(VideoFilter):
    """dewarp (gstdewarp.cpp): 360-degree fisheye-donut unwrap.

    Output dims = ROUND_UP_8(2*pi*(r2+r1)/2) x ROUND_UP_8(r2-r1)
    (gst_dewarp_calculate_dimensions:481-527); display modes split the
    panorama into stacked halves or a 2x2 quad (:663-708).  Passthrough
    when outer-radius <= inner-radius.  interpolation-mode bilinear and
    nearest are supported; the reference's bicubic/lanczos modes fall back
    to bilinear (documented divergence).
    """

    NAME = "dewarp"
    FORMATS = (VideoFormat.RGBA,)
    PROPERTIES = (
        Property("x-center", float, 0.5, 0.0, 1.0, static=True),
        Property("y-center", float, 0.5, 0.0, 1.0, static=True),
        Property("inner-radius", float, 0.0, 0.0, 1.0, static=True),
        Property("outer-radius", float, 0.0, 0.0, 1.0, static=True),
        Property("remap-x-correction", float, 1.0, 0.1, 10.0, static=True),
        Property("remap-y-correction", float, 1.0, 0.1, 10.0, static=True),
        Property("display-mode", str, "single-panorama", static=True,
                 doc="single-panorama | double-panorama | quad-view"),
        Property("interpolation-method", str, "bilinear", static=True,
                 doc="nearest | bilinear"),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        spec = super().negotiate(in_spec)
        r1 = in_spec.width * self.props["inner-radius"]
        r2 = in_spec.width * self.props["outer-radius"]
        if self.props["outer-radius"] <= self.props["inner-radius"]:
            self._passthrough = True
            return spec
        self._passthrough = False
        out_w = _round_up_8(int((2.0 * np.pi) * ((r2 + r1) / 2.0)))
        out_h = _round_up_8(int(r2 - r1))
        if self.props["display-mode"] != "single-panorama":
            out_w //= 2
            out_h *= 2
        if out_w == 0 or out_h == 0:
            self._passthrough = True
            return spec
        self._in_w, self._in_h = in_spec.width, in_spec.height
        return spec.with_(width=out_w, height=out_h)

    def prepare(self):
        if self._passthrough:
            return
        spec = self.out_spec
        if self.props["display-mode"] == "single-panorama":
            map_w, map_h = spec.width, spec.height
        else:
            map_w, map_h = spec.width * 2, spec.height // 2
        self._maps = remap_ops.dewarp_map(
            self._in_w, self._in_h, map_w, map_h,
            self.props["x-center"], self.props["y-center"],
            self.props["inner-radius"], self.props["outer-radius"],
            self.props["remap-x-correction"], self.props["remap-y-correction"])

    def process(self, params, state, batch: FrameBatch):
        if self._passthrough:
            return state, batch
        mx, my = self._maps
        if self.props["interpolation-method"] == "nearest":
            from gstbad.ops.remap import fix_map
            mp = np.stack([mx, my], -1)
            flat, valid = fix_map(mp, self._in_w, self._in_h, "ignore")
            img = batch.data
            pano = remap_ops.remap(img, jnp.asarray(flat), jnp.asarray(valid),
                                   jnp.zeros(img.shape[-1], jnp.uint8))
            pano = pano.reshape(img.shape[0], my.shape[0], my.shape[1], -1)
        else:
            pano = remap_ops.remap_bilinear(batch.data, mx, my)
        mode = self.props["display-mode"]
        if mode == "single-panorama":
            out = pano
        elif mode == "double-panorama":
            w = pano.shape[2] // 2
            out = jnp.concatenate([pano[:, :, :w], pano[:, :, w:]], axis=1)
        else:  # quad-view (gstdewarp.cpp:682-707)
            vw = pano.shape[2] // 4
            v = [pano[:, :, i * vw:(i + 1) * vw] for i in range(4)]
            left = jnp.concatenate([v[0], v[1]], axis=1)
            right = jnp.concatenate([v[2], v[3]], axis=1)
            out = jnp.concatenate([left, right], axis=2)
        return state, batch.with_data(out)
