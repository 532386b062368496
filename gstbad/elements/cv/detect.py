"""Detection elements of the opencv family: skindetect + motioncells.

skindetect is stateless per-pixel classification; motioncells carries the
previous frame in its scan state and emits per-frame `motion` messages with
the motion-cell grid — the reference's string encoding ("i:j,i:j") is
available via MotionCells.indices_string().
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from gstbad.core.element import Property, VideoFilter
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import VideoFormat
from gstbad.ops import cv as cvops


@register
class SkinDetect(VideoFilter):
    """skindetect (gstskindetect.cpp:299-396): HSV or RGB rule-based skin
    mask, optional opening-closing postprocess (erode, 2x dilate, erode),
    output = GRAY2RGB of the mask."""

    NAME = "skindetect"
    FORMATS = (VideoFormat.RGB,)
    PROPERTIES = (
        Property("postprocess", bool, True, static=True),
        Property("method", str, "hsv", static=True, doc="hsv | rgb"),
    )

    def process(self, params, state, batch: FrameBatch):
        img = batch.data
        if self.props["method"] == "hsv":
            hsv = cvops.rgb2hsv_u8(img)
            h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
            h2 = cvops.threshold_binary(h, 10)            # hue > 10
            hm = cvops.threshold_binary(h, 20, inverse=True)  # hue <= 20
            sm = cvops.threshold_binary(s, 48)
            vm = cvops.threshold_binary(v, 80)
            # erode the HUE mask once (gstskindetect.cpp:324)
            hm = cvops.erode_u8(hm[..., None], 1)[..., 0]
            mask = hm & sm & h2 & vm
        else:  # RGB rules (gstskindetect.cpp:334-369)
            r = img[..., 0].astype(jnp.float32)
            g = img[..., 1].astype(jnp.float32)
            b = img[..., 2].astype(jnp.float32)
            # cv::add on u8 saturates at 255 BEFORE the f32 convert; the
            # reference adds into a CV_32F dst, so no saturation
            allc = r + g + b
            # cv::divide yields 0 where the divisor is 0
            rp = jnp.where(allc > 0, r / allc, 0.0)
            gp = jnp.where(allc > 0, g / allc, 0.0)
            m = ((r > 60) & (rp > 0.42) & (rp <= 0.6)
                 & (gp > 0.28) & (gp <= 0.4))
            mask = jnp.where(m, jnp.uint8(255), jnp.uint8(0))
        if self.props["postprocess"]:
            m4 = mask[..., None]
            m4 = cvops.erode_u8(m4, 1)
            m4 = cvops.dilate_u8(m4, 2)
            m4 = cvops.erode_u8(m4, 1)
            mask = m4[..., 0]
        return state, batch.with_data(cvops.gray2rgb(mask))


@register
class MotionCells(VideoFilter):
    """motioncells (gstmotioncells.cpp + MotionCells.cpp:105-425):
    grid-based motion detection.

    Per frame: pyrDown to half size, gray, absdiff vs the previous
    half-gray frame, adaptiveThreshold(GAUSSIAN, INV, 7, 5), dilate x2 +
    erode x2, per-cell motion ratio vs (1 - sensitivity)
    (calculateMotionPercentInCell, MotionCells.cpp:390-425 — the
    reference's early-exit floor quirks are not reproduced; the decision is
    the exact ratio > 1-sensitivity).  Emits a `motion` message per frame
    with the boolean cell grid and has_motion (cells beyond `threshold`
    fraction); display paints cell rectangles.

    The previous half-res gray frame is scan state, so windows stay fused;
    framerate-based frame skipping (sumframecnt, MotionCells.cpp:119-128)
    is not applied (every frame is analyzed).
    """

    NAME = "motioncells"
    FORMATS = (VideoFormat.RGB,)
    PROPERTIES = (
        Property("gridx", int, 10, 1, 32, static=True),
        Property("gridy", int, 10, 1, 32, static=True),
        Property("sensitivity", float, 0.5, 0.0, 1.0, controllable=True),
        Property("threshold", float, 0.01, 0.0, 1.0, controllable=True),
        Property("display", bool, True, static=True),
        Property("postallmotion", bool, False, static=True),
        Property("cellscolor", str, "255,0,0", static=True),
    )

    def init_state(self, window: int):
        spec = self.out_spec
        hh, hw = spec.height // 2, spec.width // 2
        return {"prev": jnp.zeros((hh, hw), jnp.uint8),
                "primed": jnp.zeros((), jnp.bool_)}

    def prepare(self):
        self._color = np.array(
            [int(v) for v in self.props["cellscolor"].split(",")], np.uint8)

    @staticmethod
    def indices_string(grid: np.ndarray) -> str:
        """The reference's motioncellsidx encoding "line:col,line:col"
        (MotionCells.cpp:209-222)."""
        ys, xs = np.nonzero(np.asarray(grid))
        return ",".join(f"{i}:{j}" for i, j in zip(ys, xs)) or " "

    def process(self, params, state, batch: FrameBatch):
        img = batch.data
        b, h, w, _ = img.shape
        gx, gy = self.props["gridx"], self.props["gridy"]
        half = cvops.pyr_down_u8(img)
        gray = cvops.rgb2gray_u8(half)
        hh, hw = gray.shape[1], gray.shape[2]

        # sequential prev-frame chain across the window
        prevs = jnp.concatenate([state["prev"][None], gray[:-1]], axis=0)
        diff = jnp.abs(gray.astype(jnp.int32) - prevs.astype(jnp.int32)
                       ).astype(jnp.uint8)
        bw = cvops.adaptive_threshold_gaussian_inv(diff, 7, 5)
        bw4 = cvops.dilate_u8(bw[..., None], 2)
        bw4 = cvops.erode_u8(bw4, 2)
        moving = (bw4[..., 0] > 0)

        # per-cell ratios on the half-res image; cell bounds floor(j*cw)
        cw = hw / gx
        ch = hh / gy
        col_of = (np.arange(hw)[None, :] >= np.floor(
            np.arange(gx)[:, None] * cw)).sum(0) - 1
        row_of = (np.arange(hh)[None, :] >= np.floor(
            np.arange(gy)[:, None] * ch)).sum(0) - 1
        cell_id = (row_of[:, None] * gx + col_of[None, :]).astype(np.int32)
        ids = jnp.asarray(cell_id.reshape(-1))
        counts = jnp.zeros((b, gy * gx), jnp.int32).at[
            :, ids].add(moving.reshape(b, -1).astype(jnp.int32))
        areas = jnp.asarray(np.bincount(cell_id.reshape(-1),
                                        minlength=gy * gx).astype(np.int32))
        ratio = counts / jnp.maximum(areas, 1)
        sens = 1.0 - params["sensitivity"]
        has = (ratio > sens).reshape(b, gy, gx)
        # the reference only scores cells when the bw image is nonzero at
        # all (MotionCells.cpp:174)
        any_moving = moving.reshape(b, -1).any(axis=1)
        has = has & any_moving[:, None, None]
        n_motion = has.reshape(b, -1).sum(axis=1)
        frame_motion = n_motion > params["threshold"] * (gx * gy)

        out = img
        if self.props["display"]:
            # paint cell rectangles at full res (cell bounds * 2)
            y_full = jnp.asarray(np.repeat(row_of, 2)[:h])
            x_full = jnp.asarray(np.repeat(col_of, 2)[:w])
            cell_full = has[:, y_full][:, :, x_full]
            # 1px border of each motion cell
            ys = np.repeat(row_of, 2)[:h]
            xs = np.repeat(col_of, 2)[:w]
            edge_y = jnp.asarray(np.concatenate(
                [[True], ys[1:] != ys[:-1]]) | np.concatenate(
                [ys[1:] != ys[:-1], [True]]))
            edge_x = jnp.asarray(np.concatenate(
                [[True], xs[1:] != xs[:-1]]) | np.concatenate(
                [xs[1:] != xs[:-1], [True]]))
            border = cell_full & (edge_y[None, :, None]
                                  | edge_x[None, None, :])
            out = jnp.where(border[..., None], jnp.asarray(self._color), img)

        new_state = {"prev": gray[-1], "primed": jnp.ones((), jnp.bool_)}
        emit = (frame_motion | bool(self.props["postallmotion"]))
        # the first ever frame has no previous frame to diff against
        first = ~state["primed"]
        emit = emit & ~(first & (jnp.arange(b) == 0))
        msgs = {"motion": {"cells": has, "n_motion": n_motion,
                           "has_motion": frame_motion,
                           "_emit": emit}}
        return new_state, batch.with_data(out), msgs
