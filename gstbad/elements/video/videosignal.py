"""videosignal — videoanalyse, simplevideomark, simplevideomarkdetect
(gst/videosignal/)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from gstbad.core.element import Property, VideoFilter
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import MediaSpec, VideoFormat, require


class _LumaPlanarFilter(VideoFilter):
    FORMATS = (VideoFormat.I420, VideoFormat.GRAY8, VideoFormat.AYUV)

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "video", f"{self.NAME}: needs video")
        require(in_spec.format in self.FORMATS,
                f"{self.NAME}: format {in_spec.format} unsupported")
        return in_spec

    def _luma(self, data):
        if isinstance(data, dict):
            return data["y"]
        if self.out_spec.format == VideoFormat.AYUV:
            return data[..., 1]
        return data

    def _set_luma(self, data, y):
        if isinstance(data, dict):
            return {**data, "y": y}
        if self.out_spec.format == VideoFormat.AYUV:
            return data.at[..., 1].set(y)
        return y


@register
class VideoAnalyse(_LumaPlanarFilter):
    """gstvideoanalyse.c: per-frame luma average/variance message.

    Keeps the reference's integer-average quirk: the variance is computed
    against avg = sum // (w*h) (gstvideoanalyse.c:228-242)."""

    NAME = "videoanalyse"
    PROPERTIES = (Property("message", bool, True),)

    def process(self, params, state, batch: FrameBatch):
        y = self._luma(batch.data).astype(jnp.int64)
        h, w = y.shape[-2], y.shape[-1]
        area = h * w
        s = jnp.sum(y, axis=(-2, -1))
        avg_int = s // area
        luma_average = s.astype(jnp.float64) / (255.0 * area)
        diff = avg_int[:, None, None] - y
        var = jnp.sum(diff * diff, axis=(-2, -1))
        luma_variance = var.astype(jnp.float64) / (255.0 * 255.0 * area)
        msgs = {"GstVideoAnalyse": {
            "_emit": jnp.broadcast_to(params["message"], (y.shape[0],)),
            "luma-average": luma_average,
            "luma-variance": luma_variance,
        }}
        return state, batch, msgs


def _pattern_geometry(width, height, pattern_width, pattern_height,
                      pattern_count, pattern_data_count, left_offset,
                      bottom_offset):
    """Watermark block layout (gstsimplevideomark.c draw loop)."""
    total = pattern_count + pattern_data_count
    x0 = left_offset
    y0 = height - bottom_offset - pattern_height
    return [(x0 + i * pattern_width, y0) for i in range(total)]


@register
class SimpleVideoMark(_LumaPlanarFilter):
    """gstsimplevideomark.c: stamp machine-readable corner squares.

    pattern-count solid sync squares (alternating bright/dark) followed by
    pattern-data-count squares encoding `pattern-data` bits (LSB first:
    bit set -> bright square).
    """

    NAME = "simplevideomark"
    PROPERTIES = (
        Property("pattern-width", int, 4, 1, None),
        Property("pattern-height", int, 16, 1, None),
        Property("pattern-count", int, 4, 0, None),
        Property("pattern-data-count", int, 5, 0, 64),
        Property("pattern-data", int, 10, 0, None),
        Property("enabled", bool, True),
        Property("left-offset", int, 0, 0, None),
        Property("bottom-offset", int, 0, 0, None),
    )

    def process(self, params, state, batch: FrameBatch):
        y = self._luma(batch.data)
        h, w = y.shape[-2], y.shape[-1]
        pw = self.props["pattern-width"]
        ph = self.props["pattern-height"]
        pc = self.props["pattern-count"]
        pdc = self.props["pattern-data-count"]
        blocks = _pattern_geometry(w, h, pw, ph, pc, pdc,
                                   self.props["left-offset"],
                                   self.props["bottom-offset"])
        data_bits = params["pattern-data"].astype(jnp.int64)
        out = y
        for i, (bx, by) in enumerate(blocks):
            if i < pc:
                bright = jnp.bool_(i % 2 == 0)
            else:
                bright = ((data_bits >> (i - pc)) & 1) == 1
            val = jnp.where(bright, jnp.uint8(255), jnp.uint8(0))
            patch = jnp.full((y.shape[0], ph, pw), 1, jnp.uint8) * val
            out = out.at[..., by:by + ph, bx:bx + pw].set(patch)
        out = jnp.where(params["enabled"], out, y)
        return state, batch.with_data(self._set_luma(batch.data, out))


@register
class SimpleVideoMarkDetect(_LumaPlanarFilter):
    """gstsimplevideomarkdetect.c: read the squares back; posts a
    simplevideomarkdetect message with the decoded data per frame."""

    NAME = "simplevideomarkdetect"
    PROPERTIES = (
        Property("pattern-width", int, 4, 1, None),
        Property("pattern-height", int, 16, 1, None),
        Property("pattern-count", int, 4, 0, None),
        Property("pattern-data-count", int, 5, 0, 64),
        Property("pattern-center", float, 0.5, 0.0, 1.0),
        Property("pattern-sensitivity", float, 0.3, 0.0, 1.0),
        Property("left-offset", int, 0, 0, None),
        Property("bottom-offset", int, 0, 0, None),
        Property("message", bool, True),
    )

    def process(self, params, state, batch: FrameBatch):
        y = self._luma(batch.data)
        h, w = y.shape[-2], y.shape[-1]
        pw = self.props["pattern-width"]
        ph = self.props["pattern-height"]
        pc = self.props["pattern-count"]
        pdc = self.props["pattern-data-count"]
        blocks = _pattern_geometry(w, h, pw, ph, pc, pdc,
                                   self.props["left-offset"],
                                   self.props["bottom-offset"])
        center = params["pattern-center"].astype(jnp.float64) * 255.0
        means = []
        for bx, by in blocks:
            blk = y[..., by:by + ph, bx:bx + pw].astype(jnp.float64)
            means.append(jnp.mean(blk, axis=(-2, -1)))
        means = jnp.stack(means, axis=-1)  # [B, pc+pdc]
        bright = means > center
        # sync pattern must alternate starting bright
        expect = jnp.asarray([(i % 2 == 0) for i in range(pc)])
        found = jnp.all(bright[..., :pc] == expect[None, :], axis=-1)
        bits = bright[..., pc:].astype(jnp.int64)
        data = jnp.sum(bits * (2 ** jnp.arange(pdc, dtype=jnp.int64))[None, :],
                       axis=-1)
        msgs = {"simplevideomarkdetect": {
            "_emit": jnp.broadcast_to(params["message"], (y.shape[0],)),
            "have-pattern": found,
            "pattern-data": data,
        }}
        return state, batch, msgs
