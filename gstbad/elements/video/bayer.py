"""bayer2rgb / rgb2bayer (gst/bayer/).

The caps rewrite video/x-bayer <-> video/x-raw (gstbayer2rgb.c:290-320)
becomes a MediaSpec kind transition at negotiation.
"""

from __future__ import annotations

import jax.numpy as jnp

from gstbad.core.element import Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import (BayerFormat, MediaSpec, VideoFormat,
                                  require)
from gstbad.ops import bayer as ops


@register
class Bayer2RGB(Element):
    """Demosaic video/x-bayer {bggr,gbrg,grbg,rggb} -> packed RGB
    (gstbayer2rgb.c).  `format` picks the output ordering (8 orderings as in
    gstbayer2rgb.c:134-141); alpha fills with 255."""

    NAME = "bayer2rgb"
    PROPERTIES = (Property("format", str, VideoFormat.RGBA, static=True),)

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "bayer",
                f"{self.NAME}: needs video/x-bayer input, got {in_spec}")
        require(in_spec.format in BayerFormat.ALL,
                f"{self.NAME}: bad bayer format {in_spec.format}")
        require(in_spec.height >= 4 and in_spec.width % 2 == 0,
                f"{self.NAME}: needs H>=4 and even W")
        out_fmt = self.props["format"]
        require(out_fmt in VideoFormat.PACKED_RGB4,
                f"{self.NAME}: output format {out_fmt} unsupported")
        return in_spec.with_(kind="video", format=out_fmt)

    def prepare(self):
        r, g, b, a = VideoFormat.rgb_offsets(self.out_spec.format)
        self._offsets = (r, g, b, a)
        self._bayer_fmt = self.in_spec.format

    def process(self, params, state, batch: FrameBatch):
        out = ops.demosaic(batch.data, self._bayer_fmt, self._offsets)
        return state, batch.with_data(out)


@register
class RGB2Bayer(Element):
    """ARGB -> video/x-bayer decimation for round-trip testing
    (gstrgb2bayer.c)."""

    NAME = "rgb2bayer"
    PROPERTIES = (Property("format", str, BayerFormat.BGGR, static=True),)

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "video", f"{self.NAME}: needs video input")
        require(in_spec.format in VideoFormat.PACKED_RGB4,
                f"{self.NAME}: format {in_spec.format} unsupported")
        require(self.props["format"] in BayerFormat.ALL,
                f"{self.NAME}: bad bayer format {self.props['format']}")
        return in_spec.with_(kind="bayer", format=self.props["format"])

    def prepare(self):
        self._offsets = VideoFormat.rgb_offsets(self.in_spec.format)[:3]

    def process(self, params, state, batch: FrameBatch):
        out = ops.to_bayer(batch.data, self.out_spec.format, self._offsets)
        return state, batch.with_data(out)
