"""disparity element (ext/opencv/gstdisparity.cpp): 2-input stereo
correspondence.

Inputs [left, right] RGB; per frame both convert to gray, the selected
matcher runs with the reference's hard-coded settings (initialise_sbm,
gstdisparity.cpp:622-653: SBM block 9 / 32 disparities / preFilterCap 32
/ post-filters off; SGBM minDisp 1 / 64 disparities / block 3 / P1 200 /
P2 255 / MODE_HH), the CV_16S map min-max normalizes to u8 and replaces
the RIGHT stream as gray2rgb (gstdisparity.cpp:560-580).  ops/stereo.py
documents which parts are bit-exact vs cv2 and which diverge."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gstbad.core.element import Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import VideoFormat, require
from gstbad.ops import cv as cvops
from gstbad.ops import stereo


@register
class Disparity(Element):
    NAME = "disparity"
    N_INPUTS = 2

    PROPERTIES = (
        Property("method", str, "sgbm", static=True,
                 doc="sbm | sgbm (gstdisparity.cpp:156-157; "
                     "DEFAULT_METHOD = sgbm)"),
    )

    def negotiate(self, in_spec):
        require(isinstance(in_spec, list) and len(in_spec) == 2,
                "disparity: needs (left, right) inputs")
        left, right = in_spec
        require(left.kind == "video" and right.kind == "video",
                "disparity: needs video inputs")
        require(left.width == right.width
                and left.height == right.height,
                "disparity: geometry mismatch")
        require(left.format == VideoFormat.RGB
                and right.format == VideoFormat.RGB,
                "disparity: needs RGB inputs (use videoconvert)")
        require(self.props["method"] in ("sbm", "sgbm"),
                f"disparity: unknown method {self.props['method']!r}")
        return right

    def process(self, params, state, batches):
        left, right = batches
        gl = cvops.rgb2gray_u8(left.data)
        gr = cvops.rgb2gray_u8(right.data)
        if self.props["method"] == "sbm":
            f = lambda a, b: stereo.stereo_bm(a, b)      # noqa: E731
        else:
            f = lambda a, b: stereo.stereo_sgm(a, b)     # noqa: E731
        disp = jax.vmap(f)(gl, gr)
        norm = jax.vmap(stereo.normalize_minmax_u8)(disp)
        out = cvops.gray2rgb(norm)
        return state, right.with_data(out)
