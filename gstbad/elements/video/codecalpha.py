"""codecalpha — alphacombine / codecalphademux (gst/codecalpha/).

alphacombine takes the luma plane of a second (alpha-carrying) stream as the
alpha plane of the first (gstalphacombine.c:25-31): I420 + {I420, GRAY8}
luma -> A420 (planar YUV with alpha).  codecalphademux splits them back.
"""

from __future__ import annotations

import jax.numpy as jnp

from gstbad.core.element import Element
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import MediaSpec, VideoFormat, require


@register
class AlphaCombine(Element):
    """2-input: [video (I420/GRAY8), alpha (I420/GRAY8)] -> A420-style planar
    dict with an "a" plane taken from the alpha stream's luma."""

    NAME = "alphacombine"
    N_INPUTS = 2

    def negotiate(self, in_spec):
        require(isinstance(in_spec, list) and len(in_spec) == 2,
                "alphacombine: needs two inputs (video, alpha)")
        video, alpha = in_spec
        require(video.kind == "video" and alpha.kind == "video",
                "alphacombine: needs video inputs")
        require(video.width == alpha.width and video.height == alpha.height,
                "alphacombine: geometry mismatch")
        require(video.format in (VideoFormat.I420, VideoFormat.GRAY8),
                f"alphacombine: unsupported video format {video.format}")
        require(alpha.format in (VideoFormat.I420, VideoFormat.GRAY8),
                f"alphacombine: unsupported alpha format {alpha.format}")
        self._video_fmt = video.format
        return video.with_(format="A420")

    def process(self, params, state, batches):
        video, alpha = batches
        a = (alpha.data["y"] if isinstance(alpha.data, dict) else alpha.data)
        if isinstance(video.data, dict):
            out = {**video.data, "a": a}
        else:
            h, w = video.data.shape[-2:]
            out = {"y": video.data,
                   "u": jnp.full(video.data.shape[:-2] + (h // 2, w // 2),
                                 128, jnp.uint8),
                   "v": jnp.full(video.data.shape[:-2] + (h // 2, w // 2),
                                 128, jnp.uint8),
                   "a": a}
        return state, video.with_data(out)


@register
class CodecAlphaDemux(Element):
    """Split an A420-style planar stream back into (video, alpha-luma);
    the two outputs surface as two graph leaves."""

    NAME = "codecalphademux"

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.format == "A420", "codecalphademux: needs A420")
        return in_spec.with_(format=VideoFormat.I420)

    def process(self, params, state, batch: FrameBatch):
        data = {k: v for k, v in batch.data.items() if k != "a"}
        return state, batch.with_data(data), {
            # the alpha plane rides as a message-visible mean for checks
            "alpha": {"alpha-mean": jnp.mean(
                batch.data["a"].astype(jnp.float32), axis=(-2, -1))}}
