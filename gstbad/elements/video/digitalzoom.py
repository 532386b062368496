"""digitalzoom — center crop + scale back to size
(gst/camerabin2/gstdigitalzoom.c: a GstBin of videocrop ! videoscale !
capsfilter, exposing a `zoom` float).

Design: rather than a dynamic-shape crop followed by a resize (two
HBM round trips and a shape change XLA can't trace), the whole zoom is one
separable bilinear resample of the crop window, expressed as two matmuls
with interpolation matrices built in-graph from the traced zoom scalar —
so the hot path rides the MXU and `zoom` changes never recompile.

The crop arithmetic is the reference's exactly
(gstdigitalzoom.c:95-107): w2 = (W - trunc(W/zoom))/2, left forced even.
videoscale itself lives in gst-plugins-base (outside this reference), so
the scaler here is plain bilinear — the videoscale method=bilinear analog.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from gstbad.core.element import Property, VideoFilter
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import MediaSpec, VideoFormat, require


def _interp_matrix(n_in: int, n_out: int, start, length):
    """[n_in, n_out] f32 bilinear sampling matrix for the window
    [start, start+length) resampled to n_out pixels (center-aligned).
    start/length are traced scalars — the matrix is data-dependent but
    statically shaped, and the resample is a single MXU matmul."""
    start = start.astype(jnp.float32)
    length = length.astype(jnp.float32)
    x = (jnp.arange(n_out, dtype=jnp.float32) + 0.5) * (length / n_out) \
        + start - 0.5
    x = jnp.clip(x, 0.0, n_in - 1.0)
    x0 = jnp.floor(x)
    ax = x - x0
    x0i = x0.astype(jnp.int32)
    x1i = jnp.minimum(x0i + 1, n_in - 1)
    rows = jnp.arange(n_in, dtype=jnp.int32)[:, None]
    return (jnp.where(rows == x0i[None, :], 1.0 - ax[None, :], 0.0)
            + jnp.where(rows == x1i[None, :], ax[None, :], 0.0))


def _zoom_plane(img, left, top, cw, ch):
    """img [B,H,W] or [B,H,W,C] f32 -> same shape, window resampled."""
    h, w = img.shape[1], img.shape[2]
    sr = _interp_matrix(h, h, top, ch)     # [H_in, H_out]
    sc = _interp_matrix(w, w, left, cw)    # [W_in, W_out]
    # rows: [B,(C,)H_out,W] = sr^T @ img ; cols: @ sc
    hi = lax.Precision.HIGHEST  # f32 resampling weights, never TF32
    out = jnp.einsum("io,bi...->bo...", sr, img, precision=hi)
    if img.ndim == 4:
        out = jnp.einsum("bhic,io->bhoc", out, sc, precision=hi)
    else:
        out = jnp.einsum("bhi,io->bho", out, sc, precision=hi)
    return out


def _crop_box(width, height, zoom):
    """gstdigitalzoom.c:95-107 integer crop; zoom traced f32 scalar."""
    zoom = jnp.maximum(zoom.astype(jnp.float32), 1.0)
    w2 = (width - (width * 1.0 / zoom).astype(jnp.int32)) // 2
    h2 = (height - (height * 1.0 / zoom).astype(jnp.int32)) // 2
    left = w2 & 0xFFFE  # even left, avoids videoscale slow path
    right = w2
    cw = width - left - right
    ch = height - 2 * h2
    return left, h2, cw, ch


@register
class DigitalZoom(VideoFilter):
    """zoom in [1, inf), default 1 (gstdigitalzoom.c zoom property);
    zooming is centered."""

    NAME = "digitalzoom"
    FORMATS = (VideoFormat.AYUV, VideoFormat.GRAY8, VideoFormat.I420,
               VideoFormat.RGBx, VideoFormat.BGRx, VideoFormat.xRGB,
               VideoFormat.xBGR)
    PROPERTIES = (
        Property("zoom", float, 1.0, 1.0, None, controllable=True),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "video", "digitalzoom: needs video")
        require(in_spec.format in self.FORMATS,
                f"digitalzoom: format {in_spec.format} unsupported")
        return in_spec

    def process(self, params, state, batch: FrameBatch):
        zoom = params["zoom"]
        spec = self.out_spec

        def do(img, left, top, cw, ch):
            out = _zoom_plane(img.astype(jnp.float32), left, top, cw, ch)
            return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)

        if isinstance(batch.data, dict):  # I420 planes
            w, h = spec.width, spec.height
            left, top, cw, ch = _crop_box(w, h, zoom)
            out = {"y": do(batch.data["y"], left, top, cw, ch),
                   "u": do(batch.data["u"], left // 2, top // 2,
                           cw // 2, ch // 2),
                   "v": do(batch.data["v"], left // 2, top // 2,
                           cw // 2, ch // 2)}
        else:
            h, w = batch.data.shape[1], batch.data.shape[2]
            left, top, cw, ch = _crop_box(w, h, zoom)
            out = do(batch.data, left, top, cw, ch)
        return state, batch.with_data(out)
