"""qroverlay / debugqroverlay (ext/qroverlay/gstqroverlay.c,
gstdebugqroverlay.c over gstbaseqroverlay.c).

The reference encodes a content string with libqrencode
(QRcode_encodeString(content, 0, level, QR_MODE_8, 0)), rasterizes it
with draw_overlay (gstbaseqroverlay.c:138-204 — transcribed in
golden/qroverlay.py with its little-endian BGRA channels, the
one-module-right shift and the float pixel-size truncations) and blends
the composition at (x, y) per overlay_position.  io/qr.py is the
from-spec encoder (libqrencode is absent; divergences documented
there).

qroverlay: the `data` property supplies the content.  The reference's
get_qrcode_content (gstqroverlay.c:72-85) sets
`*reuse_prev = self->data_changed` and never clears the flag, so once
the first frame's overlay exists every later frame reuses it and
mid-stream `data` changes never re-encode; `data` here is a static
property, which yields the same observable stream (quirk documented).

debugqroverlay: per-frame JSON content (gstdebugqroverlay.c:243-284):
{"TIMESTAMP": pts, "BUFFERCOUNT": n, "FRAMERATE": "N/D", "NAME": name}
in json-glib compact form, plus the extra-data member on the reference's
schedule (frame 1, every `extra-data-interval-buffers`-th frame
counting from 1, and through `extra-data-span-buffers` consecutive
frames, cycling `extra-data-array`; a span of 0 strands the cycle
counter at its first entry exactly like the C, where span_frame can
never equal 0 after the first increment).  The per-frame symbols are
pre-rasterized on the host for `max-frames` frames (a bank property of
this implementation — the device composite gathers by frame counter;
frames past the bank show no overlay, documented) and TIMESTAMP is the
source-clock pts `i * frame_duration_ns` — identical to what this
framework's sources stamp.
"""

from __future__ import annotations

import json

import numpy as np
import jax.numpy as jnp
from jax import lax

from gstbad.core.element import Property, VideoFilter
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import VideoFormat, require
from gstbad.golden import qroverlay as golden
from gstbad.io import qr

_LEVEL_NAMES = ("L", "M", "Q", "H")   # QRecLevel order (libqrencode)


class _QrOverlayBase(VideoFilter):
    """Shared raster/placement/blend; subclasses supply content."""

    FORMATS = VideoFormat.PACKED_RGB4 + VideoFormat.PACKED_RGB3
    PROPERTIES = (
        Property("x", float, 50.0, 0.0, 100.0, static=True,
                 doc="X position in percent of the width "
                     "(gstbaseqroverlay.c:281-285)"),
        Property("y", float, 50.0, 0.0, 100.0, static=True,
                 doc="Y position in percent of the height"),
        Property("pixel-size", float, 3.0, 1.0, 100.0, static=True,
                 doc="pixel size of each QR module "
                     "(DEFAULT_PROP_PIXEL_SIZE 3)"),
        Property("qrcode-error-correction", int, 1, 0, 3, static=True,
                 doc="QRecLevel: 0=L 1=M 2=Q 3=H "
                     "(DEFAULT_PROP_QUALITY 1 = M)"),
    )

    def _level(self) -> str:
        return _LEVEL_NAMES[self.props["qrcode-error-correction"]]

    def _rasterize(self, content: str):
        """content -> (rgb [s,s,3] u8, alpha [s,s] u8, x, y) or None."""
        if not content:
            return None
        modules = qr.encode(content, self._level())
        canvas = golden.draw_overlay(modules, self.props["pixel-size"])
        sq = canvas.shape[0]
        spec = self.out_spec
        x, y = golden.overlay_position(spec.width, spec.height, sq,
                                       self.props["x"], self.props["y"])
        # canvas is BGRA bytes (golden/qroverlay.py)
        rgb = canvas[..., [2, 1, 0]]
        alpha = canvas[..., 3]
        return rgb, alpha, x, y

    def _to_frame_planes(self, ras):
        """Clip a rasterized overlay into full-frame RGB + alpha."""
        spec = self.out_spec
        H, W = spec.height, spec.width
        frgb = np.zeros((H, W, 3), np.uint8)
        fa = np.zeros((H, W), np.uint8)
        if ras is None:
            return frgb, fa
        rgb, alpha, x, y = ras
        sq = alpha.shape[0]
        sy, sx = max(0, -y), max(0, -x)
        dy, dx = max(0, y), max(0, x)
        h = min(sq - sy, H - dy)
        w = min(sq - sx, W - dx)
        if h > 0 and w > 0:
            frgb[dy:dy + h, dx:dx + w] = rgb[sy:sy + h, sx:sx + w]
            fa[dy:dy + h, dx:dx + w] = alpha[sy:sy + h, sx:sx + w]
        return frgb, fa

    def _composite(self, frames, over_rgb, over_a):
        """Video-blend the overlay (video-blend.c truncating
        (D*(256-a) + S*a) >> 8) onto [B,H,W,C] frames."""
        fmt = self.out_spec.format
        ro, go, bo, xo = VideoFormat.rgb_offsets(fmt)
        d = frames.astype(jnp.int32)
        a = over_a.astype(jnp.int32)
        out = frames
        for off, ch in ((ro, 0), (go, 1), (bo, 2)):
            s = over_rgb[..., ch].astype(jnp.int32)
            blended = (d[..., off] * (256 - a) + s * a) >> 8
            out = out.at[..., off].set(blended.astype(jnp.uint8))
        if xo is not None and VideoFormat.has_alpha(fmt):
            da = d[..., xo]
            oa = ((da * (256 - a) + 255 * a) >> 8).astype(jnp.uint8)
            out = out.at[..., xo].set(oa)
        return out


@register
class QrOverlay(_QrOverlayBase):
    NAME = "qroverlay"
    PROPERTIES = _QrOverlayBase.PROPERTIES + (
        Property("data", str, "", static=True,
                 doc="content string (gstqroverlay.c:141-146; static "
                     "here = the reference's stuck reuse_prev quirk)"),
    )

    def prepare(self):
        ras = self._rasterize(self.props["data"])
        rgb, a = self._to_frame_planes(ras)
        self._rgb = jnp.asarray(rgb)
        self._a = jnp.asarray(a)
        self._active = ras is not None

    def process(self, params, state, batch: FrameBatch):
        if not self._active:
            return state, batch
        out = self._composite(batch.data, self._rgb[None], self._a[None])
        return state, batch.with_data(out)


@register
class DebugQrOverlay(_QrOverlayBase):
    NAME = "debugqroverlay"
    PROPERTIES = _QrOverlayBase.PROPERTIES + (
        Property("extra-data-interval-buffers", int, 60, 0, None,
                 static=True),
        Property("extra-data-span-buffers", int, 1, 0, None, static=True),
        Property("extra-data-name", str, "", static=True),
        Property("extra-data-array", str, "", static=True,
                 doc="comma-separated values cycled at each interval"),
        Property("max-frames", int, 240, 1, None, static=True,
                 doc="host pre-raster bank depth (this implementation; "
                     "frames beyond it get no overlay)"),
    )

    _instances = 0

    def __init__(self, **props):
        super().__init__(**props)
        self._name = f"debugqroverlay{DebugQrOverlay._instances}"
        DebugQrOverlay._instances += 1

    def _content(self, frame_number: int, pts_ns: int,
                 sched: dict) -> str:
        spec = self.out_spec
        fr = spec.framerate
        obj = {
            "TIMESTAMP": int(pts_ns),
            "BUFFERCOUNT": frame_number,
            "FRAMERATE": f"{fr.numerator}/{fr.denominator}",
            "NAME": self._name,
        }
        arr = sched["array"]
        name = self.props["extra-data-name"]
        interval = self.props["extra-data-interval-buffers"]
        span = self.props["extra-data-span-buffers"]
        if arr and name and (
                frame_number == 1
                or (interval and frame_number % interval == 1)
                or (0 < sched["span_frame"] < span)):
            obj[name] = arr[sched["counter"]]
            sched["span_frame"] += 1
            if sched["span_frame"] == span:
                sched["counter"] += 1
                sched["span_frame"] = 0
                if sched["counter"] >= len(arr):
                    sched["counter"] = 0
        return json.dumps(obj, separators=(",", ":"))

    def prepare(self):
        require(self.props["extra-data-interval-buffers"] > 0
                or not (self.props["extra-data-array"]
                        and self.props["extra-data-name"]),
                "debugqroverlay: extra-data-interval-buffers of 0 "
                "divides by zero in the reference "
                "(gstdebugqroverlay.c:264); rejected here")
        spec = self.out_spec
        dur = spec.frame_duration_ns
        arr = [s for s in self.props["extra-data-array"].split(",")] \
            if self.props["extra-data-array"] else []
        sched = {"array": arr, "counter": 0, "span_frame": 0}
        n = self.props["max-frames"]
        rgbs, alphas = [], []
        for i in range(n):
            content = self._content(i + 1, i * dur, sched)
            rgb, a = self._to_frame_planes(self._rasterize(content))
            rgbs.append(rgb)
            alphas.append(a)
        self._rgb_bank = jnp.asarray(np.stack(rgbs))
        self._a_bank = jnp.asarray(np.stack(alphas))

    def init_state(self, batch: int):
        return {"count": jnp.int32(0)}

    def process(self, params, state, batch: FrameBatch):
        b = batch.batch
        n = self._rgb_bank.shape[0]
        idx = state["count"] + jnp.arange(b, dtype=jnp.int32)
        inbank = idx < n
        ci = jnp.minimum(idx, n - 1)
        rgb = jnp.take(self._rgb_bank, ci, axis=0)
        a = jnp.take(self._a_bank, ci, axis=0)
        a = jnp.where(inbank[:, None, None], a, 0)
        out = self._composite(batch.data, rgb, a)
        return ({"count": state["count"] + b},
                batch.with_data(out))
