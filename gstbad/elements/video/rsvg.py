"""rsvgoverlay / rsvgdec (ext/rsvg/gstrsvgoverlay.c, gstrsvgdec.c) over
the real librsvg (io/rsvg.py ctypes binding).

rsvgoverlay (gstrsvgoverlay.c:361-431): composites an SVG document over
the video.  Offsets: absolute x/y (ints) win; when 0, x-relative/
y-relative x frame dims apply.  Dimensions: absolute width/height (or
relative x frame dims when 0); if only one is given the other keeps the
SVG's natural size; when neither is set the SVG renders unscaled.
fit-to-frame=true is the reference's property-setter shorthand for
x=y=0, width-relative=height-relative=1 (gstrsvgoverlay.c:197-213).
The SVG comes from `data` (inline markup), `location` (file), or — like
the reference's data sink pad — push_data() before the run.

Device-first split: the reference re-renders the SVG into every frame with
cairo on the CPU; here the rasterization happens ONCE on the host at
prepare time (the overlay is static per property set) and the per-frame
work is pixman's exact OVER composite on device —
out = O + UN8_MUL(F, 255 - O_a), UN8_MUL(a,b) = (t = a*b + 0x80;
(t + (t >> 8)) >> 8), saturating add — which XLA fuses into the window
program.  Byte-exact vs cairo rendering directly onto the frame, except
where semi-transparent SVG shapes overlap: the reference composites
every draw op onto the frame, so its intermediate roundings differ by
<=1 LSB there (OVER is associative in exact math, not in u8) —
documented divergence, tested at atol=1.

Caps: the reference takes BGRA only (little-endian cairo ARGB32);
this element also accepts the other 8-bit alpha formats by permuting
the rendered overlay into the frame's channel layout.

rsvgdec (gstrsvgdec.c:156-246): SVG documents in, BGRA frames out, one
frame per document, split at the `</svg>` terminator like the
reference's parse().  The first document's natural size fixes the
static output spec; later documents render cairo_scale'd to it (the
reference renegotiates caps per document instead — static-shape
divergence, documented)."""

from __future__ import annotations

import fractions
import os

import numpy as np
import jax.numpy as jnp

from gstbad.core.element import Element, Property, VideoFilter
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import MediaSpec, VideoFormat, require
from gstbad.io import rsvg


def over_u8(frame_i32, overlay_np, alpha_idx):
    """pixman OVER on device: frame [..,4] i32, overlay [h,w,4] u8
    premultiplied (already in the frame's channel order)."""
    o = jnp.asarray(overlay_np.astype(np.int32))
    oa = o[..., alpha_idx:alpha_idx + 1]
    t = frame_i32 * (jnp.int32(255) - oa) + jnp.int32(0x80)
    r = (t + (t >> jnp.int32(8))) >> jnp.int32(8)
    return jnp.minimum(o + r, jnp.int32(255))


@register
class RsvgOverlay(VideoFilter):
    NAME = "rsvgoverlay"
    FORMATS = (VideoFormat.BGRA, VideoFormat.RGBA, VideoFormat.ARGB,
               VideoFormat.ABGR)
    PROPERTIES = (
        Property("data", str, "", static=True, doc="SVG markup"),
        Property("location", str, "", static=True, doc="SVG file"),
        Property("fit-to-frame", bool, False, static=True),
        Property("x", int, 0, static=True),
        Property("y", int, 0, static=True),
        Property("x-relative", float, 0.0, static=True),
        Property("y-relative", float, 0.0, static=True),
        Property("width", int, 0, static=True),
        Property("height", int, 0, static=True),
        Property("width-relative", float, 0.0, static=True),
        Property("height-relative", float, 0.0, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._pushed = b""

    def push_data(self, data: bytes) -> None:
        """The reference's data sink pad: SVG markup as a byte stream
        (consumed at prepare, i.e. this framework's EOS analog)."""
        self._pushed += bytes(data)

    def _svg(self):
        if self.props["data"]:
            return rsvg.Svg(self.props["data"].encode())
        if self.props["location"]:
            return rsvg.Svg.from_file(self.props["location"])
        if self._pushed:
            return rsvg.Svg(self._pushed)
        return None

    def prepare(self):
        spec = self.out_spec
        fw, fh = spec.width, spec.height
        svg = self._svg()
        if svg is None:
            self._overlay = None
            return
        x, y = self.props["x"], self.props["y"]
        xr, yr = self.props["x-relative"], self.props["y-relative"]
        w, h = self.props["width"], self.props["height"]
        wr = self.props["width-relative"]
        hr = self.props["height-relative"]
        if self.props["fit-to-frame"]:
            x = y = 0
            xr = yr = 0.0
            w = h = 0
            wr = hr = 1.0
        # gstrsvgoverlay.c:391-410 applied-offset/dimension walk
        ax = float(x) if x else xr * fw
        ay = float(y) if y else yr * fh
        aw = w if w else int(wr * fw)
        ah = h if h else int(hr * fh)
        sx = sy = 1.0
        if (aw or ah) and svg.width and svg.height:
            aw = aw if aw else svg.width
            ah = ah if ah else svg.height
            sx = aw / svg.width
            sy = ah / svg.height
        bgra = svg.render(fw, fh, tx=ax, ty=ay, sx=sx, sy=sy)
        # permute cairo's B,G,R,A memory order into the frame layout
        ro, go, bo, ao = VideoFormat.rgb_offsets(spec.format)
        perm = np.empty_like(bgra)
        perm[..., ro] = bgra[..., 2]
        perm[..., go] = bgra[..., 1]
        perm[..., bo] = bgra[..., 0]
        perm[..., ao] = bgra[..., 3]
        self._overlay = perm
        self._alpha_idx = ao

    def process(self, params, state, batch: FrameBatch):
        if self._overlay is None:
            return state, batch
        out = over_u8(batch.data.astype(jnp.int32), self._overlay,
                      self._alpha_idx).astype(jnp.uint8)
        return state, batch.with_data(out)


@register
class RsvgDec(Element):
    NAME = "rsvgdec"
    KIND = "host-source"
    PROPERTIES = (
        Property("framerate", str, "30/1", static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._docs = []
        self._carry = b""
        self._pos = 0
        self._last = None

    def push_packet(self, data: bytes) -> None:
        """One complete SVG document = one output frame."""
        self._docs.append(bytes(data))

    def push_data(self, data: bytes) -> None:
        """Byte-stream feed: split at '</svg>' like the reference's
        parse() (gstrsvgdec.c:105-154)."""
        self._carry += bytes(data)
        while True:
            idx = self._carry.find(b"</svg>")
            if idx < 0:
                break
            end = idx + len(b"</svg>")
            self._docs.append(self._carry[:end])
            self._carry = self._carry[end:]

    def process(self, params, state, batch: FrameBatch):
        return state, batch          # frames come from pull_window

    def negotiate(self, in_spec):
        require(self._docs, "rsvgdec: push SVG documents before "
                            "negotiating")
        self._svgs = [rsvg.Svg(d) for d in self._docs]
        first = self._svgs[0]
        require(first.width > 0 and first.height > 0,
                "rsvgdec: SVG has no intrinsic dimensions")
        self._fr = fractions.Fraction(self.props["framerate"])
        return MediaSpec(kind="video", format=VideoFormat.BGRA,
                         width=first.width, height=first.height,
                         framerate=self._fr)

    def pull_window(self, window: int):
        if self._pos >= len(self._svgs):
            return None
        W, H = self.out_spec.width, self.out_spec.height
        dur = self.out_spec.frame_duration_ns
        frames, pts, valid = [], [], []
        for _ in range(window):
            if self._pos < len(self._svgs):
                svg = self._svgs[self._pos]
                # gstrsvgdec.c:229-242 scale-to-output-state walk
                sx = W / svg.width if svg.width != W else 1.0
                sy = H / svg.height if svg.height != H else 1.0
                self._last = svg.render(W, H, sx=sx, sy=sy)
                frames.append(self._last)
                pts.append(self._pos * dur)
                valid.append(True)
                self._pos += 1
            else:
                frames.append(self._last)
                pts.append(pts[-1] if pts else 0)
                valid.append(False)
        return FrameBatch.make(
            jnp.asarray(np.stack(frames)),
            pts=jnp.asarray(np.asarray(pts, np.int64)),
            valid=jnp.asarray(valid))

    def save_position(self):
        return self._pos

    def restore_position(self, pos) -> None:
        self._pos = pos
