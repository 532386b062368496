"""webpdec / webpenc (ext/webp/gstwebpdec.c, gstwebpenc.c) over the
REAL libwebp shipped in this environment (io/webp.py ctypes binding —
the exact library the reference wraps).

- webpdec: host-source; push image/webp buffers (one image each), the
  output format follows the reference's alpha walk — ARGB when the
  bitstream has alpha, RGB otherwise (gstwebpdec.c:389-396) — with
  the bypass-filtering / no-fancy-upsampling / use-threads decoder
  options applied for real through the advanced decode API
  (gstwebpdec.c:463-467).
- webpenc: host element; every valid input frame encodes through the
  reference's WebPConfigPreset(preset, quality) + lossless + method
  walk (gstwebpenc.c:377-392) and posts a `webp-image` bus message;
  `packets` mirrors the posts.  RGB/RGBA frames use use_argb import,
  I420 uses the WEBP_YUV420 plane path (gstwebpenc.c:191-205,
  269-291).
"""

from __future__ import annotations

import fractions

import numpy as np
import jax.numpy as jnp

from gstbad.core.element import Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import MediaSpec, VideoFormat, require
from gstbad.io import webp


@register
class WebpDec(Element):
    NAME = "webpdec"
    KIND = "host-source"
    PROPERTIES = (
        Property("bypass-filtering", bool, False, static=True,
                 doc="skip the in-loop filter (gstwebpdec.c:76)"),
        Property("no-fancy-upsampling", bool, False, static=True),
        Property("use-threads", bool, False, static=True),
        Property("framerate", str, "30/1", static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._images = []
        self._pos = 0
        self._last = None

    def push_packet(self, data: bytes) -> None:
        """One complete WebP bitstream = one output frame."""
        self._images.append(bytes(data))

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def negotiate(self, in_spec):
        require(webp.available(), "webpdec: libwebp not available")
        require(self._images,
                "webpdec: push_packet() WebP images first")
        feats = [webp.features(d) for d in self._images]
        require(all(f is not None for f in feats),
                "webpdec: not a WebP bitstream")
        w, h, _a = feats[0]
        require(all((fw, fh) == (w, h) for fw, fh, _ in feats),
                "webpdec: all images must share dimensions")
        # the reference picks ARGB when the (first) bitstream carries
        # alpha, RGB otherwise (gstwebpdec.c:389-396)
        self._alpha = any(a for _w, _h, a in feats)
        self._fr = fractions.Fraction(self.props["framerate"])
        fmt = VideoFormat.ARGB if self._alpha else VideoFormat.RGB
        return MediaSpec(kind="video", format=fmt, width=w, height=h,
                         framerate=self._fr)

    def _decode(self, data: bytes) -> np.ndarray:
        mode = webp.MODE_ARGB if self._alpha else webp.MODE_RGB
        return webp.decode(
            data, mode,
            bypass_filtering=self.props["bypass-filtering"],
            no_fancy_upsampling=self.props["no-fancy-upsampling"],
            use_threads=self.props["use-threads"])

    def pull_window(self, window: int):
        if self._pos >= len(self._images):
            return None
        dur = self.out_spec.frame_duration_ns
        frames, pts, valid = [], [], []
        for _ in range(window):
            if self._pos < len(self._images):
                self._last = self._decode(self._images[self._pos])
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


@register
class WebpEnc(Element):
    NAME = "webpenc"
    HOST = True          # host_process posts the encoded images
    PROPERTIES = (
        Property("lossless", bool, False, static=True,
                 doc="DEFAULT_LOSSLESS FALSE (gstwebpenc.c:43)"),
        Property("quality", float, 90.0, 0.0, 100.0, static=True),
        Property("speed", int, 4, 0, 6, static=True,
                 doc="maps to WebPConfig.method"),
        Property("preset", str, "photo", static=True,
                 doc="default|picture|photo|drawing|icon|text "
                     "(DEFAULT_PRESET WEBP_PRESET_PHOTO)"),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self.packets = []            # (pts_ns, bytes)

    def negotiate(self, in_spec):
        require(webp.available(), "webpenc: libwebp not available")
        require(in_spec.kind == "video", "webpenc: video input")
        require(in_spec.format in (VideoFormat.RGB, VideoFormat.RGBA,
                                   VideoFormat.I420),
                "webpenc: needs RGB/RGBA/I420 input (reference sink "
                "caps { I420, YV12, RGB, RGBA } — use videoconvert)")
        require(self.props["preset"] in webp.PRESETS,
                "webpenc: unknown preset")
        return in_spec

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        from gstbad.core.bus import Message
        kw = dict(quality=self.props["quality"],
                  speed=self.props["speed"],
                  preset=webp.PRESETS[self.props["preset"]],
                  lossless=self.props["lossless"])
        for i in range(np_batch.batch):
            if not bool(np.asarray(np_batch.valid)[i]):
                continue
            pts = int(np.asarray(np_batch.pts)[i])
            if self.out_spec.format == VideoFormat.I420:
                d = np_batch.data
                data = webp.encode(None, yuv=(
                    np.asarray(d["y"][i]), np.asarray(d["u"][i]),
                    np.asarray(d["v"][i])), **kw)
            else:
                data = webp.encode(np.asarray(np_batch.data[i]), **kw)
            self.packets.append((pts, data))
            if bus is not None:
                bus.post(Message(self.NAME, "webp-image", pts,
                                 {"data": data}))
