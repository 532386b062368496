"""openexrdec (ext/openexr/gstopenexrdec.cpp) over the REAL OpenEXR
shipped in this environment (io/exr.py binds libOpenEXRCore-3_1, the C
API of the library family the reference wraps via the C++
RgbaInputFile).

Host-source video decoder: push whole EXR images (push_packet) or a raw
concatenation (push_bytes - split at validated magics exactly like the
reference's sink parse, gstopenexrdec.cpp:203-250).  Output is ARGB64
frames via the reference's conversion CLAMP(half * 65536, 0, 65535)
(gstopenexrdec.cpp:430-441) with the pixel-aspect-ratio forwarded from
the EXR header (gstopenexrdec.cpp:291-301).
"""

from __future__ import annotations

import fractions

import numpy as np
import jax.numpy as jnp

from gstbad.core.element import Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import MediaSpec, VideoFormat, require
from gstbad.io import exr


@register
class OpenEXRDec(Element):
    NAME = "openexrdec"
    KIND = "host-source"
    PROPERTIES = (
        Property("framerate", str, "30/1", static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._images = []
        self._tail = b""
        self._pos = 0
        self._last = None

    def push_packet(self, data: bytes) -> None:
        """One complete EXR image = one output frame."""
        self._images.append(bytes(data))

    def push_bytes(self, data: bytes) -> None:
        """Raw stream: split at validated EXR magics (the reference's
        adapter scan, gstopenexrdec.cpp:203-250).  The final image is
        only complete once the next magic or EOS arrives; flush with
        event_eos()."""
        self._tail += data
        images = exr.split_exr_stream(self._tail)
        if len(images) > 1:
            self._images.extend(images[:-1])
            self._tail = images[-1]

    def event_eos(self) -> None:
        if self._tail:
            self._images.extend(exr.split_exr_stream(self._tail))
            self._tail = b""

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def negotiate(self, in_spec):
        require(exr.available(), "openexrdec: OpenEXRCore not available")
        require(self._images,
                "openexrdec: push EXR images first")
        rgba, self._par = exr.decode_exr(self._images[0])
        h, w = rgba.shape[:2]
        self._fr = fractions.Fraction(self.props["framerate"])
        return MediaSpec(kind="video", format=VideoFormat.ARGB64,
                         width=w, height=h, framerate=self._fr)

    def pull_window(self, window: int):
        if self._pos >= len(self._images):
            return None
        dur = self.out_spec.frame_duration_ns
        frames, pts, valid = [], [], []
        for _ in range(window):
            if self._pos < len(self._images):
                rgba, _par = exr.decode_exr(self._images[self._pos])
                self._last = exr.to_argb64(rgba)
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
