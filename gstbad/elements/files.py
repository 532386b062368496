"""File endpoints — filesink (raw), gdpfilesink/gdpfilesrc (gst/gdp/ over a
file transport), multifilesink (one file per frame)."""

from __future__ import annotations

import os
import struct

import numpy as np

from gstbad.core.element import Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.io import gdp


@register
class FileSink(Element):
    """Write raw frame bytes (videoparse/audioparse-compatible)."""

    NAME = "filesink"
    KIND = "sink"
    HOST = True
    PROPERTIES = (Property("location", str, "out.raw", static=True),)

    def __init__(self, **props):
        super().__init__(**props)
        self._fh = None

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        if self._fh is None:
            self._fh = open(self.props["location"], "wb")
        data = np_batch.data
        for i in range(np_batch.batch):
            if isinstance(data, dict):
                for k in ("y", "u", "v", "a"):
                    if k in data:
                        self._fh.write(np.ascontiguousarray(
                            data[k][i]).tobytes())
            else:
                self._fh.write(np.ascontiguousarray(data[i]).tobytes())
        self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


@register
class MultiFileSink(Element):
    """multifilesink analog: location printf-pattern, one file per frame."""

    NAME = "multifilesink"
    KIND = "sink"
    HOST = True
    PROPERTIES = (Property("location", str, "frame%05d.raw", static=True),)

    def __init__(self, **props):
        super().__init__(**props)
        self._index = 0

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        data = np_batch.data
        for i in range(np_batch.batch):
            path = self.props["location"] % self._index
            with open(path, "wb") as f:
                if isinstance(data, dict):
                    for k in sorted(data):
                        f.write(np.ascontiguousarray(data[k][i]).tobytes())
                else:
                    f.write(np.ascontiguousarray(data[i]).tobytes())
            self._index += 1


@register
class GdpFileSink(Element):
    """gdppay ! filesink analog: length-prefixed GDP packets to a file."""

    NAME = "gdpfilesink"
    KIND = "sink"
    HOST = True
    PROPERTIES = (Property("location", str, "out.gdp", static=True),)

    def __init__(self, **props):
        super().__init__(**props)
        self._fh = None

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        if self._fh is None:
            self._fh = open(self.props["location"], "wb")
        blob = gdp.pay(np_batch, self.out_spec)
        self._fh.write(struct.pack("<Q", len(blob)))
        self._fh.write(blob)
        self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


@register
class GdpFileSrc(Element):
    """filesrc ! gdpdepay analog: read GDP packets; spec comes from the
    stream (caps-over-the-wire)."""

    NAME = "gdpfilesrc"
    KIND = "host-source"
    PROPERTIES = (Property("location", str, "in.gdp", static=True),)

    def __init__(self, **props):
        super().__init__(**props)
        self._fh = None
        self._spec = None

    def negotiate(self, in_spec):
        self._fh = open(self.props["location"], "rb")
        self._pending_off = 0
        self._pending, self._spec = self._read_packet()
        if self._pending is None:
            raise EOFError("gdpfilesrc: empty stream")
        return self._spec

    def _read_packet(self):
        hdr = self._fh.read(8)
        if len(hdr) < 8:
            return None, self._spec
        (n,) = struct.unpack("<Q", hdr)
        return gdp.depay(self._fh.read(n))

    def pull_window(self, window: int):
        if self._pending is not None:
            batch, self._pending = self._pending, None
            return batch
        self._pending_off = self._fh.tell()
        batch, _ = self._read_packet()
        return batch

    # checkpoint/resume (Pipeline.save_checkpoint): file byte offset of the
    # next unconsumed packet
    def save_position(self):
        if self._pending is not None:
            return self._pending_off
        return self._fh.tell()

    def restore_position(self, pos) -> None:
        if self._fh is None:
            self._fh = open(self.props["location"], "rb")
        self._fh.seek(pos)
        self._pending = None

    def process(self, params, state, batch):
        return state, batch


@register
class Y4mFileSrc(Element):
    """y4mdec analog (gst/y4m/gsty4mdec.c) as a file source: parse the
    YUV4MPEG2 header into the MediaSpec (caps) and emit I420 planar
    windows.  (The reference decodes a byte stream mid-pipeline; here the
    io/y4m.py reader does the byte parsing and this element frames it.)"""

    NAME = "y4mfilesrc"
    KIND = "host-source"
    PROPERTIES = (Property("location", str, "in.y4m", static=True),)

    def __init__(self, **props):
        super().__init__(**props)
        self._planes = None
        self._pos = 0

    def negotiate(self, in_spec):
        from gstbad.io import y4m
        spec, self._planes = y4m.read_y4m(self.props["location"])
        self._n = next(iter(self._planes.values())).shape[0]
        self._dur = spec.frame_duration_ns
        return spec

    def pull_window(self, window: int):
        import jax.numpy as jnp
        if self._pos >= self._n:
            return None
        n = min(window, self._n - self._pos)
        sl = slice(self._pos, self._pos + n)
        data = {k: jnp.asarray(v[sl]) for k, v in self._planes.items()}
        pts = (self._pos + np.arange(n, dtype=np.int64)) * self._dur
        self._pos += n
        return FrameBatch.make(data, pts=jnp.asarray(pts))

    def save_position(self):
        return self._pos

    def restore_position(self, pos) -> None:
        self._pos = pos

    def process(self, params, state, batch):
        return state, batch


@register
class Y4mFileSink(Element):
    """y4m writer endpoint (the gst-good y4menc ! filesink chain analog;
    pairs with y4mfilesrc for launch-string y4m io)."""

    NAME = "y4mfilesink"
    KIND = "sink"
    HOST = True
    PROPERTIES = (Property("location", str, "out.y4m", static=True),)

    def __init__(self, **props):
        super().__init__(**props)
        self._frames = []

    def negotiate(self, in_spec):
        from gstbad.core.spec import VideoFormat, require
        require(in_spec.kind == "video"
                and in_spec.format == VideoFormat.I420,
                "y4mfilesink: needs I420 (use videoconvert)")
        return in_spec

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        valid = np.asarray(np_batch.valid)
        data = {k: np.asarray(v)[valid] for k, v in np_batch.data.items()}
        if data["y"].shape[0]:
            self._frames.append(data)

    def close(self):
        from gstbad.io import y4m
        if self._frames:
            merged = {k: np.concatenate([f[k] for f in self._frames])
                      for k in self._frames[0]}
            y4m.write_y4m(self.props["location"], self.out_spec, merged)
            self._frames = []


@register
class AiffFileSrc(Element):
    """aiffparse analog (gst/aiff/aiffparse.c) as a file source: parse
    FORM/COMM/SSND into the audio MediaSpec and emit [B, S, C] sample
    windows.  S8 widens to S16 (same values) and S24 to S32
    (sign-extended) to land on the framework's native AudioFormat set —
    io/aiff.py documents the byte-level parsing quirks kept."""

    NAME = "aifffilesrc"
    KIND = "host-source"
    PROPERTIES = (
        Property("location", str, "in.aiff", static=True),
        Property("samplesperbuffer", int, 1024, 1, None, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._samples = None
        self._pos = 0

    def negotiate(self, in_spec):
        from gstbad.io import aiff
        spec, samples = aiff.read_aiff(self.props["location"])
        if spec.format == "S8":
            import dataclasses
            samples = samples.astype(np.int16)
            spec = dataclasses.replace(spec, format="S16")
        self._samples = samples
        self._rate = spec.rate
        return spec

    def pull_window(self, window: int):
        import jax.numpy as jnp
        s = self.props["samplesperbuffer"]
        total = self._samples.shape[0]
        if self._pos >= total:
            return None
        blocks = []
        pts = []
        for _ in range(window):
            if self._pos >= total:
                blocks.append(np.zeros((s,) + self._samples.shape[1:],
                                       self._samples.dtype))
                pts.append(pts[-1] if pts else 0)
                continue
            chunk = self._samples[self._pos:self._pos + s]
            if chunk.shape[0] < s:
                chunk = np.pad(chunk, ((0, s - chunk.shape[0]), (0, 0)))
            blocks.append(chunk)
            pts.append(self._pos * 10 ** 9 // self._rate)
            self._pos += s
        valid = jnp.asarray([p * self._rate // 10 ** 9 < total or i == 0
                             for i, p in enumerate(pts)])
        return FrameBatch.make(jnp.asarray(np.stack(blocks)),
                               pts=jnp.asarray(np.asarray(pts, np.int64)))

    def save_position(self):
        return self._pos

    def restore_position(self, pos) -> None:
        self._pos = pos

    def process(self, params, state, batch):
        return state, batch


@register
class AiffFileSink(Element):
    """aiffmux ! filesink analog: accumulate [B, S, C] windows, write one
    AIFF (AIFC for float formats) at close (aiffmux.c:213-249)."""

    NAME = "aifffilesink"
    KIND = "sink"
    HOST = True
    PROPERTIES = (Property("location", str, "out.aiff", static=True),)

    def __init__(self, **props):
        super().__init__(**props)
        self._blocks = []

    def negotiate(self, in_spec):
        from gstbad.core.spec import require
        require(in_spec.kind == "audio",
                "aifffilesink: needs audio input")
        return in_spec

    def process(self, params, state, batch):
        return state, batch

    def host_process(self, np_batch, bus) -> None:
        valid = np.asarray(np_batch.valid)
        data = np.asarray(np_batch.data)[valid]
        if data.shape[0]:
            self._blocks.append(data.reshape(-1, data.shape[-1]))

    def close(self):
        from gstbad.io import aiff
        if self._blocks:
            aiff.write_aiff(self.props["location"], self.out_spec,
                            np.concatenate(self._blocks))
            self._blocks = []
