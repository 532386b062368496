"""gmedec / openmptdec (ext/gme/gstgme.c, ext/openmpt/
gstopenmptdec.c) over the REAL libgme / libopenmpt shipped in this
environment (io/gme.py, io/openmpt.py — the exact libraries the
reference wraps).

Both are host-sources: push the module file bytes with push_packet()
(the reference accumulates its sink pad until EOS, then opens the
whole blob — gstgme.c:139-148/376-396), and PCM blocks flow from
pull_window.  Tags and duration post as a `tags` bus message on the
first processed window (the reference pushes a tag event +
GST_TAG_DURATION, gstgme.c:411-447)."""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from gstbad.core.element import Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import AudioFormat, MediaSpec, require
from gstbad.io import gme as gme_io
from gstbad.io import openmpt as mpt_io


class _ModuleSourceBase(Element):
    """Shared pull/pts/tag plumbing for the module decoders."""

    KIND = "host-source"
    HOST = True

    def __init__(self, **props):
        super().__init__(**props)
        self._data = b""
        self._pos = 0            # output sample position
        self._done = False
        self._tags = {}
        self._duration_ns = None
        self._posted_tags = False

    def push_packet(self, data: bytes) -> None:
        """Module file bytes (may arrive in several chunks; the
        reference's chain fn adapter-accumulates the same way)."""
        self._data += bytes(data)

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def _block(self, n: int):
        """-> [n, C] PCM or None at end of song (subclass)."""
        raise NotImplementedError

    def pull_window(self, window: int):
        if self._done:
            return None
        spec = self.out_spec
        s = self._spb
        blocks, pts, valid = [], [], []
        zero = np.zeros((s, spec.channels), self._dtype)
        last_any = False
        for _ in range(window):
            blk = None if self._done else self._block(s)
            if blk is None or blk.shape[0] == 0:
                self._done = True
                blocks.append(zero)
                pts.append(pts[-1] if pts else 0)
                valid.append(False)
                continue
            if blk.shape[0] < s:
                blk = np.pad(blk, ((0, s - blk.shape[0]), (0, 0)))
                self._done = True
            blocks.append(blk.astype(self._dtype))
            pts.append(self._pos * 10 ** 9 // spec.rate)
            valid.append(True)
            self._pos += s
            last_any = True
        if not last_any:
            return None
        return FrameBatch.make(
            jnp.asarray(np.stack(blocks)),
            pts=jnp.asarray(np.asarray(pts, np.int64)),
            valid=jnp.asarray(valid))

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        from gstbad.core.bus import Message
        if self._posted_tags or bus is None:
            return
        self._posted_tags = True
        fields = dict(self._tags)
        if self._duration_ns is not None:
            fields["duration"] = self._duration_ns
        bus.post(Message(self.NAME, "tags", 0, fields))

    def save_position(self):
        return self._pos

    def restore_position(self, pos) -> None:
        self._pos = pos
        self._done = False
        self._seek(pos)

    def _seek(self, pos: int) -> None:
        """Engine seek for checkpoint resume (subclass)."""


@register
class GmeDec(_ModuleSourceBase):
    """Game-music decoder: S16 stereo at 32000 Hz in 1600-frame
    buffers, exactly the reference's fixed caps and NUM_SAMPLES
    (gstgme.c:48-50, 325)."""

    NAME = "gmedec"
    PROPERTIES = (
        Property("track", int, 0, 0, 255, static=True,
                 doc="the reference always starts track 0; exposed "
                     "for multi-track dumps"),
    )

    def negotiate(self, in_spec):
        require(gme_io.available(), "gmedec: libgme not available")
        require(self._data, "gmedec: push_packet() the module first")
        self._player = gme_io.GmePlayer(self._data, 32000,
                                        self.props["track"])
        self._tags = dict(self._player.info)
        self._tags["track-count"] = self._player.track_count
        self._duration_ns = self._player.duration_ms * 10 ** 6
        self._spb = 1600
        self._dtype = np.int16
        return MediaSpec(kind="audio", format=AudioFormat.S16,
                         rate=32000, channels=2)

    def _block(self, n: int):
        return self._player.play(n)

    def _seek(self, pos: int) -> None:
        self._player.seek_frames(pos)


@register
class OpenMptDec(_ModuleSourceBase):
    """Tracker-module decoder; render parameters map 1:1 onto the
    reference's properties (gstopenmptdec.c:55-72, 641-650)."""

    NAME = "openmptdec"
    PROPERTIES = (
        Property("master-gain", int, 0, None, None, static=True,
                 doc="millibel (DEFAULT_MASTER_GAIN 0)"),
        Property("stereo-separation", int, 100, 0, 400, static=True),
        Property("filter-length", int, 0, 0, 8, static=True,
                 doc="0 = internal default, 1/2/4/8 taps"),
        Property("volume-ramping", int, -1, -1, 10, static=True),
        Property("output-buffer-size", int, 1024, 1, 65536,
                 static=True),
        Property("format", str, AudioFormat.F32, static=True,
                 doc="F32 (default) or S16 (the reference's caps)"),
        Property("rate", int, 48000, 1, 192000, static=True),
        Property("channels", int, 2, 1, 2, static=True),
        Property("subsong", int, 0, 0, 255, static=True),
        Property("num-loops", int, 0, -1, None, static=True),
    )

    def negotiate(self, in_spec):
        require(mpt_io.available(),
                "openmptdec: libopenmpt not available")
        require(self._data,
                "openmptdec: push_packet() the module first")
        mod = mpt_io.Module(self._data)
        require(self.props["subsong"] < max(mod.num_subsongs, 1),
                "openmptdec: subsong out of range")
        if mod.num_subsongs > 1 or self.props["subsong"]:
            mod.select_subsong(self.props["subsong"])
        mod.set_repeat_count(self.props["num-loops"])
        mod.set_render_param(mpt_io.RENDER_MASTERGAIN_MILLIBEL,
                             self.props["master-gain"])
        mod.set_render_param(mpt_io.RENDER_STEREOSEPARATION_PERCENT,
                             self.props["stereo-separation"])
        if self.props["filter-length"]:
            mod.set_render_param(
                mpt_io.RENDER_INTERPOLATIONFILTER_LENGTH,
                self.props["filter-length"])
        if self.props["volume-ramping"] >= 0:
            mod.set_render_param(mpt_io.RENDER_VOLUMERAMPING_STRENGTH,
                                 self.props["volume-ramping"])
        self._mod = mod
        self._tags = mod.tags()
        self._tags["num-subsongs"] = mod.num_subsongs
        self._duration_ns = int(mod.duration_seconds * 1e9)
        self._spb = self.props["output-buffer-size"]
        fmt = self.props["format"]
        require(fmt in (AudioFormat.F32, AudioFormat.S16),
                "openmptdec: format must be F32 or S16")
        self._dtype = np.float32 if fmt == AudioFormat.F32 \
            else np.int16
        return MediaSpec(kind="audio", format=fmt,
                         rate=self.props["rate"],
                         channels=self.props["channels"])

    def _block(self, n: int):
        fmt = "F32" if self._dtype == np.float32 else "S16"
        return self._mod.read(self.out_spec.rate, n,
                              self.out_spec.channels, fmt)

    def _seek(self, pos: int) -> None:
        self._mod.set_position_seconds(pos / self.out_spec.rate)
