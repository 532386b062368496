"""x265enc / libde265dec (ext/x265/gstx265enc.c,
ext/libde265/libde265-dec.c) over the REAL libx265 + libde265
(io/h265.py ctypes bindings — the exact libraries the reference
wraps).

- x265enc: I420 in; every valid frame runs through the reference's
  param walk (x265_param_default_preset(speed-preset, tune), bitrate
  vs qp selection, key-int-max, option-string as colon-separated
  x265_param_parse pairs — gstx265enc.c:56-72 properties).  Encoded
  annex-B access units post as `h265-nal` bus messages and mirror in
  `.packets`; the lookahead drains into `.packets` at close().
- libde265dec: host-source; push annex-B bytes, I420 frames out
  (the reference's only src format, libde265-dec.c:64)."""

from __future__ import annotations

import fractions

import numpy as np
import jax.numpy as jnp

from gstbad.core.element import Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import MediaSpec, VideoFormat, require
from gstbad.io import h265


@register
class X265Enc(Element):
    NAME = "x265enc"
    HOST = True
    PROPERTIES = (
        Property("bitrate", int, 2048, 1, 100000, static=True,
                 doc="kbit/s (PROP_BITRATE_DEFAULT 2*1024)"),
        Property("qp", int, -1, -1, 51, static=True,
                 doc="-1 = rate control by bitrate; otherwise CQP"),
        Property("option-string", str, "", static=True,
                 doc="colon-separated x265_param_parse pairs"),
        Property("speed-preset", str, "medium", static=True),
        Property("tune", str, "ssim", static=True,
                 doc="PROP_TUNE_DEFAULT ssim"),
        Property("key-int-max", int, 0, 0, 65535, static=True),
        Property("lossless", bool, False, static=True,
                 doc="x265 lossless mode (exposed beyond the "
                     "reference for bit-exact round-trip tests)"),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self.packets = []            # (pts_ns, annex-B bytes)
        self._enc = None
        self._closed = False

    def negotiate(self, in_spec):
        require(h265.available(),
                "x265enc: libx265/libde265 not available")
        require(in_spec.kind == "video"
                and in_spec.format == VideoFormat.I420,
                "x265enc: needs I420 input (gstx265enc sink caps; "
                "use videoconvert)")
        fr = in_spec.framerate or fractions.Fraction(30, 1)
        self._enc = h265.H265Encoder(
            in_spec.width, in_spec.height,
            fps=f"{fr.numerator}/{fr.denominator}",
            speed_preset=self.props["speed-preset"],
            tune=self.props["tune"],
            bitrate_kbps=self.props["bitrate"],
            qp=self.props["qp"],
            key_int_max=self.props["key-int-max"],
            option_string=self.props["option-string"],
            lossless=self.props["lossless"])
        return in_spec

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        from gstbad.core.bus import Message
        d = np_batch.data
        for i in range(np_batch.batch):
            if not bool(np.asarray(np_batch.valid)[i]):
                continue
            pts = int(np.asarray(np_batch.pts)[i])
            data = self._enc.encode(np.asarray(d["y"][i]),
                                    np.asarray(d["u"][i]),
                                    np.asarray(d["v"][i]), pts=pts)
            if data:
                self.packets.append((pts, data))
                if bus is not None:
                    bus.post(Message(self.NAME, "h265-nal", pts,
                                     {"data": data}))

    def close(self) -> None:
        """Drain the encoder lookahead (EOS)."""
        if self._closed or self._enc is None:
            return
        self._closed = True
        for data in self._enc.flush():
            pts = self.packets[-1][0] if self.packets else 0
            self.packets.append((pts, data))

    def stream(self) -> bytes:
        """The full annex-B stream produced so far (drains first)."""
        self.close()
        return b"".join(d for _p, d in self.packets)


@register
class LibDe265Dec(Element):
    NAME = "libde265dec"
    KIND = "host-source"
    PROPERTIES = (
        Property("framerate", str, "30/1", static=True),
        Property("max-threads", int, 0, 0, 64, static=True,
                 doc="accepted for parity; this build decodes "
                     "single-threaded in-process"),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._stream = b""
        self._frames = None
        self._pos = 0

    def push_packet(self, data: bytes) -> None:
        self._stream += bytes(data)

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def negotiate(self, in_spec):
        require(h265.available(),
                "libde265dec: libde265 not available")
        require(self._stream,
                "libde265dec: push_packet() annex-B bytes first")
        dec = h265.H265Decoder()
        dec.push(self._stream)
        dec.flush()
        self._frames = dec.decode()
        require(self._frames, "libde265dec: no decodable pictures")
        h, w = self._frames[0]["y"].shape
        self._fr = fractions.Fraction(self.props["framerate"])
        return MediaSpec(kind="video", format=VideoFormat.I420,
                         width=w, height=h, framerate=self._fr)

    def pull_window(self, window: int):
        if self._pos >= len(self._frames):
            return None
        dur = self.out_spec.frame_duration_ns
        ys, us, vs, pts, valid = [], [], [], [], []
        for _ in range(window):
            idx = min(self._pos, len(self._frames) - 1)
            f = self._frames[idx]
            ys.append(f["y"])
            us.append(f["u"])
            vs.append(f["v"])
            pts.append(idx * dur)
            valid.append(self._pos < len(self._frames))
            self._pos += 1
        data = {"y": jnp.asarray(np.stack(ys)),
                "u": jnp.asarray(np.stack(us)),
                "v": jnp.asarray(np.stack(vs))}
        return FrameBatch.make(
            data, pts=jnp.asarray(np.asarray(pts, np.int64)),
            valid=jnp.asarray(valid))

    def save_position(self):
        return self._pos

    def restore_position(self, pos) -> None:
        self._pos = pos
