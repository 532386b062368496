"""av1enc / av1dec (ext/aom/gstav1enc.c, gstav1dec.c) over the REAL
libaom shipped in this environment (io/av1.py ctypes binding — the
exact library the reference wraps).

av1enc's properties map 1:1 onto the aom_codec_enc_cfg fields the
reference sets (gstav1enc.c PROP_ list): cpu-used (AOME_SET_CPUUSED
control), end-usage vbr/cbr/cq/q, target-bitrate, min/max-quantizer,
undershoot/overshoot, buffer sizes, drop-frame, resize-* / superres-*
knobs, threads, keyframe-max-dist, usage-profile
good-quality/realtime/all-intra.  Encoded temporal units post as
`av1-frame` bus messages and mirror in `.packets`; the lag drains at
close().  av1dec is a host-source over pushed temporal units,
I420 out."""

from __future__ import annotations

import fractions

import numpy as np
import jax.numpy as jnp

from gstbad.core.element import Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import MediaSpec, VideoFormat, require
from gstbad.io import av1

_END_USAGE = {"vbr": 0, "cbr": 1, "cq": 2, "q": 3}
_USAGE = {"good-quality": 0, "realtime": 1, "all-intra": 2}


@register
class Av1Enc(Element):
    NAME = "av1enc"
    HOST = True
    PROPERTIES = (
        Property("cpu-used", int, 0, 0, 10, static=True,
                 doc="0 = slowest (the reference default); the "
                     "realtime usage profile clamps internally"),
        Property("end-usage", str, "vbr", static=True),
        Property("target-bitrate", int, 256, 1, 100000, static=True,
                 doc="kbit/s (DEFAULT_TARGET_BITRATE 256)"),
        Property("min-quantizer", int, 0, 0, 63, static=True),
        Property("max-quantizer", int, 63, 0, 63, static=True),
        Property("undershoot-pct", int, 25, 0, 1000, static=True),
        Property("overshoot-pct", int, 25, 0, 1000, static=True),
        Property("buf-sz", int, 6000, 1, 1000000, static=True),
        Property("buf-initial-sz", int, 4000, 1, 1000000,
                 static=True),
        Property("buf-optimal-sz", int, 5000, 1, 1000000,
                 static=True),
        Property("drop-frame", int, 0, 0, 100, static=True),
        Property("resize-mode", int, 0, 0, 4, static=True),
        Property("resize-denominator", int, 8, 8, 16, static=True),
        Property("resize-kf-denominator", int, 8, 8, 16,
                 static=True),
        Property("superres-mode", int, 0, 0, 4, static=True),
        Property("superres-denominator", int, 8, 8, 16, static=True),
        Property("superres-kf-denominator", int, 8, 8, 16,
                 static=True),
        Property("superres-qthresh", int, 63, 1, 63, static=True),
        Property("superres-kf-qthresh", int, 32, 1, 63, static=True),
        Property("threads", int, 0, 0, 64, static=True),
        Property("keyframe-max-dist", int, 30, 0, 9999, static=True),
        Property("lag-in-frames", int, 0, 0, 48, static=True),
        Property("usage-profile", str, "good-quality", static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self.packets = []            # (pts_ns, temporal-unit bytes)
        self._enc = None
        self._closed = False
        self._pending_pts = []

    def negotiate(self, in_spec):
        require(av1.available(), "av1enc: libaom not available")
        require(in_spec.kind == "video"
                and in_spec.format == VideoFormat.I420,
                "av1enc: needs I420 input (use videoconvert)")
        require(self.props["end-usage"] in _END_USAGE,
                "av1enc: end-usage must be vbr|cbr|cq|q")
        require(self.props["usage-profile"] in _USAGE,
                "av1enc: usage-profile must be "
                "good-quality|realtime|all-intra")
        fr = in_spec.framerate or fractions.Fraction(30, 1)
        cfg = {
            "rc_end_usage": _END_USAGE[self.props["end-usage"]],
            "rc_min_quantizer": self.props["min-quantizer"],
            "rc_max_quantizer": self.props["max-quantizer"],
            "rc_undershoot_pct": self.props["undershoot-pct"],
            "rc_overshoot_pct": self.props["overshoot-pct"],
            "rc_buf_sz": self.props["buf-sz"],
            "rc_buf_initial_sz": self.props["buf-initial-sz"],
            "rc_buf_optimal_sz": self.props["buf-optimal-sz"],
            "rc_dropframe_thresh": self.props["drop-frame"],
            "rc_resize_mode": self.props["resize-mode"],
            "rc_resize_denominator":
                self.props["resize-denominator"],
            "rc_resize_kf_denominator":
                self.props["resize-kf-denominator"],
            "rc_superres_mode": self.props["superres-mode"],
            "rc_superres_denominator":
                self.props["superres-denominator"],
            "rc_superres_kf_denominator":
                self.props["superres-kf-denominator"],
            "rc_superres_qthresh": self.props["superres-qthresh"],
            "rc_superres_kf_qthresh":
                self.props["superres-kf-qthresh"],
            "kf_max_dist": self.props["keyframe-max-dist"],
        }
        self._enc = av1.AV1Encoder(
            in_spec.width, in_spec.height,
            target_bitrate_kbps=self.props["target-bitrate"],
            cpu_used=self.props["cpu-used"],
            usage=_USAGE[self.props["usage-profile"]],
            timebase=(fr.denominator, fr.numerator),
            threads=self.props["threads"],
            lag_in_frames=self.props["lag-in-frames"],
            cfg_fields=cfg)
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
            self._pending_pts.append(pts)
            data = self._enc.encode(np.asarray(d["y"][i]),
                                    np.asarray(d["u"][i]),
                                    np.asarray(d["v"][i]))
            if data:
                out_pts = self._pending_pts.pop(0)
                self.packets.append((out_pts, data))
                if bus is not None:
                    bus.post(Message(self.NAME, "av1-frame", out_pts,
                                     {"data": data}))

    def close(self) -> None:
        if self._closed or self._enc is None:
            return
        self._closed = True
        for data in self._enc.flush():
            pts = self._pending_pts.pop(0) if self._pending_pts \
                else (self.packets[-1][0] if self.packets else 0)
            self.packets.append((pts, data))

    def stream_packets(self):
        self.close()
        return list(self.packets)


@register
class Av1Dec(Element):
    NAME = "av1dec"
    KIND = "host-source"
    PROPERTIES = (
        Property("framerate", str, "30/1", static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._units = []
        self._frames = None
        self._pos = 0

    def push_packet(self, data: bytes) -> None:
        """One AV1 temporal unit per push."""
        self._units.append(bytes(data))

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def negotiate(self, in_spec):
        require(av1.available(), "av1dec: libaom not available")
        require(self._units,
                "av1dec: push_packet() temporal units first")
        dec = av1.AV1Decoder()
        self._frames = []
        for unit in self._units:
            self._frames += dec.decode(unit)
        require(self._frames, "av1dec: no decodable frames")
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
