"""Transcoder — the GstTranscoder analog (gst-libs/gst/transcoder/).

The reference wraps uritranscodebin (decodebin3 -> profile encoders -> mux)
with position signals; the output shape is chosen by a serialized
GstEncodingProfile ("container:videocaps[:audiocaps]",
gst-libs/gst/pbutils encoding-profile syntax).  Here the profile string
selects among this framework's containers and (r3) its REAL codec
elements:

    "y4m"            I420/GRAY8 YUV4MPEG2 (default)
    "y4m:GRAY8"      force an output format (auto-inserts videoconvert)
    "pnm"            P5/P6 image sequence (dest must contain a %d pattern)
    "gdp"            GDP packet stream (any negotiated format, caps on
                     the wire)
    "hevc"           H.265 annex-B elementary stream via x265enc (the
                     real libx265); options "hevc:qp=24" or
                     "hevc:lossless"; needs I420 reaching the encoder
    "av1"            AV1 in an IVF container via av1enc (the real
                     libaom); option "av1:bitrate=NNN" (kbit/s)

Inputs: .y4m or .gdp files.  Progress posts `position` messages and the
optional on_position callback, like GstTranscoder's signals.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from gstbad.core.frame import FrameBatch
from gstbad.core.bus import Message
from gstbad.core.pipeline import Pipeline, parse_launch
from gstbad.core.spec import MediaSpec, VideoFormat
from gstbad.io import y4m


class Transcoder:
    def __init__(self, src_uri: str, dest_uri: str, filters: str = "",
                 window: int = 8, profile: str = "y4m",
                 on_position: Optional[Callable[[int, int], None]] = None):
        self.src_uri = src_uri
        self.dest_uri = dest_uri
        self.filters = filters.strip()
        self.window = window
        self.on_position = on_position
        container, _, fmt = profile.partition(":")
        self.container = container or "y4m"
        if self.container not in ("y4m", "pnm", "gdp", "hevc", "av1"):
            raise ValueError(f"unknown profile container {container!r}; "
                             "known: y4m, pnm, gdp, hevc, av1")
        self.codec_opt = fmt if self.container in ("hevc", "av1") \
            else None
        self.out_format = None if self.container in ("hevc", "av1") \
            else (fmt or None)
        if self.container == "pnm" and "%" not in dest_uri:
            raise ValueError("pnm profile writes an image sequence; "
                             "dest must contain a %d pattern")
        desc = ("gdpfilesrc name=tsrc location=" + src_uri
                if src_uri.endswith(".gdp") else "appsrc name=tsrc")
        if self.filters:
            desc += " ! " + self.filters
        if self.out_format:
            desc += f" ! videoconvert format={self.out_format}"
        elif self.container == "y4m" and self.filters:
            pass  # caller's filters decide; run() validates planar output
        if self.container == "hevc":
            enc = "x265enc name=tenc speed-preset=ultrafast " \
                  "tune=zerolatency"
            if self.codec_opt == "lossless":
                enc += " lossless=true"
            elif self.codec_opt and self.codec_opt.startswith("qp="):
                enc += f" qp={int(self.codec_opt[3:])}"
            desc += " ! " + enc
        elif self.container == "av1":
            enc = "av1enc name=tenc usage-profile=realtime cpu-used=8"
            if self.codec_opt and self.codec_opt.startswith("bitrate="):
                enc += f" target-bitrate={int(self.codec_opt[8:])}"
            desc += " ! " + enc
        desc += " ! appsink"
        self.pipeline = parse_launch(desc)

    @property
    def bus(self):
        return self.pipeline.bus

    def _read_input(self):
        if self.src_uri.endswith(".y4m"):
            spec, planes = y4m.read_y4m(self.src_uri)
            src = self.pipeline.get_by_name("tsrc")
            src.props["kind"] = "video"
            src.props["format"] = VideoFormat.I420
            src.props["width"] = spec.width
            src.props["height"] = spec.height
            src.props["framerate"] = (f"{spec.framerate.numerator}/"
                                      f"{spec.framerate.denominator}")
            n = planes["y"].shape[0]
            src.push_frames(planes)
            return spec, n
        if self.src_uri.endswith(".gdp"):
            # frame count comes from the stream; estimate duration after
            return None, None
        raise ValueError("transcoder reads .y4m or .gdp input")

    def run(self) -> int:
        """Transcode to completion; returns the number of frames written."""
        spec, n = self._read_input()
        out_spec = self.pipeline.negotiate()
        if spec is not None:
            total_ns = int(n * spec.frame_duration_ns)
        else:
            total_ns = 0
        outs = self.pipeline.run(window=self.window)
        batches = outs if isinstance(outs, list) else outs[0]
        written = 0
        sink_planes = {"y": [], "u": [], "v": []}
        packed_frames = []
        gdp_blobs = []
        from gstbad.io import gdp as gdpio
        for b in batches:
            data = b.data
            if self.container in ("hevc", "av1"):
                pass                 # the encoder tap collects packets
            elif self.container == "y4m":
                if not isinstance(data, dict):
                    raise ValueError(
                        f"y4m profile needs planar output; pipeline "
                        f"produced {out_spec}; add `videoconvert "
                        "format=I420` or use profile='gdp'/'pnm'")
                for k in sink_planes:
                    sink_planes[k].append(np.asarray(data[k]))
            elif self.container == "pnm":
                if isinstance(data, dict):
                    raise ValueError("pnm profile needs GRAY8 or packed "
                                     "RGB output")
                packed_frames.append(np.asarray(data))
            else:  # gdp
                gdp_blobs.append(gdpio.pay(b.to_numpy(), out_spec))
            written += b.batch
            pos = int(np.asarray(b.pts)[-1]) if b.batch else 0
            if self.on_position:
                self.on_position(pos, total_ns)
            self.bus.post(Message("transcoder", "position", pos,
                                  {"position": pos, "duration": total_ns}))
        if self.container in ("hevc", "av1"):
            enc = self.pipeline.get_by_name("tenc")
            enc.close()              # drain the encoder lookahead
            if self.container == "hevc":
                with open(self.dest_uri, "wb") as f:
                    for _pts, d in enc.packets:
                        f.write(d)
            else:
                from gstbad.io.ivf import write_ivf
                fr = out_spec.framerate
                write_ivf(self.dest_uri, b"AV01", out_spec.width,
                          out_spec.height, fr.numerator,
                          fr.denominator,
                          [(i, d) for i, (_p, d)
                           in enumerate(enc.packets)])
        elif self.container == "y4m":
            merged = {k: np.concatenate(v) for k, v in sink_planes.items()}
            y4m.write_y4m(self.dest_uri, out_spec, merged)
        elif self.container == "pnm":
            from gstbad.io.pnm import write_pnm
            offs = None
            if out_spec.format in VideoFormat.PACKED_RGB4 \
                    or out_spec.format in VideoFormat.PACKED_RGB3:
                offs = list(VideoFormat.rgb_offsets(out_spec.format)[:3])
            i = 0
            for chunk in packed_frames:
                for frame in chunk:
                    img = frame[..., offs] if offs and frame.ndim == 3 \
                        else frame
                    write_pnm(self.dest_uri % i, img)
                    i += 1
        else:
            import struct
            with open(self.dest_uri, "wb") as f:
                for blob in gdp_blobs:
                    f.write(struct.pack("<Q", len(blob)))  # gdpfilesink framing
                    f.write(blob)
        return written
