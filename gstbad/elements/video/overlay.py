"""Subtitle/graphics overlay — the dvdspu / dvbsuboverlay compositing analog
(gst/dvdspu/, gst/dvbsuboverlay/).

The reference blends decoded subpicture RGBA/palette planes onto video with
per-pixel alpha; `suboverlay` does the same for an alpha-carrying overlay
branch (AYUV or A420-style planar) onto AYUV/I420 video, with integer
(alpha + 1)/256 blending in the reference's fixed-point style.

`dvdspu` additionally decodes the VobSub SPU BITSTREAM itself (io/spu.py:
DCSQT walk, nibble RLE, palette/alpha nibbles, display window timing) and
gates the blend on each frame's PTS against the subpicture's show/hide
ticks.  Divergences: chroma blends at full resolution (the reference's
compositing buffers are 4:2:2 horizontally subsampled) and CHG_COLCON
per-line palettes are parsed but not applied.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from gstbad.core.element import Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import MediaSpec, VideoFormat, require


def _blend(dst, src, alpha):
    """dst + (src - dst) * a, fixed point: (a * src + (255 - a) * dst) / 255
    evaluated as (x * 257 + 257) >> 16 style is overkill here; use exact
    integer rounding (x + 127) // 255."""
    d = dst.astype(jnp.int32)
    s = src.astype(jnp.int32)
    a = alpha.astype(jnp.int32)
    return ((a * s + (255 - a) * d + 127) // 255).astype(jnp.uint8)


@register
class SubOverlay(Element):
    """2-input: [video, overlay] -> video with the overlay alpha-blended.

    video: AYUV or I420; overlay: AYUV, or planar dict with an "a" plane
    (alphacombine output); geometries must match.
    """

    NAME = "suboverlay"
    N_INPUTS = 2

    def negotiate(self, in_spec):
        require(isinstance(in_spec, list) and len(in_spec) == 2,
                "suboverlay: needs (video, overlay) inputs")
        video, overlay = in_spec
        require(video.kind == "video" and overlay.kind == "video",
                "suboverlay: needs video inputs")
        require(video.width == overlay.width
                and video.height == overlay.height,
                "suboverlay: geometry mismatch")
        require(video.format in (VideoFormat.AYUV, VideoFormat.I420),
                f"suboverlay: video format {video.format} unsupported")
        require(overlay.format in (VideoFormat.AYUV, "A420"),
                f"suboverlay: overlay format {overlay.format} unsupported")
        self._video_fmt = video.format
        self._overlay_fmt = overlay.format
        return video

    def process(self, params, state, batches):
        video, overlay = batches
        if self._overlay_fmt == VideoFormat.AYUV:
            oa = overlay.data[..., 0]
            oy = overlay.data[..., 1]
            ou = overlay.data[..., 2]
            ov = overlay.data[..., 3]
        else:  # A420 planar dict
            oa = overlay.data["a"]
            oy = overlay.data["y"]
            ou = jnp.repeat(jnp.repeat(overlay.data["u"], 2, -2), 2, -1)
            ov = jnp.repeat(jnp.repeat(overlay.data["v"], 2, -2), 2, -1)
        if self._video_fmt == VideoFormat.AYUV:
            out = video.data
            out = out.at[..., 1].set(_blend(video.data[..., 1], oy, oa))
            out = out.at[..., 2].set(_blend(video.data[..., 2], ou, oa))
            out = out.at[..., 3].set(_blend(video.data[..., 3], ov, oa))
            return state, video.with_data(out)
        # I420: blend luma full-res; chroma at subsampled alpha
        y = _blend(video.data["y"], oy, oa)
        a_sub = oa[..., ::2, ::2]
        u = _blend(video.data["u"], ou[..., ::2, ::2], a_sub)
        v = _blend(video.data["v"], ov[..., ::2, ::2], a_sub)
        return state, video.with_data({"y": y, "u": u, "v": v})


@register
class DvbSubOverlay(Element):
    """dvbsuboverlay (gst/dvbsuboverlay/gstdvbsuboverlay.c): decode DVB
    subtitle PES payloads (io/dvbsub.py, the dvb-sub.c segment parser) and
    blend the active display set onto AYUV video.

    PES payloads arrive via `push_pes(data, pts_ns)` before the run (the
    reference takes them on a subtitle pad mid-stream; our window model
    decodes on the host and bakes overlays as device constants).  A
    display set shows from its PTS until the next set's PTS or its
    page-time-out, whichever is first; sets with zero rects clear the
    screen; page-time-out 0 is overridden to 1 s and capped by
    max-page-timeout (gstdvbsuboverlay.c:795-845, 1063-1125).  Blending is
    the video-blend.c truncating (D*(256-a) + S*a) >> 8 on Y/U/V; the
    composition's linear rect rescale is nearest-neighbor here and the
    video alpha channel is left untouched (documented divergences)."""

    NAME = "dvbsuboverlay"
    PROPERTIES = (
        Property("enable", bool, True, static=True),
        Property("max-page-timeout", int, 0, 0, None, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        from gstbad.io.dvbsub import DvbSubParser
        self._parser = DvbSubParser()
        self._sets = []

    def push_pes(self, data: bytes, pts_ns: int = 0) -> None:
        self._sets.extend(self._parser.feed(data, pts_ns))

    def negotiate(self, in_spec):
        require(in_spec.kind == "video"
                and in_spec.format == VideoFormat.AYUV,
                "dvbsuboverlay: needs AYUV video (use videoconvert)")
        return in_spec

    def process(self, params, state, batch: FrameBatch):
        from gstbad.io.dvbsub import display_set_to_ayuv
        out = batch.data
        if not self.props["enable"] or not self._sets:
            return state, batch
        h, w = out.shape[1], out.shape[2]
        max_to = self.props["max-page-timeout"]
        for i, ds in enumerate(self._sets):
            if not ds.rects:
                continue                      # clear-screen set
            timeout = ds.page_time_out
            if max_to > 0:
                timeout = min(timeout, max_to)
            if timeout == 0:
                timeout = 1                   # gstdvbsuboverlay.c:821-824
            show = ds.pts_ns
            hide = show + timeout * 10 ** 9
            if i + 1 < len(self._sets):       # replaced by the next set
                hide = min(hide, self._sets[i + 1].pts_ns)
            ov = jnp.asarray(display_set_to_ayuv(ds, w, h))
            a = ov[..., 0].astype(jnp.int32)
            active = (batch.pts >= show) & (batch.pts < hide)
            act = active[:, None, None, None]
            d = out.astype(jnp.int32)
            s = ov.astype(jnp.int32)
            blended = (d * (256 - a[None, ..., None])
                       + s * a[None, ..., None]) >> 8
            blended = blended.at[..., 0].set(d[..., 0])
            out = jnp.where(act & (a[None] > 0)[..., None],
                            blended.astype(jnp.uint8), out)
        return state, batch.with_data(out)


@register
class DvdSpu(Element):
    """dvdspu (gst/dvdspu/gstdvdspu.c + gstspu-vobsub.c): decode a VobSub
    subpicture packet and blend it onto the video while its display window
    is active.

    Subpicture packets arrive via `push_spu(data, pts_ns, clut=None)`
    before the run (the reference takes them on a second pad mid-stream;
    our window model decodes on the host and bakes the overlay as a device
    constant — re-push + rerun recompiles).  Blending is the reference's
    truncating (inv_a*dst + a*src)/255 (gstspu-vobsub-render.c:172-190)."""

    NAME = "dvdspu"

    def __init__(self, **props):
        super().__init__(**props)
        self._pending = []   # (pic, pts_ns, overlay np [H,W,4] AYUV)

    def push_spu(self, data: bytes, pts_ns: int = 0,
                 clut: np.ndarray = None) -> None:
        from gstbad.io import spu as spuio
        pic = spuio.parse_spu(data)
        overlay = spuio.spu_to_ayuv(pic, clut)
        self._pending.append((pic, pts_ns, overlay))

    def negotiate(self, in_spec):
        require(in_spec.kind == "video"
                and in_spec.format == VideoFormat.AYUV,
                "dvdspu: needs AYUV video (use videoconvert)")
        return in_spec

    def process(self, params, state, batch: FrameBatch):
        out = batch.data
        h, w = out.shape[1], out.shape[2]
        for pic, pts_ns, overlay in self._pending:
            top, left = pic.rect[0], pic.rect[1]
            full = np.zeros((h, w, 4), np.uint8)
            ph = min(pic.height, h - top)
            pw = min(pic.width, w - left)
            if ph <= 0 or pw <= 0:
                continue
            full[top:top + ph, left:left + pw] = overlay[:ph, :pw]
            ov = jnp.asarray(full)
            a = ov[..., 0].astype(jnp.int32)
            show = pts_ns + pic.show_ns()
            hide_ns = pic.hide_ns()
            hide = pts_ns + hide_ns if hide_ns is not None else None
            active = batch.pts >= show
            if hide is not None:
                active = active & (batch.pts < hide)
            act = active[:, None, None, None]
            d = out.astype(jnp.int32)
            s = ov.astype(jnp.int32)
            blended = ((255 - a[None, ..., None]) * d
                       + a[None, ..., None] * s) // 255
            blended = blended.at[..., 0].set(d[..., 0])  # video alpha kept
            out = jnp.where(act & (a[None] > 0)[..., None],
                            blended.astype(jnp.uint8), out)
        return state, batch.with_data(out)


@register
class DvbSubEnc(Element):
    """dvbsubenc (gst/dvbsubenc/gstdvbsubenc.c): encode AYUV subtitle
    pictures to DVB subtitle private-PES packets (io/dvbsubenc.py is
    the byte-level spec, transcribed from gstdvbsubenc-util.c with its
    RLE branch quirks; the >max-colours quantizer replaces the vendored
    libimagequant — documented there).

    Host element: the device path passes video through; each valid
    frame's packet posts as a `dvbsub-pes` bus message (data/x/y) with
    pts shifted by ts-offset (gst_pad_set_offset analog,
    gstdvbsubenc.c:201), and a pending end-of-page packet (empty
    display set) posts when a later frame's pts passes the previous
    subtitle's end time (gst_dvb_sub_enc_generate_end_packet) —
    io/dvbsub.py's decoder reads the stream back (the round-trip
    tests' oracle).  All-transparent frames are skipped (the
    reference's negative-width crop is fixed, not reproduced)."""

    NAME = "dvbsubenc"
    HOST = True
    PROPERTIES = (
        Property("max-colours", int, 16, 1, 256, static=True,
                 doc="DEFAULT_MAX_COLOURS 16 (gstdvbsubenc.c:42)"),
        Property("ts-offset", int, 0, None, None, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._object_version = 0
        self._current_end_time = None
        self.packets = []        # (pts_ns, bytes) mirror of the posts

    def negotiate(self, in_spec):
        require(in_spec.kind == "video"
                and in_spec.format == VideoFormat.AYUV,
                "dvbsubenc: needs AYUV input (use videoconvert)")
        self._dur = in_spec.frame_duration_ns
        return in_spec

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def _post(self, bus, name: str, pts: int, fields: dict) -> None:
        from gstbad.core.bus import Message
        self.packets.append((pts, fields["data"]))
        if bus is not None:
            bus.post(Message(self.NAME, name, pts, fields))

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        from gstbad.io import dvbsubenc as enc
        off = self.props["ts-offset"]
        for i in range(np_batch.batch):
            if not bool(np.asarray(np_batch.valid)[i]):
                continue
            pts = int(np.asarray(np_batch.pts)[i])
            if self._current_end_time is not None \
                    and self._current_end_time < pts:
                pkt = enc.encode_display_set(
                    self._object_version & 0xF, 1, [])
                self._object_version += 1
                self._post(bus, "dvbsub-pes",
                           self._current_end_time + off,
                           {"data": pkt, "x": 0, "y": 0, "end": True})
                self._current_end_time = None
            frame = np.asarray(np_batch.data[i])
            res = enc.encode_frame(frame, self._object_version,
                                   self.props["max-colours"])
            if res is None:
                continue
            pkt, x, y = res
            self._object_version += 1
            self._post(bus, "dvbsub-pes", pts + off,
                       {"data": pkt, "x": x, "y": y, "end": False})
            self._current_end_time = pts + self._dur
