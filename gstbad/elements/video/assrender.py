"""assrender (ext/assrender/gstassrender.c): SSA/ASS subtitles onto
video.

io/ass.py holds the track model (libass replacement — parse/layout
divergences documented there) and the EXACT transcription of the
element's own blit_bgra_premultiplied compositing.  Host-push model:
`push_script(text)` feeds the codec-private header or a whole script
(ass_process_codec_private; Dialogue events included), and
`push_chunk(text, pts_ns, duration_ns)` feeds Matroska ASS chunks
(ass_process_chunk, duplicate ReadOrders dropped).  Overlays are
premultiplied-BGRA snapshots per event-transition interval, selected
by frame PTS on device and composited with the premultiplied OVER
blend (s + (255-a)*d/255).

Events that animate (\\t, \\move, \\fad/\\fade, karaoke) are sampled
WITHIN their active range at animation-fps (device-bank snapshots are
pre-rendered, so granularity trades HBM for smoothness; the reference
re-renders every frame on the CPU — set animation-fps to the video
rate for frame-exact parity, the 512-snapshot cap guards the bank).

Properties follow gstassrender.c:162-176: enable toggles rendering;
embeddedfonts and wait-text are accepted for API parity (font
attachments don't exist for the bitmap face, and the host-push model
has no async text stream to wait on — documented).  animation-fps is
this port's knob (no reference analog — the reference's per-frame
render loop has no sampling grid to configure)."""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from gstbad.core.element import Property, VideoFilter
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import VideoFormat


@register
class AssRender(VideoFilter):
    NAME = "assrender"
    FORMATS = VideoFormat.PACKED_RGB4 + VideoFormat.PACKED_RGB3
    PROPERTIES = (
        Property("enable", bool, True, static=True,
                 doc="enable rendering of subtitles"),
        Property("embeddedfonts", bool, True, static=True,
                 doc="accepted for parity (no font attachments here)"),
        Property("wait-text", bool, False, static=True,
                 doc="accepted for parity (host-push model)"),
        Property("face", str, "auto", static=True,
                 doc="auto | pango | fixed — pango shapes glyphs with"
                     " real fonts (io/ass._pango_span)"),
        Property("animation-fps", float, 10.0, static=True,
                 doc="snapshot rate inside animated events (\\t, \\move,"
                     " \\fad, karaoke); match the video rate for"
                     " frame-exact animation"),
    )

    _SNAPSHOT_CAP = 512
    _ANIM_RE = None  # compiled lazily

    def __init__(self, **props):
        super().__init__(**props)
        from gstbad.io.ass import AssTrack
        self._track = AssTrack()

    def push_script(self, text: str) -> None:
        self._track.process_script(text)

    def push_chunk(self, text: str, pts_ns: int,
                   duration_ns: int) -> None:
        self._track.process_chunk(text, pts_ns, duration_ns)

    def prepare(self):
        from gstbad.io import ass
        spec = self.out_spec
        H, W = spec.height, spec.width
        face = self.props.get("face", "auto")
        if face == "pango" and not ass.pango_available():
            raise ValueError("assrender: face=pango but "
                             "pango/pangocairo is not available")
        self._face = "pango" if (face in ("auto", "pango")
                                 and ass.pango_available()) else "fixed"
        times = {t for ev in self._track.events
                 for t in (ev.start, ev.end)}
        # animated events need intra-event samples: \t, \move,
        # \fad/\fade and karaoke all vary with the event clock
        import re
        if AssRender._ANIM_RE is None:
            AssRender._ANIM_RE = re.compile(
                r"\\(t[\s(0-9]|move|fade?|k[fo]?\d|K\d)")
        anim_fps = max(0.1, float(self.props.get("animation-fps", 10.0)))
        step = int(1e9 / anim_fps)
        anim_times = set()
        for ev in self._track.events:
            if AssRender._ANIM_RE.search(ev.raw_text or ""):
                anim_times.update(range(ev.start, ev.end, step))
        if len(times) + len(anim_times) > self._SNAPSHOT_CAP:
            keep = max(1, self._SNAPSHOT_CAP - len(times))
            ordered = sorted(anim_times)
            stride = max(1, len(ordered) // keep)
            anim_times = set(ordered[::stride][:keep])
        times = sorted(times | anim_times)
        overlays = [np.zeros((H, W, 4), np.uint8)]
        begins, ends = [0], [0]
        for i, t in enumerate(times[:-1]):
            imgs = ass.render_events(self._track, t, W, H,
                                     face=self._face)
            if not imgs:
                continue
            overlays.append(ass.blit_bgra_premultiplied(imgs, W, H))
            begins.append(t)
            ends.append(times[i + 1])
        self._ov = jnp.asarray(np.stack(overlays))
        self._begin = jnp.asarray(np.asarray(begins, np.int64))
        self._end = jnp.asarray(np.asarray(ends, np.int64))

    def process(self, params, state, batch: FrameBatch):
        if not self.props["enable"] or self._ov.shape[0] == 1:
            return state, batch
        pts = batch.pts
        active = (pts[:, None] >= self._begin[None, :]) \
            & (pts[:, None] < self._end[None, :])
        active = active.at[:, 0].set(~active[:, 1:].any(axis=1))
        idx = jnp.argmax(active, axis=1)
        ov = jnp.take(self._ov, idx, axis=0)   # [B, H, W, 4] BGRA
        fmt = self.out_spec.format
        ro, go, bo, _x = VideoFormat.rgb_offsets(fmt)
        a = ov[..., 3].astype(jnp.int32)
        d = batch.data.astype(jnp.int32)
        out = batch.data
        # premultiplied OVER: s + (255 - a) * d / 255
        for off, ch in ((ro, 2), (go, 1), (bo, 0)):
            s = ov[..., ch].astype(jnp.int32)
            blended = s + (255 - a) * d[..., off] // 255
            out = out.at[..., off].set(
                jnp.clip(blended, 0, 255).astype(jnp.uint8))
        return state, batch.with_data(out)
