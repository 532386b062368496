"""ttmlparse + ttmlrender (ext/ttml/): TTML subtitles onto video.

io/ttml.py is the parse spec (ttmlparse.c transcription) and the
layout renderer (gstttmlrender.c geometry over the bitmap face —
divergences documented there).  The reference splits the work into a
parser element producing GstSubtitleMeta buffers and a renderer that
composites them; here the `ttmlrender` element covers both ends with
the host-push model used by the other subtitle overlays:
`push_ttml(doc, pts_ns, duration_ns)` feeds documents before the run
(pts/duration as the document's temporal context, like the buffer
times ttmlparse receives), scenes render to RGBA snapshots on the
host, and each video frame blends the scene active at its PTS
(straight alpha, video-blend truncating >> 8)."""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from gstbad.core.element import Element, Property, VideoFilter
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import VideoFormat, require


@register
class TtmlRender(VideoFilter):
    NAME = "ttmlrender"
    FORMATS = VideoFormat.PACKED_RGB4 + VideoFormat.PACKED_RGB3

    PROPERTIES = (
        Property("face", str, "auto", static=True,
                 doc="auto | pango | bitmap — pango is the reference's"
                     " real text stack (io/ttml_pango.py)"),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._docs = []

    def push_ttml(self, doc: str, pts_ns=None, duration_ns=None) -> None:
        self._docs.append((doc, pts_ns, duration_ns))

    def _use_pango(self) -> bool:
        from gstbad.io import pangocairo
        face = self.props.get("face", "auto")
        if face == "pango" and not pangocairo.available():
            raise RuntimeError("ttmlrender: face=pango but "
                               "pango/pangocairo is not available")
        return face in ("auto", "pango") and pangocairo.available()

    def prepare(self):
        from gstbad.io import ttml
        spec = self.out_spec
        H, W = spec.height, spec.width
        scenes = []
        for doc, pts, dur in self._docs:
            parsed, consumed = ttml.ttml_parse(doc, pts, dur)
            require(consumed > 0 or not doc.strip(),
                    "ttmlrender: document is not framed by "
                    "<?xml ... </tt>")
            scenes += parsed
        self._pango = self._use_pango()
        if self._pango:
            from gstbad.io import ttml_pango
            render = lambda sc: ttml_pango.render_scene(sc, W, H)  # noqa: E731
        else:
            render = lambda sc: ttml.render_scene(sc, W, H)  # noqa: E731
        overlays = [np.zeros((H, W, 4), np.uint8)]
        begins, ends = [0], [0]
        for sc in scenes:
            overlays.append(render(sc))
            begins.append(sc.begin)
            ends.append(sc.end)
        self._ov = jnp.asarray(np.stack(overlays))
        self._begin = jnp.asarray(np.asarray(begins, np.int64))
        self._end = jnp.asarray(np.asarray(ends, np.int64))

    def process(self, params, state, batch: FrameBatch):
        if self._ov.shape[0] == 1:
            return state, batch
        pts = batch.pts                       # [B]
        active = (pts[:, None] >= self._begin[None, :]) \
            & (pts[:, None] < self._end[None, :])
        active = active.at[:, 0].set(~active[:, 1:].any(axis=1))
        idx = jnp.argmax(active, axis=1)
        ov = jnp.take(self._ov, idx, axis=0)  # [B, H, W, 4]
        fmt = self.out_spec.format
        ro, go, bo, xo = VideoFormat.rgb_offsets(fmt)
        a = ov[..., 3].astype(jnp.int32)
        d = batch.data.astype(jnp.int32)
        out = batch.data
        if self._pango:
            # premultiplied cairo overlay (B,G,R,A): pixman OVER —
            # the blend GstVideoOverlayComposition performs on the
            # reference's PREMULTIPLIED rectangles
            for off, ch in ((ro, 2), (go, 1), (bo, 0)):
                s = ov[..., ch].astype(jnp.int32)
                t = d[..., off] * (jnp.int32(255) - a) + jnp.int32(0x80)
                blended = jnp.minimum(
                    s + ((t + (t >> jnp.int32(8))) >> jnp.int32(8)),
                    jnp.int32(255))
                out = out.at[..., off].set(blended.astype(jnp.uint8))
            return state, batch.with_data(out)
        for off, ch in ((ro, 0), (go, 1), (bo, 2)):
            s = ov[..., ch].astype(jnp.int32)
            blended = (d[..., off] * (256 - a) + s * a) >> 8
            out = out.at[..., off].set(blended.astype(jnp.uint8))
        return state, batch.with_data(out)


@register
class TtmlParse(Element):
    """ttmlparse (ext/ttml/gstttmlparse.c): the parser half of the
    reference pair as its own element name.  The reference emits
    GstSubtitleMeta-decorated buffers consumed by ttmlrender; here the
    element is a HOST tap: push_ttml() documents before the run, and
    each scene posts a `ttml-scene` message (begin/end ns + per-region
    block texts) — the scene model itself lives in io/ttml.py.  For
    composited output use ttmlrender, which covers both halves."""

    NAME = "ttmlparse"
    HOST = True
    PROPERTIES = ()

    def __init__(self, **props):
        super().__init__(**props)
        self._docs = []
        self._posted = False

    def push_ttml(self, doc: str, pts_ns=None, duration_ns=None) -> None:
        self._docs.append((doc, pts_ns, duration_ns))

    def negotiate(self, in_spec):
        return in_spec

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        from gstbad.core.bus import Message
        from gstbad.io import ttml
        if self._posted or bus is None:
            return
        self._posted = True
        for doc, pts, dur in self._docs:
            scenes, _ = ttml.ttml_parse(doc, pts, dur)
            for sc in scenes:
                texts = ["".join(e.text for e in b.elements)
                         for r in sc.regions for b in r.blocks]
                bus.post(Message(self.NAME, "ttml-scene", sc.begin,
                                 {"begin": sc.begin, "end": sc.end,
                                  "texts": texts}))
