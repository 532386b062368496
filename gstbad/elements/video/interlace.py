"""interlace (gst/interlace/gstinterlace.c) — progressive -> interlaced /
telecine field weaver with the 11 pulldown patterns.

The reference's chain loop (gstinterlace.c:1292-1448) consumes
n_fields[phase] fields per input frame and emits woven buffers while >= 2
fields are available; since the per-frame loop runs at most twice, it
becomes 2 gated output slots per input frame in a lax.scan, with the phase
index / field index / stored-frame as carried state.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from gstbad.core.element import Property, VideoFilter
from gstbad.core.frame import (FLAG_BOTTOM_FIELD, FLAG_INTERLACED,
                                   FLAG_ONEFIELD, FLAG_RFF, FLAG_TFF,
                                   FLAG_TOP_FIELD, FrameBatch)
from gstbad.core.registry import register
from gstbad.core.spec import MediaSpec, VideoFormat, require

# gstinterlace.c:363-385: name -> (ratio_n, ratio_d, n_fields per phase)
PATTERNS = {
    "1:1": (1, 2, [1]),
    "2:2": (1, 1, [2]),
    "2:3": (5, 4, [2, 3]),
    "2:3:3:2": (5, 4, [2, 3, 3, 2]),
    "2-11:3": (25, 24, [2] * 11 + [3]),
    "3:4-3": (15, 8, [3, 4, 4, 4]),
    "3-7:4": (25, 16, [3] * 7 + [4]),
    "3:3:4": (5, 3, [3, 3, 4]),
    "3:3": (3, 2, [3, 3]),
    "3:2-4": (11, 10, [3, 2, 2, 2, 2]),
    "1:2-4": (9, 10, [1, 2, 2, 2, 2]),
}


@register
class Interlace(VideoFilter):
    NAME = "interlace"
    # the 8-bit subset of the reference's wide format list
    # (gstinterlace.c:177-200: AYUV/Y444/YUY2/UYVY/Y42B/I420/YV12/NV12/
    # NV21/Y41B ...; >8-bit depths are out of scope) + GRAY8 extension.
    # The field machinery below is plane-generic: every plane interleaves
    # its own rows, exactly like the reference's per-component
    # copy_field/copy_fields walk (gstinterlace.c:1070-1171).
    FORMATS = (VideoFormat.I420, VideoFormat.YV12, VideoFormat.Y444,
               VideoFormat.Y42B, VideoFormat.Y41B, VideoFormat.NV12,
               VideoFormat.NV21, VideoFormat.YUY2, VideoFormat.UYVY,
               VideoFormat.AYUV, VideoFormat.GRAY8)
    PROPERTIES = (
        Property("top-field-first", bool, False, static=True),
        Property("pattern", str, "2:3", static=True),
        Property("pattern-offset", int, 0, 0, 12, static=True),
        Property("allow-rff", bool, False, static=True),
        # interlace-mode=alternate output: two half-height field buffers per
        # woven frame, sharing PTS, flagged TOP_FIELD/BOTTOM_FIELD
        # (gstinterlace.c:1288-1410 alternate branches).  The reference
        # selects this when downstream caps prefer alternate
        # (gstinterlace.c:484-488); negotiation here is forward-only, so it
        # is an explicit property.
        Property("alternate", bool, False, static=True),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "video", "interlace: needs video")
        require(in_spec.format in self.FORMATS,
                f"interlace: format {in_spec.format} unsupported")
        require(self.props["pattern"] in PATTERNS,
                f"interlace: unknown pattern {self.props['pattern']}")
        rn, rd, fields = PATTERNS[self.props["pattern"]]
        require(self.props["pattern-offset"] < len(fields),
                "interlace: pattern-offset beyond pattern")
        mode = ("mixed" if self.props["pattern"] not in ("1:1", "2:2")
                else "interleaved")
        if self.props["alternate"]:
            sub420 = ((VideoFormat.I420, VideoFormat.YV12)
                      + VideoFormat.SEMIPLANAR_YUV)
            div = 4 if in_spec.format in sub420 else 2
            require(in_spec.height % div == 0,
                    f"interlace: alternate needs height % {div} == 0")
            return in_spec.with_(
                framerate=in_spec.framerate * Fraction(rn, rd),
                interlace_mode="alternate", height=in_spec.height // 2)
        return in_spec.with_(
            framerate=in_spec.framerate * Fraction(rn, rd),
            interlace_mode=mode)

    def prepare(self):
        rn, rd, fields = PATTERNS[self.props["pattern"]]
        self._table = np.array(fields + [0], np.int32)  # 0-terminated
        self._mixed = self.props["pattern"] not in ("1:1", "2:2")
        out_fr = self.out_spec.framerate
        # field duration in ns = 1e9 * fps_d / (2 * fps_n)
        self._field_ns = int(round(1e9 * out_fr.denominator
                                   / (2 * out_fr.numerator)))

    def init_state(self, batch: int):
        spec = self.in_spec
        h, w = spec.height, spec.width
        fmt = spec.format
        z = lambda *s: jnp.zeros(s, jnp.uint8)  # noqa: E731
        if fmt in (VideoFormat.I420, VideoFormat.YV12):
            stored = {"y": z(h, w), "u": z(h // 2, w // 2),
                      "v": z(h // 2, w // 2)}
        elif fmt == VideoFormat.Y444:
            stored = {"y": z(h, w), "u": z(h, w), "v": z(h, w)}
        elif fmt == VideoFormat.Y42B:
            stored = {"y": z(h, w), "u": z(h, w // 2), "v": z(h, w // 2)}
        elif fmt == VideoFormat.Y41B:
            stored = {"y": z(h, w), "u": z(h, w // 4), "v": z(h, w // 4)}
        elif fmt in VideoFormat.SEMIPLANAR_YUV:
            stored = {"y": z(h, w), "uv": z(h // 2, w)}
        elif fmt == VideoFormat.AYUV:
            stored = {"p": z(h, w, 4)}
        elif fmt in VideoFormat.PACKED_YUV422:
            stored = {"p": z(h, 2 * w)}
        else:
            stored = {"p": z(h, w)}
        return {
            "phase": jnp.int32(self.props["pattern-offset"]),
            "field_index": jnp.int32(0 if self.props["top-field-first"]
                                     else 1),
            "stored": stored,
            "stored_fields": jnp.int32(0),
            "timebase": jnp.int64(0),
            "fields_since": jnp.int32(0),
            "started": jnp.bool_(False),
        }

    @staticmethod
    def _copy_field(planes, fi):
        """Half-height field extract: rows fi, fi+2, ... of every plane
        (copy_field, gstinterlace.c:1131-1171).  fi is traced 0/1, so both
        static strided slices are built and selected."""
        out = {}
        for k, v in planes.items():
            h2 = v.shape[0] // 2
            out[k] = jnp.where(fi == 0, v[0::2][:h2], v[1::2][:h2])
        return out

    @staticmethod
    def _weave(stored, current, field_index):
        """Rows of parity `field_index` from stored, others from current
        (copy_fields, gstinterlace.c:1070-1113)."""
        out = {}
        for k in stored:
            h = stored[k].shape[0]
            rows = (jnp.arange(h) % 2)[:, None]
            if stored[k].ndim == 3:
                rows = rows[..., None]
            out[k] = jnp.where(rows == field_index, stored[k], current[k])
        return out

    def process(self, params, state, batch: FrameBatch):
        table = jnp.asarray(self._table)
        offset = self.props["pattern-offset"]
        allow_rff = self.props["allow-rff"]
        alternate = self.props["alternate"]
        mixed = self._mixed
        field_ns = self._field_ns
        is_dict = isinstance(batch.data, dict)

        def step(st, inp):
            frame, pts, in_valid = inp
            planes = frame if isinstance(frame, dict) else {"p": frame}
            # timebase reset (gstinterlace.c:1261-1266)
            at_reset = (st["stored_fields"] == 0) & (st["phase"] == offset)
            timebase = jnp.where(at_reset, pts, st["timebase"])
            fields_since = jnp.where(at_reset, 0, st["fields_since"])

            current = table[st["phase"]]
            phase = st["phase"] + 1
            phase = jnp.where(table[phase] == 0, 0, phase)

            stored = st["stored"]
            stored_fields = st["stored_fields"]
            field_index = st["field_index"]
            num = stored_fields + current

            outs, out_pts, out_flags, out_valid = [], [], [], []
            for _ in range(2):
                emit = num >= 2
                use_stored = stored_fields > 0
                take3 = (~use_stored) & (num >= 3) & allow_rff
                nout = jnp.where(use_stored, 2, jnp.where(take3, 3, 2))
                interlaced = use_stored
                pts_out = timebase + jnp.int64(field_ns) \
                    * fields_since.astype(jnp.int64)

                if alternate:
                    # field 1 from stored (or current), field 2 always from
                    # the incoming buffer (gstinterlace.c:1306-1341)
                    src1 = {k: jnp.where(use_stored, stored[k], planes[k])
                            for k in planes}
                    f1 = self._copy_field(src1, field_index)
                    f2 = self._copy_field(planes, field_index ^ 1)
                    top_first = field_index == 0
                    flags1 = jnp.where(top_first, FLAG_TOP_FIELD,
                                       FLAG_BOTTOM_FIELD) | FLAG_INTERLACED
                    flags2 = jnp.where(top_first, FLAG_BOTTOM_FIELD,
                                       FLAG_TOP_FIELD) | FLAG_INTERLACED
                    outs += [f1, f2]
                    out_pts += [pts_out, pts_out]  # fields share the ts
                    out_flags += [
                        jnp.where(emit, flags1, 0).astype(jnp.int32),
                        jnp.where(emit, flags2, 0).astype(jnp.int32)]
                    out_valid += [emit, emit]
                else:
                    woven = self._weave(stored, planes, field_index)
                    frame_out = {k: jnp.where(use_stored, woven[k],
                                              planes[k]) for k in planes}
                    # flags (gst_interlace_decorate_buffer)
                    flags = jnp.where(field_index == 0, FLAG_TFF, 0)
                    flags = flags | jnp.where(nout == 3, FLAG_RFF, 0)
                    if mixed:
                        flags = flags | jnp.where(interlaced & (nout == 2),
                                                  FLAG_INTERLACED, 0)
                    outs.append(frame_out)
                    out_pts.append(pts_out)
                    out_flags.append(jnp.where(emit, flags, 0)
                                     .astype(jnp.int32))
                    out_valid.append(emit)

                consumed_cur = jnp.where(use_stored, 1, nout)
                current = jnp.where(emit, current - consumed_cur, current)
                stored_fields = jnp.where(
                    emit & use_stored, stored_fields - 1, stored_fields)
                fields_since = jnp.where(emit, fields_since + nout,
                                         fields_since)
                field_index = jnp.where(emit, field_index ^ (nout & 1),
                                        field_index)
                num = jnp.where(emit, num - nout, num)

            # store leftover field (gstinterlace.c:1436-1447)
            keep = current > 0
            stored = {k: jnp.where(keep, planes[k], stored[k])
                      for k in planes}
            stored_fields = jnp.where(keep, current, jnp.int32(0))

            new_st = {"phase": phase, "field_index": field_index,
                      "stored": stored, "stored_fields": stored_fields,
                      "timebase": timebase, "fields_since": fields_since,
                      "started": jnp.bool_(True)}
            # an invalid slot (window-adapter rate padding) is not a
            # buffer arrival: chain() is never called — no state change,
            # no emission
            new_st = jax.tree_util.tree_map(
                lambda new, old: jnp.where(
                    jnp.reshape(in_valid, (1,) * new.ndim), new, old),
                new_st, st)
            out_valid = [v & in_valid for v in out_valid]
            stacked = {k: jnp.stack([o[k] for o in outs]) for k in planes}
            return new_st, (stacked, jnp.stack(out_pts),
                            jnp.stack(out_flags), jnp.stack(out_valid))

        data = batch.data if is_dict else {"p": batch.data}
        state, (frames, pts, flags, valid) = lax.scan(
            step, state, (data, batch.pts, batch.valid))
        b = batch.batch
        slots = 4 if alternate else 2
        out_data = {k: v.reshape((slots * b,) + v.shape[2:])
                    for k, v in frames.items()}
        if not is_dict:
            out_data = out_data["p"]
        out = FrameBatch(data=out_data, pts=pts.reshape(slots * b),
                         flags=flags.reshape(slots * b),
                         valid=valid.reshape(slots * b))
        return state, out
