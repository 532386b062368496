"""videofilters — scenechange, zebrastripe, videodiff (gst/videofilters/)
plus smooth (gst/smooth/)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from gstbad.core.element import Property, VideoFilter
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import MediaSpec, VideoFormat, require
from gstbad.ops import pointops

_PLANAR = (VideoFormat.I420,)
# the reference zebrastripe/videodiff format breadth
# (gstzebrastripe.c:145-148): every 8-bit YUV layout with a luma component
_LUMA_FORMATS = VideoFormat.YUV_WITH_LUMA + (VideoFormat.GRAY8,)


class _LumaFilter(VideoFilter):
    """Filter that edits the luma component of any 8-bit YUV layout
    (planar/semi-planar dicts, AYUV channel 1, YUY2/UYVY line strides)."""

    FORMATS = _LUMA_FORMATS

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "video", f"{self.NAME}: needs video")
        require(in_spec.format in self.FORMATS,
                f"{self.NAME}: format {in_spec.format} unsupported")
        return in_spec

    def _get_luma(self, data):
        return VideoFormat.luma_view(self.out_spec.format, data)

    def _set_luma(self, data, y):
        return VideoFormat.luma_set(self.out_spec.format, data, y)


@register
class ZebraStripe(_LumaFilter):
    """gstzebrastripe.c: diagonal stripes over lumas above
    16 + round(2.19 * threshold%); the stripe phase advances per frame
    (gstzebrastripe.c:145-148,205-253)."""

    NAME = "zebrastripe"
    # "{ I420, Y444, Y42B, Y41B, YUY2, UYVY, AYUV, NV12, NV21, YV12 }"
    # (gstzebrastripe.c:81-82) + GRAY8 as this framework's extension
    FORMATS = _LUMA_FORMATS
    PROPERTIES = (Property("threshold", int, 90, 0, 100, controllable=True),)

    def init_state(self, batch: int):
        return jnp.int32(0)  # t, the per-frame stripe phase

    def process(self, params, state, batch: FrameBatch):
        y = self._get_luma(batch.data)
        b = y.shape[0]
        # y_threshold = 16 + floor(0.5 + 2.19 * threshold)
        thr = (16 + jnp.floor(0.5 + 2.19 * params["threshold"]
                              .astype(jnp.float64))).astype(jnp.int32)
        thr = pointops._per_frame(thr, 3)  # [B] controllable -> [B, 1, 1]
        t = state + jnp.arange(b, dtype=jnp.int32)
        out = pointops.zebrastripe(y, thr, t[:, None, None])
        return state + b, batch.with_data(self._set_luma(batch.data, out))

    def table_tail(self, params, state, chain, batch):
        """Table-fusion tail: materialize the chain's word ONCE, then the
        stripe select is 3 plain ops on the luma byte — y' = 16 where
        stripe & y >= thr (gstzebrastripe.c:205-253)."""
        if (self.out_spec.format != VideoFormat.AYUV
                or not chain.single_indexed()):
            return None
        thr = (16 + jnp.floor(0.5 + 2.19 * params["threshold"]
                              .astype(jnp.float64))).astype(jnp.int32)
        b = chain.src_batch.batch
        h, w = chain.src_word.shape[-2:]
        tph = state + jnp.arange(b, dtype=jnp.int32)

        # fused-kernel fast path: a deferred dilate3 stencil + this stripe
        # select + the word materialization all run in ONE GPU pass
        # (ops/chainfuse.py) when tables are per-run
        from gstbad.core import tablefuse
        from gstbad.ops import chainfuse
        ps = chain.pending_stencil
        if (ps is not None and ps[3] == "dilate3"
                and chain.index_fn is not None
                and ps[0].ndim == 1 and thr.ndim <= 1
                and b * h * w < 2 ** 31
                and all((k == tablefuse.IDX and t.ndim == 1)
                        or (k == tablefuse.CONST
                            and jnp.asarray(t).ndim == 0)
                        for k, t in chain.bytes_)
                and chainfuse._use_kernel()):
            key_t, _move, sparams, _tag = ps
            chain.pending_stencil = None
            src = (chain.src_word_base if chain.src_word_base is not None
                   else chain.src_word)
            out = chainfuse.dilate_zebra_fused(
                src, chain.rank_table(key_t), chain.word_table(),
                chain.index_fn, sparams["erode"], thr, tph, batch=b)
            return state + b, chain.src_batch.with_data(
                pointops.unpack32(out)).replace(word=out)

        thr = pointops._per_frame(thr, 3)
        i = jnp.arange(w, dtype=jnp.int32)[None, :]
        j = jnp.arange(h, dtype=jnp.int32)[:, None]
        stripe = (((i + j)[None] + tph[:, None, None]) & 0x4) != 0
        word = chain.materialize_word()
        y = pointops.byte_of(word, 1)
        zebra = ((word & jnp.int32(np.int32(np.uint32(0xFFFF00FF))))
                 | jnp.int32(16 << 8))
        out = jnp.where(stripe & (y >= thr), zebra, word)
        # attach the output word twin: a sink that keeps the word view
        # (fakesink) lets XLA drop the i32->u8 relayout entirely
        return state + b, chain.src_batch.with_data(
            pointops.unpack32(out)).replace(word=out)


@register
class VideoDiff(_LumaFilter):
    """gstvideodiff.c: highlight luma deltas above threshold=10 vs the
    previous frame; first frame passes through (gstvideodiff.c:128-174).
    The reference never increments its stripe phase t, so t=0."""

    NAME = "videodiff"
    # "{ I420, Y444, Y42B, Y41B }" (gstvideodiff.c:51) + GRAY8 extension
    FORMATS = (VideoFormat.I420, VideoFormat.Y444, VideoFormat.Y42B,
               VideoFormat.Y41B, VideoFormat.GRAY8)

    def init_state(self, batch: int):
        h, w = self.in_spec.height, self.in_spec.width
        return {"prev": jnp.zeros((h, w), jnp.uint8),
                "have_prev": jnp.bool_(False)}

    def process(self, params, state, batch: FrameBatch):
        y = self._get_luma(batch.data)
        b = y.shape[0]
        # each slot diffs against the last VALID frame before it — invalid
        # slots (window-adapter rate padding) are not buffer arrivals
        pos = jnp.arange(b, dtype=jnp.int32)
        vpos = jnp.where(batch.valid, pos, -1)
        last_v = jnp.concatenate(
            [jnp.int32(-1)[None], lax.cummax(vpos)[:-1]], axis=0)
        prevs = jnp.where(last_v[:, None, None] >= 0,
                          y[jnp.maximum(last_v, 0)], state["prev"][None])
        have = (last_v >= 0) | state["have_prev"]
        diff = pointops.videodiff(y, prevs, jnp.int32(10), jnp.int32(0))
        out = jnp.where(have[:, None, None], diff, y)
        any_v = jnp.any(batch.valid)
        new_state = {
            "prev": jnp.where(any_v, y[jnp.maximum(jnp.max(vpos), 0)],
                              state["prev"]),
            "have_prev": state["have_prev"] | any_v}
        return new_state, batch.with_data(self._set_luma(batch.data, out))


@register
class SceneChange(_LumaFilter):
    """gstscenechange.c: SAD of consecutive luma frames, 5-score ring,
    adaptive threshold 1.8*max - 0.8*min + decision tree; posts a
    scenechange message where the reference sends force-key-unit events."""

    NAME = "scenechange"
    # "{ I420, Y42B, Y41B, Y444 }" (gstscenechange.c:107) + GRAY8 extension
    FORMATS = (VideoFormat.I420, VideoFormat.Y42B, VideoFormat.Y41B,
               VideoFormat.Y444, VideoFormat.GRAY8)

    def init_state(self, batch: int):
        h, w = self.in_spec.height, self.in_spec.width
        return {"prev": jnp.zeros((h, w), jnp.uint8),
                "have_prev": jnp.bool_(False),
                "diffs": jnp.zeros((5,), jnp.float64),
                "n_diffs": jnp.int32(0),
                "count": jnp.int32(0)}

    def process(self, params, state, batch: FrameBatch):
        y = self._get_luma(batch.data)

        def step(carry, inp):
            frame, valid = inp
            prev, have_prev, diffs, n_diffs, count = carry
            score = pointops.sad(frame, prev)

            def with_prev(_):
                d = jnp.concatenate([diffs[1:], score[None]])
                n = n_diffs + 1
                window = d[:4]
                smin = jnp.min(window)
                smax = jnp.max(window)
                threshold = 1.8 * smax - 0.8 * smin
                change = jnp.where(
                    n <= 4, False,
                    jnp.where(score < 5, False,
                    jnp.where(score / threshold < 1.0, False,
                    jnp.where((score > 30) & (score / d[3] > 1.4), True,
                    jnp.where(score / threshold > 2.3, True,
                              score > 50)))))
                d = jnp.where(change, jnp.zeros_like(d), d)
                n = jnp.where(change, 0, n)
                return d, n, change

            def no_prev(_):
                return diffs, n_diffs, jnp.bool_(False)

            d, n, change = lax.cond(have_prev, with_prev, no_prev, None)
            # invalid slots (rate padding) are not arrivals: no history
            # update, no message
            change = change & valid
            d = jnp.where(valid, d, diffs)
            n = jnp.where(valid, n, n_diffs)
            new_count = count + change.astype(jnp.int32)
            new_prev = jnp.where(valid, frame, prev)
            return ((new_prev, have_prev | valid, d, n, new_count),
                    (change, new_count - 1))

        carry = (state["prev"], state["have_prev"], state["diffs"],
                 state["n_diffs"], state["count"])
        carry, (changes, counts) = lax.scan(step, carry, (y, batch.valid))
        new_state = {"prev": carry[0], "have_prev": carry[1],
                     "diffs": carry[2], "n_diffs": carry[3],
                     "count": carry[4]}
        msgs = {"scenechange": {"_emit": changes,
                                "count": counts.astype(jnp.int32)}}
        return new_state, batch, msgs


@register
class Smooth(_LumaFilter):
    """gst/smooth/gstsmooth.c: tolerance-gated window mean on luma.

    Faithful to the reference's pointer arithmetic (see
    golden.videofilters.smooth_y): output row r takes its window from rows
    [r-filtersize, r+filtersize+3) and the last row is passed through.
    """

    NAME = "smooth"
    FORMATS = _PLANAR + (VideoFormat.GRAY8,)
    PROPERTIES = (
        Property("active", bool, True),
        Property("tolerance", int, 8, static=True),
        Property("filter-size", int, 3, static=True),
        Property("luma-only", bool, True, static=True),
    )

    def process(self, params, state, batch: FrameBatch):
        y = self._get_luma(batch.data)
        out_y = self._smooth_plane(y, params)
        data = self._set_luma(batch.data, out_y)
        if not self.props["luma-only"] and isinstance(batch.data, dict):
            for k in ("u", "v"):  # smooth_filter on planes 1,2
                data = {**data, k: self._smooth_plane(batch.data[k], params)}
        return state, batch.with_data(data)

    def _smooth_plane(self, y, params):
        fs = self.props["filter-size"]
        tol = self.props["tolerance"]
        h, w = y.shape[-2], y.shape[-1]
        src = y.astype(jnp.int32)
        ref = src
        ssum = jnp.zeros_like(src)
        num = jnp.zeros_like(src)
        for dy in range(-fs, fs + 3):
            for dx in range(-fs, fs + 1):
                jr = jnp.arange(h) + dy
                jc = jnp.arange(w) + dx
                inb = ((jr >= 0) & (jr < h))[:, None] & \
                      ((jc >= 0) & (jc < w))[None, :]
                v = src[..., jnp.clip(jr, 0, h - 1), :][..., jnp.clip(jc, 0, w - 1)]
                within = (ref - tol - v) * (ref + tol - v) < 0
                m = (inb & within).astype(jnp.int32)
                ssum = ssum + v * m
                num = num + m
        mean = (ref + ssum) // (1 + num)
        out = mean.astype(jnp.uint8)
        out = out.at[..., h - 1, :].set(y[..., h - 1, :])  # last row untouched
        return jnp.where(params["active"], out, y)
