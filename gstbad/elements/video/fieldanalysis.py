"""fieldanalysis (gst/fieldanalysis/gstfieldanalysis.c) — telecine/interlace
analyzer.

The hardest reference element (SURVEY.md section 3.2): a custom GstElement
with a 2-frame history, five metric scores per frame pair, and a decision
tree that classifies PROGRESSIVE / INTERLACED / TELECINE_PROGRESSIVE /
TELECINE_MIXED, decorating buffers with TFF/RFF/ONEFIELD/INTERLACED flags.

Here the metrics are batched device reductions (ops/fieldanalysis.py) and the
decision tree runs in-graph on scalars, emitting exactly one decorated frame
per input after the first (the reference pushes the previous buffer each
chain call), so the whole analyzer stays inside the fused window program.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp
from jax import lax

from gstbad.core.element import Property, VideoFilter
from gstbad.core.frame import (FLAG_INTERLACED, FLAG_ONEFIELD, FLAG_RFF,
                                   FLAG_TFF, FrameBatch)
from gstbad.core.registry import register
from gstbad.core.spec import MediaSpec, VideoFormat, require
from gstbad.ops import fieldanalysis as ops

PROGRESSIVE, INTERLACED, TC_PROGRESSIVE, TC_MIXED = 0, 1, 2, 3


@register
class FieldAnalysis(VideoFilter):
    """Defaults per gstfieldanalysis.c:74-84 (SSD field metric, 5-tap frame
    metric)."""

    NAME = "fieldanalysis"
    FORMATS = (VideoFormat.I420, VideoFormat.GRAY8)
    PROPERTIES = (
        Property("field-metric", str, "ssd", static=True),
        Property("frame-metric", str, "5-tap", static=True),
        Property("noise-floor", int, 16),
        Property("field-threshold", float, 0.08),
        Property("frame-threshold", float, 0.002),
        Property("spatial-threshold", int, 9, static=True),
        Property("block-width", int, 16, static=True),
        Property("block-height", int, 16, static=True),
        Property("block-threshold", int, 80, static=True),
        Property("ignored-lines", int, 2, static=True),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "video", "fieldanalysis: needs video")
        require(in_spec.format in self.FORMATS,
                f"fieldanalysis: format {in_spec.format} unsupported")
        require(in_spec.height % 2 == 0, "fieldanalysis: needs even height")
        return in_spec

    def _same_field(self, f0, p0, f1, p1, nf):
        metric = self.props["field-metric"]
        if metric == "sad":
            return ops.same_parity_sad(f0, p0, f1, p1, nf)
        if metric == "3-tap":
            return ops.same_parity_3_tap(f0, p0, f1, p1, nf)
        return ops.same_parity_ssd(f0, p0, f1, p1, nf)

    def _same_frame(self, f0, p0, f1, nf):
        if self.props["frame-metric"] == "windowed-comb":
            return ops.windowed_comb(
                f0, p0, f1, self.props["spatial-threshold"],
                self.props["block-width"], self.props["block-height"],
                self.props["block-threshold"], self.props["ignored-lines"],
                self.in_spec.interlace_mode == "interleaved")
        return ops.opposite_parity_5_tap(f0, p0, f1, nf)

    def init_state(self, batch: int):
        spec = self.in_spec
        h, w = spec.height, spec.width
        zero = {"y": jnp.zeros((h, w), jnp.uint8)}
        if spec.format == VideoFormat.I420:
            zero["u"] = jnp.zeros((h // 2, w // 2), jnp.uint8)
            zero["v"] = jnp.zeros((h // 2, w // 2), jnp.uint8)
        return {
            "prev": zero,
            "prev_flags": jnp.int32(0),
            "prev_pts": jnp.int64(0),
            "prev_f": jnp.float32(0),
            "prev_concl": jnp.int32(PROGRESSIVE),
            "prev_holding": jnp.int32(-1),
            "have_prev": jnp.bool_(False),
            "first_buffer": jnp.bool_(True),
        }

    def process(self, params, state, batch: FrameBatch):
        is_dict = isinstance(batch.data, dict)
        nf = params["noise-floor"].astype(jnp.int32)
        field_thresh = params["field-threshold"].astype(jnp.float32)
        frame_thresh = params["frame-threshold"].astype(jnp.float32)

        data = batch.data if is_dict else {"y": batch.data}
        y_all = data["y"]
        b_sz = y_all.shape[0]

        # ---- metrics hoisted out of the scan (r5 perf) ----------------
        # Every metric depends only on (frame, previous VALID frame) —
        # not on scan state — so compute all five for the whole window as
        # ONE batched pass instead of 5 sequential full-frame reductions
        # per lax.scan step.  The previous valid frame of slot i follows
        # from a cummax index plan (invalid window-adapter padding slots
        # are not buffer arrivals); index 0 of the pool is the carried
        # state frame.
        pos = jnp.arange(b_sz, dtype=jnp.int32)
        vpos = jnp.where(batch.valid, pos, -1)
        last_v = jnp.concatenate(
            [jnp.int32(-1)[None], lax.cummax(vpos)[:-1]], axis=0)
        prev_idx = last_v + 1
        pool = {k: jnp.concatenate([state["prev"][k][None], v], axis=0)
                for k, v in data.items()}
        prev_y_all = pool["y"][prev_idx]

        def metrics(y, prev_y):
            f = self._same_frame(y, jnp.int32(0), y, nf)
            t = self._same_field(y, jnp.int32(0), prev_y, jnp.int32(0), nf)
            b = self._same_field(y, jnp.int32(1), prev_y, jnp.int32(1), nf)
            t_b = self._same_frame(y, jnp.int32(0), prev_y, nf)
            b_t = self._same_frame(y, jnp.int32(1), prev_y, nf)
            return f, t, b, t_b, b_t

        f_all, t_all, b_all, tb_all, bt_all = jax.vmap(metrics)(
            y_all, prev_y_all)

        def step(st, inp):
            pts, in_flags, in_valid, f, t, b, t_b, b_t = inp

            cur_p = f <= frame_thresh
            prev_p = st["prev_f"] <= frame_thresh
            TB = t_b <= frame_thresh
            BT = b_t <= frame_thresh
            TM = (t <= field_thresh) | (t * 10 < b)
            BM = (b <= field_thresh) | (b * 10 < t)

            h1 = st["prev_holding"]
            tt = (h1 == -1) | (h1 == 1)
            bb = (h1 == -1) | (h1 == 2)
            first_buffer = st["first_buffer"]

            repeat = TM | BM
            predA1 = repeat & prev_p
            predA1a = predA1 & TM & BM
            predA2 = repeat & ~prev_p
            a2a = predA2 & ((tt & BM) | (bb & TM))
            a2b = predA2 & ~a2a & ~cur_p & ((tt & BT) | (bb & TB))
            a2c = predA2 & ~a2a & ~a2b & first_buffer & (BT | TB)
            a2d = predA2 & ~a2a & ~a2b & ~a2c & ((h1 == 3) | (h1 == -1))
            a2e = predA2 & ~a2a & ~a2b & ~a2c & ~a2d
            predB = ~repeat & cur_p
            b1 = predB & ((h1 == 3) | (h1 == -1))
            b2 = predB & ~((h1 == 3) | (h1 == -1)) & (h1 > 0)
            b3 = predB & ~((h1 == 3) | (h1 == -1)) & ~(h1 > 0)
            predC1 = ~repeat & ~cur_p & (TB | BT)
            c1a = predC1 & (h1 == 3)
            c1b = predC1 & ~(h1 == 3) & ((tt & TB) | (bb & BT))
            c1c = predC1 & ~(h1 == 3) & ~((tt & TB) | (bb & BT)) \
                & (((h1 > 0) & (h1 != 3)) | (tt & BT) | (bb & TB))
            c1d = predC1 & ~(h1 == 3) & ~((tt & TB) | (bb & BT)) & ~(
                ((h1 > 0) & (h1 != 3)) | (tt & BT) | (bb & TB))
            predC2 = ~repeat & ~cur_p & ~(TB | BT)
            c2a1 = predC2 & (h1 != 0) & ((h1 == 3) | (h1 == -1))
            c2a2 = predC2 & (h1 != 0) & ~((h1 == 3) | (h1 == -1))
            c2b = predC2 & (h1 == 0)

            i32 = jnp.int32

            def w(*pairs, default):
                out = i32(default)
                for pred, val in pairs:
                    out = jnp.where(pred, i32(val) if isinstance(val, int)
                                    else val, out)
                return out

            # res0 conclusion / holding (carried into next step)
            res0_concl = w(
                (predA1a, TC_PROGRESSIVE),
                (predA1 & ~predA1a, TC_MIXED),
                (predA2 & cur_p, TC_PROGRESSIVE),
                (predA2 & ~cur_p, TC_MIXED),
                (predB, PROGRESSIVE),
                (predC1, TC_MIXED),
                (predC2, INTERLACED),
                default=PROGRESSIVE)
            a2_holding = jnp.where(
                cur_p, 3, jnp.where(TM & BM, 0,
                                    jnp.where(BM, 1, 2)))
            res0_holding = w(
                (predA1a, 3),
                (predA1 & ~predA1a, jnp.where(BM, i32(1), i32(2))),
                (predA2, a2_holding),
                (a2b, jnp.where(tt & BT, i32(2), i32(1))),
                (predB, 3),
                (predC1, -1),
                (c1b, jnp.where(TB, i32(1), i32(2))),  # 1 + !(m & TB)
                (predC2, 3),
                default=-1)
            # first frame: conclusion from f only (gstfieldanalysis.c:1470)
            res0_concl = jnp.where(
                st["have_prev"], res0_concl,
                jnp.where(cur_p, i32(PROGRESSIVE), i32(INTERLACED)))
            res0_holding = jnp.where(st["have_prev"], res0_holding, i32(-1))

            # emission flags for the PREVIOUS frame
            tff_sel = w(  # 1 set, 0 clear, -1 keep incoming
                (a2a, jnp.where(tt & BM, i32(1), i32(0))),
                (a2b, jnp.where(tt & BT, i32(1), i32(0))),
                (a2c, jnp.where(TB, i32(1), i32(0))),
                (b2, jnp.where(h1 == 1, i32(1), i32(0))),
                (c1c, jnp.where(h1 == 1, i32(1), i32(0))),
                (c2a2, jnp.where(h1 == 1, i32(1), i32(0))),
                default=-1)
            onefield = a2a | a2b | a2c | b2 | c1c | c2a2
            drop = predA1a | a2e | b3 | c1d | c2b
            e_concl = jnp.where(a2c, i32(TC_MIXED), st["prev_concl"])

            prev_tff_in = (st["prev_flags"] & FLAG_TFF) != 0
            tff_bit = jnp.where(tff_sel == 1, True,
                                jnp.where(tff_sel == 0, False, prev_tff_in))
            interlaced_bit = (e_concl == INTERLACED) | (e_concl == TC_MIXED)
            out_flags = (jnp.where(tff_bit, FLAG_TFF, 0)
                         | jnp.where(onefield, FLAG_ONEFIELD, 0)
                         | jnp.where(drop, FLAG_RFF, 0)
                         | jnp.where(interlaced_bit, FLAG_INTERLACED, 0)
                         ).astype(jnp.int32)

            out_pts = st["prev_pts"]
            # an invalid slot (window-adapter rate padding) is NOT a
            # buffer arrival: no emission, no history update — the
            # reference's chain() never sees such frames
            out_valid = st["have_prev"] & in_valid

            new_st = {
                "prev_flags": in_flags,
                "prev_pts": pts,
                "prev_f": f,
                "prev_concl": res0_concl,
                "prev_holding": res0_holding,
                "have_prev": jnp.bool_(True),
                "first_buffer": jnp.where(st["have_prev"], jnp.bool_(False),
                                          first_buffer),
            }
            new_st = jax.tree_util.tree_map(
                lambda new, old: jnp.where(in_valid, new, old), new_st, st)
            scores = jnp.stack([f, t, b, t_b, b_t])
            return new_st, (out_pts, out_flags, out_valid, e_concl, scores)

        self._is_dict = is_dict
        # the scan carries only scalars (the frame history lives in the
        # hoisted pool: the emitted frame of slot i IS the previous valid
        # frame, prev_y_all / pool gathers)
        sst = {k: v for k, v in state.items() if k != "prev"}
        sst, (pts, flags, valid, concl, scores) = lax.scan(
            step, sst,
            (batch.pts, batch.flags, batch.valid,
             f_all, t_all, b_all, tb_all, bt_all),
            unroll=8 if b_sz % 8 == 0 else 1)
        # final frame history: the last valid frame of the window (or the
        # carried one when the window had no arrivals)
        final_idx = jnp.max(vpos) + 1
        state = {**sst,
                 "prev": {k: pool[k][final_idx] for k in pool}}
        frames = ({k: pool[k][prev_idx] for k in pool} if is_dict
                  else prev_y_all)
        out_data = frames
        out = FrameBatch(data=out_data, pts=pts, flags=flags, valid=valid)
        msgs = {"fieldanalysis": {
            "_emit": valid,
            "_pts": pts,
            "conclusion": concl,
            "f": scores[:, 0], "t": scores[:, 1], "b": scores[:, 2],
            "t_b": scores[:, 3], "b_t": scores[:, 4],
        }}
        return state, out, msgs

    def drain(self, state):
        """EOS flush (gst_field_analysis_flush_one,
        gstfieldanalysis.c:692-722): emit the held frame.  Returns
        (state, FrameBatch) host-side."""
        import numpy as np
        if not bool(np.asarray(state["have_prev"])):
            return state, None
        holding = int(np.asarray(state["prev_holding"]))
        concl = int(np.asarray(state["prev_concl"]))
        if holding in (1, 2):  # 1 + TOP / 1 + BOTTOM: one field needed
            tff = holding == 1
            flags = (FLAG_TFF if tff else 0) | FLAG_ONEFIELD
        else:
            flags = FLAG_RFF if holding == 0 else 0
        if concl in (1, 3):  # INTERLACED / TC_MIXED
            flags |= FLAG_INTERLACED
        frame = state["prev"]
        data = frame if self._is_dict else frame["y"]
        data = jax.tree_util.tree_map(lambda x: x[None], data)
        batch = FrameBatch(
            data=data,
            pts=jnp.asarray([np.asarray(state["prev_pts"])], jnp.int64),
            flags=jnp.asarray([flags], jnp.int32),
            valid=jnp.ones(1, bool))
        state = {**state, "have_prev": jnp.bool_(False)}
        return state, batch
