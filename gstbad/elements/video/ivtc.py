"""ivtc + combdetect (gst/ivtc/) — inverse telecine as an in-graph field
queue.

The reference keeps a queue of mapped field buffers and per output frame
picks weave vs single-field reconstruction by comb-score thresholds
(gstivtc.c construct_frame).  Here the queue is a ring of device arrays
carried through a lax.scan over the window; data-dependent emission (0-2
frames per input) becomes 2 gated output slots per input with validity
masks — SURVEY.md hard part #3.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from gstbad.core.element import Property, VideoFilter
from gstbad.core.frame import (FLAG_INTERLACED, FLAG_ONEFIELD, FLAG_RFF,
                                   FLAG_TFF, FrameBatch)
from gstbad.core.registry import register
from gstbad.core.spec import MediaSpec, VideoFormat, require
from gstbad.ops import comb as comb_ops
from gstbad.ops import ivtc as ivtc_ops

CAP = 8  # field queue capacity (reference GST_IVTC_MAX_FIELDS = 10)
THRESHOLD = 100
_SCORE_CHUNK = 128  # pairs per streamed comb pass


@register
class Ivtc(VideoFilter):
    """Inverse telecine.  The reference strips framerate and forces
    progressive in transform_caps (gstivtc.c:160-185); downstream picks the
    rate — here the `output-framerate` property (default 4/5 of the input,
    the 30000/1001 -> 24000/1001 pulldown inverse)."""

    NAME = "ivtc"
    FORMATS = (VideoFormat.I420, VideoFormat.GRAY8)
    PROPERTIES = (Property("output-framerate", str, "", static=True),)

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        from fractions import Fraction
        require(in_spec.kind == "video", "ivtc: needs video")
        require(in_spec.format in self.FORMATS,
                f"ivtc: format {in_spec.format} unsupported")
        fr = self.props["output-framerate"]
        out_fr = (Fraction(fr) if fr
                  else in_spec.framerate * Fraction(4, 5))
        return in_spec.with_(framerate=out_fr,
                             interlace_mode="progressive")

    def init_state(self, batch: int):
        spec = self.in_spec
        h, w = spec.height, spec.width
        planes = {"y": jnp.zeros((CAP, h, w), jnp.uint8)}
        if spec.format == VideoFormat.I420:
            planes["u"] = jnp.zeros((CAP, h // 2, w // 2), jnp.uint8)
            planes["v"] = jnp.zeros((CAP, h // 2, w // 2), jnp.uint8)
        return {
            "q": planes,
            "parity": jnp.zeros(CAP, jnp.int32),
            "ts": jnp.zeros(CAP, jnp.int64),
            "head": jnp.int32(0),
            "count": jnp.int32(0),
            "current_ts": jnp.int64(0),
        }

    def process(self, params, state, batch: FrameBatch):
        spec = self.in_spec
        field_dur = jnp.int64(spec.frame_duration_ns // 2)
        out_dur = jnp.int64(self.out_spec.frame_duration_ns)
        is_dict = isinstance(batch.data, dict)
        data = batch.data if is_dict else {"y": batch.data}
        b = batch.batch

        # ---- dense field sequence for the whole window ---------------
        # Fields only ever ARRIVE in order and retire from the front, so
        # every comb score construct_frame can ask for is a score of an
        # ADJACENT pair in arrival order.  Lay the window's fields out
        # densely (queue leftovers first, then this window's candidates,
        # invalid candidates routed to a dummy tail slot) and score ALL
        # adjacent pairs in ONE batched chain pass — the per-frame scan
        # then just indexes pair_scores instead of running a two-chain
        # comb pass inside each construct (ops/comb.py).
        L = CAP + 3 * b
        ring = (state["head"] + jnp.arange(CAP, dtype=jnp.int32)) % CAP
        pos_old = jnp.where(
            jnp.arange(CAP, dtype=jnp.int32) < state["count"],
            jnp.arange(CAP, dtype=jnp.int32), L)
        # frame POOL (carried ring slots, then this window's frames) +
        # an index-valued dense sequence: a field at dense position j is
        # pool[k][src[j]].  Storing indices instead of pixels keeps the
        # window cost O(b) frames — a pixel-valued sequence was ~3x the
        # window in copies and blew HBM at the bench's 256-frame windows
        pool = {k: jnp.concatenate([state["q"][k], data[k]], axis=0)
                for k in state["q"]}
        src = jnp.zeros(L + 1, jnp.int32).at[pos_old].set(ring)
        parity_seq = jnp.zeros(L + 1, jnp.int32).at[pos_old].set(
            state["parity"][ring])
        ts_seq = jnp.zeros(L + 1, jnp.int64).at[pos_old].set(
            state["ts"][ring])

        tff = (batch.flags & FLAG_TFF) != 0
        onefield = (batch.flags & FLAG_ONEFIELD) != 0
        rff = (batch.flags & FLAG_RFF) != 0
        p0 = jnp.where(tff, 0, 1).astype(jnp.int32)
        cand_par = jnp.stack([p0, 1 - p0, p0], axis=1).reshape(3 * b)
        # an invalid input slot (window-adapter rate padding) contributes
        # no fields — the reference's chain() never sees such buffers
        cand_valid = (jnp.stack(
            [jnp.ones(b, bool), ~onefield, ~onefield & rff],
            axis=1) & batch.valid[:, None]).reshape(3 * b)
        cand_ts = (batch.pts[:, None].astype(jnp.int64)
                   + jnp.arange(3, dtype=jnp.int64)[None, :]
                   * field_dur).reshape(3 * b)
        cpos = (state["count"] + jnp.cumsum(cand_valid.astype(jnp.int32))
                - cand_valid.astype(jnp.int32))
        cpos = jnp.where(cand_valid, cpos, L)
        src = src.at[cpos].set(
            CAP + jnp.repeat(jnp.arange(b, dtype=jnp.int32), 3))
        parity_seq = parity_seq.at[cpos].set(cand_par)
        ts_seq = ts_seq.at[cpos].set(cand_ts)
        arrivals = cand_valid.reshape(b, 3).sum(axis=1).astype(jnp.int32)

        # all adjacent-pair scores in one score-only pass: the parity
        # select happens on INDICES, and comb_score_pairs weaves the two
        # frames of each pair itself
        ysrc = pool["y"]
        npairs = L - 1
        ids = jnp.arange(npairs, dtype=jnp.int32)
        tf = parity_seq[ids] == 0
        top_idx = jnp.where(tf, src[ids], src[ids + 1])
        bot_idx = jnp.where(tf, src[ids + 1], src[ids])
        pair_scores = comb_ops.comb_score_pairs(
            ysrc, top_idx, bot_idx, chunk=_SCORE_CHUNK)

        # ---- emission: one construct per scan step, with only the
        # taken branch of a lax.switch executed.
        seq_pos = jnp.arange(L + 1, dtype=jnp.int32)

        def weave_frame(st, i1, i2):
            j1 = st["head_abs"] + i1
            j2 = st["head_abs"] + i2
            p1 = parity_seq[j1]
            out = {}
            for k in pool:
                f1 = pool[k][src[j1]]
                f2 = pool[k][src[j2]]
                top = jnp.where(p1 == 0, f1, f2)
                bottom = jnp.where(p1 == 0, f2, f1)
                out[k] = ivtc_ops.weave(top, bottom)
            return out

        def single_frame(st, i1):
            j1 = st["head_abs"] + i1
            p = parity_seq[j1]
            out = {"y": ivtc_ops.reconstruct_single_luma(
                pool["y"][src[j1]], p)}
            for k in pool:
                if k != "y":
                    out[k] = ivtc_ops.reconstruct_single_chroma(
                        pool[k][src[j1]], p)
            return out

        def construct(st):
            """construct_frame (gstivtc.c:565-630)."""
            forward_ok = ts_seq[st["head_abs"] + 1] < st["current_ts"]
            prev_score = pair_scores[st["head_abs"]]
            next_score = pair_scores[st["head_abs"] + 1]

            use_next_a = forward_ok & (next_score < prev_score)
            branch_prev = prev_score < THRESHOLD
            branch_next = ~branch_prev & (next_score < THRESHOLD)

            # only the taken reconstruction is built (lax.switch) —
            # computing all three candidates and where-selecting cost
            # ~3x the frame traffic per output
            case = jnp.where(
                branch_prev, jnp.where(use_next_a, 0, 1),
                jnp.where(branch_next, 0, 2)).astype(jnp.int32)
            out = lax.switch(
                case,
                [lambda st=st: weave_frame(st, 1, 2),
                 lambda st=st: weave_frame(st, 1, 0),
                 lambda st=st: single_frame(st, 1)])
            n_retire = jnp.where(
                branch_prev, jnp.where(use_next_a, 3, 2),
                jnp.where(branch_next, jnp.where(forward_ok, 3, 2), 2)
            ).astype(jnp.int32)
            pts = st["current_ts"]
            st = {**st,
                  "head_abs": st["head_abs"] + n_retire,
                  "count": st["count"] - n_retire,
                  "current_ts": st["current_ts"] + out_dur}
            return st, out, pts

        def step(st, arr):
            # this step's fields are already in seq; they become visible
            # by bumping count (arrival order == dense-sequence order)
            st = {**st, "count": st["count"] + arr}

            # retire early fields (gstivtc.c:536-540).  ts_seq is
            # ascending in arrival order, so the early entries form a
            # PREFIX of the live window — one vector count replaces the
            # data-dependent while_loop (r5)
            in_q = ((seq_pos >= st["head_abs"])
                    & (seq_pos < st["head_abs"] + st["count"]))
            early = ts_seq + jnp.int64(50_000_000) < st["current_ts"]
            n_ret = jnp.sum(in_q & early).astype(jnp.int32)
            st = {**st, "head_abs": st["head_abs"] + n_ret,
                  "count": st["count"] - n_ret}

            outs = []
            outs_pts = []
            outs_valid = []
            for _ in range(2):
                can = st["count"] >= 4

                def do(st=st):
                    return construct(st)

                def dont(st=st):
                    dummy = {k: pool[k][0] for k in pool}
                    return st, dummy, jnp.int64(0)

                st, out, opts = lax.cond(can, do, dont)
                outs.append(out)
                outs_pts.append(opts)
                outs_valid.append(can)
            stacked = {k: jnp.stack([o[k] for o in outs]) for k in outs[0]}
            return st, (stacked, jnp.stack(outs_pts),
                        jnp.stack(outs_valid))

        sst = {"head_abs": jnp.int32(0), "count": state["count"],
               "current_ts": state["current_ts"]}
        sst, (frames, pts, valid) = lax.scan(step, sst, arrivals)

        # write the surviving tail of the dense sequence back into the
        # ring state (head renormalized to 0; slots past count are
        # whatever the clipped gather grabs and are never read)
        tail = jnp.clip(
            sst["head_abs"] + jnp.arange(CAP, dtype=jnp.int32), 0, L)
        state = {
            "q": {k: pool[k][src[tail]] for k in pool},
            "parity": parity_seq[tail],
            "ts": ts_seq[tail],
            "head": jnp.int32(0),
            "count": sst["count"],
            "current_ts": sst["current_ts"],
        }

        # [B, 2, ...] -> [2B, ...]
        out_data = {k: v.reshape((2 * b,) + v.shape[2:])
                    for k, v in frames.items()}
        if not is_dict:
            out_data = out_data["y"]
        out = FrameBatch(
            data=out_data,
            pts=pts.reshape(2 * b),
            flags=jnp.zeros(2 * b, jnp.int32),  # progressive, flags cleared
            valid=valid.reshape(2 * b))
        return state, out


@register
class CombDetect(VideoFilter):
    """combdetect (gstcombdetect.c): paint zebra over combed cells; border
    rows (j<2, j>=h-2) are halved."""

    NAME = "combdetect"
    FORMATS = (VideoFormat.I420, VideoFormat.GRAY8)

    def init_state(self, batch: int):
        return jnp.int32(0)  # z frame counter

    def process(self, params, state, batch: FrameBatch):
        is_dict = isinstance(batch.data, dict)
        y = batch.data["y"] if is_dict else batch.data
        b, h, w = y.shape
        z = state + 1 + jnp.arange(b, dtype=jnp.int32)

        # comb_mask is batched (one chain pass for the window)
        mask, _ = comb_ops.comb_mask(y)
        i = jnp.arange(w, dtype=jnp.int32)[None, None, :]
        j = jnp.arange(h, dtype=jnp.int32)[None, :, None]
        zebra = jnp.where(((i + j + z[:, None, None]) & 0x4) != 0,
                          jnp.uint8(235), jnp.uint8(16))
        out_y = jnp.where(mask, zebra, y)
        border = (j < 2) | (j >= h - 2)
        out_y = jnp.where(border, y // 2, out_y)
        if is_dict:
            out = {**batch.data, "y": out_y}
        else:
            out = out_y
        return state + b, batch.with_data(out)
