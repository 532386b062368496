"""removesilence (gst/removesilence/) — VAD-gated silence dropper.

The VAD recurrence runs in-graph (ops.audio.vad_block, exact integer
transcription of vad_private.c); buffer dropping becomes the window validity
mask, and squash retiming adjusts PTS with a carried ts_offset — the
static-shape rebuild of GST_BASE_TRANSFORM_FLOW_DROPPED.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from gstbad.core.element import AudioFilter, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import AudioFormat
from gstbad.ops import audio as ops


@register
class RemoveSilence(AudioFilter):
    """Defaults per gstremovesilence.c:55-62,217-222."""

    NAME = "removesilence"
    FORMATS = (AudioFormat.S16,)
    CHANNELS = (1, 1)
    PROPERTIES = (
        Property("remove", bool, False),
        Property("hysteresis", int, 480, 1, None),
        Property("threshold", int, -60, -70, 70),
        Property("squash", bool, False),
        Property("silent", bool, True),
        Property("minimum-silence-buffers", int, 0, 0, 10000),
        Property("minimum-silence-time", int, 0, 0, None),
    )

    def dynamic_params(self):
        # vad_set_threshold (vad_private.c:105-114)
        power = int(self.props["threshold"] / 10.0)
        return {
            "threshold": jnp.int64(int((10.0 ** power) * 4294967295)),
            "hysteresis": jnp.int64(self.props["hysteresis"]),
            "remove": jnp.bool_(self.props["remove"]),
            "squash": jnp.bool_(self.props["squash"]),
            "silent": jnp.bool_(self.props["silent"]),
            "min-buffers": jnp.int64(self.props["minimum-silence-buffers"]),
            "min-time": jnp.int64(self.props["minimum-silence-time"]),
        }

    def init_state(self, batch: int):
        return {
            "vad": ops.vad_init_state(),
            "consec_buffers": jnp.int64(0),
            "consec_time": jnp.int64(0),
            "silence_detected": jnp.bool_(False),
            "ts_offset": jnp.int64(0),
        }

    def process(self, params, state, batch: FrameBatch):
        x = batch.data[..., 0]  # [B, S] mono S16
        s = x.shape[1]
        dur = jnp.int64(round(1e9 * s / self.in_spec.rate))

        # fast path: the whole window's VAD in one pass (blocks bracketed
        # in parallel, ops.vad_window); blocks shorter than the ZCR ring
        # keep the per-block fold
        whole_window = s >= ops.VAD_RING
        if whole_window:
            vad_state_out, frame_types = ops.vad_window(
                state["vad"], x, params["threshold"],
                params["hysteresis"])

        def step(carry, inp):
            st, xb, pts = carry, inp[0], inp[1]
            if whole_window:
                vad_state, frame_type = st["vad"], inp[2]
            else:
                vad_state, frame_type = ops.vad_block(
                    st["vad"], xb, params["threshold"],
                    params["hysteresis"])
            is_sil = frame_type == 0
            consec_b = jnp.where(is_sil, st["consec_buffers"] + 1,
                                 jnp.int64(0))
            consec_t = jnp.where(is_sil, st["consec_time"] + dur,
                                 jnp.int64(0))
            no_minimums = (params["min-buffers"] == 0) \
                & (params["min-time"] == 0)
            reached = jnp.where(
                no_minimums, True,
                ((params["min-buffers"] > 0)
                 & (consec_b >= params["min-buffers"]))
                | ((params["min-time"] > 0)
                   & (consec_t >= params["min-time"])))
            reached = reached & is_sil
            emit_detected = is_sil & ~st["silence_detected"] & reached \
                & ~params["silent"]
            emit_finished = ~is_sil & st["silence_detected"] \
                & ~params["silent"]
            silence_detected = jnp.where(
                is_sil, st["silence_detected"] | reached, jnp.bool_(False))
            drop = params["remove"] & reached
            ts_offset = jnp.where(drop & params["squash"],
                                  st["ts_offset"] + dur, st["ts_offset"])
            out_pts = jnp.where(params["squash"] & (st["ts_offset"] > 0),
                                pts - st["ts_offset"], pts)
            new = {"vad": vad_state, "consec_buffers": consec_b,
                   "consec_time": consec_t,
                   "silence_detected": silence_detected,
                   "ts_offset": ts_offset}
            return new, (drop, out_pts, emit_detected, emit_finished,
                         pts - st["ts_offset"])

        xs = (x, batch.pts, frame_types) if whole_window \
            else (x, batch.pts)
        state, (drops, out_pts, det, fin, msg_pts) = lax.scan(
            step, state, xs)
        if whole_window:
            state = {**state, "vad": vad_state_out}
        out = batch.replace(valid=batch.valid & ~drops, pts=out_pts)
        msgs = {"removesilence": {
            "_emit": det | fin,
            "_pts": msg_pts,
            "silence_detected": det,
            "silence_finished": fin,
        }}
        return state, out, msgs
