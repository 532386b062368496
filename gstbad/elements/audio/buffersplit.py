"""audiobuffersplit (gst/audiobuffersplit/) — exact-duration re-chunker.

The reference accumulates input in an adapter and emits buffers of exactly
output-buffer-duration (gstaudiobuffersplit.c:99-155).  Static-shape rebuild:
each window re-chunks B*S samples plus the carried remainder into
fixed-size output blocks with a validity mask for the partial tail.
"""

from __future__ import annotations

from fractions import Fraction

import jax.numpy as jnp
import numpy as np

from gstbad.core.element import AudioFilter, Property
from gstbad.core.frame import FLAG_DISCONT, FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import AudioFormat, MediaSpec


@register
class AudioBufferSplit(AudioFilter):
    NAME = "audiobuffersplit"
    FORMATS = AudioFormat.ALL
    PROPERTIES = (
        Property("output-buffer-duration", str, "1/50", static=True,
                 doc="seconds, as a fraction (default 20 ms)"),
        # GstAudioStreamAlign knobs (gstaudiobuffersplit.c:123-136):
        # a timestamp drift beyond alignment-threshold sustained for
        # discont-wait resyncs the output timeline to the input pts.
        # Detection here is at window granularity (our chain unit).
        Property("alignment-threshold", int, 40_000_000),   # ns, 40 ms
        Property("discont-wait", int, 1_000_000_000),       # ns, 1 s
        # strict-buffer-size: discard the carried partial tail at EOS
        # instead of emitting a short buffer (gstaudiobuffersplit.c:138-141)
        Property("strict-buffer-size", bool, False, static=True),
        # gapless mode (gstaudiobuffersplit.c:543-625): on a discont,
        # instead of resyncing the output timeline, insert silence (gap
        # forward, bounded by max-silence-time) or drop samples (gap
        # backward).  max-silence-time doubles as the STATIC silence budget
        # of the fused window program; like the reference, a gap longer
        # than it falls through to the discont/resync path (the reference's
        # default 0 therefore never inserts silence — mirrored here).
        Property("gapless", bool, False, static=True),
        Property("max-silence-time", int, 0, static=True),  # ns
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        frac = Fraction(self.props["output-buffer-duration"])
        self._out_samples = int(in_spec.rate * frac)
        if self._out_samples < 1:
            raise ValueError("output-buffer-duration too small")
        return in_spec

    def _sil_budget(self) -> int:
        """Static silence-sample budget per window (gapless mode)."""
        if not self.props["gapless"]:
            return 0
        return int(self.props["max-silence-time"] * self.in_spec.rate
                   // 1_000_000_000)

    def init_state(self, batch: int):
        c = self.in_spec.channels
        dtype = jnp.dtype(AudioFormat.dtype(self.in_spec.format))
        st = {
            "rem": jnp.zeros((self._out_samples, c), dtype),
            "rem_fill": jnp.int32(0),
            "next_pts": jnp.int64(0),
            "have_pts": jnp.bool_(False),
            "next_in_pts": jnp.int64(0),
            "misaligned_since": jnp.int64(-1),
        }
        if self.props["gapless"]:
            st["drop_pending"] = jnp.int64(0)
        return st

    def process(self, params, state, batch: FrameBatch):
        b, s, c = batch.data.shape
        so = self._out_samples
        rate = self.in_spec.rate
        sil_budget = self._sil_budget()
        gapless = self.props["gapless"]
        total_max = b * s + so + sil_budget  # remainder + silence + window
        n_out = total_max // so  # fixed output block count per window
        # lay remainder [+ gapless silence] + input contiguously,
        # zero-padded to n_out*so (zeros ARE the silence for all formats)
        flat = batch.data.reshape(b * s, c)
        buf = jnp.zeros((n_out * so + so, c), flat.dtype)
        buf = lax_dynamic_update(buf, state["rem"], 0)
        if gapless:
            from gstbad.core.frame import FLAG_DISCONT as _FD
            explicit = (batch.flags[0] & _FD) != 0
            gap = batch.pts[0] - state["next_in_pts"]
            drift = jnp.abs(gap)
            trigger = state["have_pts"] & (
                explicit | (drift > params["alignment-threshold"]))
            sil_n = jnp.where(trigger & (gap > 0),
                              gap * rate // 1_000_000_000, 0)
            sil_time = sil_n * 1_000_000_000 // rate
            # like the reference (gstaudiobuffersplit.c:574-580), a gap
            # beyond max-silence-time is NOT filled — it falls through to
            # the normal discont/resync machinery below
            do_sil = trigger & (gap > 0) & \
                (sil_time <= self.props["max-silence-time"])
            sil_n = jnp.where(do_sil, jnp.minimum(sil_n, sil_budget), 0)
            new_drop = jnp.where(trigger & (gap < 0),
                                 (-gap) * rate // 1_000_000_000, 0)
            total_drop = state["drop_pending"] + new_drop
            drop_used = jnp.minimum(total_drop, b * s)
            drop_pending = total_drop - drop_used
            handled = do_sil | (trigger & (gap < 0))
            flat_eff = jnp.roll(flat, -drop_used, axis=0)
            pos = state["rem_fill"] + sil_n.astype(jnp.int32)
            buf = lax_dynamic_update(buf, flat_eff, pos)
            fill = (pos + b * s - drop_used).astype(jnp.int32)
        else:
            handled = jnp.bool_(False)
            drop_pending = None
            buf = lax_dynamic_update(buf, flat, state["rem_fill"])
            fill = state["rem_fill"] + b * s
        n_full = fill // so
        blocks = buf[:n_out * so].reshape(n_out, so, c)
        valid = jnp.arange(n_out) < n_full
        # carry the tail
        tail_start = n_full * so
        rem = jnp.zeros((so, c), flat.dtype)
        rem_fill = fill - tail_start
        idx = tail_start + jnp.arange(so)
        rem = jnp.where((jnp.arange(so) < rem_fill)[:, None],
                        buf[idx], rem)
        # timestamps: continuous from the first input pts seen; a drift
        # beyond alignment-threshold sustained past discont-wait resyncs
        # the output timeline to the input pts (GstAudioStreamAlign)
        in_pts = batch.pts[0]
        drift = jnp.abs(in_pts - state["next_in_pts"])
        misaligned = state["have_pts"] & \
            (drift > params["alignment-threshold"])
        since = jnp.where(misaligned,
                          jnp.where(state["misaligned_since"] >= 0,
                                    state["misaligned_since"], in_pts),
                          jnp.int64(-1))
        # a gapless-handled discont (silence filled / samples dropped)
        # keeps the output timeline continuous instead of resyncing
        resync = misaligned & (since >= 0) & \
            (in_pts - since >= params["discont-wait"]) & ~handled
        since = jnp.where(handled, jnp.int64(-1), since)
        base = jnp.where(resync, in_pts, state["next_pts"])
        since = jnp.where(resync, jnp.int64(-1), since)

        first_pts = jnp.where(state["have_pts"], base, in_pts)
        dur = jnp.int64(round(1e9 * so / self.in_spec.rate))
        pts = first_pts + jnp.arange(n_out, dtype=jnp.int64) * dur
        next_pts = first_pts + n_full.astype(jnp.int64) * dur
        in_dur = (jnp.int64(b * s) * 1_000_000_000) // self.in_spec.rate
        # expected input position accumulates from the aligned timeline;
        # only a resync (or stream start) re-anchors it to the actual pts —
        # otherwise a sustained jump would "self-heal" after one window and
        # discont-wait could never elapse (GstAudioStreamAlign tracks the
        # accumulated expected position the same way)
        next_in = jnp.where(resync | handled | ~state["have_pts"],
                            in_pts + in_dur,
                            state["next_in_pts"] + in_dur)
        new_state = {"rem": rem, "rem_fill": rem_fill.astype(jnp.int32),
                     "next_pts": next_pts, "have_pts": jnp.bool_(True),
                     "next_in_pts": next_in,
                     "misaligned_since": since}
        if drop_pending is not None:
            new_state["drop_pending"] = drop_pending
        flags = jnp.zeros(n_out, jnp.int32).at[0].set(
            jnp.where(resync, jnp.int32(FLAG_DISCONT), 0))
        out = FrameBatch(data=blocks, pts=pts, flags=flags, valid=valid)
        return new_state, out


def lax_dynamic_update(buf, update, start):
    import jax.lax as lax
    return lax.dynamic_update_slice(
        buf, update, (jnp.asarray(start, jnp.int32), jnp.int32(0)))
