"""pitch — pitch/tempo/rate shifter (ext/soundtouch/gstpitch.cc).

The reference wraps SoundTouch's WSOLA time-stretcher: `tempo` changes
duration keeping pitch, `pitch` changes pitch keeping duration, `rate`
changes both (plain resample), `output-rate` only rescales downstream
segments (gstpitch.cc:141-163, all [0.1, 10], default 1).

JAX rebuild: a Hann phase vocoder (ops/audio.phase_vocoder) — analysis hop
256 of a 1024 frame, synthesis hop round(256·pitch/tempo), then a linear
resample by 1/(pitch·rate) — FFTs batch across frames; only the phase
accumulator is sequential (a small scan).  The realized stretch quantizes
to the integer synthesis hop, like SoundTouch's internal sequence
quantization.  Props are compile-static (output length depends on them),
but LIVE changes work through Pipeline.set_static_property — the pipeline
recompiles and migrate_state carries the vocoder state across, matching
the reference's mid-stream setTempo/setRate (gstpitch.cc:248-258).
"""

from __future__ import annotations

import jax.numpy as jnp

from gstbad.core.element import AudioFilter, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import AudioFormat, MediaSpec, require
from gstbad.ops import audio as ops

FRAME = 1024
HA = 256


@register
class Pitch(AudioFilter):
    NAME = "pitch"
    FORMATS = (AudioFormat.F32,)
    CHANNELS = (1, 64)
    PROPERTIES = (
        Property("pitch", float, 1.0, 0.1, 10.0, static=True),
        Property("tempo", float, 1.0, 0.1, 10.0, static=True),
        Property("rate", float, 1.0, 0.1, 10.0, static=True),
        Property("output-rate", float, 1.0, 0.1, 10.0, static=True),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        spec = super().negotiate(in_spec)
        pitch, tempo, rate = (self.props["pitch"], self.props["tempo"],
                              self.props["rate"])
        # vocoder stretch realizes duration 1/(tempo*rate) AND pitch
        # factor pitch*rate once resampled back by 1/(pitch*rate)
        self._hs = max(1, round(HA * pitch / tempo))
        self._resample = pitch * rate
        return spec

    def init_state(self, batch: int):
        return ops.pv_init_state(FRAME, HA, self._hs,
                                 self.in_spec.channels)

    def migrate_state(self, old_state, window: int):
        """Live tempo/rate change (gstpitch.cc:248-258 mutates the engine
        mid-stream via Pipeline.set_static_property here): the carried
        analysis tail and phase accumulators are hop-independent and kept;
        the OLA tail's length is frame-hs, so it is cropped/zero-padded to
        the new hop — a one-frame synthesis transient, like SoundTouch's
        internal sequence re-quantization."""
        fresh = ops.pv_init_state(FRAME, HA, self._hs, self.in_spec.channels)
        out = dict(old_state)
        old_ola = old_state["ola"]
        new_len = fresh["ola"].shape[0]
        keep = min(new_len, old_ola.shape[0])
        out["ola"] = fresh["ola"].at[:keep].set(old_ola[:keep])
        return out

    def process(self, params, state, batch: FrameBatch):
        b, s, c = batch.data.shape
        n = b * s
        require(n % HA == 0,
                f"pitch: window samples {n} must be a multiple of {HA}")
        x = batch.data.reshape(n, c).astype(jnp.float32)
        stretched, state = ops.phase_vocoder(x, state, FRAME, HA, self._hs)
        n_str = stretched.shape[0]
        n_out = max(1, round(n_str / self._resample))
        y = ops.resample_linear(stretched, n_out)
        # duration scale: output spans input time / (tempo*rate)
        scale = 1.0 / (self.props["tempo"] * self.props["rate"]
                       * self.props["output-rate"])
        pts = (batch.pts[:1].astype(jnp.float64) * scale).astype(jnp.int64)
        out = FrameBatch(data=y[None, :, :], pts=pts,
                         flags=batch.flags[:1],
                         valid=batch.valid[:1])
        return state, out
