"""bpmdetect — beats-per-minute estimator
(ext/soundtouch/gstbpmdetect.cc, DSP from SoundTouch's BPMDetect).

SoundTouch's detector lowpasses and rectifies the signal into a ~1 kHz
amplitude envelope, autocorrelates it over lags covering 29-200 BPM, and
picks the strongest peak; the element pushes the value downstream as a
BEATS_PER_MINUTE tag whenever it changes (gstbpmdetect.cc:255-261).

JAX rebuild: the envelope is a parallel first-order lowpass
(associative scan) + strided decimation; a ~8 s envelope ring carried in
state is autocorrelated with one batched FFT per window (Wiener-Khinchin)
— no sequential loops at all.  The value posts as a `bpm` message on the
bus (the tag-event analog) whenever the estimate changes by >= 1 BPM.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from gstbad.core.element import AudioFilter, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import AudioFormat, MediaSpec
from gstbad.ops import audio as ops

MIN_BPM, MAX_BPM = 29.0, 200.0   # SoundTouch's detection range
ENV_RATE = 1000                  # envelope sample rate, Hz
RING_SECONDS = 8


@register
class BpmDetect(AudioFilter):
    NAME = "bpmdetect"
    FORMATS = (AudioFormat.F32, AudioFormat.S16)
    CHANNELS = (1, 64)
    PROPERTIES = (Property("message", bool, True),)

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        spec = super().negotiate(in_spec)
        self._decim = max(1, spec.rate // ENV_RATE)
        self._ring = RING_SECONDS * ENV_RATE
        return spec

    def init_state(self, batch: int):
        return {
            "lp": jnp.zeros((1,), jnp.float32),
            "ring": jnp.zeros((self._ring,), jnp.float32),
            "fill": jnp.int64(0),
            "last_bpm": jnp.float32(0.0),
        }

    def process(self, params, state, batch: FrameBatch):
        b, s, c = batch.data.shape
        x = batch.data.reshape(b * s, c).astype(jnp.float32)
        if self.in_spec.format == AudioFormat.S16:
            x = x / 32768.0
        mono = jnp.mean(x, axis=1, keepdims=True)
        # rectified envelope through a ~20 Hz one-pole lowpass
        alpha = float(np.exp(-2.0 * np.pi * 20.0 / self.in_spec.rate))
        env = ops.first_order_iir((1.0 - alpha) * jnp.abs(mono), alpha,
                                  state["lp"])
        lp = env[-1]
        dec = env[:: self._decim, 0]
        n = dec.shape[0]
        ring = jnp.roll(state["ring"], -n).at[-n:].set(dec)
        fill = jnp.minimum(state["fill"] + n, self._ring)

        # autocorrelation via rfft (Wiener-Khinchin), mean-removed
        w = ring - jnp.mean(ring)
        spec = jnp.fft.rfft(w, n=2 * self._ring)
        ac = jnp.fft.irfft(spec * jnp.conj(spec))[: self._ring].real
        lag_min = int(ENV_RATE * 60.0 / MAX_BPM)
        lag_max = int(ENV_RATE * 60.0 / MIN_BPM)
        lags = jnp.arange(self._ring)
        band = (lags >= lag_min) & (lags <= lag_max)
        best = jnp.argmax(jnp.where(band, ac, -jnp.inf))
        bpm = (60.0 * ENV_RATE / best.astype(jnp.float32)).astype(
            jnp.float32)
        ready = fill >= 2 * lag_max  # need >= 2 periods of the slowest BPM
        bpm = jnp.where(ready, bpm, 0.0)
        changed = (jnp.abs(bpm - state["last_bpm"]) >= 1.0) & ready
        new_state = {"lp": lp, "ring": ring, "fill": fill,
                     "last_bpm": jnp.where(changed, bpm,
                                           state["last_bpm"])}
        emit = jnp.zeros((b,), bool).at[-1].set(
            changed & jnp.asarray(self.props["message"]))
        msgs = {"bpm": {"_emit": emit,
                        "bpm": jnp.broadcast_to(bpm, (b,))}}
        return new_state, batch, msgs
