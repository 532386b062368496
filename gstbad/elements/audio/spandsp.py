"""spandsp elements (ext/spandsp/): tonegeneratesrc, dtmfdetect,
spanplc.

The reference wraps libspandsp (absent here); the DSP is implemented
from the published algorithms, device-first:

- tonegeneratesrc (gsttonegeneratesrc.c): dual-frequency tone with the
  on/off//on2/off2 cadence and repeat flag; `volume` is attenuation in
  dB below full scale (libspandsp levels are dBm0 — the fixed 3.14 dB
  dBm0 offset is not modeled, documented).
- dtmfdetect (gstdtmfdetect.c): Goertzel filterbank over 102-sample
  blocks at 8 kHz (the spandsp block size) as one [102, 16] sin/cos
  matmul per block — MXU-shaped — with row/column energy thresholds,
  twist limits and a two-block persistence check before a digit
  registers; posts `dtmf-event` messages with the reference's fields
  (type=1, number 0-15, method=2).  spandsp's exact thresholds and
  dial-tone filter are not reproduced (documented; synthesized-tone
  round-trips are the tests' ground truth).
- spanplc (gstspanplc.c): packet loss concealment in the shape of ITU
  G.711 Appendix I — on a lost frame (valid=False in this framework =
  the reference's GAP event) the engine detects the pitch period by
  normalized cross-correlation over the history ring, replays it with
  progressive attenuation, and cross-fades back in on the first good
  frame (plc_rx's ramp-in).  Runs fully in-graph (scan-carried ring);
  posts `spanplc-stats` messages with the num-pushed/num-gap/
  plc-num-samples/plc-duration/pitch fields of the reference's stats
  property (gstspanplc.c:76-100).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from gstbad.core.element import Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import AudioFormat, MediaSpec, require

RATE = 8000

# -- tonegeneratesrc --------------------------------------------------------


@register
class ToneGenerateSrc(Element):
    NAME = "tonegeneratesrc"
    KIND = "source"
    PROPERTIES = (
        Property("samplesperbuffer", int, 1024, 1, None, static=True),
        Property("freq", int, 0, 0, 20000, static=True),
        Property("volume", int, 0, 0, 50, static=True,
                 doc="attenuation in dB (0 = full scale)"),
        Property("freq2", int, 0, 0, 20000, static=True),
        Property("volume2", int, 0, 0, 50, static=True),
        Property("on-time", int, 1000, 1, None, static=True,
                 doc="ms on in the first cadence phase"),
        Property("off-time", int, 1000, 0, None, static=True),
        Property("on-time2", int, 0, 0, None, static=True),
        Property("off-time2", int, 0, 0, None, static=True),
        Property("repeat", bool, False, static=True),
    )

    def negotiate(self, in_spec):
        return MediaSpec(kind="audio", format=AudioFormat.S16,
                         rate=RATE, channels=1)

    def init_state(self, window: int):
        return jnp.int64(0)          # absolute sample position

    def generate(self, params, state, window: int):
        s = self.props["samplesperbuffer"]
        n = state + jnp.arange(window * s, dtype=jnp.int64)
        t = n.astype(jnp.float64) / RATE
        amp1 = 32767.0 * 10.0 ** (-self.props["volume"] / 20.0)
        sig = amp1 * jnp.sin(2 * jnp.pi * self.props["freq"] * t)
        if self.props["freq2"]:
            amp2 = 32767.0 * 10.0 ** (-self.props["volume2"] / 20.0)
            sig = sig + amp2 * jnp.sin(
                2 * jnp.pi * self.props["freq2"] * t)
        # cadence: on, off, on2, off2 (ms) then repeat or silence
        seg = [self.props["on-time"], self.props["off-time"],
               self.props["on-time2"], self.props["off-time2"]]
        bounds = np.cumsum([v * RATE // 1000 for v in seg])
        total = int(bounds[-1])
        pos = n % total if self.props["repeat"] else n
        on = (pos < bounds[0]) | ((pos >= bounds[1])
                                  & (pos < bounds[2]))
        sig = jnp.where(on & (pos < total), sig, 0.0)
        out = jnp.clip(sig, -32768, 32767).astype(jnp.int16)
        out = out.reshape(window, s, 1)
        pts = (state // s + jnp.arange(window, dtype=jnp.int64)) \
            * s * 10 ** 9 // RATE
        return state + window * s, FrameBatch.make(out, pts=pts)


# -- dtmfdetect -------------------------------------------------------------

_DTMF_ROWS = (697.0, 770.0, 852.0, 941.0)
_DTMF_COLS = (1209.0, 1336.0, 1477.0, 1633.0)
_BLOCK = 102                      # spandsp dtmf_rx block size
# RFC 2833 event numbers laid out on the 4x4 keypad
_DIGITS = ((1, 2, 3, 12), (4, 5, 6, 13), (7, 8, 9, 14), (10, 0, 11, 15))


def _goertzel_basis():
    n = np.arange(_BLOCK)
    freqs = list(_DTMF_ROWS) + list(_DTMF_COLS)
    cos = np.stack([np.cos(2 * np.pi * f * n / RATE) for f in freqs])
    sin = np.stack([np.sin(2 * np.pi * f * n / RATE) for f in freqs])
    return np.concatenate([cos, sin]).T       # [102, 16]


@register
class DtmfDetect(Element):
    NAME = "dtmfdetect"
    PROPERTIES = ()

    MAX_EVENTS = 8               # per frame, like MAX_DTMF_DIGITS' spirit

    def negotiate(self, in_spec):
        require(in_spec.kind == "audio"
                and in_spec.format == AudioFormat.S16
                and in_spec.channels == 1,
                "dtmfdetect: needs S16 mono")
        require(in_spec.rate == RATE,
                "dtmfdetect: needs 8000 Hz (the spandsp DTMF rate)")
        return in_spec

    def init_state(self, window: int):
        return {"last": jnp.int32(-1), "count": jnp.int32(0),
                "reported": jnp.bool_(False)}

    def process(self, params, state, batch: FrameBatch):
        basis = jnp.asarray(_goertzel_basis())
        x = batch.data[..., 0].astype(jnp.float32)   # [B, S]
        b, s = x.shape
        nblk = s // _BLOCK
        blocks = x[:, :nblk * _BLOCK].reshape(b, nblk, _BLOCK)
        proj = jnp.einsum("bns,sf->bnf", blocks, basis,
                          precision=lax.Precision.HIGHEST)
        power = proj[..., :8] ** 2 + proj[..., 8:] ** 2   # [B, nblk, 8]
        rowp, colp = power[..., :4], power[..., 4:]
        ri = jnp.argmax(rowp, axis=-1)
        ci = jnp.argmax(colp, axis=-1)
        re = jnp.max(rowp, axis=-1)
        ce = jnp.max(colp, axis=-1)
        total = jnp.sum(power, axis=-1)
        # thresholds: absolute energy, dominance, twist limits (8 dB
        # forward / 4 dB reverse like the classic detector)
        floor = (_BLOCK * 0.05 * 32768.0 / 2) ** 2
        hit = (re + ce > floor) \
            & (re + ce > 0.85 * total) \
            & (re < ce * 10 ** 0.8) & (ce < re * 10 ** 0.4)
        digit_tab = jnp.asarray(np.asarray(_DIGITS, np.int32))
        digit = digit_tab[ri, ci]
        digit = jnp.where(hit, digit, -1)

        def blk_step(st, d):
            last, count, reported = st
            same = d == last
            count = jnp.where(same & (d >= 0), count + 1, 0)
            # register on the 2nd consecutive hit of the same digit
            emit = (d >= 0) & same & (count == 1) & ~reported
            reported = jnp.where(d < 0, False,
                                 jnp.where(emit, True, reported))
            return (d, count, reported), (emit, d)

        def frame_step(st, dseq):
            (last, count, rep), (emits, ds) = lax.scan(
                blk_step, (st["last"], st["count"], st["reported"]),
                dseq)
            # compact up to MAX_EVENTS per frame
            order = jnp.argsort(~emits, stable=True)
            evs = jnp.where(emits[order], ds[order], -1)[
                :self.MAX_EVENTS]
            return ({"last": last, "count": count, "reported": rep},
                    evs)

        state, events = lax.scan(frame_step, state, digit)
        msgs = {"dtmf-event": {
            "type": jnp.ones((b, self.MAX_EVENTS), jnp.int32),
            "number": events,
            "method": jnp.full((b, self.MAX_EVENTS), 2, jnp.int32),
            "_emit": (events >= 0).any(axis=-1)}}
        return state, batch, msgs


# -- spanplc ----------------------------------------------------------------

_HIST = 1024                      # history ring (128 ms at 8 kHz)
_MIN_PITCH = 20                   # 400 Hz
_MAX_PITCH = 200                  # 40 Hz
_ATTEN_MS = 50.0                  # full fade over ~50 ms of fill
_OLA = 32                         # ramp-in cross-fade samples


@register
class SpanPlc(Element):
    NAME = "spanplc"
    PROPERTIES = ()

    def negotiate(self, in_spec):
        require(in_spec.kind == "audio"
                and in_spec.format == AudioFormat.S16
                and in_spec.channels == 1,
                "spanplc: needs S16 mono")
        self._rate = in_spec.rate
        return in_spec

    def init_state(self, window: int):
        return {"hist": jnp.zeros(_HIST, jnp.float32),
                "missing": jnp.bool_(False),
                "pitch": jnp.int32(_MIN_PITCH),
                "offset": jnp.int32(0),
                "filled": jnp.int32(0),
                "num_pushed": jnp.int64(0),
                "num_gap": jnp.int64(0),
                "plc_samples": jnp.int64(0)}

    def _detect_pitch(self, hist):
        """Normalized cross-correlation of the most recent window
        against itself at lags MIN..MAX."""
        probe = hist[-_MIN_PITCH * 2:]
        n = probe.shape[0]
        lags = jnp.arange(_MIN_PITCH, _MAX_PITCH, dtype=jnp.int32)

        def score(lag):
            seg = lax.dynamic_slice(hist, (jnp.int32(
                _HIST - n) - lag,), (n,))
            num = jnp.sum(seg * probe)
            den = jnp.sqrt(jnp.sum(seg * seg)
                           * jnp.sum(probe * probe)) + 1e-6
            return num / den

        scores = jax.vmap(score)(lags)
        return lags[jnp.argmax(scores)]

    def process(self, params, state, batch: FrameBatch):
        x = batch.data[..., 0].astype(jnp.float32)   # [B, S]
        b, s = x.shape
        atten_per = jnp.float32(1000.0 / (_ATTEN_MS * self._rate))

        def step(st, inp):
            samples, valid = inp

            def fillin(st):
                pitch = jnp.where(st["missing"], st["pitch"],
                                  self._detect_pitch(st["hist"]))
                idx = (st["offset"]
                       + jnp.arange(s, dtype=jnp.int32)) % pitch
                # fixed tail window; the period starts pitch samples
                # from the end
                src = st["hist"][-_MAX_PITCH:]
                synth = jnp.take(src, jnp.clip(
                    _MAX_PITCH - pitch + idx, 0, _MAX_PITCH - 1))
                # no attenuation for the first 10 ms, then a linear
                # fade to silence over _ATTEN_MS (G.711 A1 shape)
                k = st["filled"] + jnp.arange(s, dtype=jnp.int32)
                lead = jnp.int32(self._rate // 100)
                k = jnp.maximum(k - lead, 0)
                gain = jnp.clip(1.0 - k.astype(jnp.float32)
                                * atten_per, 0.0, 1.0)
                out = synth * gain
                new = {**st,
                       "missing": jnp.bool_(True),
                       "pitch": pitch,
                       "offset": (st["offset"] + s) % pitch,
                       "filled": st["filled"] + s,
                       "num_gap": st["num_gap"] + 1,
                       "plc_samples": st["plc_samples"] + s}
                return out, new

            def passthrough(st):
                # ramp-in after concealment: cross-fade the synthetic
                # continuation into the real signal (plc_rx behaviour)
                pitch = st["pitch"]
                idx = (st["offset"]
                       + jnp.arange(_OLA, dtype=jnp.int32)) % pitch
                src = st["hist"][-_MAX_PITCH:]
                synth = jnp.take(src, jnp.clip(
                    _MAX_PITCH - pitch + idx, 0, _MAX_PITCH - 1))
                w = (jnp.arange(_OLA, dtype=jnp.float32) + 1) / _OLA
                head = samples[:_OLA] * w + synth * (1 - w)
                out = jnp.where(st["missing"],
                                jnp.concatenate([head,
                                                 samples[_OLA:]]),
                                samples)
                new = {**st, "missing": jnp.bool_(False),
                       "offset": jnp.int32(0),
                       "filled": jnp.int32(0)}
                return out, new

            out, new = lax.cond(valid, passthrough, fillin, st)
            hist = jnp.concatenate([new["hist"][s:], out]) \
                if s < _HIST else out[-_HIST:]
            new = {**new, "hist": hist,
                   "num_pushed": new["num_pushed"] + 1}
            return new, out

        state, outs = lax.scan(step, state, (x, batch.valid))
        out = jnp.clip(outs, -32768, 32767).astype(jnp.int16)[..., None]
        dur = s * 10 ** 9 // self._rate
        msgs = {"spanplc-stats": {
            "num-pushed": jnp.broadcast_to(state["num_pushed"], (b,)),
            "num-gap": jnp.broadcast_to(state["num_gap"], (b,)),
            "plc-num-samples": jnp.broadcast_to(state["plc_samples"],
                                                (b,)),
            "plc-duration": jnp.broadcast_to(
                state["plc_samples"] * (10 ** 9 // self._rate), (b,)),
            "pitch": jnp.broadcast_to(
                self._rate // jnp.maximum(state["pitch"], 1), (b,)),
            "_emit": jnp.arange(b) == b - 1}}
        # concealed frames become valid output (the fill-in buffers)
        return state, FrameBatch.make(
            out, pts=batch.pts, flags=batch.flags,
            valid=jnp.ones_like(batch.valid)), msgs