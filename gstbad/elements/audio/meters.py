"""videoframe-audiolevel + audiolatency analogs
(gst/videoframe_audiolevel/, gst/audiolatency/)."""

from __future__ import annotations

import time

import jax.numpy as jnp
import numpy as np

from gstbad.core.element import AudioFilter, Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import AudioFormat, MediaSpec


@register
class VideoFrameAudioLevel(AudioFilter):
    """Per-video-frame RMS meter (gstvideoframe-audiolevel.c:26-32).

    Connected with TWO inputs (video branch + audio branch, the reference's
    vsink/asink pads), audio samples are binned to video frames by PTS and
    one message per video frame is posted; the video stream passes through.
    With a single (audio) input, frame boundaries derive from `framerate`
    and one message per audio block is posted.
    rms = sqrt(mean(sample^2)) on normalized [-1,1] samples.
    """

    NAME = "videoframe-audiolevel"
    N_INPUTS = 2
    FORMATS = AudioFormat.ALL
    PROPERTIES = (Property("framerate", str, "30/1", static=True),)

    def negotiate(self, in_spec):
        if isinstance(in_spec, list):
            video, audio = in_spec
            from gstbad.core.spec import require
            require(video.kind == "video" and audio.kind == "audio",
                    "videoframe-audiolevel: needs (video, audio) inputs")
            self._audio_spec = audio
            return video
        self._audio_spec = in_spec
        return in_spec

    def _norm(self, x):
        fmt = self._audio_spec.format
        if fmt == AudioFormat.S16:
            return x.astype(jnp.float64) / 32768.0
        if fmt == AudioFormat.S32:
            return x.astype(jnp.float64) / 2147483648.0
        return x.astype(jnp.float64)

    def process(self, params, state, batch):
        if isinstance(batch, list):
            video, audio = batch
            xf = self._norm(audio.data)          # [Ba, S, C]
            ba, s, c = xf.shape
            rate = self._audio_spec.rate
            # absolute pts of every audio sample
            sample_pts = (audio.pts[:, None]
                          + (jnp.arange(s, dtype=jnp.int64)
                             * jnp.int64(round(1e9 / rate)))[None, :]
                          ).reshape(-1)           # [Ba*S]
            sq = (xf * xf).reshape(-1, c)
            vdur = jnp.int64(self.out_spec.frame_duration_ns)
            lo = video.pts[:, None]               # [Bv, 1]
            hi = lo + vdur
            m = ((sample_pts[None, :] >= lo)
                 & (sample_pts[None, :] < hi)).astype(jnp.float64)
            counts = jnp.maximum(m.sum(axis=1), 1.0)
            sums = m @ sq                         # [Bv, C]
            rms = jnp.sqrt(sums / counts[:, None])
            msgs = {"videoframe-audiolevel": {"rms": rms}}
            return state, video, msgs
        xf = self._norm(batch.data)
        rms = jnp.sqrt(jnp.mean(xf * xf, axis=1))  # [B, C]
        return state, batch, {"videoframe-audiolevel": {"rms": rms}}


@register
class AudioLatency(AudioFilter):
    """audiolatency (gst/audiolatency/gstaudiolatency.c): tick-probe
    roundtrip latency meter.

    The reference outputs 1 Hz ticks on its src pad (an internal
    audiotestsrc with wave=ticks, gstaudiolatency.c:224) and watches its
    sink pad for a sample with |x| > 0.7 (buffer_has_wave,
    gstaudiolatency.c:368), keeping a ring of the last 5 latencies and
    posting a "latency" message with last-latency / average-latency in
    microseconds (gst_audiolatency_set_latency, :287-310).  Latencies
    above the 1 s tick period cannot be measured — same constraint here.

    Dataflow rebuild: the OUTPUT is a 10 ms 440 Hz tick burst aligned to
    every whole stream-time second; the INPUT is scanned for the first
    |x| > 0.7 sample per frame and its stream-time offset into the
    current second IS the loop latency (the reference measures the same
    thing with g_get_monotonic_time because its loop crosses real audio
    hardware; ours is stream-time-observable, like netsim)."""

    NAME = "audiolatency"
    FORMATS = (AudioFormat.F32,)  # reference caps are F32 (gstaudiolatency.h)
    PROPERTIES = (Property("print-latency", bool, False),)

    TICK_HZ = 440.0
    TICK_NS = 10_000_000  # 10 ms burst

    def init_state(self, batch: int):
        return {
            "ring": jnp.zeros((5,), jnp.int64),   # µs, last 5
            "idx": jnp.int64(0),
            "count": jnp.int64(0),
            "last_bucket": jnp.int64(-1),
        }

    def process(self, params, state, batch: FrameBatch):
        import jax
        from jax import lax
        b, s, c = batch.data.shape
        rate = self.in_spec.rate

        # sample stream times [B, S] ns
        offs = (jnp.arange(s, dtype=jnp.int64) * 1_000_000_000) // rate
        pos = batch.pts[:, None] + offs[None, :]

        # --- output: tick bursts at whole seconds --------------------------
        in_burst = (pos % 1_000_000_000) < self.TICK_NS
        t = (pos % 1_000_000_000).astype(jnp.float32) / 1e9
        wave = jnp.sin(2.0 * jnp.pi * self.TICK_HZ * t) * 0.8
        out = jnp.where(in_burst, wave, 0.0).astype(jnp.float32)
        out = jnp.broadcast_to(out[..., None], (b, s, c))

        # --- input: detect tick arrivals -----------------------------------
        hits = jnp.abs(batch.data[..., 0]) > 0.7   # first channel, like C
        first = jnp.argmax(hits, axis=1)           # per frame
        has = jnp.any(hits, axis=1)
        hit_pos = pos[jnp.arange(b), first]
        bucket = hit_pos // 1_000_000_000

        def step(st, inp):
            has_i, bucket_i, pos_i, valid_i = inp
            accept = has_i & valid_i & (bucket_i > st["last_bucket"])
            lat_us = (pos_i % 1_000_000_000) // 1000
            ring = jnp.where(accept,
                             st["ring"].at[st["idx"] % 5].set(lat_us),
                             st["ring"])
            idx = jnp.where(accept, st["idx"] + 1, st["idx"])
            count = jnp.minimum(jnp.where(accept, st["count"] + 1,
                                          st["count"]), 5)
            avg = jnp.where(count > 0,
                            jnp.sum(ring) // jnp.maximum(count, 1), 0)
            new = {"ring": ring, "idx": idx, "count": count,
                   "last_bucket": jnp.where(accept, bucket_i,
                                            st["last_bucket"])}
            return new, (accept, lat_us, avg)

        state, (accepted, lat_us, avg_us) = lax.scan(
            step, state, (has, bucket, hit_pos, batch.valid))

        msgs = {"latency": {"_emit": accepted,
                            "last-latency": lat_us,
                            "average-latency": avg_us}}
        return state, batch.with_data(out), msgs

    @property
    def last_latency_us(self):
        return self._measurements[-1] if self._measurements else None
