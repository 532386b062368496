"""Observability elements — fpsdisplaysink, videocodectestsink, debugspy
(gst/debugutils/) and netsim (gst/netsim/)."""

from __future__ import annotations

import hashlib
import time

import numpy as np
import jax.numpy as jnp

from gstbad.core.bus import Message
from gstbad.core.element import Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register


@register
class FpsDisplaySink(Element):
    """fpsdisplaysink (gst/debugutils/fpsdisplaysink.c:80-91): rendered/
    dropped counts and min/max/avg fps, posted as `fps-measurements`."""

    NAME = "fpsdisplaysink"
    KIND = "sink"
    HOST = True
    PROPERTIES = (Property("fps-update-interval", int, 500),)  # ms

    def __init__(self, **props):
        super().__init__(**props)
        self.frames_rendered = 0
        self.frames_dropped = 0
        self._t0 = None
        self._last_update = None
        self._last_frames = 0
        self.min_fps = float("inf")
        self.max_fps = 0.0

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = self._last_update = now
        self.frames_rendered += np_batch.batch
        interval = self.props["fps-update-interval"] / 1000.0
        if now - self._last_update >= interval:
            fps = ((self.frames_rendered - self._last_frames)
                   / (now - self._last_update))
            self.min_fps = min(self.min_fps, fps)
            self.max_fps = max(self.max_fps, fps)
            self._last_update = now
            self._last_frames = self.frames_rendered
            if bus is not None:
                elapsed = now - self._t0
                bus.post(Message(self.NAME, "fps-measurements",
                                 int(np_batch.pts[-1]),
                                 {"fps": fps,
                                  "drop-rate": 0.0,
                                  "avg-fps": self.frames_rendered / elapsed
                                  if elapsed else 0.0}))

    @property
    def average_fps(self):
        elapsed = time.monotonic() - self._t0 if self._t0 else 0
        return self.frames_rendered / elapsed if elapsed else 0.0


@register
class VideoCodecTestSink(Element):
    """videocodectestsink (gstvideocodectestsink.c:33-46,193-230): per-frame
    and whole-stream MD5 conformance checksums posted as `conformance`
    messages."""

    NAME = "videocodectestsink"
    KIND = "sink"
    HOST = True

    def __init__(self, **props):
        super().__init__(**props)
        self._stream_md5 = hashlib.md5()
        self.frame_checksums = []

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    @staticmethod
    def _frame_bytes(data, i):
        if isinstance(data, dict):
            return b"".join(np.ascontiguousarray(data[k][i]).tobytes()
                            for k in sorted(data))
        return np.ascontiguousarray(data[i]).tobytes()

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        for i in range(np_batch.batch):
            blob = self._frame_bytes(np_batch.data, i)
            digest = hashlib.md5(blob).hexdigest()
            self._stream_md5.update(blob)
            self.frame_checksums.append(digest)
            if bus is not None:
                bus.post(Message(self.NAME, "conformance",
                                 int(np_batch.pts[i]),
                                 {"checksum": digest}))

    @property
    def stream_checksum(self) -> str:
        return self._stream_md5.hexdigest()


@register
class DebugSpy(Element):
    """debugspy: posts a buffer-info message per frame (PTS, flags,
    checksum-free)."""

    NAME = "debugspy"
    PROPERTIES = (Property("silent", bool, False),)

    def process(self, params, state, batch: FrameBatch):
        msgs = {"buffer-info": {
            "_emit": jnp.broadcast_to(~params["silent"], (batch.batch,)),
            "flags": batch.flags,
        }}
        return state, batch, msgs


@register
class NetSim(Element):
    """netsim (gst/netsim/gstnetsim.c): network fault injection — token
    bucket, drop-packets counter, drop/duplicate probability, delay with
    uniform/normal/gamma distributions, allow-reordering.

    Chain order matches the reference chain fn (gstnetsim.c:476-501):
    token bucket -> drop-packets -> drop-probability -> duplicate -> delay.
    Dropping uses the validity mask; duplicates emit a second gated slot.

    Documented divergences (dataflow semantics on a batch machine):
    - delay applies to PTS rather than wall-clock transmission (the
      observable effect on a dataflow graph); allow-reordering=false
      enforces a monotone output-PTS floor (the reference's
      last_ready_time+1 rule, gstnetsim.c:371-373).
    - the token bucket meters stream time (PTS deltas) instead of the
      pipeline wall clock (gstnetsim.c:404-421) — deterministic and
      equivalent for a realtime stream.
    - distributions are sampled with JAX's PRNG, not GLib's Mersenne
      twister, so sequences differ from the reference for equal seeds;
      the distribution shapes match (normal: mu=(lo+hi)/2 with 95% CI at
      [lo,hi], gstnetsim.c:277-285; gamma: shape 1.25 scaled so
      P(x < hi-lo) = 0.95, gstnetsim.c:318-327)."""

    NAME = "netsim"
    GAMMA_SHAPE, GAMMA_R95 = 1.25, 3.4640381  # gstnetsim.c:323-325
    PROPERTIES = (
        Property("drop-probability", float, 0.0, 0.0, 1.0),
        Property("duplicate-probability", float, 0.0, 0.0, 1.0),
        Property("delay-probability", float, 0.0, 0.0, 1.0),
        Property("min-delay", int, 200),   # ms, DEFAULT_MIN_DELAY
        Property("max-delay", int, 400),   # ms, DEFAULT_MAX_DELAY
        Property("delay-distribution", str, "uniform", static=True),
        Property("drop-packets", int, 0, 0, None, static=True),
        Property("max-kbps", int, -1, -1, None),
        Property("max-bucket-size", int, -1, -1, None),  # Kb
        Property("allow-reordering", bool, True, static=True),
        Property("max-delay-ns", int, 0),  # legacy: uniform [0,ns) PTS shift
        Property("seed", int, 0, static=True),
    )

    def init_state(self, batch: int):
        import jax
        mbs = self.props["max-bucket-size"]
        return {
            "key": jax.random.PRNGKey(self.props["seed"]),
            # setting max-bucket-size starts the bucket full
            # (gstnetsim.c:538-540)
            "bucket": jnp.int64(mbs * 1000 if mbs > 0 else 0),
            "prev_time": jnp.int64(-1),
            "drop_packets": jnp.int64(self.props["drop-packets"]),
            "last_ready": jnp.int64(-(2 ** 62)),
        }

    def _delay_ms(self, key, shape, params):
        """One delay draw per slot, in ms (float64)."""
        import jax
        lo = params["min-delay"].astype(jnp.float64)
        hi = params["max-delay"].astype(jnp.float64)
        dist = self.props["delay-distribution"]
        if dist == "uniform":
            # g_rand_int_range(min, max+1), gstnetsim.c:244-247
            d = jnp.floor(jax.random.uniform(key, shape,
                                             dtype=jnp.float64)
                          * (hi - lo + 1.0)) + lo
        elif dist == "normal":
            mu = (hi + lo) / 2.0
            sigma = (hi - lo) / (2 * 1.96)
            d = jnp.round(jax.random.normal(key, shape, jnp.float64)
                          * sigma + mu)
        elif dist == "gamma":
            scale = (hi - lo) / self.GAMMA_R95
            d = jnp.round(jax.random.gamma(key, self.GAMMA_SHAPE, shape,
                                           jnp.float64) * scale + lo)
        else:
            raise ValueError(f"netsim: unknown delay-distribution {dist!r}")
        return jnp.maximum(d, 0.0)  # gstnetsim.c:363-364

    def _frame_bits(self, batch: FrameBatch) -> int:
        import jax
        leaves = jax.tree_util.tree_leaves(batch.data)
        b = batch.batch
        return sum(l.size // b * jnp.dtype(l.dtype).itemsize
                   for l in leaves) * 8

    def process(self, params, state, batch: FrameBatch):
        import jax
        from jax import lax
        key, k1, k2, k3, k4, k5 = jax.random.split(state["key"], 6)
        b = batch.batch

        # --- token bucket + drop-packets: serial over the window --------
        frame_bits = jnp.int64(self._frame_bits(batch))
        kbps = params["max-kbps"].astype(jnp.int64)
        mbs = params["max-bucket-size"].astype(jnp.int64)

        def step(carry, inp):
            bucket, prev_time, dropn = carry
            pts, valid = inp
            first = prev_time < 0
            elapsed = jnp.where(first, 0, jnp.maximum(pts - prev_time, 0))
            unlimited_rate = kbps == -1
            tokens = jnp.where(unlimited_rate, mbs * 1000 - bucket,
                               elapsed * kbps * 1000 // 1_000_000_000)
            token_time = jnp.where(
                unlimited_rate | (kbps <= 0), 0,
                tokens * 1_000_000_000 // jnp.maximum(kbps * 1000, 1))
            new_prev = jnp.where(first, pts, prev_time + token_time)
            nb = jnp.minimum(bucket + tokens, mbs * 1000)
            nb = jnp.where(mbs == -1, bucket, nb)  # bucket bypassed
            bucket_ok = (mbs == -1) | (frame_bits <= nb)
            nb = jnp.where(bucket_ok & (mbs != -1) & valid,
                           nb - frame_bits, nb)
            counted = valid & bucket_ok   # bucket drops skip the counter
            counter_drop = counted & (dropn > 0)
            dropn = jnp.where(counter_drop, dropn - 1, dropn)
            keep = valid & bucket_ok & ~counter_drop
            # only frames that reach the token code advance the meter
            new_prev = jnp.where(valid & (mbs != -1), new_prev, prev_time)
            nb = jnp.where(valid, nb, bucket)
            return (nb, new_prev, dropn), keep

        (bucket, prev_time, dropn), keep = lax.scan(
            step, (state["bucket"], state["prev_time"],
                   state["drop_packets"]),
            (batch.pts, batch.valid))

        # --- probabilistic drop / duplicate / delay ----------------------
        drop = jax.random.uniform(k1, (b,)) < params["drop-probability"]
        dup = jax.random.uniform(k2, (b,)) < params["duplicate-probability"]
        delayed = jax.random.uniform(k3, (b,)) < params["delay-probability"]
        delay_ns = (self._delay_ms(k4, (b, 2), params)
                    * 1_000_000).astype(jnp.int64)
        legacy = (jax.random.uniform(k5, (b,), jnp.float64)
                  * params["max-delay-ns"].astype(jnp.float64)
                  ).astype(jnp.int64)
        # original and its duplicate get independent delay draws
        # (both pushes go through delay_buffer, gstnetsim.c:494-496)
        pts0 = batch.pts + jnp.where(delayed, delay_ns[:, 0], 0) + legacy
        pts1 = batch.pts + jnp.where(delayed, delay_ns[:, 1], 0) + legacy

        valid0 = keep & ~drop
        valid1 = keep & ~drop & dup
        pts = jnp.concatenate([pts0, pts1])
        valid = jnp.concatenate([valid0, valid1])
        if not self.props["allow-reordering"]:
            # monotone ready-time floor over emitted packets
            eff = jnp.where(valid, pts, -(2 ** 62))
            floor = lax.associative_scan(jnp.maximum, eff)
            floor = jnp.maximum(floor, state["last_ready"])
            pts = jnp.where(valid & (pts < floor), floor + 1, pts)
            last_ready = jnp.maximum(jnp.max(jnp.where(valid, pts,
                                                       -(2 ** 62))),
                                     state["last_ready"])
        else:
            last_ready = state["last_ready"]

        def dup2(x):
            if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == b:
                return jnp.concatenate([x, x], axis=0)
            return x

        data = (jax.tree_util.tree_map(dup2, batch.data)
                if isinstance(batch.data, dict) else dup2(batch.data))
        out = FrameBatch(
            data=data, pts=pts,
            flags=jnp.concatenate([batch.flags, batch.flags]),
            valid=valid)
        new_state = {"key": key, "bucket": bucket, "prev_time": prev_time,
                     "drop_packets": dropn, "last_ready": last_ready}
        return new_state, out
