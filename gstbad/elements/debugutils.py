"""debugutils — identity/fakesink/errorignore/watchdog analogs plus the
checksum-style conformance sinks (gst/debugutils/)."""

from __future__ import annotations

import hashlib
import time

import jax.numpy as jnp
import numpy as np

from gstbad.core.element import Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import MediaSpec


@register
class Identity(Element):
    NAME = "identity"

    def process(self, params, state, batch: FrameBatch):
        return state, batch


@register
class FakeSink(Element):
    """Terminal sink (drops buffers, like GStreamer's fakesink).

    When the batch carries a packed-u32 word twin (FrameBatch.word — a
    byte-identical view of 4-byte packed video), the sink keeps the WORD
    as its retained data: nothing downstream consumes the bytes, so XLA
    can drop the i32->u8 relayout pass entirely.  Pipeline.run restores
    the u8 view host-side (a free numpy bitcast), so run() callers always
    observe ordinary uint8 frames."""

    NAME = "fakesink"
    KIND = "sink"

    def process(self, params, state, batch: FrameBatch):
        if batch.word is not None and not isinstance(batch.data, dict):
            return state, batch.replace(data=batch.word)
        return state, batch


@register
class FakeVideoSink(FakeSink):
    NAME = "fakevideosink"


@register
class FakeAudioSink(FakeSink):
    NAME = "fakeaudiosink"


@register
class AppSink(FakeSink):
    """Collects frames for the host (the appsink analog); the Pipeline
    runner returns every window's valid frames, so this is a marker."""
    NAME = "appsink"


@register
class ErrorIgnore(Element):
    """gsterrorignore.c: convert downstream errors into OK.  Errors in this
    framework are Python exceptions from downstream host hooks; the pipeline
    wraps downstream processing when an errorignore is present.  In-graph it
    is a passthrough."""
    NAME = "errorignore"
    PROPERTIES = (Property("ignore-error", bool, True),)

    def process(self, params, state, batch: FrameBatch):
        return state, batch


@register
class Watchdog(Element):
    """gstwatchdog.c: post an error if no buffers flow within timeout.

    Here process stamps a host-side monotonic time at every window; `check`
    raises if the gap exceeded the timeout (driven by Pipeline.run)."""

    NAME = "watchdog"
    PROPERTIES = (Property("timeout", int, 1000),)  # ms

    def __init__(self, **props):
        super().__init__(**props)
        self._last = time.monotonic()

    def process(self, params, state, batch: FrameBatch):
        self._last = time.monotonic()
        return state, batch

    def check(self):
        gap_ms = (time.monotonic() - self._last) * 1000.0
        if gap_ms > self.props["timeout"]:
            raise TimeoutError(
                f"watchdog: no data for {gap_ms:.0f} ms "
                f"(timeout {self.props['timeout']} ms)")


@register
class ChecksumSink(Element):
    """checksumsink/videocodectestsink analog: per-frame MD5 of the raw
    frame bytes, posted as messages (gstvideocodectestsink.c:193-230).

    MD5 runs host-side; the element keeps frame bytes on device until the
    runner drains the window, then hashes.
    """

    NAME = "checksumsink"
    KIND = "sink"
    HOST = True

    def __init__(self, **props):
        super().__init__(**props)
        self.checksums = []

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        from gstbad.core.bus import Message
        data = np_batch.data
        b = np_batch.batch
        for i in range(b):
            if isinstance(data, dict):
                blob = b"".join(np.ascontiguousarray(data[k][i]).tobytes()
                                for k in sorted(data))
            else:
                blob = np.ascontiguousarray(data[i]).tobytes()
            digest = hashlib.md5(blob).hexdigest()
            self.checksums.append(digest)
            if bus is not None:
                bus.post(Message(self.NAME, "checksum",
                                 int(np_batch.pts[i]),
                                 {"checksum": digest}))


@register
class Tee(Identity):
    """tee: fan-out marker.  In the DAG any node may feed several consumers;
    a named tee makes the launch syntax read like gst-launch."""
    NAME = "tee"


@register
class Queue(Identity):
    """queue: a scheduling decoupler in the reference; a no-op in the fused
    window program (the whole graph is one schedule)."""
    NAME = "queue"


@register
class ClockSelect(Identity):
    """clockselect (gst/debugutils/gstclockselect.c): force the pipeline
    clock.  The reference is a GstBin electing clock-id
    default/monotonic/realtime/ptp/tai (+ptp-domain) as the pipeline
    clock; here the element is a passthrough marker whose `clock()`
    callable paces realtime sessions — Play looks one up in its pipeline
    (session/play.py).  ptp has no host implementation and raises, like
    the reference failing when the PTP subsystem is not initialized."""

    NAME = "clockselect"
    PROPERTIES = (
        Property("clock-id", str, "default", static=True),
        Property("ptp-domain", int, 0, 0, 255, static=True),
    )

    _IDS = ("default", "monotonic", "realtime", "ptp", "tai")

    def __init__(self, **props):
        super().__init__(**props)
        if self.props["clock-id"] not in self._IDS:
            raise ValueError(f"clockselect: unknown clock-id "
                             f"{self.props['clock-id']!r} (have {self._IDS})")

    def clock(self):
        """Returns a float-seconds callable for the selected clock."""
        import time
        cid = self.props["clock-id"]
        if cid in ("default", "monotonic"):
            return time.monotonic
        if cid == "realtime":
            return time.time
        if cid == "tai":
            return lambda: time.clock_gettime(time.CLOCK_TAI)
        raise RuntimeError("clockselect: ptp clock unavailable "
                           "(no PTP subsystem on this host)")
