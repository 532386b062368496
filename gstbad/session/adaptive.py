"""Adaptive-streaming scheduler
(gst-libs/gst/adaptivedemux/gstadaptivedemux.c) + the dash/hls/mss
demux front-ends over the manifest models (io/dashmpd.py, io/m3u8.py,
io/mss.py).

The reference's adaptivedemux owns the download loop: per-stream it
asks the subclass for the next fragment URI, downloads it, measures
the download bitrate, feeds a moving average, and lets the subclass
switch representations.  Here the network source is an INJECTED fetch
callable (url, byte_range) -> bytes — the framework treats
transport as host I/O the embedder provides (file://, an http client,
a test dict...), while this module keeps the reference's scheduling
semantics exactly:

  - download-rate estimation: last_bitrate = bytes * 8 / download
    time (the EOS probe math, gstadaptivedemux.c:2880-2886), folded
    into a NUM_LOOKBACK_FRAGMENTS=3 moving average dividing by the
    fragments seen so far until the window fills
    (_update_average_bitrate, gstadaptivedemux.c:2259-2273);
  - the advertised rate is min(average, last_fragment) — "make sure
    we don't upgrade too fast" — times bitrate_limit (default 0.8);
    a non-zero connection_speed (kbps property, stored *1000)
    overrides measurement entirely
    (gst_adaptive_demux_stream_update_current_bitrate,
    gstadaptivedemux.c:2277-2326);
  - after each fragment the subclass may switch bitrate; a switch
    refreshes the stream caps on the next emitted fragment;
  - live streams with no fragment left wait for a manifest update
    (gst_adaptive_demux_stream_wait_manifest_update) — surfaced here
    as a `needs-manifest` signal so the embedder refetches.
"""

from __future__ import annotations

import dataclasses
import re
import time as _time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from gstbad.io import dashmpd
from gstbad.io import m3u8 as m3u8_io
from gstbad.io import mss as mss_io

GST_SECOND = 1_000_000_000
NUM_LOOKBACK_FRAGMENTS = 3      # gstadaptivedemux.c:133
DEFAULT_BITRATE_LIMIT = 0.8     # gstadaptivedemux.c:131
DEFAULT_CONNECTION_SPEED = 0

Fetch = Callable[..., bytes]


class AdaptiveError(ValueError):
    pass


@dataclasses.dataclass
class FragmentInfo:
    uri: str
    byte_range: Optional[Tuple[int, int]] = None  # (offset, length)
    pts: int = 0
    duration: int = 0
    is_init: bool = False


class AdaptiveStream:
    """Per-format adapter interface (the GstAdaptiveDemuxStream
    subclass hooks)."""

    name = "stream"

    def caps(self) -> Dict:
        raise NotImplementedError

    def fragment_info(self) -> Optional[FragmentInfo]:
        """Next fragment, or None (EOS / needs manifest update)."""
        raise NotImplementedError

    def advance(self) -> bool:
        raise NotImplementedError

    def select_bitrate(self, bitrate: int) -> bool:
        """Returns True when the representation changed."""
        raise NotImplementedError

    def is_live(self) -> bool:
        return False

    def update_manifest(self, fetch: Fetch) -> bool:
        """Live refresh; returns True when new fragments appeared."""
        return False


class _StreamState:
    def __init__(self, adapter: AdaptiveStream):
        self.adapter = adapter
        self.fragment_bitrates = [0] * NUM_LOOKBACK_FRAGMENTS
        self.moving_bitrate = 0
        self.moving_index = 0
        self.current_download_rate = 0
        self.last_bitrate = 0
        self.need_caps = True
        self.eos = False

    def update_average_bitrate(self, new_bitrate: int) -> int:
        """_update_average_bitrate (gstadaptivedemux.c:2259-2273)."""
        index = self.moving_index % NUM_LOOKBACK_FRAGMENTS
        self.moving_bitrate -= self.fragment_bitrates[index]
        self.fragment_bitrates[index] = new_bitrate
        self.moving_bitrate += new_bitrate
        self.moving_index += 1
        if self.moving_index > NUM_LOOKBACK_FRAGMENTS:
            return self.moving_bitrate // NUM_LOOKBACK_FRAGMENTS
        return self.moving_bitrate // self.moving_index


class AdaptiveDemux:
    """The scheduling core.  fetch(url, byte_range=None) -> bytes is
    the injected source; clock() -> seconds is injectable for
    deterministic tests."""

    def __init__(self, fetch: Fetch,
                 connection_speed_kbps: int = 0,
                 bitrate_limit: float = DEFAULT_BITRATE_LIMIT,
                 clock: Optional[Callable[[], float]] = None):
        self.fetch = fetch
        # the property is kbps; stored *1000 (gstadaptivedemux.c:359)
        self.connection_speed = connection_speed_kbps * 1000
        self.bitrate_limit = bitrate_limit
        self.clock = clock or _time.monotonic
        self.streams: List[_StreamState] = []

    def add_stream(self, adapter: AdaptiveStream) -> None:
        self.streams.append(_StreamState(adapter))

    # -- bitrate --------------------------------------------------------

    def _update_current_bitrate(self, stream: _StreamState) -> int:
        """gst_adaptive_demux_stream_update_current_bitrate
        (gstadaptivedemux.c:2277-2326)."""
        if self.connection_speed:
            stream.current_download_rate = self.connection_speed
            return self.connection_speed
        fragment_bitrate = stream.last_bitrate
        average = stream.update_average_bitrate(fragment_bitrate)
        # conservative: don't upgrade too fast
        rate = min(average, fragment_bitrate)
        stream.current_download_rate = int(rate * self.bitrate_limit)
        return stream.current_download_rate

    # -- the loop ---------------------------------------------------------

    def _download_one(self, stream: _StreamState) -> Optional[Dict]:
        adapter = stream.adapter
        info = adapter.fragment_info()
        if info is None:
            if adapter.is_live():
                if adapter.update_manifest(self.fetch):
                    info = adapter.fragment_info()
                if info is None:
                    return {"stream": adapter.name,
                            "needs-manifest": True}
            if info is None:
                stream.eos = True
                return None
        t0 = self.clock()
        data = self.fetch(info.uri, byte_range=info.byte_range)
        dt = max(self.clock() - t0, 1e-9)
        stream.last_bitrate = int(len(data) * 8 / dt)
        out = {
            "stream": adapter.name,
            "uri": info.uri,
            "data": data,
            "pts": info.pts,
            "duration": info.duration,
            "is-init": info.is_init,
            "download-rate": stream.last_bitrate,
        }
        if stream.need_caps:
            out["caps"] = adapter.caps()
            if not info.is_init:
                # keep announcing through init fragments so the first
                # MEDIA buffer of a new representation carries caps
                stream.need_caps = False
        # advance BEFORE any bitrate switch so a representation change
        # takes effect at the next fragment boundary (the reference
        # advances in the download loop, then switches on the next
        # update_fragment_info)
        adapter.advance()
        if not info.is_init:
            rate = self._update_current_bitrate(stream)
            out["bitrate"] = rate
            if adapter.select_bitrate(rate):
                stream.need_caps = True  # caps on the next fragment
        return out

    def fragments(self, max_fragments: Optional[int] = None
                  ) -> Iterator[Dict]:
        """Round-robin fragment pull across all streams until every
        stream reaches EOS (or max_fragments emissions)."""
        count = 0
        while True:
            progressed = False
            for stream in self.streams:
                if stream.eos:
                    continue
                frag = self._download_one(stream)
                if frag is None:
                    continue
                progressed = True
                yield frag
                count += 1
                if max_fragments is not None \
                        and count >= max_fragments:
                    return
            if not progressed:
                if self._advance_period():
                    continue
                return

    def _advance_period(self) -> bool:
        """Format hook: move to the next period (DASH) when every
        stream reached EOS.  Default: no more periods."""
        return False


# ------------------------------------------------------------------ HLS

class HlsStream(AdaptiveStream):
    """gsthlsdemux semantics over io/m3u8.py: variant selection via
    get_variant_for_bitrate, media-playlist iteration by sequence,
    sequence continuity across variant switches and live updates."""

    name = "hls"

    def __init__(self, master: m3u8_io.MasterPlaylist, fetch: Fetch):
        self.master = master
        self.variant = master.default_variant
        if self.variant is None:
            raise AdaptiveError("no variants in master playlist")
        self._fetch = fetch
        self._load_playlist()
        self._sequence = self.playlist.files[0].sequence \
            if self.playlist.files else 0
        self._sent_init: Optional[str] = None
        self._pts = 0

    def _load_playlist(self) -> None:
        if self.variant.m3u8 is None:
            self.variant.m3u8 = m3u8_io.M3u8(self.variant.uri)
        if not self.variant.m3u8.files:
            data = self._fetch(self.variant.uri, byte_range=None)
            if not self.variant.m3u8._parse(data.decode()):
                raise AdaptiveError(
                    f"bad media playlist {self.variant.uri}")
        self.playlist = self.variant.m3u8

    def caps(self) -> Dict:
        return {"media": "application/x-hls",
                "variant-uri": self.variant.uri,
                "bandwidth": self.variant.bandwidth,
                "codecs": self.variant.codecs}

    def _current(self) -> Optional[m3u8_io.MediaFile]:
        return self.playlist.find_file_by_sequence(self._sequence)

    def fragment_info(self) -> Optional[FragmentInfo]:
        f = self._current()
        if f is None:
            return None
        if f.init_file is not None \
                and self._sent_init != f.init_file.uri:
            return FragmentInfo(uri=f.init_file.uri, is_init=True)
        rng = None
        if f.size != -1:
            rng = (f.offset, f.size)
        return FragmentInfo(uri=f.uri, byte_range=rng, pts=self._pts,
                            duration=f.duration)

    def advance(self) -> bool:
        f = self._current()
        if f is not None and f.init_file is not None \
                and self._sent_init != f.init_file.uri:
            self._sent_init = f.init_file.uri
            return True  # the media fragment itself is still due
        if f is not None:
            self._pts += f.duration
        self._sequence += 1
        return self._current() is not None

    def select_bitrate(self, bitrate: int) -> bool:
        new = self.master.get_variant_for_bitrate(bitrate)
        if new is None or new is self.variant:
            return False
        self.variant = new
        self._load_playlist()
        return True

    def is_live(self) -> bool:
        return self.playlist.is_live()

    def update_manifest(self, fetch: Fetch) -> bool:
        data = fetch(self.variant.uri, byte_range=None)
        before = max((f.sequence for f in self.playlist.files),
                     default=-1)
        self.playlist.update(data.decode())
        after = max((f.sequence for f in self.playlist.files),
                    default=-1)
        return after > before


# ------------------------------------------------------------------ MSS

class MssAdaptiveStream(AdaptiveStream):
    """gstmssdemux over io/mss.py: fragment URLs resolved against the
    manifest base, bitrate via select_bitrate, live growth from tfrf
    look-ahead boxes (stream_parse_fragment)."""

    def __init__(self, manifest: mss_io.MssManifest,
                 stream: mss_io.MssStream, base_uri: str = ""):
        self.manifest = manifest
        self.stream = stream
        self.base_uri = base_uri
        stream.active = True
        self.name = f"mss-{stream.type}"

    def caps(self) -> Dict:
        return self.stream.get_caps() or {}

    def fragment_info(self) -> Optional[FragmentInfo]:
        url = self.stream.get_fragment_url()
        if url is None:
            return None
        return FragmentInfo(
            uri=self.base_uri + url,
            pts=self.stream.get_fragment_gst_timestamp(),
            duration=self.stream.get_fragment_gst_duration())

    def advance(self) -> bool:
        return self.stream.advance_fragment()

    def select_bitrate(self, bitrate: int) -> bool:
        return self.stream.select_bitrate(bitrate)

    def is_live(self) -> bool:
        return self.manifest.is_live

    def feed_fragment(self, data: bytes) -> bool:
        """Grow the live fragment list from a downloaded fragment's
        tfrf look-ahead (gstmssmanifest.c:1632-1682)."""
        return mss_io.stream_parse_fragment(self.stream, data)


# ----------------------------------------------------------------- DASH

class DashStream(AdaptiveStream):
    """gstdashdemux over io/dashmpd.py: one adaptation set; segment
    URLs from SegmentTemplate ($RepresentationID$/$Number$/$Time$ via
    build_url_from_template, SegmentTimeline honored) or SegmentList;
    representation picked with
    representation_index_with_max_bandwidth."""

    def __init__(self, client: dashmpd.MpdClient,
                 adaptation_set, base_uri: str = ""):
        self.client = client
        self.aset = adaptation_set
        self.base_uri = base_uri
        self.reps = list(adaptation_set.Representations)
        if not self.reps:
            raise AdaptiveError("adaptation set has no representations")
        self.rep_index = \
            dashmpd.MpdClient.representation_index_with_min_bandwidth(
                self.reps)
        self.segment_index = 0
        self._init_sent = False
        self.name = f"dash-{adaptation_set.contentType or 'stream'}"
        period = client.current_period()
        self.period_duration_ms = period.duration_ms if period else -1
        # fragments carry presentation time: period start + media time
        self.period_start_ns = (period.start_ms if period else 0) \
            * 1_000_000

    # -- segment enumeration ------------------------------------------

    @property
    def rep(self):
        return self.reps[self.rep_index]

    def _template(self):
        return self.rep.SegmentTemplate or self.aset.SegmentTemplate

    def _seg_list(self):
        return self.rep.SegmentList or self.aset.SegmentList

    def _segments(self) -> List[Tuple[str, int, int]]:
        """[(uri, pts_ns, dur_ns)] for the current representation."""
        tmpl = self._template()
        if tmpl is not None and tmpl.media:
            return self._segments_from_template(tmpl)
        sl = self._seg_list()
        if sl is not None:
            out = []
            scale = sl.timescale or 1
            t = 0
            dur = sl.duration * GST_SECOND // scale \
                if sl.duration else 0
            for su in sl.SegmentURL:
                out.append((su.media or "", t, dur))
                t += dur
            return out
        raise AdaptiveError("representation has no segment info")

    def _segments_from_template(self, tmpl) -> List[Tuple[str, int,
                                                          int]]:
        scale = tmpl.timescale or 1
        out = []
        if tmpl.SegmentTimeline is not None:
            t = 0
            number = tmpl.startNumber
            for s in tmpl.SegmentTimeline.S:
                if s.t != -1:
                    t = s.t
                for _ in range(s.r + 1):
                    url = dashmpd.build_url_from_template(
                        tmpl.media, self.rep.id, number,
                        self.rep.bandwidth, t)
                    out.append((url, t * GST_SECOND // scale,
                                s.d * GST_SECOND // scale))
                    t += s.d
                    number += 1
            return out
        if not tmpl.duration:
            raise AdaptiveError("SegmentTemplate without duration")
        seg_dur_ms = tmpl.duration * 1000 // scale
        if self.period_duration_ms and self.period_duration_ms > 0:
            count = -(-self.period_duration_ms // seg_dur_ms)
        else:
            count = 0  # live: unbounded (enumerated lazily)
        for i in range(count):
            number = tmpl.startNumber + i
            t = i * tmpl.duration
            url = dashmpd.build_url_from_template(
                tmpl.media, self.rep.id, number, self.rep.bandwidth, t)
            out.append((url, t * GST_SECOND // scale,
                        tmpl.duration * GST_SECOND // scale))
        return out

    def _init_uri(self) -> Optional[str]:
        tmpl = self._template()
        if tmpl is not None and tmpl.initialization:
            return dashmpd.build_url_from_template(
                tmpl.initialization, self.rep.id, 0,
                self.rep.bandwidth, 0)
        sl = self._seg_list()
        if sl is not None and sl.Initialization is not None:
            return sl.Initialization.sourceURL
        return None

    # -- AdaptiveStream hooks -------------------------------------------

    def caps(self) -> Dict:
        rep = self.rep
        caps = {"media": rep.mimeType or self.aset.mimeType
                or "application/octet-stream",
                "bandwidth": rep.bandwidth,
                "representation-id": rep.id}
        if rep.width or self.aset.width:
            caps["width"] = rep.width or self.aset.width
        if rep.height or self.aset.height:
            caps["height"] = rep.height or self.aset.height
        if rep.codecs or self.aset.codecs:
            caps["codecs"] = rep.codecs or self.aset.codecs
        return caps

    def fragment_info(self) -> Optional[FragmentInfo]:
        if not self._init_sent:
            uri = self._init_uri()
            if uri is not None:
                return FragmentInfo(uri=self.base_uri + uri,
                                    is_init=True)
        segments = self._segments()
        if self.segment_index >= len(segments):
            return None
        uri, pts, dur = segments[self.segment_index]
        return FragmentInfo(uri=self.base_uri + uri,
                            pts=self.period_start_ns + pts,
                            duration=dur)

    def advance(self) -> bool:
        if not self._init_sent:
            self._init_sent = True
            if self._init_uri() is not None:
                return True  # init emitted; segment 0 is still due
        self.segment_index += 1
        return self.segment_index < len(self._segments())

    def select_bitrate(self, bitrate: int) -> bool:
        idx = \
            dashmpd.MpdClient.representation_index_with_max_bandwidth(
                self.reps, bitrate)
        if idx == -1:
            idx = \
                dashmpd.MpdClient \
                .representation_index_with_min_bandwidth(self.reps)
        if idx == self.rep_index:
            return False
        self.rep_index = idx
        self._init_sent = False  # new representation: re-send init
        return True


# ---------------------------------------------------------------- fronts

class DashAdaptiveDemux(AdaptiveDemux):
    """AdaptiveDemux with DASH period switching: when every stream of
    the current period reaches EOS, advance to the next period and
    rebuild the streams (gstdashdemux period-switch path)."""

    def __init__(self, client: dashmpd.MpdClient, fetch: Fetch,
                 base_uri: str = "", **kw):
        super().__init__(fetch, **kw)
        self.client = client
        self.base_uri = base_uri
        self._build_period_streams()

    def _build_period_streams(self) -> None:
        self.streams = []
        period = self.client.current_period()
        for aset in period.period.AdaptationSets:
            self.add_stream(DashStream(self.client, aset,
                                       self.base_uri))

    def _advance_period(self) -> bool:
        if not self.client.has_next_period():
            return False
        self.client.set_period_index(self.client.period_idx + 1)
        self._build_period_streams()
        return True


def open_dash(mpd_xml: str, fetch: Fetch, base_uri: str = "",
              **kw) -> AdaptiveDemux:
    client = dashmpd.MpdClient(mpd_xml)
    if not client.setup_media_presentation():
        raise AdaptiveError("could not set up media presentation")
    return DashAdaptiveDemux(client, fetch, base_uri, **kw)


def open_hls(master_data: str, uri: str, fetch: Fetch,
             **kw) -> AdaptiveDemux:
    master = m3u8_io.load_master(master_data, uri)
    if master is None:
        raise AdaptiveError("bad master playlist")
    demux = AdaptiveDemux(fetch, **kw)
    demux.add_stream(HlsStream(master, fetch))
    return demux


def open_mss(manifest_data: bytes, fetch: Fetch, base_uri: str = "",
             **kw) -> AdaptiveDemux:
    manifest = mss_io.MssManifest(manifest_data)
    demux = AdaptiveDemux(fetch, **kw)
    for stream in manifest.streams:
        demux.add_stream(MssAdaptiveStream(manifest, stream, base_uri))
    return demux


# ------------------------------------------------------------------ seek

def _hls_seek(stream: HlsStream, time_ns: int, forward: bool = True,
              snap_after: bool = False) -> int:
    """gst_hls_demux seek: walk the files accumulating EXTINF
    durations; snap-after moves to the next fragment boundary."""
    t = 0
    chosen = None
    for f in stream.playlist.files:
        if t + f.duration > time_ns:
            chosen = f
            if snap_after and t != time_ns:
                idx = stream.playlist.files.index(f)
                if idx + 1 < len(stream.playlist.files):
                    chosen = stream.playlist.files[idx + 1]
                    t += f.duration
            break
        t += f.duration
    if chosen is None and stream.playlist.files:
        chosen = stream.playlist.files[-1]
        t -= chosen.duration
    if chosen is not None:
        stream._sequence = chosen.sequence
        stream._pts = t
        stream._sent_init = None
    return t


def _dash_seek(stream: DashStream, time_ns: int, forward: bool = True,
               snap_after: bool = False) -> int:
    segments = stream._segments()
    final = 0
    for i, (_, pts, dur) in enumerate(segments):
        if pts + dur > time_ns:
            idx = i
            if snap_after and pts != time_ns \
                    and i + 1 < len(segments):
                idx = i + 1
            stream.segment_index = idx
            final = segments[idx][1]
            break
    else:
        stream.segment_index = len(segments)
        final = time_ns
    stream._init_sent = False  # re-send the init after a seek
    return final


def demux_seek(demux: AdaptiveDemux, time_ns: int,
               forward: bool = True, snap_after: bool = False) -> None:
    """gst_adaptive_demux seek: reposition every stream (flush +
    per-subclass stream_seek)."""
    for st in demux.streams:
        adapter = st.adapter
        st.eos = False
        st.need_caps = True
        if isinstance(adapter, HlsStream):
            _hls_seek(adapter, time_ns, forward, snap_after)
        elif isinstance(adapter, DashStream):
            _dash_seek(adapter, time_ns, forward, snap_after)
        elif isinstance(adapter, MssAdaptiveStream):
            adapter.stream.fragment_repetition_index = 0
            adapter.stream.seek(forward, time_ns,
                                snap_after=snap_after)


AdaptiveDemux.seek = demux_seek
