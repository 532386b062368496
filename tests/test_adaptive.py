"""Adaptive-streaming scheduler (gst-libs/gst/adaptivedemux) over the
dash/hls/mss manifest models, with an injected in-memory fetcher."""

import pytest

from gstbad.session import adaptive as ad


class FakeNet:
    """Deterministic fetch + clock: each URI downloads at the
    configured link rate (bits/sec)."""

    def __init__(self, files, rate_bps=1_000_000):
        self.files = dict(files)
        self.rate = rate_bps
        self.t = 0.0
        self.log = []

    def clock(self):
        return self.t

    def fetch(self, uri, byte_range=None):
        data = self.files[uri]
        if byte_range is not None:
            off, size = byte_range
            data = data[off:off + size]
        self.t += len(data) * 8 / self.rate
        self.log.append(uri)
        return data


# -------------------------------------------------------- rate math

def test_moving_average_window():
    """_update_average_bitrate (gstadaptivedemux.c:2259-2273): divide
    by fragments seen until the 3-window fills."""
    st = ad._StreamState(ad.AdaptiveStream())
    assert st.update_average_bitrate(300) == 300
    assert st.update_average_bitrate(600) == 450
    assert st.update_average_bitrate(900) == 600
    # window full: (600+900+1200)/3
    assert st.update_average_bitrate(1200) == 900


def test_bitrate_limit_and_conservative_min():
    """min(average, last) * bitrate_limit
    (gstadaptivedemux.c:2300-2310)."""
    demux = ad.AdaptiveDemux(fetch=lambda *a, **k: b"")
    st = ad._StreamState(ad.AdaptiveStream())
    st.last_bitrate = 1000
    assert demux._update_current_bitrate(st) == 800  # 1000 * 0.8
    st.last_bitrate = 100   # a slow fragment drags the rate down
    # average is (1000+100)/2 = 550, min(550, 100) = 100
    assert demux._update_current_bitrate(st) == 80


def test_connection_speed_overrides():
    """connection-speed is kbps, stored x1000, bypasses measurement
    (gstadaptivedemux.c:359, 2283-2287)."""
    demux = ad.AdaptiveDemux(fetch=lambda *a, **k: b"",
                             connection_speed_kbps=5000)
    st = ad._StreamState(ad.AdaptiveStream())
    st.last_bitrate = 42
    assert demux._update_current_bitrate(st) == 5_000_000


# ---------------------------------------------------------------- HLS

MASTER = """#EXTM3U
#EXT-X-STREAM-INF:PROGRAM-ID=1,BANDWIDTH=100000
low.m3u8
#EXT-X-STREAM-INF:PROGRAM-ID=1,BANDWIDTH=1000000
high.m3u8
"""


def _media(prefix, n=6):
    out = "#EXTM3U\n#EXT-X-TARGETDURATION:2\n#EXT-X-VERSION:3\n"
    for i in range(n):
        out += f"#EXTINF:2,\n{prefix}{i}.ts\n"
    return out + "#EXT-X-ENDLIST\n"


def _hls_files(seg_size=25_000):
    files = {"http://x/low.m3u8": _media("http://x/low").encode(),
             "http://x/high.m3u8": _media("http://x/high").encode()}
    for i in range(6):
        files[f"http://x/low{i}.ts"] = b"L" * seg_size
        files[f"http://x/high{i}.ts"] = b"H" * (seg_size * 10)
    return files


def test_hls_upswitch_on_fast_network():
    """Fast link: after the first fragment the measured rate exceeds
    the high variant and the stream switches up, continuing at the
    next sequence (gsthlsdemux variant switch)."""
    net = FakeNet(_hls_files(), rate_bps=10_000_000)
    demux = ad.open_hls(MASTER, "http://x/master.m3u8", net.fetch,
                        clock=net.clock)
    frags = list(demux.fragments())
    assert len(frags) == 6
    assert frags[0]["uri"] == "http://x/low0.ts"  # starts on default
    assert frags[0]["caps"]["bandwidth"] == 100000
    # measured 10 Mbps * 0.8 = 8 Mbps > 1M: switch up at fragment 1
    assert frags[1]["uri"] == "http://x/high1.ts"
    assert frags[1]["caps"]["bandwidth"] == 1000000  # new caps
    assert all(f["uri"].startswith("http://x/high")
               for f in frags[1:])
    # sequence continuity: 0..5 overall
    assert [f["uri"][-4] for f in frags] == list("012345")


def test_hls_downswitch_on_slow_network():
    net = FakeNet(_hls_files(), rate_bps=10_000_000)
    demux = ad.open_hls(MASTER, "http://x/master.m3u8", net.fetch,
                        clock=net.clock)
    # force the high variant first
    demux.streams[0].adapter.select_bitrate(2_000_000)
    net.rate = 200_000  # then the link degrades
    frags = list(demux.fragments())
    assert frags[0]["uri"] == "http://x/high0.ts"
    # 200k * 0.8 = 160k < 1M -> down to the 100k variant
    assert frags[1]["uri"] == "http://x/low1.ts"


def test_hls_connection_speed_pins_variant():
    net = FakeNet(_hls_files(), rate_bps=50_000)  # slow link
    demux = ad.open_hls(MASTER, "http://x/master.m3u8", net.fetch,
                        clock=net.clock,
                        connection_speed_kbps=2000)
    frags = list(demux.fragments(max_fragments=3))
    # pinned 2 Mbps: switches to high regardless of measurement
    assert frags[1]["uri"].startswith("http://x/high")


def test_hls_live_needs_manifest():
    live = ("#EXTM3U\n#EXT-X-TARGETDURATION:2\n"
            "#EXT-X-MEDIA-SEQUENCE:0\n"
            "#EXTINF:2,\nhttp://x/s0.ts\n")
    files = {"http://x/live.m3u8": live.encode(),
             "http://x/s0.ts": b"a" * 100,
             "http://x/s1.ts": b"b" * 100}
    net = FakeNet(files)
    demux = ad.open_hls(live, "http://x/live.m3u8", net.fetch,
                        clock=net.clock)
    it = demux.fragments()
    f0 = next(it)
    assert f0["uri"] == "http://x/s0.ts"
    # playlist exhausted but live: the update refetch finds nothing new
    f1 = next(it)
    assert f1.get("needs-manifest")
    # the server adds a segment; the next pull picks it up
    net.files["http://x/live.m3u8"] = (live
                                       + "#EXTINF:2,\nhttp://x/s1.ts\n"
                                       ).encode()
    f2 = next(it)
    assert f2["uri"] == "http://x/s1.ts"


# --------------------------------------------------------------- DASH

MPD = """<?xml version="1.0"?>
<MPD xmlns="urn:mpeg:dash:schema:mpd:2011" type="static"
     mediaPresentationDuration="PT12S">
  <Period>
    <AdaptationSet contentType="video" mimeType="video/mp4">
      <SegmentTemplate media="$RepresentationID$/seg-$Number$.m4s"
          initialization="$RepresentationID$/init.mp4"
          duration="2" timescale="1" startNumber="1"/>
      <Representation id="low" bandwidth="100000" width="320"
          height="180" codecs="avc1.42c00d"/>
      <Representation id="high" bandwidth="1000000" width="1280"
          height="720" codecs="avc1.640028"/>
    </AdaptationSet>
  </Period>
</MPD>
"""


def _dash_files(seg=25_000):
    files = {}
    for rep, size in (("low", seg), ("high", seg * 10)):
        files[f"http://d/{rep}/init.mp4"] = b"I" * 500
        for n in range(1, 7):
            files[f"http://d/{rep}/seg-{n}.m4s"] = b"x" * size
    return files


def test_dash_template_enumeration_and_switch():
    net = FakeNet(_dash_files(), rate_bps=10_000_000)
    demux = ad.open_dash(MPD, net.fetch, base_uri="http://d/",
                         clock=net.clock)
    frags = list(demux.fragments())
    # init + 6 segments on low, then the switch re-sends the new init
    assert frags[0]["is-init"]
    assert frags[0]["uri"] == "http://d/low/init.mp4"
    assert frags[1]["uri"] == "http://d/low/seg-1.m4s"
    assert frags[1]["caps"]["representation-id"] == "low"
    assert frags[1]["duration"] == 2_000_000_000
    # fast link: switch up after the first media segment
    assert frags[2]["is-init"]
    assert frags[2]["uri"] == "http://d/high/init.mp4"
    assert frags[3]["uri"] == "http://d/high/seg-2.m4s"
    assert frags[3]["caps"]["width"] == 1280
    # 12 s / 2 s = 6 media segments total, plus the two inits
    media = [f for f in frags if not f["is-init"]]
    assert len(media) == 6
    assert media[-1]["uri"].endswith("seg-6.m4s")


MPD_TIMELINE = """<?xml version="1.0"?>
<MPD xmlns="urn:mpeg:dash:schema:mpd:2011" type="static"
     mediaPresentationDuration="PT6S">
  <Period>
    <AdaptationSet contentType="audio" mimeType="audio/mp4">
      <Representation id="a" bandwidth="64000">
        <SegmentTemplate media="a/$Time$.m4s" timescale="1000">
          <SegmentTimeline>
            <S t="0" d="2000"/>
            <S d="1500" r="1"/>
          </SegmentTimeline>
        </SegmentTemplate>
      </Representation>
    </AdaptationSet>
  </Period>
</MPD>
"""


def test_dash_segment_timeline():
    files = {"http://d/a/0.m4s": b"1" * 10,
             "http://d/a/2000.m4s": b"2" * 10,
             "http://d/a/3500.m4s": b"3" * 10}
    net = FakeNet(files)
    demux = ad.open_dash(MPD_TIMELINE, net.fetch,
                         base_uri="http://d/", clock=net.clock)
    frags = list(demux.fragments())
    assert [f["uri"] for f in frags] == [
        "http://d/a/0.m4s", "http://d/a/2000.m4s",
        "http://d/a/3500.m4s"]
    assert [f["pts"] for f in frags] == [0, 2_000_000_000,
                                         3_500_000_000]
    assert frags[1]["duration"] == 1_500_000_000


# ---------------------------------------------------------------- MSS

MSS = """<SmoothStreamingMedia TimeScale="10000000"
    Duration="80000000">
  <StreamIndex Type="video"
      Url="QualityLevels({bitrate})/Fragments(video={start time})">
    <QualityLevel Bitrate="300000" FourCC="H264" MaxWidth="320"
        MaxHeight="180"/>
    <QualityLevel Bitrate="2000000" FourCC="H264" MaxWidth="1280"
        MaxHeight="720"/>
    <c t="0" d="20000000" r="4"/>
  </StreamIndex>
</SmoothStreamingMedia>
"""


def test_mss_fragments_and_switch():
    files = {}
    for q, size in (("300000", 20_000), ("2000000", 200_000)):
        for t in range(0, 80000000, 20000000):
            files[f"http://m/QualityLevels({q})/"
                  f"Fragments(video={t})"] = b"f" * size
    net = FakeNet(files, rate_bps=50_000_000)
    demux = ad.open_mss(MSS.encode(), net.fetch,
                        base_uri="http://m/", clock=net.clock)
    frags = list(demux.fragments())
    assert len(frags) == 4
    assert "QualityLevels(300000)/Fragments(video=0)" \
        in frags[0]["uri"]
    assert frags[0]["caps"]["width"] == 320
    # 50 Mbps link: up to the 2 Mbps level for the rest
    assert "QualityLevels(2000000)" in frags[1]["uri"]
    assert frags[1]["caps"]["width"] == 1280
    assert frags[1]["pts"] == 2_000_000_000
    assert frags[1]["duration"] == 2_000_000_000


# ------------------------------------------------------------- elements

def test_demux_elements_registered():
    import gstbad as gt
    net = FakeNet(_hls_files(), rate_bps=10_000_000)
    el = gt.make("hlsdemux", **{"connection-speed": 150})
    el.load(MASTER, net.fetch, uri="http://x/master.m3u8",
            clock=net.clock)
    frags = list(el.fragments(max_fragments=2))
    # pinned 150 kbps keeps the 100k variant
    assert all(f["uri"].startswith("http://x/low") for f in frags)

    net2 = FakeNet(_dash_files())
    d = gt.make("dashdemux", **{"bitrate-limit": 0.5})
    d.load(MPD, net2.fetch, base_uri="http://d/", clock=net2.clock)
    assert next(d.fragments())["is-init"]
    assert d.demux.bitrate_limit == 0.5

    m = gt.make("mssdemux")
    files = {f"http://m/QualityLevels(300000)/Fragments(video={t})":
             b"f" * 100 for t in range(0, 80000000, 20000000)}
    m.load(MSS, FakeNet(files).fetch, base_uri="http://m/")
    first = next(m.fragments())
    assert first["caps"]["width"] == 320


# ----------------------------------------------------------------- seek

def test_hls_seek():
    """testSeek/testSeekPosition analog: reposition to the fragment
    containing the time; snap-after takes the next boundary."""
    net = FakeNet(_hls_files())
    demux = ad.open_hls(MASTER, "http://x/master.m3u8", net.fetch,
                        clock=net.clock, connection_speed_kbps=50)
    demux.seek(5_000_000_000)  # inside fragment 2 (2s each)
    frag = next(demux.fragments())
    assert frag["uri"].endswith("2.ts")
    assert frag["pts"] == 4_000_000_000
    demux.seek(4_000_000_000, snap_after=True)  # exact boundary stays
    assert next(demux.fragments())["uri"].endswith("2.ts")
    demux.seek(4_100_000_000, snap_after=True)  # snaps forward
    assert next(demux.fragments())["uri"].endswith("3.ts")


def test_dash_seek_resends_init():
    net = FakeNet(_dash_files())
    demux = ad.open_dash(MPD, net.fetch, base_uri="http://d/",
                         clock=net.clock, connection_speed_kbps=50)
    list(demux.fragments(max_fragments=3))
    demux.seek(7_000_000_000)  # 2s segments: segment index 3 (seg-4)
    frags = list(demux.fragments(max_fragments=2))
    assert frags[0]["is-init"]  # init re-sent after the seek
    assert frags[1]["uri"].endswith("seg-4.m4s")
    assert frags[1]["pts"] == 6_000_000_000


def test_mss_seek():
    files = {f"http://m/QualityLevels(300000)/Fragments(video={t})":
             b"f" * 100 for t in range(0, 80000000, 20000000)}
    net = FakeNet(files)
    demux = ad.open_mss(MSS.encode(), net.fetch, base_uri="http://m/",
                        clock=net.clock, connection_speed_kbps=50)
    demux.seek(4_500_000_000)
    frag = next(demux.fragments())
    assert "Fragments(video=40000000)" in frag["uri"]
    assert frag["pts"] == 4_000_000_000


def test_download_error_propagates():
    def failing_fetch(uri, byte_range=None):
        raise IOError(f"404 {uri}")
    files = {"http://x/one.m3u8":
             b"#EXTM3U\n#EXTINF:2,\nhttp://x/s0.ts\n#EXT-X-ENDLIST\n"}
    def fetch(uri, byte_range=None):
        if uri.endswith(".m3u8"):
            return files[uri]
        raise IOError(f"404 {uri}")
    demux = ad.open_hls(files["http://x/one.m3u8"].decode(),
                        "http://x/one.m3u8", fetch)
    with pytest.raises(IOError):
        list(demux.fragments())


MPD_TWO_PERIODS = """<?xml version="1.0"?>
<MPD xmlns="urn:mpeg:dash:schema:mpd:2011" type="static"
     mediaPresentationDuration="PT8S">
  <Period duration="PT4S">
    <AdaptationSet contentType="video" mimeType="video/mp4">
      <SegmentTemplate media="p1/$Number$.m4s" duration="2"
          timescale="1" startNumber="1"/>
      <Representation id="r" bandwidth="100"/>
    </AdaptationSet>
  </Period>
  <Period>
    <AdaptationSet contentType="video" mimeType="video/mp4">
      <SegmentTemplate media="p2/$Number$.m4s" duration="2"
          timescale="1" startNumber="1"/>
      <Representation id="r" bandwidth="100"/>
    </AdaptationSet>
  </Period>
</MPD>
"""


def test_dash_multi_period():
    """Period switching: after the first period drains, streams are
    rebuilt for the next period and pts carries the period start."""
    files = {f"http://d/p{p}/{n}.m4s": b"x" * 50
             for p in (1, 2) for n in (1, 2)}
    net = FakeNet(files)
    demux = ad.open_dash(MPD_TWO_PERIODS, net.fetch,
                         base_uri="http://d/", clock=net.clock)
    frags = list(demux.fragments())
    assert [f["uri"] for f in frags] == [
        "http://d/p1/1.m4s", "http://d/p1/2.m4s",
        "http://d/p2/1.m4s", "http://d/p2/2.m4s"]
    # second period fragments are offset by the 4 s period start
    assert [f["pts"] for f in frags] == [
        0, 2_000_000_000, 4_000_000_000, 6_000_000_000]
    # the new period re-announces caps
    assert "caps" in frags[2]
