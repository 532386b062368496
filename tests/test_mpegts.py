"""MPEG transport stream mux/demux (gst/mpegtsmux, gst/mpegtsdemux).

The from-spec io/mpegts.py layer cross-validates against the system
libavformat in BOTH directions (io/tsoracle.py binding): everything our
mux writes must demux identically through ffmpeg, and everything
ffmpeg's muxer writes must demux identically through us."""

import struct

import numpy as np
import pytest

import gstbad as gt
from gstbad.elements.mpegts import k90_to_ns, ns_to_90k
from gstbad.io import mpegts as ts
from gstbad.io import tsoracle
from gstbad.io.typefind import find_type


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _mux_av(rng, n=12):
    """A 2-stream (video + audio) mux with deterministic payloads."""
    mux = ts.TsMux()
    v = mux.add_stream(ts.ST_VIDEO_H264)
    a = mux.add_stream(ts.ST_AUDIO_AAC, language="eng")
    stream = b""
    sent = []
    for i in range(n):
        vd = rng.integers(0, 256, 700 + 13 * i, np.uint8).tobytes()
        ad = rng.integers(0, 256, 200, np.uint8).tobytes()
        pts = 90000 + i * 3000
        stream += b"".join(mux.add_data(v, vd, pts=pts, dts=pts - 1500,
                                        random_access=(i % 5 == 0)))
        stream += b"".join(mux.add_data(a, ad, pts=pts))
        sent.append((v.pid, vd, pts, pts - 1500))
        sent.append((a.pid, ad, pts, ts.NO_TS))
    return mux, stream, sent


# --------------------------------------------------------------- wire

def test_packets_are_188_aligned(rng):
    _, stream, _ = _mux_av(rng)
    assert len(stream) % ts.PACKET_LENGTH == 0
    for off in range(0, len(stream), ts.PACKET_LENGTH):
        assert stream[off] == ts.SYNC_BYTE


def test_crc32_mpeg():
    """A valid section CRCs to 0 over section+crc (the check the
    packetizer applies)."""
    mux = ts.TsMux()
    mux.add_stream(ts.ST_VIDEO_H264)
    sec = mux._pat_section()
    assert ts.crc32_mpeg(sec) == 0
    sec = mux._pmt_section()
    assert ts.crc32_mpeg(sec) == 0


def test_pes_timestamp_encoding():
    """tsmux_put_ts marker/shift layout survives a round trip at the
    33-bit edges."""
    for v in (0, 1, 90000, (1 << 33) - 1):
        st = ts.TsMuxStream(0x40, ts.ST_VIDEO_H264)
        hdr = st.pes_header(10, v, v - 1 if v else ts.NO_TS)
        flags2 = hdr[7]
        assert flags2 & 0x80
        got = ts._get_ts(hdr[9:14])
        assert got == v


def test_roundtrip_self(rng):
    _, stream, sent = _mux_av(rng)
    dmx = ts.TsDemux()
    outs = []
    for i in range(0, len(stream), 997):  # arbitrary chunking
        outs += dmx.push(stream[i:i + 997])
    outs += dmx.eos()
    assert len(outs) == len(sent)
    for (pid, data, pts, dts), o in zip(sent, outs):
        assert o.pid == pid
        assert o.data == data
        assert o.pts == pts
        assert o.dts == dts
    assert dmx.continuity_errors == 0
    assert dmx.streams == {0x40: ts.ST_VIDEO_H264,
                           0x41: ts.ST_AUDIO_AAC}
    assert dmx.pcr_pid == 0x40


def test_resync_after_garbage(rng):
    """The demuxer resyncs over mid-stream garbage (the packetizer's
    0x47 scan) and counts the continuity break."""
    _, stream, sent = _mux_av(rng)
    cut = 30 * ts.PACKET_LENGTH
    corrupted = stream[:cut] + b"\xde\xad\xbe\xef" * 50 \
        + stream[cut + 2 * ts.PACKET_LENGTH:]
    dmx = ts.TsDemux()
    outs = dmx.push(corrupted) + dmx.eos()
    # most packets survive; the two dropped TS packets cost at most the
    # two PES they belonged to
    assert len(outs) >= len(sent) - 3
    assert dmx.continuity_errors >= 1


def test_random_access_flag(rng):
    _, stream, _ = _mux_av(rng)
    dmx = ts.TsDemux()
    outs = dmx.push(stream) + dmx.eos()
    vid = [o for o in outs if o.pid == 0x40]
    assert [o.random_access for o in vid] == \
        [i % 5 == 0 for i in range(len(vid))]


def test_psi_cadence(rng):
    """PAT/PMT repeat at pat/pmt-interval against the 90 kHz clock
    (tsmuxcommon.h:103-105)."""
    mux = ts.TsMux(pat_interval=3000, pmt_interval=3000)
    v = mux.add_stream(ts.ST_VIDEO_H264)
    stream = b""
    for i in range(10):
        stream += b"".join(mux.add_data(v, b"x" * 64, pts=i * 1500))
    pats = sum(1 for off in range(0, len(stream), 188)
               if struct.unpack_from(">H", stream, off + 1)[0]
               & 0x1FFF == 0)
    # t=0,3000,6000,9000,12000 -> 5 PAT emissions over 15 * 1500 ticks
    assert pats == 5


def test_unbounded_video_pes(rng):
    """Video PES > 64k writes length 0 (tsmuxstream.c:636-641) and the
    demuxer flushes it at the next PUSI."""
    mux = ts.TsMux()
    v = mux.add_stream(ts.ST_VIDEO_H264)
    big = rng.integers(0, 256, 70000, np.uint8).tobytes()
    stream = b"".join(mux.add_data(v, big, pts=90000))
    stream += b"".join(mux.add_data(v, b"tail", pts=93000))
    dmx = ts.TsDemux()
    outs = dmx.push(stream) + dmx.eos()
    assert [len(o.data) for o in outs] == [70000, 4]
    assert outs[0].data == big
    # a large AUDIO pes must refuse (bounded-only)
    a = mux.add_stream(ts.ST_AUDIO_AAC)
    with pytest.raises(ts.TsError):
        mux.add_data(a, big, pts=90000)


# ----------------------------------------------------- ffmpeg oracle

need_oracle = pytest.mark.skipif(not tsoracle.available(),
                                 reason="libavformat not available")


@need_oracle
def test_our_mux_ffmpeg_demux(rng):
    _, stream, sent = _mux_av(rng)
    kinds, pkts = tsoracle.demux(stream)
    assert kinds[0] == tsoracle.KIND_H264
    assert kinds[1] == tsoracle.KIND_AAC
    assert len(pkts) == len(sent)
    for (pid, data, pts, dts), p in zip(sent, pkts):
        assert p.data == data
        assert p.pts == pts
        if dts != ts.NO_TS:
            assert p.dts == dts


@need_oracle
def test_ffmpeg_mux_our_demux(rng):
    packets = []
    sent = []
    for i in range(12):
        vd = rng.integers(0, 256, 600 + i, np.uint8).tobytes()
        ad = rng.integers(0, 256, 150, np.uint8).tobytes()
        pts = 180000 + i * 3000
        packets.append((0, pts, pts - 1000, vd))
        packets.append((1, pts, None, ad))
        sent.append((vd, pts, pts - 1000))
        sent.append((ad, pts, None))
    blob = tsoracle.mux([tsoracle.KIND_MPEG2VIDEO, tsoracle.KIND_MP2],
                        packets)
    dmx = ts.TsDemux()
    outs = dmx.push(blob) + dmx.eos()
    assert len(outs) == len(sent)
    assert sorted(dmx.streams.values()) == [ts.ST_VIDEO_MPEG2,
                                            ts.ST_AUDIO_MPEG1]
    got = {(o.data, o.pts) for o in outs}
    assert got == {(d, p) for d, p, _ in sent}


# ----------------------------------------------------------- elements

def test_mpegtsmux_tsdemux_elements(rng):
    mux = gt.make("mpegtsmux")
    v = mux.connect("video/x-h264")
    a = mux.connect("audio/aac", language="deu")
    NSEC = 1_000_000_000
    stream = b""
    for i in range(5):
        stream += mux.chain(v, b"video%d" % i, pts_ns=i * NSEC,
                            dts_ns=i * NSEC - 500 if i else 0,
                            random_access=True)
        stream += mux.chain(a, b"audio%d" % i, pts_ns=i * NSEC)
    dmx = gt.make("tsdemux")
    outs = dmx.push_bytes(stream) + dmx.event_eos()
    texts = [o["data"] for o in outs]
    assert texts == [b"video0", b"audio0", b"video1", b"audio1",
                     b"video2", b"audio2", b"video3", b"audio3",
                     b"video4", b"audio4"]
    # ns -> 90k -> ns is lossy only below the 90 kHz tick
    assert outs[2]["pts"] == k90_to_ns(ns_to_90k(NSEC))
    assert dmx.streams == {0x40: ts.ST_VIDEO_H264,
                           0x41: ts.ST_AUDIO_AAC}


def test_tsparse_passthrough(rng):
    _, stream, _ = _mux_av(rng, n=4)
    parse = gt.make("tsparse")
    out = parse.chain(stream[:1000]) + parse.chain(stream[1000:])
    assert out == stream[:len(out)]
    assert len(stream) - len(out) < ts.PACKET_LENGTH
    assert parse.programs == {1: ts.START_PMT_PID}
    assert 0x40 in parse.streams


def test_typefind_mpegts(rng):
    _, stream, _ = _mux_av(rng, n=2)
    assert find_type(stream) == "video/mpegts"


def test_m2ts_mode(rng):
    """m2ts-mode: 192-byte packets (4-byte 30-bit arrival prefix,
    gstmpegtsmux.c:85,213-230); the demuxer auto-detects and strips."""
    mux = gt.make("mpegtsmux", **{"m2ts-mode": True})
    v = mux.connect("video/x-h264")
    NSEC = 1_000_000_000
    stream = b""
    sent = []
    for i in range(6):
        d = rng.integers(0, 256, 400, np.uint8).tobytes()
        stream += mux.chain(v, d, pts_ns=i * NSEC)
        sent.append(d)
    assert len(stream) % 192 == 0
    assert stream[4] == ts.SYNC_BYTE and stream[196] == ts.SYNC_BYTE
    dmx = gt.make("tsdemux")
    outs = []
    for i in range(0, len(stream), 700):
        outs += dmx.push_bytes(stream[i:i + 700])
    outs += dmx.event_eos()
    assert [o["data"] for o in outs] == sent
    if tsoracle.available():
        _, pkts = tsoracle.demux(stream, any_format=True)
        assert [p.data for p in pkts] == sent
