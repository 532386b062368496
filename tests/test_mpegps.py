"""MPEG program stream mux/demux (gst/mpegpsmux, gst/mpegdemux),
cross-validated against libavformat's PS ("vob") muxer/demuxer."""

import struct

import numpy as np
import pytest

import gstbad as gt
from gstbad.io import mpegps as ps
from gstbad.io import tsoracle
from gstbad.io.typefind import find_type


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _mux_av(rng, n=10):
    mux = ps.PsMux()
    v = mux.add_stream(ps.ST_VIDEO_MPEG2)
    a = mux.add_stream(ps.ST_AUDIO_MPEG1)
    stream = b""
    sent = []
    for i in range(n):
        vd = rng.integers(0, 256, 900 + i, np.uint8).tobytes()
        ad = rng.integers(0, 256, 300, np.uint8).tobytes()
        pts = 90000 + i * 3000
        stream += mux.add_data(v, vd, pts=pts, dts=pts - 1500)
        stream += mux.add_data(a, ad, pts=pts)
        sent.append((v.stream_id, vd, pts, pts - 1500))
        sent.append((a.stream_id, ad, pts, ps.NO_TS))
    stream += mux.finish()
    return mux, stream, sent


def test_stream_id_allocation():
    """psmux_stream_new (psmuxstream.c:87-132): audio 0xC0.., video
    0xE0.., private data 0xBD."""
    mux = ps.PsMux()
    assert mux.add_stream(ps.ST_AUDIO_MPEG1).stream_id == 0xC0
    assert mux.add_stream(ps.ST_AUDIO_MPEG2).stream_id == 0xC1
    assert mux.add_stream(ps.ST_VIDEO_MPEG2).stream_id == 0xE0
    assert mux.add_stream(ps.ST_PRIVATE_DATA).stream_id == 0xBD


def test_pack_header_layout(rng):
    _, stream, _ = _mux_av(rng, n=1)
    assert stream[:4] == b"\x00\x00\x01\xba"
    # MPEG-2 form: '01' prefix bits
    assert (stream[4] >> 6) == 0x1
    d = ps.PsDemux()
    d.push(stream)
    assert d.last_scr == 90000
    assert d.saw_end


def test_roundtrip_self(rng):
    _, stream, sent = _mux_av(rng)
    d = ps.PsDemux()
    outs = []
    for i in range(0, len(stream), 777):
        outs += d.push(stream[i:i + 777])
    assert len(outs) == len(sent)
    for (sid, data, pts, dts), o in zip(sent, outs):
        assert (o.stream_id, o.data, o.pts, o.dts) == \
            (sid, data, pts, dts)
    assert d.stream_types == {0xE0: ps.ST_VIDEO_MPEG2,
                              0xC0: ps.ST_AUDIO_MPEG1}


def test_large_payload_pes_split(rng):
    """> 65500-byte buffers split into continuation PES
    (PSMUX_PES_MAX_PAYLOAD, psmuxcommon.h:58); the demuxer emits the
    pieces (per-PES, like the reference pesfilter)."""
    mux = ps.PsMux()
    v = mux.add_stream(ps.ST_VIDEO_MPEG2)
    big = rng.integers(0, 256, 150000, np.uint8).tobytes()
    stream = mux.add_data(v, big, pts=90000)
    d = ps.PsDemux()
    outs = d.push(stream)
    assert b"".join(o.data for o in outs) == big
    assert outs[0].pts == 90000
    assert all(o.pts == ps.NO_TS for o in outs[1:])


def test_psm_crc():
    mux = ps.PsMux()
    mux.add_stream(ps.ST_VIDEO_MPEG2)
    sec = mux._psm()
    assert sec[3] == 0xBC
    assert ps.crc32_mpeg(sec) == 0


need_oracle = pytest.mark.skipif(not tsoracle.available(),
                                 reason="libavformat not available")


@need_oracle
def test_our_mux_ffmpeg_demux(rng):
    _, stream, sent = _mux_av(rng)
    kinds, pkts = tsoracle.demux(stream, any_format=True)
    assert len(pkts) == len(sent)
    assert sorted(p.data for p in pkts) == sorted(x[1] for x in sent)
    # pts survive (ffmpeg may reorder across streams at equal pts)
    by_payload = {x[1]: x[2] for x in sent}
    for p in pkts:
        assert p.pts == by_payload[p.data]


@need_oracle
def test_ffmpeg_mux_our_demux(rng):
    packets = []
    sent = []
    for i in range(10):
        vd = rng.integers(0, 256, 600, np.uint8).tobytes()
        ad = rng.integers(0, 256, 150, np.uint8).tobytes()
        pts = 180000 + i * 3000
        packets.append((0, pts, pts - 1000, vd))
        packets.append((1, pts, None, ad))
        sent.append((vd, pts))
        sent.append((ad, pts))
    blob = tsoracle.mux([tsoracle.KIND_MPEG2VIDEO, tsoracle.KIND_MP2],
                        packets, program_stream=True)
    d = ps.PsDemux()
    outs = d.push(blob)
    # ffmpeg's vob muxer may split large PES and pads with private
    # streams; reassemble per stream id and compare payload bytes
    got: dict = {}
    for o in outs:
        got.setdefault(o.stream_id, bytearray()).extend(o.data)
    all_sent = b"".join(x[0] for x in sent)
    video = bytes(got.get(0xE0, b""))
    audio = bytes(got.get(0xC0, b""))
    assert b"".join(x[0] for x in sent if len(x[0]) == 600) == video
    assert b"".join(x[0] for x in sent if len(x[0]) == 150) == audio
    # at least the first PES of each stream carries the right pts
    firsts = {}
    for o in outs:
        if o.stream_id not in firsts and o.pts != ps.NO_TS:
            firsts[o.stream_id] = o.pts
    assert firsts[0xE0] == 180000 - 1000 or firsts[0xE0] == 180000


def test_elements(rng):
    mux = gt.make("mpegpsmux")
    v = mux.connect("video/mpeg2")
    a = mux.connect("audio/mpeg")
    NSEC = 1_000_000_000
    stream = b""
    for i in range(4):
        stream += mux.chain(v, b"v%d" % i, pts_ns=i * NSEC)
        stream += mux.chain(a, b"a%d" % i, pts_ns=i * NSEC)
    stream += mux.event_eos()
    dmx = gt.make("mpegpsdemux")
    outs = dmx.push_bytes(stream)
    assert [o["data"] for o in outs] == [b"v0", b"a0", b"v1", b"a1",
                                         b"v2", b"a2", b"v3", b"a3"]
    assert dmx.saw_end
    assert dmx.stream_types[0xE0] == ps.ST_VIDEO_MPEG2


def test_typefind_ps(rng):
    _, stream, _ = _mux_av(rng, n=1)
    assert find_type(stream) == "video/mpeg-sys"
