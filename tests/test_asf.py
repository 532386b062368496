"""asfmux / asfparse (gst/asfmux/) — ASF writer validated against
libavformat's ASF demuxer and the gstasfmux.c layout."""

import struct

import numpy as np
import pytest

import gstbad as gt
from gstbad.io import asf
from gstbad.io import tsoracle
from gstbad.io.typefind import find_type


@pytest.fixture
def rng():
    return np.random.default_rng(21)


def _build(rng, n=20, ecc=True, packet_size=asf.DEFAULT_PACKET_SIZE):
    mux = asf.AsfMux(ecc=ecc, packet_size=packet_size)
    a = mux.add_audio_stream(0x0050, 2, 48000, block_align=384)
    v = mux.add_video_stream(b"MPG2", 64, 48)
    stream = mux.header()
    sent = []
    for i in range(n):
        vd = rng.integers(0, 256, 1200 + i, np.uint8).tobytes()
        ad = rng.integers(0, 256, 384, np.uint8).tobytes()
        stream += mux.add_buffer(v, vd, pts_ms=i * 40,
                                 keyframe=(i % 5 == 0))
        stream += mux.add_buffer(a, ad, pts_ms=i * 40)
        sent.append((vd, i * 40))
        sent.append((ad, i * 40))
    stream += mux.finish()
    return mux, asf.finalize(mux, stream, n * 40), sent


def test_header_layout(rng):
    """Header object GUID + object count; file properties carries the
    packet size at the documented offset (gstasfmux.c:654-671)."""
    mux, stream, _ = _build(rng, n=1)
    assert stream[:16] == asf.GUID_HEADER
    (n_objects,) = struct.unpack_from("<I", stream, 24)
    assert n_objects == 4  # file props + header ext + 2 streams
    p = stream.find(asf.GUID_FILE_PROPERTIES)
    (min_ps,) = struct.unpack_from("<I", stream, p + 92)
    (max_ps,) = struct.unpack_from("<I", stream, p + 96)
    assert min_ps == max_ps == asf.DEFAULT_PACKET_SIZE
    # finalize patched the counts and the seekable flag
    (count,) = struct.unpack_from("<Q", stream, p + 56)
    assert count == mux.total_data_packets
    (flags,) = struct.unpack_from("<I", stream, p + 88)
    assert flags == 0x2


def test_packets_are_fixed_size(rng):
    mux, stream, _ = _build(rng)
    hdr_end = stream.find(asf.GUID_DATA) + 50
    data = stream[hdr_end:]
    assert len(data) % asf.DEFAULT_PACKET_SIZE == 0
    assert len(data) // asf.DEFAULT_PACKET_SIZE \
        == mux.total_data_packets


need_oracle = pytest.mark.skipif(not tsoracle.available(),
                                 reason="libavformat not available")


@need_oracle
def test_ffmpeg_demux_exact(rng):
    """Every payload byte and timestamp survives ffmpeg's ASF demuxer
    (ecc mode: the standard 0x82 block + whole-packet length)."""
    _, stream, sent = _build(rng)
    kinds, pkts = tsoracle.demux(stream, any_format=True)
    assert len(kinds) == 2
    assert len(pkts) == len(sent)
    assert sorted(p.data for p in pkts) == sorted(s[0] for s in sent)
    by_payload = {s[0]: s[1] for s in sent}
    assert all(p.pts == by_payload[p.data] for p in pkts)


@need_oracle
def test_ffmpeg_demux_fragmented(rng):
    """Media objects larger than the packet split into subpayloads
    (gst_asf_put_subpayload) that ffmpeg reassembles byte-exact."""
    mux = asf.AsfMux(ecc=True, packet_size=1000)
    v = mux.add_video_stream(b"MPG2", 64, 48)
    stream = mux.header()
    big = rng.integers(0, 256, 5000, np.uint8).tobytes()
    stream += mux.add_buffer(v, big, pts_ms=0, keyframe=True)
    stream += mux.finish()
    stream = asf.finalize(mux, stream, 40)
    _, pkts = tsoracle.demux(stream, any_format=True)
    assert len(pkts) == 1
    assert pkts[0].data == big


def test_reference_layout_no_ecc(rng):
    """ecc=False reproduces the reference packet layout: no ECC block
    (flags bit 7 clear, gstasfmux.c:1616) and the used-byte packet
    length (gstasfmux.c:1633)."""
    mux, stream, _ = _build(rng, n=3, ecc=False)
    hdr_end = stream.find(asf.GUID_DATA) + 50
    pkt = stream[hdr_end:hdr_end + asf.DEFAULT_PACKET_SIZE]
    flags = pkt[0]
    assert not (flags & 0x80)      # no error correction
    assert flags & 0x1             # multiple payloads
    (plen,) = struct.unpack_from("<H", pkt, 2)
    (pad,) = struct.unpack_from("<H", pkt, 4)
    assert plen + pad == asf.DEFAULT_PACKET_SIZE


def test_asfparse_alignment(rng):
    _, stream, _ = _build(rng, n=6)
    parse = asf.AsfParse()
    outs = []
    for i in range(0, len(stream), 997):
        outs += parse.push(stream[i:i + 997])
    assert parse.packet_size == asf.DEFAULT_PACKET_SIZE
    assert outs[0] == stream[:len(outs[0])]  # header blob
    assert all(len(o) == asf.DEFAULT_PACKET_SIZE for o in outs[1:])
    assert b"".join(outs) == stream


def test_elements(rng):
    mux = gt.make("asfmux", ecc=True)
    a = mux.connect_audio(0x0050, 2, 48000)
    v = mux.connect_video(b"MPG2", 32, 32)
    NSEC = 1_000_000_000
    for i in range(3):
        mux.chain(v, b"vid%d" % i, pts_ns=i * NSEC, keyframe=True)
        mux.chain(a, b"aud%d" % i, pts_ns=i * NSEC)
    stream = mux.event_eos()
    assert find_type(stream) == "video/x-ms-asf"
    if tsoracle.available():
        _, pkts = tsoracle.demux(stream, any_format=True)
        assert sorted(p.data for p in pkts) == [
            b"aud0", b"aud1", b"aud2", b"vid0", b"vid1", b"vid2"]
    parse = gt.make("asfparse")
    outs = parse.chain(stream)
    assert b"".join(outs) == stream
