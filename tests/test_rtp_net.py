"""rtpsrc/rtpsink over real localhost UDP + the io/rtpnet.py session
layer: RFC 4175 raw-video framing, L16, MP2T, the jitter buffer's
reorder/loss contract, RTCP SR/SDES/BYE, and the rtp:// URI query
property path (gst/rtp/gstrtpsrc.c, gstrtpsink.c, gstrtp-utils.c)."""

import time

import numpy as np
import pytest

from gstbad.core.frame import FrameBatch
from gstbad.core.registry import make
from gstbad.core.spec import AudioFormat, MediaSpec, VideoFormat
from gstbad.io import rtpnet
from gstbad.io.rtp import RtpPacket


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _free_port():
    import socket
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    # rtp wants port and port+1 free; even base like the RFC suggests
    return port if port % 2 == 0 else port + 1


# ---------------------------------------------------------------------------
# io layer
# ---------------------------------------------------------------------------


def test_jitterbuffer_reorders_and_unwraps():
    jb = rtpnet.JitterBuffer(latency_ms=50)
    seqs = [65533, 65534, 65535, 0, 1, 2]  # wraps
    pkts = [RtpPacket(seq=s, ssrc=9, payload=bytes([i]))
            for i, s in enumerate(seqs)]
    order = [0, 2, 1, 4, 3, 5]  # deliver shuffled
    for i in order:
        jb.insert(pkts[i], now=0.0)
    got = jb.pop_ready(now=0.0)
    assert [p.payload[0] for p in got] == [0, 1, 2, 3, 4, 5]
    assert jb.num_lost == 0


def test_jitterbuffer_skips_gap_after_latency():
    jb = rtpnet.JitterBuffer(latency_ms=100)
    jb.insert(RtpPacket(seq=10, ssrc=1, payload=b"a"), now=0.0)
    assert [p.payload for p in jb.pop_ready(now=0.0)] == [b"a"]
    # seq 11 lost; 12 arrives
    jb.insert(RtpPacket(seq=12, ssrc=1, payload=b"c"), now=0.01)
    assert jb.pop_ready(now=0.05) == []          # still waiting
    got = jb.pop_ready(now=0.2)                  # latency exceeded
    assert [p.payload for p in got] == [b"c"]
    assert jb.num_lost == 1  # the skipped seq 11

def test_jitterbuffer_locks_first_ssrc():
    jb = rtpnet.JitterBuffer()
    jb.insert(RtpPacket(seq=0, ssrc=7), now=0.0)
    jb.insert(RtpPacket(seq=1, ssrc=8), now=0.0)
    assert jb.num_foreign == 1
    assert len(jb.pop_ready(now=0.0)) == 1


@pytest.mark.parametrize("fmt,sampling,shape", [
    ("RGB", "RGB", (17, 31, 3)),
    ("BGRA", "BGRA", (12, 25, 4)),
    ("UYVY", "YCbCr-4:2:2", (16, 2 * 22)),
])
def test_rfc4175_roundtrip(rng, fmt, sampling, shape):
    h, w = shape[0], (shape[1] if len(shape) == 2 else shape[1])
    width = w // 2 if fmt == "UYVY" else w
    frame = rng.integers(0, 256, shape, dtype=np.uint8)
    pay = rtpnet.RawVideoPayloader(sampling, width, h, mtu=200)
    pkts = pay.pay_frame(frame, ts90=123450)
    assert pkts[-1].marker and not pkts[0].marker or len(pkts) == 1
    depay = rtpnet.RawVideoDepayloader(sampling, width, h)
    done = []
    for p in pkts:
        done += depay.depay(p)
    assert len(done) == 1
    ts, got = done[0]
    assert ts == 123450
    np.testing.assert_array_equal(
        got, frame.reshape(h, -1))


def test_rfc4175_lost_packet_drops_frame(rng):
    frame = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    pay = rtpnet.RawVideoPayloader("RGB", 16, 16, mtu=100)
    pkts = pay.pay_frame(frame, ts90=0)
    assert len(pkts) > 2
    depay = rtpnet.RawVideoDepayloader("RGB", 16, 16)
    done = []
    for p in pkts[:1] + pkts[2:]:  # drop one mid-frame packet
        done += depay.depay(p)
    assert done == [] and depay.num_dropped == 1
    # next intact frame still decodes
    pkts2 = pay.pay_frame(frame, ts90=3000)
    for p in pkts2:
        done += depay.depay(p)
    assert len(done) == 1


def test_l16_roundtrip_and_timestamps(rng):
    samples = rng.integers(-30000, 30000, (1000, 2), dtype=np.int16)
    pay = rtpnet.L16Payloader(48000, 2, mtu=300)
    pkts = pay.pay(samples)
    per = (300 - 12) // 4
    assert pkts[1].timestamp - pkts[0].timestamp == per
    depay = rtpnet.L16Depayloader(2)
    got = np.concatenate([depay.depay(p) for p in pkts])
    np.testing.assert_array_equal(got, samples)


def test_mp2t_packs_whole_ts_packets():
    data = bytes(range(256)) * 10  # 2560 bytes = 13x188 + 116
    pay = rtpnet.Mp2tPayloader(mtu=1400)
    pkts = pay.pay(data)
    assert all(len(p.payload) % 188 == 0 for p in pkts)
    assert pkts[0].payload_type == 33
    total = sum(len(p.payload) for p in pkts)
    assert total == 13 * 188 and len(pay._partial) == 2560 - total
    depay = rtpnet.Mp2tDepayloader()
    assert b"".join(depay.depay(p) for p in pkts) == data[:total]


def test_rtcp_sr_sdes_bye_roundtrip():
    sr = rtpnet.RtcpSR(ssrc=0xAA, ntp=rtpnet.unix_to_ntp64(1234.5),
                       rtp_ts=777, packet_count=10, octet_count=999)
    compound = (sr.serialize() + rtpnet.rtcp_sdes_cname(0xAA, "x@y")
                + rtpnet.rtcp_bye(0xAA))
    items = rtpnet.parse_rtcp(compound)
    kinds = [i["type"] for i in items]
    assert kinds == ["sr", "sdes", "bye"]
    assert items[0]["rtp_ts"] == 777 and items[0]["octet_count"] == 999
    assert items[1]["cname"] == "x@y"


def test_payload_info_lookup():
    assert rtpnet.payload_info_for_pt(33) == ("video", "MP2T", 90000, None)
    assert rtpnet.payload_info_for_pt(10) == ("audio", "L16", 44100, 2)
    assert rtpnet.payload_info_for_name("mp2t")[1] == "MP2T"
    assert rtpnet.parse_rtp_uri("rtp://127.0.0.1:6000?latency=50") == \
        ("127.0.0.1", 6000, {"latency": "50"})


# ---------------------------------------------------------------------------
# elements over real localhost sockets
# ---------------------------------------------------------------------------


def test_rtp_loopback_raw_video(rng):
    port = _free_port()
    src = make("rtpsrc", **{
        "uri": f"rtp://127.0.0.1:{port}?latency=50",
        "caps": ("application/x-rtp,media=video,encoding-name=RAW,"
                 "sampling=RGB,width=32,height=24,framerate=30/1")})
    spec = src.negotiate(None)
    assert spec.format == VideoFormat.RGB and spec.width == 32
    src.open()

    sink = make("rtpsink", uri=f"rtp://127.0.0.1:{port}", mtu=400)
    sink.negotiate(MediaSpec(kind="video", format=VideoFormat.RGB,
                             width=32, height=24))
    import jax.numpy as jnp
    frames = rng.integers(0, 256, (4, 24, 32, 3), dtype=np.uint8)
    pts = np.arange(4, dtype=np.int64) * 33_333_333
    sink.host_process(FrameBatch.make(jnp.asarray(frames),
                                      pts=jnp.asarray(pts)), None)
    batch = src.pull_window(4)
    assert batch is not None
    got = np.asarray(batch.data)
    assert got.shape == (4, 24, 32, 3)
    np.testing.assert_array_equal(got, frames)
    # pts survive the 90 kHz clock round trip within one tick
    assert np.max(np.abs(np.asarray(batch.pts) - pts)) < 12000
    sink.close()
    src.close()


def test_rtp_loopback_l16_audio(rng):
    port = _free_port()
    sink = make("rtpsink", address="127.0.0.1", port=port, pt=96)
    sink.negotiate(MediaSpec(kind="audio", format=AudioFormat.S16,
                             rate=8000, channels=2))
    src = make("rtpsrc", address="127.0.0.1", port=port,
               caps=("application/x-rtp,media=audio,encoding-name=L16,"
                     "clock-rate=8000,channels=2,samplesperbuffer=256"))
    spec = src.negotiate(None)
    assert spec.rate == 8000 and spec.channels == 2
    src.open()
    import jax.numpy as jnp
    audio = rng.integers(-3000, 3000, (2, 512, 2), dtype=np.int16)
    sink.host_process(FrameBatch.make(jnp.asarray(audio)), None)
    batch = src.pull_window(4)
    assert batch is not None
    got = np.asarray(batch.data).reshape(-1, 2)
    np.testing.assert_array_equal(got, audio.reshape(-1, 2))
    sink.close()
    src.close()


def test_rtp_loopback_reorder_recovery(rng):
    """Shuffled datagram delivery must come out in order (the
    jitterbuffer contract rtpsrc inherits from rtpbin)."""
    import socket as socket_mod
    port = _free_port()
    src = make("rtpsrc", address="127.0.0.1", port=port, latency=100,
               timeout=3.0,
               caps=("application/x-rtp,media=video,encoding-name=RAW,"
                     "sampling=BGRA,width=16,height=8,framerate=30/1"))
    src.negotiate(None)
    src.open()
    pay = rtpnet.RawVideoPayloader("BGRA", 16, 8, mtu=300)
    frames = rng.integers(0, 256, (3, 8, 16, 4), dtype=np.uint8)
    pkts = []
    for i in range(3):
        pkts += pay.pay_frame(frames[i], ts90=3000 * i)
    order = rng.permutation(len(pkts))
    s = socket_mod.socket(socket_mod.AF_INET, socket_mod.SOCK_DGRAM)
    for i in order:
        s.sendto(pkts[i].serialize(), ("127.0.0.1", port))
    s.close()
    batch = src.pull_window(3)
    assert batch is not None and batch.batch == 3
    np.testing.assert_array_equal(np.asarray(batch.data), frames)
    src.close()


def test_rtp_mp2t_to_tsdemux(rng):
    """MP2T payload mode feeding the existing tsdemux (push_bytes)."""
    port = _free_port()
    src = make("rtpsrc", address="127.0.0.1", port=port,
               caps="application/x-rtp,media=video,encoding-name=MP2T",
               timeout=2.0)
    spec = src.negotiate(None)
    assert spec.kind == "bytes"
    src.open()
    import socket as socket_mod
    pay = rtpnet.Mp2tPayloader()
    ts = bytes([0x47, 0x1F, 0xFF, 0x10]) + bytes(184)  # null packets
    pkts = pay.pay(ts * 14)
    s = socket_mod.socket(socket_mod.AF_INET, socket_mod.SOCK_DGRAM)
    for p in pkts:
        s.sendto(p.serialize(), ("127.0.0.1", port))
    s.close()
    time.sleep(0.05)
    data = src.pull_bytes()
    assert len(data) == 14 * 188 and data[0] == 0x47
    src.close()


def test_rtpsink_sends_rtcp_sr(rng):
    import socket as socket_mod
    port = _free_port()
    # listen on the RTCP port before the sink sends
    rx = socket_mod.socket(socket_mod.AF_INET, socket_mod.SOCK_DGRAM)
    rx.bind(("127.0.0.1", port + 1))
    rx.settimeout(2.0)
    sink = make("rtpsink", address="127.0.0.1", port=port,
                **{"rtcp-interval": 0.0})
    sink.negotiate(MediaSpec(kind="audio", format=AudioFormat.S16,
                             rate=8000, channels=1))
    import jax.numpy as jnp
    sink.host_process(FrameBatch.make(jnp.asarray(
        rng.integers(-100, 100, (1, 64, 1), dtype=np.int16))), None)
    data, _ = rx.recvfrom(4096)
    items = rtpnet.parse_rtcp(data)
    assert items[0]["type"] == "sr" and items[0]["packet_count"] >= 1
    assert any(i["type"] == "sdes" for i in items)
    sink.close()
    rx.close()
