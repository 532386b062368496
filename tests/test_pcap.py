"""pcapparse + irtspparse (gst/pcapparse/) — upstream unit-test
transcription (tests/check/elements/pcapparse.c) plus coverage the
upstream harness exercises via gst_parser_test_split (arbitrary input
chunking must not change the output)."""

import struct

import pytest

import gstbad as gt
from gstbad.elements.pcap import PcapError

# pcapparse.c:15-18 (little-endian v2.4, linktype 1 = Ethernet)
PCAP_HEADER = bytes([
    0xd4, 0xc3, 0xb2, 0xa1, 0x02, 0x00, 0x04, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0xff, 0xff, 0x00, 0x00, 0x01, 0x00,
    0x00, 0x00,
])

# pcapparse.c:20-29: 60-byte Ethernet frame whose UDP length (24) is
# shorter than the capture (Ethernet trailer padding) - the payload is
# the 16 bytes after the headers, not 18
PADDING_OFFSET = 16 + 14 + 20 + 8
PCAP_FRAME_WITH_ETH_PADDING = bytes([
    0x5f, 0x12, 0x4e, 0x54, 0x57, 0x70, 0x00, 0x00, 0x3c, 0x00, 0x00,
    0x00, 0x3c, 0x00, 0x00, 0x00, 0x00, 0x0c, 0x29, 0xa6, 0x13, 0x41,
    0x00, 0x0c, 0x29, 0xb2, 0x93, 0x7d, 0x08, 0x00, 0x45, 0x00, 0x00,
    0x2c, 0x00, 0x00, 0x40, 0x00, 0x32, 0x11, 0x25, 0xb9, 0x52, 0xc5,
    0x4d, 0xd6, 0xb9, 0x23, 0xc9, 0x49, 0x44, 0x66, 0x9f, 0xf2, 0x00,
    0x18, 0x75, 0xe8, 0x80, 0xe3, 0x7c, 0xca, 0x79, 0xba, 0x09, 0xc0,
    0x70, 0x6e, 0x8b, 0x33, 0x05, 0x0a, 0x00, 0xa0, 0x00, 0x00,
])
PADDING_PAYLOAD = PCAP_FRAME_WITH_ETH_PADDING[PADDING_OFFSET:-2]

# pcapparse.c:74-85: a loopback capture of a zero-payload UDP datagram
ZEROSIZE_DATA = bytes([
    0xd4, 0xc3, 0xb2, 0xa1, 0x02, 0x00, 0x04, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x04, 0x00, 0x01, 0x00, 0x00, 0x00,
    0xd3, 0xff, 0x7a, 0x56, 0xbb, 0xd8, 0x0e, 0x00,
    0x2a, 0x00, 0x00, 0x00, 0x2a, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x08, 0x00, 0x45, 0x00,
    0x00, 0x1c, 0x06, 0xe7, 0x40, 0x00, 0x40, 0x11,
    0x35, 0xe8, 0x7f, 0x00, 0x00, 0x01, 0x7f, 0x00,
    0x00, 0x01, 0xd2, 0xa3, 0x13, 0x8c, 0x00, 0x08,
    0xfe, 0x1b,
])


def test_parse_frames_with_eth_padding():
    """test_parse_frames_with_eth_padding: the UDP length governs the
    payload; the 2 Ethernet trailer bytes are excluded."""
    el = gt.make("pcapparse")
    out = el.chain(PCAP_HEADER + PCAP_FRAME_WITH_ETH_PADDING)
    assert len(out) == 1
    assert out[0]["data"] == PADDING_PAYLOAD
    assert len(out[0]["data"]) == 16
    assert out[0]["discont"]


def test_parse_split_any_chunking():
    """gst_parser_test_split: pushing the same stream in any chunking
    yields the same packets."""
    stream = PCAP_HEADER + PCAP_FRAME_WITH_ETH_PADDING * 3
    whole = gt.make("pcapparse").chain(stream)
    assert len(whole) == 3
    for step in (1, 7, 24):
        el = gt.make("pcapparse")
        got = []
        for i in range(0, len(stream), step):
            got += el.chain(stream[i:i + step])
        assert [p["data"] for p in got] == [p["data"] for p in whole]
    # only the first packet is DISCONT (gstpcapparse.c:536-542)
    assert [p["discont"] for p in whole] == [True, False, False]


def test_parse_zerosize_frames():
    """test_parse_zerosize_frames: a 0-byte UDP payload still emits a
    0-byte packet."""
    el = gt.make("pcapparse")
    out = el.chain(ZEROSIZE_DATA)
    assert len(out) == 1
    assert out[0]["data"] == b""


def test_timestamps_and_offset():
    """ts = sec * 1e9 + usec * 1e3; ts-offset rebases to the first
    packet (gstpcapparse.c:545-553)."""
    el = gt.make("pcapparse")
    out = el.chain(ZEROSIZE_DATA)
    assert out[0]["pts"] == 0x567AFFD3 * 10 ** 9 + 0x000ED8BB * 1000

    el = gt.make("pcapparse", **{"ts-offset": 5})
    out = el.chain(ZEROSIZE_DATA)
    assert out[0]["pts"] == 5


def test_filters():
    """src/dst IP and port filters drop non-matching records."""
    stream = PCAP_HEADER + PCAP_FRAME_WITH_ETH_PADDING
    # the frame is 82.197.77.214:17510 -> 185.35.201.73:...
    el = gt.make("pcapparse", **{"src-ip": "82.197.77.214"})
    assert len(el.chain(stream)) == 1
    el = gt.make("pcapparse", **{"src-ip": "10.0.0.1"})
    assert len(el.chain(stream)) == 0
    src_port = struct.unpack_from(
        ">H", PCAP_FRAME_WITH_ETH_PADDING, 16 + 14 + 20)[0]
    el = gt.make("pcapparse", **{"src-port": src_port})
    assert len(el.chain(stream)) == 1
    el = gt.make("pcapparse", **{"dst-port": 1})
    assert len(el.chain(stream)) == 0


def test_bad_magic_errors():
    el = gt.make("pcapparse")
    with pytest.raises(PcapError):
        el.chain(b"\x00" * 24)


def test_nanosecond_magic():
    header = struct.pack("<IHHiIII", 0xA1B23C4D, 2, 4, 0, 0, 0xFFFF, 1)
    rec = struct.pack("<IIII", 1, 500, len(ZEROSIZE_DATA) - 40, 0) \
        + ZEROSIZE_DATA[40:]
    el = gt.make("pcapparse")
    out = el.chain(header + rec)
    assert out[0]["pts"] == 10 ** 9 + 500  # usec field is nanoseconds


# ---------------------------------------------------------------- irtsp

def _rtsp_frame(channel: int, payload: bytes) -> bytes:
    return bytes([0x24, channel]) + struct.pack(">H", len(payload)) \
        + payload


def test_irtspparse_channel_filter():
    el = gt.make("irtspparse", **{"channel-id": 3})
    stream = (_rtsp_frame(0, b"drop me") + _rtsp_frame(3, b"keep")
              + _rtsp_frame(5, b"drop") + _rtsp_frame(3, b"this too"))
    out = el.chain(stream)
    assert [p["data"] for p in out] == [b"keep", b"this too"]
    assert [p["discont"] for p in out] == [True, False]


def test_irtspparse_leading_garbage_and_chunking():
    """The first 0x24 is taken as frame start (gstirtspparse.c:160-166);
    chunk boundaries don't change the output."""
    stream = b"RTSP/1.0 200 OK\r\n\r\n" \
        + _rtsp_frame(0, b"abc") + _rtsp_frame(0, bytes(300))
    whole = gt.make("irtspparse").chain(stream)
    # note: the garbage contains no 0x24, frames parse after it
    assert [len(p["data"]) for p in whole] == [3, 300]
    for step in (1, 5):
        el = gt.make("irtspparse")
        got = []
        for i in range(0, len(stream), step):
            got += el.chain(stream[i:i + step])
        assert [p["data"] for p in got] == [p["data"] for p in whole]
