"""Real GDP 1.0 wire format (gst/gdp/dataprotocol.c) — header layout,
the reference's exact CRC table/final-xor, pay/depay elements."""

import struct

import pytest

import gstbad as gt
from gstbad.io import gdp


def test_crc_table_golden():
    """dataprotocol.c:333-340 first table rows."""
    assert gdp._CRC_TABLE[:16] == [
        0x0000, 0x1021, 0x2042, 0x3063, 0x4084, 0x50a5, 0x60c6,
        0x70e7, 0x8108, 0x9129, 0xa14a, 0xb16b, 0xc18c, 0xd1ad,
        0xe1ce, 0xf1ef]
    assert gdp.dp_crc(b"") == 0


def test_header_layout():
    """dataprotocol.c:140-205 field offsets."""
    pkt = gdp.dp_payload_buffer(
        b"x" * 5, pts=0x1122334455667788, duration=2, offset=3,
        offset_end=4, buf_flags=0x0010, dts=5,
        flags=gdp.DP_FLAG_CRC_HEADER)
    h = pkt[:62]
    assert (h[0], h[1]) == (1, 0)          # version 1.0
    assert h[2] == gdp.DP_FLAG_CRC_HEADER
    assert struct.unpack_from(">H", h, 4)[0] == gdp.DP_PAYLOAD_BUFFER
    assert struct.unpack_from(">I", h, 6)[0] == 5
    assert struct.unpack_from(">Q", h, 10)[0] == 0x1122334455667788
    assert struct.unpack_from(">Q", h, 18)[0] == 2
    assert struct.unpack_from(">Q", h, 26)[0] == 3
    assert struct.unpack_from(">Q", h, 34)[0] == 4
    assert struct.unpack_from(">H", h, 42)[0] == 0x0010
    assert struct.unpack_from(">Q", h, 44)[0] == 5
    # header crc over the first 58 bytes
    assert struct.unpack_from(">H", h, 58)[0] == gdp.dp_crc(h[:58])
    assert struct.unpack_from(">H", h, 60)[0] == 0  # no payload crc


def test_roundtrip_with_crcs():
    pkt = gdp.dp_payload_buffer(
        b"hello world", pts=42,
        flags=gdp.DP_FLAG_CRC_HEADER | gdp.DP_FLAG_CRC_PAYLOAD)
    (got,) = gdp.dp_depay(pkt)
    assert got["payload"] == b"hello world"
    assert got["pts"] == 42


def test_corruption_detected():
    pkt = bytearray(gdp.dp_payload_buffer(
        b"data", flags=gdp.DP_FLAG_CRC_HEADER | gdp.DP_FLAG_CRC_PAYLOAD))
    pkt[20] ^= 0xFF  # header field
    with pytest.raises(ValueError):
        list(gdp.dp_depay(bytes(pkt)))
    pkt = bytearray(gdp.dp_payload_buffer(
        b"data", flags=gdp.DP_FLAG_CRC_HEADER | gdp.DP_FLAG_CRC_PAYLOAD))
    pkt[-1] ^= 0xFF  # payload
    with pytest.raises(ValueError):
        list(gdp.dp_depay(bytes(pkt)))


def test_caps_packet():
    pkt = gdp.dp_payload_caps("video/x-raw, format=(string)I420",
                              flags=gdp.DP_FLAG_CRC_HEADER)
    (got,) = gdp.dp_depay(pkt)
    assert got["type"] == gdp.DP_PAYLOAD_CAPS
    assert got["payload"] == b"video/x-raw, format=(string)I420\x00"


def test_elements_pay_depay():
    """gdppay sends caps before the first buffer; gdpdepay recovers
    caps + buffers + events across arbitrary chunking."""
    pay = gt.make("gdppay")
    pay.set_caps("video/x-raw, format=(string)I420, width=(int)32")
    stream = pay.chain(b"frame0", pts=0)
    stream += pay.chain(b"frame1", pts=1000)
    stream += pay.event_eos()

    depay = gt.make("gdpdepay")
    bufs = []
    for i in range(0, len(stream), 7):
        bufs += depay.chain(stream[i:i + 7])
    assert [b["payload"] for b in bufs] == [b"frame0", b"frame1"]
    assert [b["pts"] for b in bufs] == [0, 1000]
    assert depay.caps == \
        "video/x-raw, format=(string)I420, width=(int)32"
    assert depay.events == [1]
