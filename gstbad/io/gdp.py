"""GDP analog — wire serialization of frames + spec (gst/gdp/).

The reference's GStreamer Data Protocol payloads buffers/caps/events as
typed packets for transport.  Here a FrameBatch + MediaSpec serializes to a
self-describing binary packet: a JSON header (the caps analog) + raw plane
bytes — the (tensor, MediaSpec, pts) tuple SURVEY.md section 2.6 calls for.
"""

from __future__ import annotations

import json
import struct
from fractions import Fraction
from typing import Tuple

import numpy as np

from gstbad.core.frame import FrameBatch
from gstbad.core.spec import MediaSpec

MAGIC = b"GTP0"  # gstbad protocol v0


def _spec_dict(spec: MediaSpec) -> dict:
    return {
        "kind": spec.kind, "format": spec.format, "width": spec.width,
        "height": spec.height,
        "framerate": [spec.framerate.numerator, spec.framerate.denominator],
        "rate": spec.rate, "channels": spec.channels, "layout": spec.layout,
        "interlace_mode": spec.interlace_mode,
    }


def _spec_from(d: dict) -> MediaSpec:
    return MediaSpec(kind=d["kind"], format=d["format"], width=d["width"],
                     height=d["height"],
                     framerate=Fraction(*d["framerate"]), rate=d["rate"],
                     channels=d["channels"], layout=d["layout"],
                     interlace_mode=d["interlace_mode"])


def pay(batch: FrameBatch, spec: MediaSpec) -> bytes:
    """Serialize (gdppay analog)."""
    np_batch = batch.to_numpy()
    if isinstance(np_batch.data, dict):
        planes = {k: np.ascontiguousarray(v) for k, v in np_batch.data.items()}
    else:
        planes = {"_": np.ascontiguousarray(np_batch.data)}
    header = {
        "spec": _spec_dict(spec),
        "planes": [{"name": k, "shape": list(v.shape),
                    "dtype": str(v.dtype)} for k, v in planes.items()],
        "pts": np.asarray(np_batch.pts).tolist(),
        "flags": np.asarray(np_batch.flags).tolist(),
        "valid": np.asarray(np_batch.valid).astype(int).tolist(),
    }
    hbytes = json.dumps(header).encode()
    out = [MAGIC, struct.pack("<I", len(hbytes)), hbytes]
    for v in planes.values():
        out.append(v.tobytes())
    return b"".join(out)


def depay(blob: bytes) -> Tuple[FrameBatch, MediaSpec]:
    """Deserialize (gdpdepay analog)."""
    if blob[:4] != MAGIC:
        raise ValueError("bad GTP magic")
    (hlen,) = struct.unpack("<I", blob[4:8])
    header = json.loads(blob[8:8 + hlen])
    off = 8 + hlen
    planes = {}
    for p in header["planes"]:
        n = int(np.prod(p["shape"])) * np.dtype(p["dtype"]).itemsize
        arr = np.frombuffer(blob[off:off + n], dtype=p["dtype"]
                            ).reshape(p["shape"])
        planes[p["name"]] = arr
        off += n
    data = planes["_"] if list(planes) == ["_"] else planes
    import jax.numpy as jnp
    batch = FrameBatch(
        data=(jnp.asarray(data) if not isinstance(data, dict)
              else {k: jnp.asarray(v) for k, v in data.items()}),
        pts=jnp.asarray(header["pts"], jnp.int64),
        flags=jnp.asarray(header["flags"], jnp.int32),
        valid=jnp.asarray(header["valid"], bool))
    return batch, _spec_from(header["spec"])


# ---------------------------------------------------------------------------
# ipcpipeline typed chunks (sys/ipcpipeline/protocol.txt:12-23)
# ---------------------------------------------------------------------------
# Same chunk grammar as the reference — type byte, little-endian request id
# and payload size — with JSON payloads where the reference serializes
# GstStructure strings (we are not GObject-wire-compatible; the protocol
# *shape* — typed chunks, request ids, acks carrying results — is the parity
# point).

CHUNK_ACK = 1
CHUNK_QUERY_RESULT = 2
CHUNK_BUFFER = 3
CHUNK_EVENT = 4
CHUNK_SINK_MESSAGE_EVENT = 5
CHUNK_QUERY = 6
CHUNK_STATE_CHANGE = 7
CHUNK_STATE_LOST = 8
CHUNK_MESSAGE = 9
CHUNK_ERROR_MESSAGE = 10

_CHUNK_HDR = struct.Struct("<BII")


def pack_chunk(ctype: int, req_id: int, payload: bytes = b"") -> bytes:
    return _CHUNK_HDR.pack(ctype, req_id, len(payload)) + payload


def unpack_chunk(blob: bytes) -> Tuple[int, int, bytes]:
    ctype, req_id, size = _CHUNK_HDR.unpack_from(blob)
    payload = blob[_CHUNK_HDR.size:_CHUNK_HDR.size + size]
    if len(payload) != size:
        raise ValueError(f"chunk truncated: want {size}, got {len(payload)}")
    return ctype, req_id, payload


def pack_json_chunk(ctype: int, req_id: int, obj) -> bytes:
    return pack_chunk(ctype, req_id, json.dumps(obj).encode())


def unpack_json(payload: bytes):
    return json.loads(payload.decode())


# ----------------------------------------------------------------------
# REAL GStreamer Data Protocol 1.0 (gst/gdp/dataprotocol.c): the wire
# format the reference's gdppay/gdpdepay speak.

DP_HEADER_LENGTH = 62  # GST_DP_HEADER_LENGTH (dataprotocol.h:37)

DP_PAYLOAD_NONE = 0
DP_PAYLOAD_BUFFER = 1
DP_PAYLOAD_CAPS = 2
DP_PAYLOAD_EVENT_NONE = 64

DP_FLAG_NONE = 0
DP_FLAG_CRC_HEADER = 1
DP_FLAG_CRC_PAYLOAD = 2

CLOCK_TIME_NONE = (1 << 64) - 1

_CRC_POLY = 0x1021  # dataprotocol.c:132, CRC-16/GENIBUS
_CRC_TABLE = []
for _i in range(256):
    _r = _i << 8
    for _ in range(8):
        _r = ((_r << 1) ^ _CRC_POLY) if _r & 0x8000 else (_r << 1)
        _r &= 0xFFFF
    _CRC_TABLE.append(_r)


def dp_crc(data: bytes) -> int:
    """gst_dp_crc: CCITT table CRC, init 0xFFFF, final xor 0xFFFF;
    empty input yields 0 (dataprotocol.c:123-156)."""
    if not data:
        return 0
    crc = 0xFFFF
    for b in data:
        crc = ((crc << 8) ^ _CRC_TABLE[((crc >> 8) & 0xFF) ^ b]) \
            & 0xFFFF
    return 0xFFFF ^ crc


def _dp_header(flags: int, ptype: int, length: int, ts: int, dur: int,
               offset: int, offset_end: int, buf_flags: int, dts: int,
               payload: bytes) -> bytes:
    """The 62-byte GDP 1.0 header (gst_dp_payload_buffer layout,
    dataprotocol.c:140-205)."""
    h = bytearray(DP_HEADER_LENGTH)
    h[0] = 1   # version major
    h[1] = 0   # version minor
    h[2] = flags
    h[3] = 0   # padding
    struct.pack_into(">H", h, 4, ptype)
    struct.pack_into(">I", h, 6, length)
    struct.pack_into(">Q", h, 10, ts & CLOCK_TIME_NONE)
    struct.pack_into(">Q", h, 18, dur & CLOCK_TIME_NONE)
    struct.pack_into(">Q", h, 26, offset & CLOCK_TIME_NONE)
    struct.pack_into(">Q", h, 34, offset_end & CLOCK_TIME_NONE)
    struct.pack_into(">H", h, 42, buf_flags)
    struct.pack_into(">Q", h, 44, dts & CLOCK_TIME_NONE)
    if flags & DP_FLAG_CRC_HEADER:
        struct.pack_into(">H", h, 58, dp_crc(bytes(h[:58])))
    if flags & DP_FLAG_CRC_PAYLOAD and payload:
        struct.pack_into(">H", h, 60, dp_crc(payload))
    return bytes(h)


def dp_payload_buffer(data: bytes, pts: int = CLOCK_TIME_NONE,
                      duration: int = CLOCK_TIME_NONE,
                      offset: int = CLOCK_TIME_NONE,
                      offset_end: int = CLOCK_TIME_NONE,
                      buf_flags: int = 0, dts: int = CLOCK_TIME_NONE,
                      flags: int = DP_FLAG_NONE) -> bytes:
    return _dp_header(flags, DP_PAYLOAD_BUFFER, len(data), pts,
                      duration, offset, offset_end, buf_flags, dts,
                      data) + data


def dp_payload_caps(caps: str, flags: int = DP_FLAG_NONE) -> bytes:
    """Caps travel as a NUL-terminated caps string
    (gst_dp_payload_caps, dataprotocol.c:207-240)."""
    payload = caps.encode() + b"\x00"
    return _dp_header(flags, DP_PAYLOAD_CAPS, len(payload), 0, 0, 0, 0,
                      0, CLOCK_TIME_NONE, payload) + payload


def dp_payload_event(event_type: int, structure: str = "",
                     pts: int = CLOCK_TIME_NONE,
                     flags: int = DP_FLAG_NONE) -> bytes:
    """Events: payload type 64 + the GstEvent type number; payload is
    the serialized structure string (gst_dp_payload_event)."""
    payload = (structure.encode() + b"\x00") if structure else b""
    return _dp_header(flags, DP_PAYLOAD_EVENT_NONE + event_type,
                      len(payload), pts, 0, 0, 0, 0, CLOCK_TIME_NONE,
                      payload) + payload


class DpPacket(dict):
    pass


def dp_validate_header(header: bytes) -> bool:
    """gst_dp_validate_header: header CRC check when flagged."""
    if len(header) < DP_HEADER_LENGTH or header[0] != 1:
        return False
    if header[2] & DP_FLAG_CRC_HEADER:
        (want,) = struct.unpack_from(">H", header, 58)
        if dp_crc(header[:58]) != want:
            return False
    return True


def dp_validate_payload(header: bytes, payload: bytes) -> bool:
    if header[2] & DP_FLAG_CRC_PAYLOAD and payload:
        (want,) = struct.unpack_from(">H", header, 60)
        return dp_crc(payload) == want
    return True


def dp_depay(stream: bytes, pos: int = 0):
    """Walk GDP packets; yields DpPacket(type, payload, pts, duration,
    offset, offset_end, buf_flags, dts) — raises ValueError on CRC or
    version mismatch (gdpdepay's error paths)."""
    while pos + DP_HEADER_LENGTH <= len(stream):
        header = stream[pos:pos + DP_HEADER_LENGTH]
        if not dp_validate_header(header):
            raise ValueError("bad GDP header")
        (ptype,) = struct.unpack_from(">H", header, 4)
        (length,) = struct.unpack_from(">I", header, 6)
        payload = stream[pos + DP_HEADER_LENGTH:
                         pos + DP_HEADER_LENGTH + length]
        if len(payload) < length:
            return
        if not dp_validate_payload(header, payload):
            raise ValueError("bad GDP payload crc")
        vals = struct.unpack_from(">QQQQ", header, 10)
        (buf_flags,) = struct.unpack_from(">H", header, 42)
        (dts,) = struct.unpack_from(">Q", header, 44)
        yield DpPacket(type=ptype, payload=payload, pts=vals[0],
                       duration=vals[1], offset=vals[2],
                       offset_end=vals[3], buf_flags=buf_flags,
                       dts=dts)
        pos += DP_HEADER_LENGTH + length
