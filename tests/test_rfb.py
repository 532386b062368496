"""rfbsrc / io/rfb.py — the gst/librfb RFB client driven against a
scripted mock VNC server (the io/festival.py injected-transport
pattern): version negotiation 3.3/3.7/3.8, security none + VNC DES
auth, server init, and every update encoding the reference decodes
(raw/copyrect/RRE/CoRRE/hextile, rfbdecoder.c:858-1100)."""

import struct

import numpy as np
import pytest

import gstbad as gt
from gstbad.io import rfb


class MockServer:
    """Duplex in-memory transport + a scripted VNC server.

    The client's read(n) pulls from the server's output buffer; the
    client's write() feeds the server state machine, which validates
    the client bytes and emits the next step."""

    def __init__(self, version=b"RFB 003.008\n", sec_types=(1,),
                 password=None, width=48, height=32,
                 name="mock-vnc", bpp=32, depth=24,
                 shifts=(16, 8, 0)):
        self.out = bytearray()
        self.version = version
        self.sec_types = sec_types
        self.password = password
        self.width, self.height = width, height
        self.name = name
        self.bpp, self.depth = bpp, depth
        self.shifts = shifts
        self.client_minor = None
        self.challenge = bytes(range(16))
        self.client_encodings = None
        self.update_requests = []
        self.key_events = []
        self._stage = "version"
        self._pending = b""
        self.out += self.version

    # transport interface ------------------------------------------
    def read(self, n):
        data = bytes(self.out[:n])
        del self.out[:n]
        return data

    def write(self, data):
        self._pending += data
        self._consume()

    # server state machine -----------------------------------------
    def _consume(self):
        while True:
            if self._stage == "version":
                if len(self._pending) < 12:
                    return
                got, self._pending = (self._pending[:12],
                                      self._pending[12:])
                assert got[:8] == b"RFB 003."
                self.client_minor = int(got[8:11])
                if self.client_minor == 3:
                    # server picks: single u32 security type
                    self.out += struct.pack(">I", self.sec_types[0])
                    self._after_security(self.sec_types[0])
                else:
                    self.out += bytes([len(self.sec_types)])
                    self.out += bytes(self.sec_types)
                    self._stage = "sectype"
            elif self._stage == "sectype":
                if len(self._pending) < 1:
                    return
                sec = self._pending[0]
                self._pending = self._pending[1:]
                assert sec in self.sec_types
                self._after_security(sec)
            elif self._stage == "auth":
                if len(self._pending) < 16:
                    return
                response, self._pending = (self._pending[:16],
                                           self._pending[16:])
                want = rfb.vnc_auth_response(self.password,
                                             self.challenge)
                ok = response == want
                self.out += struct.pack(">I", 0 if ok else 1)
                if not ok:
                    reason = b"wrong password"
                    if self.client_minor == 8:
                        self.out += struct.pack(
                            ">I", len(reason)) + reason
                    self._stage = "dead"
                    continue
                self._stage = "clientinit"
            elif self._stage == "secresult":
                self.out += struct.pack(">I", 0)
                self._stage = "clientinit"
            elif self._stage == "clientinit":
                if len(self._pending) < 1:
                    return
                self.shared = self._pending[0]
                self._pending = self._pending[1:]
                self._send_server_init()
                self._stage = "encodings"
            elif self._stage == "encodings":
                if len(self._pending) < 4:
                    return
                assert self._pending[0] == 2
                (n,) = struct.unpack_from(">H", self._pending, 2)
                if len(self._pending) < 4 + 4 * n:
                    return
                self.client_encodings = [
                    struct.unpack_from(">i", self._pending,
                                       4 + 4 * i)[0]
                    for i in range(n)]
                self._pending = self._pending[4 + 4 * n:]
                self._stage = "normal"
            elif self._stage == "normal":
                if not self._pending:
                    return
                mtype = self._pending[0]
                if mtype == 3:   # update request
                    if len(self._pending) < 10:
                        return
                    req = struct.unpack(">BBHHHH", self._pending[:10])
                    self._pending = self._pending[10:]
                    self.update_requests.append(req)
                    self.on_update_request(req)
                elif mtype == 4:  # key event
                    if len(self._pending) < 8:
                        return
                    ev = struct.unpack(">BBHI", self._pending[:8])
                    self._pending = self._pending[8:]
                    self.key_events.append(ev)
                else:
                    raise AssertionError(
                        f"unexpected client message {mtype}")
            else:  # dead
                return

    def _after_security(self, sec):
        if sec == rfb.SECURITY_VNC:
            self.out += self.challenge
            self._stage = "auth"
        elif self.client_minor == 8:
            self._stage = "secresult"
            self._consume2_noop()
        else:
            self._stage = "clientinit"

    def _consume2_noop(self):
        # 3.8 security-none still sends a SecurityResult word
        self.out += struct.pack(">I", 0)
        self._stage = "clientinit"

    def _send_server_init(self):
        rs, gs, bs = self.shifts
        init = struct.pack(">HH", self.width, self.height)
        init += bytes([self.bpp, self.depth, 0, 1])
        init += struct.pack(">HHH", 255, 255, 255)
        init += bytes([rs, gs, bs]) + b"\x00" * 3
        name = self.name.encode()
        init += struct.pack(">I", len(name)) + name
        self.out += init

    # per-test hook: emit rectangles on each update request
    def on_update_request(self, req):
        pass

    # rectangle builders -------------------------------------------
    def update(self, rects):
        msg = struct.pack(">BxH", 0, len(rects))
        self.out += msg + b"".join(rects)

    @staticmethod
    def rect(x, y, w, h, encoding, payload):
        return struct.pack(">HHHHi", x, y, w, h, encoding) + payload


def _connect(server, **props):
    el = gt.make("rfbsrc", **props)
    el.connect(server)
    return el


@pytest.mark.parametrize("version,minor", [
    (b"RFB 003.003\n", "3.3"), (b"RFB 003.007\n", "3.7"),
    (b"RFB 003.008\n", "3.8")])
def test_handshake_versions(version, minor):
    """All three protocol versions negotiate security-none and reach
    the inited state with the server's geometry and pixel format."""
    srv = MockServer(version=version)
    el = _connect(srv, version=minor)
    c = el.client
    assert c.inited
    assert (c.rect_width, c.rect_height) == (48, 32)
    assert c.info.name == "mock-vnc"
    assert el.format == "BGRx"   # LE shifts 16/8/0
    # SetEncodings was sent with the reference's preference order
    assert srv.client_encodings == [5, 4, 2, 0]


def test_version_fallback_to_33():
    """A server speaking 3.5 (unsupported minor) falls back to 3.3
    (rfbdecoder.c:361-380)."""
    srv = MockServer(version=b"RFB 003.005\n")
    el = _connect(srv, version="3.8")
    assert el.client.protocol_minor == 3


def test_des_known_vector():
    """The DES core against the classic FIPS test vector (key
    0x133457799BBCDFF1, PT 0x0123456789ABCDEF ->
    CT 0x85E813540F0AB405)."""
    key = bytes.fromhex("133457799BBCDFF1")
    sub = rfb._des_subkeys(key)
    ct = rfb._des_encrypt_block(bytes.fromhex("0123456789ABCDEF"), sub)
    assert ct == bytes.fromhex("85E813540F0AB405")


def test_vnc_auth():
    """VNC DES authentication round-trips through the mock server's
    independent verification (d3des bit-reversed key bytes)."""
    srv = MockServer(sec_types=(2,), password="s3cret")
    el = _connect(srv, version="3.8", password="s3cret")
    assert el.client.inited


def test_vnc_auth_wrong_password():
    srv = MockServer(sec_types=(2,), password="right")
    with pytest.raises(rfb.RfbError, match="wrong password"):
        _connect(srv, version="3.8", password="wrong")


def test_vnc_auth_needs_password():
    srv = MockServer(sec_types=(2,), password="x")
    with pytest.raises(rfb.RfbError, match="no password set"):
        _connect(srv, version="3.8")


def test_raw_and_rre_updates():
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 256, (32, 48, 4), dtype=np.uint8)

    class Srv(MockServer):
        def on_update_request(self, req):
            if len(self.update_requests) == 1:
                self.update([self.rect(0, 0, 48, 32, 0,
                                       raw.tobytes())])
            else:
                # RRE: background teal + one red subrect
                payload = struct.pack(">I", 1) + b"\x10\x20\x30\x40"
                payload += b"\xAA\xBB\xCC\xDD" + struct.pack(
                    ">HHHH", 4, 5, 6, 7)
                self.update([self.rect(0, 0, 48, 32, 2, payload)])

    el = _connect(Srv(), version="3.8")
    f1 = el.pull_frame()
    np.testing.assert_array_equal(f1, raw)
    f2 = el.pull_frame()
    want = np.tile(np.frombuffer(b"\x10\x20\x30\x40", np.uint8),
                   (32, 48, 1))
    want[5:12, 4:10] = np.frombuffer(b"\xAA\xBB\xCC\xDD", np.uint8)
    np.testing.assert_array_equal(f2, want)
    # the update requests carried the incremental flag + full rect
    assert el.client.inited
    assert Srv  # silence lint


def test_corre_copyrect_and_hextile():
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 256, (32, 48, 4), dtype=np.uint8)
    tile = rng.integers(0, 256, (16, 16, 4), dtype=np.uint8)

    class Srv(MockServer):
        def on_update_request(self, req):
            n = len(self.update_requests)
            if n == 1:
                self.update([self.rect(0, 0, 48, 32, 0,
                                       raw.tobytes())])
            elif n == 2:
                # CoRRE: bg + u8-coord subrect
                payload = struct.pack(">I", 1) + b"\x01\x02\x03\x04"
                payload += b"\x0A\x0B\x0C\x0D" + bytes([2, 3, 4, 5])
                # copyrect: move the raw's top-left 8x8 to (40, 24)
                cr = struct.pack(">HH", 0, 0)
                self.update([
                    self.rect(0, 0, 48, 32, 4, payload),
                    self.rect(40, 24, 8, 8, 1, cr)])
            else:
                # hextile 48x32 = 3x2 tiles: tile0 raw, tile1
                # bg+fg+2 uncolored subrects, tile2 colored subrect,
                # rest bg-only carried over
                p = b"\x01" + tile.tobytes()            # raw
                p += bytes([SUB := 0x02 | 0x04 | 0x08])  # bg+fg+rects
                p += b"\x11\x11\x11\x11" + b"\x22\x22\x22\x22"
                p += bytes([2, 0x00, 0x11, 0x23, 0x10])
                p += b"\x10"[0:0]
                p += bytes([0x10 | 0x08])  # colored subrects, keep bg
                p += bytes([1]) + b"\x33\x33\x33\x33" \
                    + bytes([0x00, 0x00])
                p += b"\x00" * 3           # three bg-only tiles
                self.update([self.rect(0, 0, 48, 32, 5, p)])

    el = _connect(Srv(), version="3.8", **{"use-copyrect": True})
    assert el.client.use_copyrect
    f1 = el.pull_frame()
    np.testing.assert_array_equal(f1, raw)

    f2 = el.pull_frame()
    want = np.tile(np.frombuffer(b"\x01\x02\x03\x04", np.uint8),
                   (32, 48, 1))
    want[3:8, 2:6] = np.frombuffer(b"\x0A\x0B\x0C\x0D", np.uint8)
    want[24:32, 40:48] = f1[0:8, 0:8]   # copyrect from prev frame
    np.testing.assert_array_equal(f2, want)

    f3 = el.pull_frame()
    want3 = np.zeros((32, 48, 4), np.uint8)
    want3[0:16, 0:16] = tile
    bg = np.frombuffer(b"\x11\x11\x11\x11", np.uint8)
    fg = np.frombuffer(b"\x22\x22\x22\x22", np.uint8)
    want3[0:16, 16:32] = bg
    # subrect 1: xy=0x00 wh=0x11 -> (0,0) 2x2; subrect 2: xy=0x23
    # wh=0x10 -> (2,3) 2x1 (all relative to tile origin x=16)
    want3[0:2, 16:18] = fg
    want3[3:4, 18:20] = fg
    want3[0:16, 32:48] = bg             # colored-subrect tile keeps bg
    want3[0:1, 32:33] = np.frombuffer(b"\x33\x33\x33\x33", np.uint8)
    want3[16:32, 0:48] = bg             # bg persists across tiles
    np.testing.assert_array_equal(f3, want3)


def test_format_from_masks():
    assert rfb.format_from_masks(32, False, 16, 8, 0) == "BGRx"
    assert rfb.format_from_masks(32, False, 0, 8, 16) == "RGBx"
    assert rfb.format_from_masks(32, False, 8, 16, 24) == "xRGB"
    assert rfb.format_from_masks(32, True, 16, 8, 0) == "xRGB"
    assert rfb.format_from_masks(24, False, 16, 8, 0) == "BGR"
    assert rfb.format_from_masks(24, False, 0, 8, 16) == "RGB"


def test_offset_cropping():
    """offset-x/y + width/height crop the requested rectangle and the
    incoming coordinates (rfbdecoder.c:700-742, update x -= offset)."""
    raw = np.arange(16 * 16 * 4, dtype=np.uint8).reshape(16, 16, 4)

    class Srv(MockServer):
        def on_update_request(self, req):
            # the request rect reflects the crop
            assert req[2:] == (8, 4, 16, 16)
            self.update([self.rect(8, 4, 16, 16, 0, raw.tobytes())])

    el = _connect(Srv(), version="3.8", **{"offset-x": 8,
                                           "offset-y": 4,
                                           "width": 16, "height": 16})
    c = el.client
    assert (c.rect_width, c.rect_height) == (16, 16)
    f = el.pull_frame()
    np.testing.assert_array_equal(f, raw)


def test_security_failure_reason():
    """3.3 security type 0 -> the server reason string surfaces as the
    error (rfb_decoder_state_reason)."""
    class Srv(MockServer):
        def _consume(self):
            if self._stage == "version" and len(self._pending) >= 12:
                self._pending = self._pending[12:]
                reason = b"too many clients"
                self.out += struct.pack(">I", 0)
                self.out += struct.pack(">I", len(reason)) + reason
                self._stage = "dead"
                return
            super()._consume()

    srv = Srv(version=b"RFB 003.003\n")
    with pytest.raises(rfb.RfbError, match="too many clients"):
        _connect(srv, version="3.3")
