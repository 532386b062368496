"""ccconverter cross-framerate engine (gstccconverter.c) — host-side
byte-level spec, the golden for the element's device mirror.

Implements the reference's full buffer flow for framerate-converting
caption streams (only possible when CDP is on at least one side of the
conversion, per the caps code at gstccconverter.c:131-270):

- the (input_frames / in_fps) vs (output_frames / out_fps) fraction
  comparison driving store/emit decisions (fit_and_scale_cc_data,
  gstccconverter.c:866-1035) including the cycle reset at equality and
  the counter seeds from reset_counters (input_frames 0,
  output_frames 1 — gstccconverter.c:2333-2342);
- the scratch carry (store_cc_data / copy_from_stored_data) with the
  overflow split preferring field-1 data (the "may not be quite
  correct" comment is part of the spec);
- combine_cc_data's 0xfc/0xfd interleave and the 0xf8/0xf9 0x80 0x80
  even-padding walk;
- the per-path presence of the (ccp, cea608-1, cea608-2) buffers
  exactly as each convert_* function passes them;
- compact_cc_data's quirks: `cc_type & 0x10` is always false for a
  2-bit type, so started_ccp never latches and the "cea608 bytes after
  cea708" error is dead code — valid triplets are copied through in
  order regardless (gstccconverter.c:600-648);
- cc_data_to_cea608_ccp's over-limit truncation whose nested repeat of
  the same condition makes the proportional-split else-branch dead:
  too many cea608 pairs always become 2*max field-1 bytes and zero
  field-2 bytes (gstccconverter.c:1425-1439);
- the basetransform generate_output loop: one transform() with the
  input buffer, then transform(None) while can_generate_output()
  (gstccconverter.c:2303-2330, 2391-2442), and drain_input's
  move-along input_frames bump on empty outputs.

Timecode sections are neither parsed into state nor written (this
framework carries PTS, not SMPTE timecodes — same documented
divergence as the fixed-rate element path).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from gstbad.io.cea608 import CDP_FPS_TABLE

MAX_CDP_PACKET_LEN = 256
MAX_CEA608_LEN = 32

# (fps_n, fps_d) -> (fps_idx, max_cc_count, max_ccp_count,
#                    max_cea608_count)   (gstccconverter.c:483-492)
FPS_ENTRIES = {
    (24000, 1001): (0x1F, 25, 22, 3),
    (24, 1): (0x2F, 25, 22, 2),
    (25, 1): (0x3F, 24, 22, 2),
    (30000, 1001): (0x4F, 20, 18, 2),
    (30, 1): (0x5F, 20, 18, 2),
    (50, 1): (0x6F, 12, 11, 1),
    (60000, 1001): (0x7F, 10, 9, 1),
    (60, 1): (0x8F, 10, 9, 1),
}


def compact_cc_data(cc: bytes) -> bytes:
    """gstccconverter.c:600-648 (see module doc for the dead checks)."""
    cc = cc[:len(cc) - (len(cc) % 3)]
    out = bytearray()
    for i in range(0, len(cc), 3):
        if cc[i] & 0x04:
            out += cc[i:i + 3]
    return bytes(out)


def cc_data_extract_cea608(cc: bytes) -> Tuple[int, bytes, bytes]:
    """gstccconverter.c:651-719: leading 608 triplets -> field pairs;
    returns (ccp_offset, field1, field2)."""
    cc = cc[:len(cc) - (len(cc) % 3)]
    f1, f2 = bytearray(), bytearray()
    i = 0
    while i < len(cc) // 3:
        valid = (cc[i * 3] & 0x04) == 0x04
        typ = cc[i * 3] & 0x03
        if typ == 0x00:
            if valid:
                f1 += cc[i * 3 + 1:i * 3 + 3]
        elif typ == 0x01:
            if valid:
                f2 += cc[i * 3 + 1:i * 3 + 3]
        else:
            break
        i += 1
    return i * 3, bytes(f1), bytes(f2)


class CCConverterEngine:
    """One caption stream's converter state (the GstCCConverter
    instance analog).  push(data) -> list of output packets (possibly
    empty); push(None) is a generate tick; drain() flushes at EOS."""

    def __init__(self, in_type: str, out_type: str,
                 in_fps: Tuple[int, int], out_fps: Tuple[int, int]):
        assert in_type in ("raw", "s334-1a", "cc-data", "cdp")
        assert out_type in ("raw", "s334-1a", "cc-data", "cdp")
        assert in_type != out_type or in_type == "cdp"
        self.in_type = in_type
        self.out_type = out_type
        self.in_fps = in_fps
        self.out_fps = out_fps
        self.in_entry = FPS_ENTRIES.get(in_fps)
        self.out_entry = FPS_ENTRIES.get(out_fps)
        # non-CDP ends fall back to the other side's entry
        # (gstccconverter.c:2121-2123 etc.)
        if self.in_entry is None:
            assert in_type != "cdp" or self.out_entry is not None
            self.in_entry = self.out_entry
        if self.out_entry is None:
            self.out_entry = self.in_entry
        assert self.in_entry is not None
        self.cdp_hdr_sequence_cntr = 0
        self.reset()

    def reset(self):
        """reset_counters (gstccconverter.c:2333-2342)."""
        self.scratch_ccp = b""
        self.scratch_c1 = b""
        self.scratch_c2 = b""
        self.input_frames = 0
        self.output_frames = 1
        self.have_previous = False

    # -- counters ----------------------------------------------------------

    def _time_cmp(self) -> int:
        """sign of input_frames/in_fps - output_frames/out_fps."""
        a = self.input_frames * self.in_fps[1] * self.out_fps[0]
        b = self.output_frames * self.out_fps[1] * self.in_fps[0]
        return (a > b) - (a < b)

    def can_generate_output(self) -> bool:
        if self.in_fps[0] == 0 or self.out_fps[0] == 0:
            return False
        return self._time_cmp() >= 0

    # -- core (fit_and_scale_cc_data) --------------------------------------

    def _fit_and_scale(self, ccp: Optional[bytes], c1: Optional[bytes],
                       c2: Optional[bytes]):
        """Returns (emit, ccp, c1, c2) with scratch updated.  None
        means the caller did not pass that buffer (its extra bytes are
        dropped from the split exactly as the C's NULL pointers)."""
        in_e, out_e = self.in_entry, self.out_entry
        if in_e[1] == out_e[1]:                  # same max_cc_count
            self.scratch_ccp = b""
            self.scratch_c1 = b""
            self.scratch_c2 = b""
            self.input_frames = 0
            self.output_frames = 0
            return True, ccp, c1, c2
        cmp = self._time_cmp()
        if cmp < 0:
            # store everything, no output yet
            self._store(ccp or b"", c1 or b"", c2 or b"")
            return False, b"" if ccp is not None else None, \
                b"" if c1 is not None else None, \
                b"" if c2 is not None else None
        if cmp == 0:
            # cycle completed: reset counters
            self.scratch_ccp = b""
            self.scratch_c1 = b""
            self.scratch_c2 = b""
            self.input_frames = 0
            self.output_frames = 0
        extra_ccp = extra_c1 = extra_c2 = 0
        ccp_off = c1_off = c2_off = 0
        if ccp is not None:
            extra_ccp = max(0, len(ccp) - 3 * out_e[2])
            ccp_off = len(ccp) - extra_ccp
        if c1 is not None:
            extra_c1 = max(0, len(c1) - 2 * out_e[3])
            c1_off = len(c1) - extra_c1
        if c2 is not None:
            if extra_c1 > 0:
                extra_c2 = len(c2)
                c2_off = 0
            elif c1 is not None:
                extra_c2 = max(0, len(c1) + len(c2) - 2 * out_e[3])
                c2_off = len(c2) - extra_c2
            else:
                extra_c2 = max(0, len(c2) - 2 * out_e[3])
                c2_off = len(c2) - extra_c2
        if extra_ccp > 0 or extra_c1 > 0 or extra_c2 > 0:
            self._store(ccp[ccp_off:] if ccp else b"",
                        c1[c1_off:] if c1 else b"",
                        c2[c2_off:] if c2 else b"")
            if ccp is not None:
                ccp = ccp[:ccp_off]
            if c1 is not None:
                c1 = c1[:c1_off]
            if c2 is not None:
                c2 = c2[:c2_off]
        else:
            self.scratch_ccp = b""
            self.scratch_c1 = b""
            self.scratch_c2 = b""
        return True, ccp, c1, c2

    def _store(self, ccp: bytes, c1: bytes, c2: bytes):
        self.scratch_ccp = bytes(ccp)
        self.scratch_c1 = bytes(c1)
        self.scratch_c2 = bytes(c2)

    # -- combine + cdp write (combine_cc_data,
    #    convert_cea708_cc_data_cea708_cdp_internal) ------------------------

    def _combine(self, pad_cea608: bool, ccp: bytes, c1: bytes,
                 c2: bytes) -> bytes:
        out_e = self.out_entry
        n1 = len(c1) // 2
        n2 = len(c2) // 2
        assert n1 + n2 <= out_e[3]
        total1, total2 = n1, n2
        count = n1 + n2
        if pad_cea608:
            i = total1 + total2
            while i < out_e[3]:
                if i > n1 // 2:
                    total1 += 1
                else:
                    total2 += 1
                count += 1
                i += 1
        out = bytearray()
        i1 = i2 = 0
        while i1 + i2 < count:
            if i1 < n1:
                out += bytes([0xFC, c1[i1 * 2], c1[i1 * 2 + 1]])
                i1 += 1
            elif i1 < total1:
                out += bytes([0xF8, 0x80, 0x80])
                i1 += 1
            if i2 < n2:
                out += bytes([0xFD, c2[i2 * 2], c2[i2 * 2 + 1]])
                i2 += 1
            elif i2 < total2:
                out += bytes([0xF9, 0x80, 0x80])
                i2 += 1
        return bytes(out) + ccp

    def _write_cdp(self, cc_data: bytes) -> bytes:
        fps_idx, max_cc = self.out_entry[0], self.out_entry[1]
        cc_data = cc_data[:3 * max_cc]
        out = bytearray()
        out += b"\x96\x69"
        out.append(0)                       # length, patched below
        out.append(fps_idx)
        out.append(0x02 | 0x40 | 0x01)      # svc_active|ccdata|reserved
        out.append((self.cdp_hdr_sequence_cntr >> 8) & 0xFF)
        out.append(self.cdp_hdr_sequence_cntr & 0xFF)
        out.append(0x72)
        out.append(0xE0 | max_cc)
        out += cc_data
        pad = max_cc - len(cc_data) // 3
        out += b"\xfa\x00\x00" * pad
        out.append(0x74)
        out.append((self.cdp_hdr_sequence_cntr >> 8) & 0xFF)
        out.append(self.cdp_hdr_sequence_cntr & 0xFF)
        self.cdp_hdr_sequence_cntr = \
            (self.cdp_hdr_sequence_cntr + 1) & 0xFFFF
        out.append(0)
        out[2] = len(out)
        checksum = (256 - (sum(out) & 0xFF)) & 0xFF
        out[-1] = checksum
        return bytes(out)

    def _parse_cdp(self, cdp: bytes) -> Optional[bytes]:
        """convert_cea708_cdp_cea708_cc_data_internal
        (gstccconverter.c:1155-1299), timecode section skipped."""
        if len(cdp) < 11 or cdp[0] != 0x96 or cdp[1] != 0x69 \
                or cdp[2] != len(cdp):
            return None
        if cdp[3] not in [e[0] for e in FPS_ENTRIES.values()]:
            return None
        flags = cdp[4]
        if not flags & 0x40:
            return None
        pos = 7
        if flags & 0x80:
            if len(cdp) - pos < 5 or cdp[pos] != 0x71:
                return None
            pos += 5
        if len(cdp) - pos < 2 or cdp[pos] != 0x72:
            return None
        cc_count = cdp[pos + 1]
        if (cc_count & 0xE0) != 0xE0:
            return None
        cc_count &= 0x1F
        pos += 2
        if len(cdp) - pos < cc_count * 3:
            return None
        return cdp[pos:pos + cc_count * 3]

    # -- per-path transform (convert_* functions) --------------------------

    def _transform(self, inbuf: Optional[bytes]) -> Optional[bytes]:
        """One transform() call.  Returns the output packet or None
        (empty output)."""
        it, ot = self.in_type, self.out_type
        in_e = self.in_entry

        # assemble (ccp, c1, c2) per path, including scratch prepend
        want_ccp = it in ("cc-data", "cdp") and ot in ("cc-data", "cdp")
        want_c2 = it != "raw" and ot != "raw"
        ccp = self.scratch_ccp if want_ccp else None
        c1 = self.scratch_c1
        c2 = self.scratch_c2 if want_c2 else None

        if inbuf is not None:
            self.input_frames += 1
            if it == "raw":
                n = (len(inbuf) // 2) * 2
                n = min(n, in_e[3] * 2)
                c1 = c1 + inbuf[:n]
            elif it == "s334-1a":
                n = len(inbuf) - (len(inbuf) % 3)
                n = min(n // 3, in_e[3])
                a1, a2 = bytearray(), bytearray()
                for i in range(n):
                    if inbuf[i * 3] & 0x80:
                        a1 += inbuf[i * 3 + 1:i * 3 + 3]
                    else:
                        a2 += inbuf[i * 3 + 1:i * 3 + 3]
                c1 = c1 + bytes(a1)
                c2 = (c2 or b"") + bytes(a2) if want_c2 else c2
            else:
                if it == "cdp":
                    # an unparseable CDP still consumes the frame and
                    # converts whatever is in scratch (the reference
                    # increments input_frames before the parse and
                    # passes a zero-length cc_data through)
                    cc = self._parse_cdp(inbuf) or b""
                else:
                    cc = inbuf
                cc = compact_cc_data(cc)
                cc = cc[:3 * in_e[1]]
                off, n1, n2 = cc_data_extract_cea608(cc)
                if (len(n1) + len(n2)) // 2 > in_e[3]:
                    # dead-else truncation quirk (module doc)
                    n1 = n1[:2 * in_e[3]]
                    n2 = b""
                c1 = c1 + n1
                if want_c2:
                    c2 = (c2 or b"") + n2
                if want_ccp:
                    ccp = (ccp or b"") + cc[off:]

        emit, ccp, c1, c2 = self._fit_and_scale(ccp, c1, c2)
        if not emit:
            return None

        if ot == "cdp":
            cc_data = self._combine(True, ccp or b"", c1 or b"", c2 or b"")
            out = self._write_cdp(cc_data)
            self.output_frames += 1
            return out
        if ot == "raw":
            # cdp -> raw: field-1 pairs straight out
            self.output_frames += 1
            return c1 or b""
        if ot == "s334-1a":
            cc_data = self._combine(False, b"", c1 or b"", c2 or b"")
            out = bytearray(cc_data)
            for i in range(0, len(out), 3):
                out[i] = 0x80 if out[i] == 0xFC else 0x00
            self.output_frames += 1
            return bytes(out)
        # cc-data out
        cc_data = self._combine(False, ccp or b"", c1 or b"", c2 or b"")
        self.output_frames += 1
        return cc_data

    # -- public stream API -------------------------------------------------

    def push(self, inbuf: Optional[bytes]) -> List[bytes]:
        """Feed one input buffer (the generate_output loop): transform
        with the buffer, then transform(None) while output is due.

        When the two fps entries share max_cc_count the conversion is
        1:1 and no extra outputs are generated.  (The reference's
        fit_and_scale zeroes both frame counters on that branch, which
        leaves can_generate_output() stuck TRUE — a literal reading of
        gstccconverter.c:884-905 + 2303-2330 generates padding packets
        forever.  The intended 1:1 behavior is implemented instead;
        divergence documented.)"""
        outs = []
        out = self._transform(inbuf)
        self.have_previous = True
        if out is not None:
            outs.append(out)
        if self.in_entry[1] == self.out_entry[1]:
            return outs
        while self.can_generate_output():
            out = self._transform(None)
            if out is None:
                break
            outs.append(out)
        return outs

    def drain(self) -> List[bytes]:
        """drain_input (gstccconverter.c:2344-2389)."""
        outs = []
        if self.in_entry[1] == self.out_entry[1]:
            return outs                      # 1:1, nothing buffered
        while (self.scratch_ccp or self.scratch_c1 or self.scratch_c2
               or self.can_generate_output()):
            if not self.have_previous:
                return outs
            out = self._transform(None)
            if out is None or len(out) == 0:
                self.input_frames += 1       # move the output along
                continue
            outs.append(out)
        return outs
