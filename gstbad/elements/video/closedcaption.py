"""Closed-caption elements (ext/closedcaption/): line21encoder,
line21decoder, cccombiner, ccextractor.

Caption bytes travel as a `"cc"` auxiliary plane on planar video batches:
[B, 6] u8 in the CEA-608 S334-1A layout the reference uses for caption
meta (two triplets: field byte with 0x80 = field 1 + 5-bit line offset,
then the two parity-carrying data bytes — gstline21dec.c:533-556).  The
reference moves the same bytes as GstVideoCaptionMeta on the buffers;
elements that rebuild plane dicts wholesale pass the plane through.

line21encoder (gstline21enc.c): I420-family 720x525/486 interleaved;
renders both field waveforms (golden/line21.py, the io-sim.c math) into
luma rows 21/22 (height 525) or 1/2 (reduced height, gstline21enc.c:520).
line21decoder (gstline21dec.c): probes the first max-line-probes=40 rows
for a pair of consecutive CC lines, attaches the S334-1A bytes + posts a
`line21` message; modes disabled/add/drop/replace.  The zvbi adaptive
bit slicer is replaced by the deterministic mid-range slicer in
ops/line21.py (round-trip bit-exact; documented divergence).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from gstbad.core.element import Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import VideoFormat, require
from gstbad.ops import line21 as l21ops

MAX_LINE_PROBES = 40     # gstline21dec.c:230


def _vbi_row(height: int) -> int:
    """Field-1 waveform row (gstline21enc.c:517-520)."""
    return 21 if height == 525 else 1


@register
class CcCombiner(Element):
    """cccombiner (gstcccombiner.c): attach a caption stream's bytes to
    the video frames.  Inputs: [video(planar), captions([B, 6] u8
    S334-1A)]; output video gains the "cc" plane."""

    NAME = "cccombiner"
    N_INPUTS = 2

    def negotiate(self, in_spec):
        require(isinstance(in_spec, list) and len(in_spec) == 2,
                "cccombiner: needs (video, captions) inputs")
        video, _cap = in_spec
        require(video.kind == "video", "cccombiner: first input is video")
        self._planar = video.format in (VideoFormat.I420, "I420")
        require(self._planar or isinstance(video.format, str),
                "cccombiner: video input required")
        return video

    def process(self, params, state, batches):
        video, caps = batches
        cc = caps.data
        if cc.ndim == 3:            # [B, 2, 3] triplets -> [B, 6]
            cc = cc.reshape(cc.shape[0], -1)
        require(isinstance(video.data, dict),
                "cccombiner: planar video required (use videoconvert "
                "format=I420)")
        return state, video.with_data({**video.data,
                                       "cc": cc.astype(jnp.uint8)})


@register
class CcExtractor(Element):
    """ccextractor (gstccextractor.c): split caption meta off the video.
    The caption bytes post as per-frame `cc-data` messages (the caption
    source pad analog); remove-caption-meta drops the "cc" plane from the
    video output (gstccextractor.c property of the same name)."""

    NAME = "ccextractor"
    PROPERTIES = (
        Property("remove-caption-meta", bool, False, static=True),
    )

    def negotiate(self, in_spec):
        require(in_spec.kind == "video", "ccextractor: needs video")
        return in_spec

    def process(self, params, state, batch: FrameBatch):
        if not isinstance(batch.data, dict) or "cc" not in batch.data:
            return state, batch
        cc = batch.data["cc"]
        msgs = {"cc-data": {"data": cc,
                            "_emit": jnp.ones(batch.batch, bool)}}
        out = batch
        if self.props["remove-caption-meta"]:
            out = batch.with_data(
                {k: v for k, v in batch.data.items() if k != "cc"})
        return state, out, msgs


@register
class Line21Encoder(Element):
    """line21encoder (gstline21enc.c)."""

    NAME = "line21encoder"
    PROPERTIES = (
        Property("remove-caption-meta", bool, False, static=True),
    )

    def negotiate(self, in_spec):
        require(in_spec.kind == "video"
                and in_spec.format == VideoFormat.I420,
                "line21encoder: needs I420 (use videoconvert)")
        require(in_spec.width == 720,
                "line21encoder: only 720 pixel wide formats are supported"
                " (gstline21enc.c:49)")
        require(in_spec.height in (525, 486),
                "line21encoder: height must be 525 or 486")
        return in_spec

    def process(self, params, state, batch: FrameBatch):
        data = batch.data
        b = batch.batch
        if "cc" in data:
            cc = data["cc"].astype(jnp.int32)          # [B, 6] S334-1A
            f1_sel = (cc[:, 0] & 0x80) != 0
            t1 = cc[:, 1:3]
            t2_is_f1 = (cc[:, 3] & 0x80) != 0
            t2 = cc[:, 4:6]
            pad = jnp.full((b, 2), 0x80, jnp.int32)    # gstline21enc.c:446
            f1 = jnp.where(f1_sel[:, None], t1,
                           jnp.where(t2_is_f1[:, None], t2, pad))
            f2 = jnp.where(~t2_is_f1[:, None], t2,
                           jnp.where(~f1_sel[:, None], t1, pad))
        else:
            f1 = f2 = jnp.full((b, 2), 0x80, jnp.int32)
        wave1 = l21ops.encode_lines(f1.astype(jnp.uint8))
        wave2 = l21ops.encode_lines(f2.astype(jnp.uint8))
        row = _vbi_row(self.out_spec.height)
        y = data["y"]
        y = y.at[:, row, :].set(wave1)
        y = y.at[:, row + 1, :].set(wave2)
        out = {**data, "y": y}
        if self.props["remove-caption-meta"]:
            out.pop("cc", None)
        return state, batch.with_data(out)


@register
class Line21Decoder(Element):
    """line21decoder (gstline21dec.c)."""

    NAME = "line21decoder"
    PROPERTIES = (
        Property("mode", str, "add", static=True,
                 doc="disabled | add | drop | replace "
                     "(gstline21dec.c:76-101)"),
        Property("ntsc-only", bool, False, static=True),
    )

    def negotiate(self, in_spec):
        require(in_spec.kind == "video"
                and in_spec.format == VideoFormat.I420,
                "line21decoder: needs I420 (use videoconvert)")
        self._compatible = in_spec.width == 720 and in_spec.height >= 200
        if self.props["ntsc-only"]:
            self._compatible &= in_spec.height in (525, 486)
        return in_spec

    def process(self, params, state, batch: FrameBatch):
        mode = self.props["mode"]
        has_meta = isinstance(batch.data, dict) and "cc" in batch.data
        if (not self._compatible or mode == "disabled"
                or (mode == "drop" and has_meta)):
            return state, batch
        y = batch.data["y"]
        b, h, _ = y.shape
        n = min(MAX_LINE_PROBES, h - 1)
        rows = y[:, :n + 1, :]
        found, pairs = l21ops.decode_lines(rows)       # [B, n+1], [.., 2]
        both = found[:, :n] & found[:, 1:n + 1]        # consecutive pair
        hit = both.any(axis=1)
        off = jnp.argmax(both, axis=1).astype(jnp.int32)
        f1 = jnp.take_along_axis(pairs, off[:, None, None], 1)[:, 0]
        f2 = jnp.take_along_axis(pairs, (off + 1)[:, None, None], 1)[:, 0]
        # S334-1A bytes incl. the line-offset fields (gstline21dec.c:550)
        base1 = 9 if h == 525 else (5 if h == 625 else 0)
        base2 = 272 if h == 525 else (318 if h == 625 else 0)
        o1 = jnp.where(off > base1, off - base1, 0) & 0x1F
        o2 = jnp.where(off > base2, off - base2, 0) & 0x1F
        cc = jnp.stack([
            (0x80 | o1), f1[:, 0].astype(jnp.int32), f1[:, 1].astype(
                jnp.int32),
            o2, f2[:, 0].astype(jnp.int32), f2[:, 1].astype(jnp.int32),
        ], axis=1).astype(jnp.uint8)
        blank = jnp.tile(jnp.asarray(
            [0x80, 0x80, 0x80, 0x00, 0x80, 0x80], jnp.uint8), (b, 1))
        cc = jnp.where(hit[:, None], cc, blank)
        out = dict(batch.data)
        if has_meta and mode == "add":
            pass                                   # keep the existing meta
        else:
            out["cc"] = cc
        msgs = {"line21": {"cc": cc, "_emit": hit}}
        return state, batch.with_data(out), msgs


@register
class CcConverter(Element):
    """ccconverter (gstccconverter.c): convert the caption representation
    between raw CEA-608 pairs, S334-1A triplets, CEA-708 cc_data and CDP
    packets.  The reference negotiates the types via caps; here
    input-type/output-type properties pick them, and io/cea608.py holds
    the byte-level spec (this element is its vectorized in-graph mirror
    for the fixed-size window layout).  CDP packets carry the running
    cdp_hdr_sequence_cntr as element state and the additive checksum
    (gstccconverter.c:1137-1152); timecode sections are skipped on input
    and never written (we have PTS, not SMPTE timecodes — documented)."""

    NAME = "ccconverter"
    PROPERTIES = (
        Property("input-type", str, "s334-1a", static=True,
                 doc="raw | s334-1a | cc-data | cdp"),
        Property("output-type", str, "cdp", static=True),
        Property("output-framerate", str, "", static=True,
                 doc="N/D target rate; enables the cross-framerate "
                     "buffering engine (io/ccconv.py is the byte-level "
                     "spec).  Needs CDP on at least one side "
                     "(gstccconverter.c:131-270) and a standalone "
                     "[B, W] caption stream, not a video cc plane "
                     "(the video itself is not resampled here)."),
    )

    def _fps(self):
        from gstbad.io.cea608 import CDP_FPS_TABLE
        fr = self.out_spec.framerate
        key = (fr.numerator, fr.denominator)
        require(key in CDP_FPS_TABLE,
                f"ccconverter: no CDP framerate entry for {fr} "
                "(gstccconverter.c:483-492)")
        return CDP_FPS_TABLE[key]

    def negotiate(self, in_spec):
        import dataclasses
        import fractions as _fr
        for p in ("input-type", "output-type"):
            require(self.props[p] in ("raw", "s334-1a", "cc-data", "cdp"),
                    f"ccconverter: bad {p} {self.props[p]!r}")
        self._xr = False
        of = self.props["output-framerate"]
        if of:
            from gstbad.io.ccconv import FPS_ENTRIES
            it, ot = self.props["input-type"], self.props["output-type"]
            num, den = ([int(x) for x in of.split("/")] if "/" in of
                        else [int(of), 1])
            infr = in_spec.framerate
            self._in_fps = (infr.numerator, infr.denominator)
            self._out_fps = (num, den)
            if self._in_fps == self._out_fps:
                return in_spec           # nothing to convert
            require(it == "cdp" or ot == "cdp",
                    "ccconverter: framerate conversion needs CDP on one "
                    "side (gstccconverter.c:131-270)")
            in_e = FPS_ENTRIES.get(self._in_fps)
            out_e = FPS_ENTRIES.get(self._out_fps)
            require(it != "cdp" or in_e is not None,
                    f"ccconverter: {infr} is not a CDP framerate")
            require(ot != "cdp" or out_e is not None,
                    f"ccconverter: {of} is not a CDP framerate")
            self._in_e = in_e or out_e
            self._out_e = out_e or in_e
            ratio = _fr.Fraction(num, den) / _fr.Fraction(*self._in_fps)
            # equal max_cc_count entries convert 1:1 (no generate loop)
            self._slots = 1 if self._in_e[1] == self._out_e[1] \
                else int(np.ceil(ratio)) + 1
            self._xr = True
            return dataclasses.replace(
                in_spec, framerate=_fr.Fraction(num, den))
        return in_spec

    def init_state(self, window: int):
        if getattr(self, "_xr", False):
            return {
                "seq": jnp.int32(0),
                "inf": jnp.int64(0),
                "outf": jnp.int64(1),     # reset_counters seeds 1
                "sc_ccp": jnp.zeros(384, jnp.int32),
                "sc_ccp_len": jnp.int32(0),
                "sc_c1": jnp.zeros(64, jnp.int32),
                "sc_c1_len": jnp.int32(0),
                "sc_c2": jnp.zeros(64, jnp.int32),
                "sc_c2_len": jnp.int32(0),
            }
        return jnp.int32(0)      # cdp_hdr_sequence_cntr

    # -- the fixed-2-triplet vectorized transforms -------------------------

    def _to_s334(self, cc, kind):
        b = cc.shape[0]
        cc = cc.astype(jnp.int32)
        if kind == "s334-1a":
            return cc
        if kind == "raw":                    # field-1 pairs
            n = cc.shape[1] // 2
            out = jnp.zeros((b, 3 * n), jnp.int32)
            for i in range(n):
                out = out.at[:, 3 * i].set(0x80)
                out = out.at[:, 3 * i + 1].set(cc[:, 2 * i])
                out = out.at[:, 3 * i + 2].set(cc[:, 2 * i + 1])
            return out
        if kind == "cc-data":
            n = cc.shape[1] // 3
            out = jnp.zeros((b, 3 * n), jnp.int32)
            for i in range(n):
                hdr = cc[:, 3 * i]
                valid = (hdr & 0x04) == 0x04
                typ = hdr & 0x03
                f1 = valid & (typ == 0)
                out = out.at[:, 3 * i].set(jnp.where(f1, 0x80, 0x00))
                keep = valid & (typ <= 1)
                out = out.at[:, 3 * i + 1].set(
                    jnp.where(keep, cc[:, 3 * i + 1], 0x80))
                out = out.at[:, 3 * i + 2].set(
                    jnp.where(keep, cc[:, 3 * i + 2], 0x80))
            return out
        # cdp: flags at byte 4; cc_data section starts at 9 (no timecode)
        # or 14 (timecode present) — select per frame
        flags = cc[:, 4]
        has_tc = (flags & 0x80) != 0
        base = jnp.where(has_tc, 14, 9).astype(jnp.int32)
        n = 2
        out = jnp.zeros((b, 3 * n), jnp.int32)
        idx = (base[:, None]
               + jnp.arange(3 * n, dtype=jnp.int32)[None, :])
        trips = jnp.take_along_axis(cc, idx, axis=1)
        for i in range(n):
            hdr = trips[:, 3 * i]
            valid = (hdr & 0x04) == 0x04
            typ = hdr & 0x03
            keep = valid & (typ <= 1)
            out = out.at[:, 3 * i].set(
                jnp.where(valid & (typ == 0), 0x80, 0x00))
            out = out.at[:, 3 * i + 1].set(
                jnp.where(keep, trips[:, 3 * i + 1], 0x80))
            out = out.at[:, 3 * i + 2].set(
                jnp.where(keep, trips[:, 3 * i + 2], 0x80))
        return out

    def _from_s334(self, s334, kind, state):
        b = s334.shape[0]
        n = s334.shape[1] // 3
        if kind == "s334-1a":
            return s334, state
        if kind == "raw":
            # field-1 pairs only; non-field-1 slots pad 0x80 (fixed shape)
            out = jnp.full((b, 2 * n), 0x80, jnp.int32)
            for i in range(n):
                f1 = (s334[:, 3 * i] & 0x80) != 0
                out = out.at[:, 2 * i].set(
                    jnp.where(f1, s334[:, 3 * i + 1], 0x80))
                out = out.at[:, 2 * i + 1].set(
                    jnp.where(f1, s334[:, 3 * i + 2], 0x80))
            return out, state
        ccd = jnp.zeros((b, 3 * n), jnp.int32)
        for i in range(n):
            f1 = (s334[:, 3 * i] & 0x80) != 0
            ccd = ccd.at[:, 3 * i].set(jnp.where(f1, 0xFC, 0xFD))
            ccd = ccd.at[:, 3 * i + 1].set(s334[:, 3 * i + 1])
            ccd = ccd.at[:, 3 * i + 2].set(s334[:, 3 * i + 2])
        if kind == "cc-data":
            return ccd, state
        # cdp
        fps_idx, max_cc = self._fps()
        length = 11 + 2 + 3 * max_cc
        seqs = (state + jnp.arange(b, dtype=jnp.int32)) & 0xFFFF
        out = jnp.zeros((b, length), jnp.int32)
        out = out.at[:, 0].set(0x96).at[:, 1].set(0x69)
        out = out.at[:, 2].set(length).at[:, 3].set(fps_idx)
        out = out.at[:, 4].set(0x02 | 0x40 | 0x01)
        out = out.at[:, 5].set(seqs >> 8).at[:, 6].set(seqs & 0xFF)
        out = out.at[:, 7].set(0x72).at[:, 8].set(0xE0 | max_cc)
        out = out.at[:, 9:9 + 3 * n].set(ccd)
        pad = jnp.tile(jnp.asarray([0xFA, 0x00, 0x00], jnp.int32),
                       max_cc - n)
        out = out.at[:, 9 + 3 * n:9 + 3 * max_cc].set(pad[None, :])
        out = out.at[:, -4].set(0x74)
        out = out.at[:, -3].set(seqs >> 8).at[:, -2].set(seqs & 0xFF)
        checksum = ((256 - (jnp.sum(out, axis=1) & 0xFF)) & 0xFF
                    ).astype(jnp.int32)
        out = out.at[:, -1].set(checksum)
        return out, state + b

    # -- cross-framerate engine (device mirror of io/ccconv.py) -----------

    @staticmethod
    def _xr_pack_pairs(sel, b1, b2, size):
        """Order-preserving pack of selected (b1, b2) pairs into a flat
        byte buffer [size]; returns (buf, nbytes)."""
        pos = jnp.cumsum(sel.astype(jnp.int32)) - 1
        idx = jnp.where(sel, pos * 2, size)
        buf = jnp.zeros(size + 2, jnp.int32)
        buf = buf.at[idx].set(b1).at[idx + 1].set(b2)
        return buf[:size], 2 * jnp.sum(sel.astype(jnp.int32))

    @staticmethod
    def _xr_pack_trips(sel, trips, size):
        pos = jnp.cumsum(sel.astype(jnp.int32)) - 1
        idx = jnp.where(sel, pos * 3, size)
        buf = jnp.zeros(size + 3, jnp.int32)
        buf = buf.at[idx].set(trips[:, 0]).at[idx + 1].set(
            trips[:, 1]).at[idx + 2].set(trips[:, 2])
        return buf[:size], 3 * jnp.sum(sel.astype(jnp.int32))

    @staticmethod
    def _xr_concat(a, alen, b, blen, size):
        """out[i] = a[i] for i < alen else b[i - alen]."""
        i = jnp.arange(size, dtype=jnp.int32)
        av = jnp.take(a, jnp.clip(i, 0, a.shape[0] - 1))
        bv = jnp.take(b, jnp.clip(i - alen, 0, b.shape[0] - 1))
        return jnp.where(i < alen, av,
                         jnp.where(i < alen + blen, bv, 0)), alen + blen

    @staticmethod
    def _xr_tail(buf, off, n, size):
        """buf[off:off+n] as a [size] buffer."""
        i = jnp.arange(size, dtype=jnp.int32)
        v = jnp.take(buf, jnp.clip(i + off, 0, buf.shape[0] - 1))
        return jnp.where(i < n, v, 0)

    def _xr_parse_input(self, cc):
        """One frame's bytes [W] -> (ccp, lccp, c1, l1, c2, l2)
        (the convert_* input halves, gstccconverter.c:1476-1930)."""
        it = self.props["input-type"]
        in_max608 = self._in_e[3]
        in_maxcc = self._in_e[1]
        W = cc.shape[0]
        zero64 = jnp.zeros(64, jnp.int32)
        zero384 = jnp.zeros(384, jnp.int32)
        if it == "raw":
            n = min(W - W % 2, 2 * in_max608)
            c1 = jnp.zeros(64, jnp.int32).at[:n].set(cc[:n])
            return zero384, jnp.int32(0), c1, jnp.int32(n), \
                zero64, jnp.int32(0)
        if it == "s334-1a":
            n = min(W // 3, in_max608)
            trips = cc[:3 * n].reshape(n, 3)
            f1 = (trips[:, 0] & 0x80) != 0
            c1, l1 = self._xr_pack_pairs(f1, trips[:, 1], trips[:, 2], 64)
            c2, l2 = self._xr_pack_pairs(~f1, trips[:, 1], trips[:, 2], 64)
            return zero384, jnp.int32(0), c1, l1, c2, l2
        if it == "cdp":
            flags = cc[4]
            tc = (flags & 0x80) != 0
            base = jnp.where(tc, jnp.int32(14), jnp.int32(9))
            cnt_raw = jnp.take(cc, base - 1)
            ok = ((cc[0] == 0x96) & (cc[1] == 0x69)
                  & ((flags & 0x40) != 0)
                  & (jnp.take(cc, base - 2) == 0x72)
                  & ((cnt_raw & 0xE0) == 0xE0)
                  & (~tc | (cc[7] == 0x71)))
            ncc = jnp.where(ok, cnt_raw & 0x1F, 0)
            NMAX = 31
            idx = base + jnp.arange(3 * NMAX, dtype=jnp.int32)
            raw = jnp.take(cc, jnp.clip(idx, 0, W - 1))
            mask = jnp.arange(3 * NMAX) < 3 * ncc
            raw = jnp.where(mask, raw, 0)
            trips = raw.reshape(NMAX, 3)
            tripmask = jnp.arange(NMAX) < ncc
        else:                                    # cc-data
            NMAX = W // 3
            trips = cc[:3 * NMAX].reshape(NMAX, 3).astype(jnp.int32)
            tripmask = jnp.ones(NMAX, bool)
        # compact_cc_data: keep valid triplets in order, then truncate
        valid = tripmask & ((trips[:, 0] & 0x04) == 0x04)
        cbuf, clen = self._xr_pack_trips(valid, trips, 3 * NMAX)
        clen = jnp.minimum(clen, 3 * in_maxcc)
        ctr = cbuf[:3 * NMAX].reshape(NMAX, 3)
        cmask = jnp.arange(NMAX) < clen // 3
        # cc_data_extract_cea608: the leading 608 run
        typ = ctr[:, 0] & 0x03
        is608 = (typ <= 1) & cmask
        prefix = jnp.cumprod(is608.astype(jnp.int32)).astype(bool)
        f1sel = prefix & (typ == 0)
        f2sel = prefix & (typ == 1)
        c1, l1 = self._xr_pack_pairs(f1sel, ctr[:, 1], ctr[:, 2], 64)
        c2, l2 = self._xr_pack_pairs(f2sel, ctr[:, 1], ctr[:, 2], 64)
        # over-limit: dead-else truncation quirk (io/ccconv.py doc)
        over = (l1 + l2) // 2 > in_max608
        l1 = jnp.where(over, jnp.minimum(l1, 2 * in_max608), l1)
        l2 = jnp.where(over, 0, l2)
        n608 = jnp.sum(prefix.astype(jnp.int32))
        ccpsel = cmask & ~prefix
        ccp, lccp = self._xr_pack_trips(ccpsel, ctr, 384)
        del n608
        return ccp, lccp, c1, l1, c2, l2

    def _xr_combine_and_emit(self, ccp, lccp, c1, l1, c2, l2, seq):
        """combine_cc_data + the output writer for the negotiated
        output type.  Returns (out_bytes [OUT_W], seq')."""
        ot = self.props["output-type"]
        out_max608 = self._out_e[3]
        out_maxcc = self._out_e[1]
        if ot == "raw":
            W = 2 * out_max608
            k = jnp.arange(W, dtype=jnp.int32)
            out = jnp.where(k < l1, jnp.take(c1, jnp.clip(k, 0, 63)),
                            jnp.int32(0x80))
            return out, seq
        pad608 = ot == "cdp"
        n1 = l1 // 2
        n2 = l2 // 2
        total1, total2 = n1, n2
        if pad608:
            for i in range(out_max608):
                is_pad = i >= n1 + n2
                to1 = i > n1 // 2
                total1 = total1 + (is_pad & to1)
                total2 = total2 + (is_pad & ~to1)
        CCW = 3 * out_maxcc
        cc = jnp.zeros(CCW + 3, jnp.int32)
        for j in range(out_max608):
            p1 = j < total1
            p2 = j < total2
            pos1 = 3 * (jnp.minimum(j, total1) + jnp.minimum(j, total2))
            pos2 = pos1 + 3 * p1.astype(jnp.int32)
            real1 = j < n1
            h1 = jnp.where(real1, 0xFC, 0xF8)
            a1 = jnp.where(real1, jnp.take(c1, jnp.clip(2 * j, 0, 63)),
                           0x80)
            b1 = jnp.where(real1,
                           jnp.take(c1, jnp.clip(2 * j + 1, 0, 63)), 0x80)
            i1 = jnp.where(p1, pos1, CCW)
            cc = cc.at[i1].set(h1).at[i1 + 1].set(a1).at[i1 + 2].set(b1)
            real2 = j < n2
            h2 = jnp.where(real2, 0xFD, 0xF9)
            a2 = jnp.where(real2, jnp.take(c2, jnp.clip(2 * j, 0, 63)),
                           0x80)
            b2 = jnp.where(real2,
                           jnp.take(c2, jnp.clip(2 * j + 1, 0, 63)), 0x80)
            i2 = jnp.where(p2, pos2, CCW)
            cc = cc.at[i2].set(h2).at[i2 + 1].set(a2).at[i2 + 2].set(b2)
        base = 3 * (total1 + total2)
        k = jnp.arange(CCW, dtype=jnp.int32)
        ccpv = jnp.take(ccp, jnp.clip(k - base, 0, 383))
        in_ccp = (k >= base) & (k - base < lccp)
        cc = jnp.where(in_ccp, ccpv, cc[:CCW])
        used = base + lccp
        if ot == "cdp":
            padpat = jnp.where((k - used) % 3 == 0,
                               jnp.int32(0xFA), jnp.int32(0))
            cc = jnp.where(k >= used, padpat, cc)
            length = 13 + CCW
            out = jnp.zeros(length, jnp.int32)
            out = out.at[0].set(0x96).at[1].set(0x69)
            out = out.at[2].set(length).at[3].set(self._out_e[0])
            out = out.at[4].set(0x02 | 0x40 | 0x01)
            s = seq & 0xFFFF
            out = out.at[5].set(s >> 8).at[6].set(s & 0xFF)
            out = out.at[7].set(0x72).at[8].set(0xE0 | out_maxcc)
            out = out.at[9:9 + CCW].set(cc)
            out = out.at[length - 4].set(0x74)
            out = out.at[length - 3].set(s >> 8)
            out = out.at[length - 2].set(s & 0xFF)
            checksum = ((256 - (jnp.sum(out) & 0xFF)) & 0xFF
                        ).astype(jnp.int32)
            out = out.at[length - 1].set(checksum)
            return out, seq + 1
        if ot == "s334-1a":
            hdr = cc[0::3]
            new_hdr = jnp.where(hdr == 0xFC, jnp.int32(0x80),
                                jnp.int32(0))
            cc = cc.at[0::3].set(new_hdr)
            pad = jnp.where(k >= used, jnp.int32(0x80), cc)
            return pad, seq
        # cc-data: pad with invalid 0xFA triplets (fixed-width frames)
        padpat = jnp.where((k - used) % 3 == 0,
                               jnp.int32(0xFA), jnp.int32(0))
        cc = jnp.where(k >= used, padpat, cc)
        return cc, seq

    def _xr_slot(self, st, parsed, first, gate):
        """One transform() call (slot 0 consumes the input)."""
        want_ccp = self.props["input-type"] in ("cc-data", "cdp") \
            and self.props["output-type"] in ("cc-data", "cdp")
        want_c2 = self.props["input-type"] != "raw" \
            and self.props["output-type"] != "raw"
        in_n, in_d = self._in_fps
        out_n, out_d = self._out_fps
        ccp_in, lccp_in, c1_in, l1_in, c2_in, l2_in = parsed
        take_in = jnp.bool_(first) & gate
        lccp_in = jnp.where(take_in & want_ccp, lccp_in, 0)
        l1_in = jnp.where(take_in, l1_in, 0)
        l2_in = jnp.where(take_in & want_c2, l2_in, 0)

        inf = st["inf"] + take_in.astype(jnp.int64)
        outf = st["outf"]
        a = inf * in_d * out_n
        b = outf * out_d * in_n
        cmp_pre = jnp.sign(st["inf"] * in_d * out_n - b)
        run = gate & (jnp.bool_(first) | (cmp_pre >= 0))

        ccp_w, lccp = self._xr_concat(st["sc_ccp"], st["sc_ccp_len"],
                                      ccp_in, lccp_in, 384)
        c1_w, l1 = self._xr_concat(st["sc_c1"], st["sc_c1_len"],
                                   c1_in, l1_in, 64)
        c2_w, l2 = self._xr_concat(st["sc_c2"], st["sc_c2_len"],
                                   c2_in, l2_in, 64)
        if not want_ccp:
            lccp = jnp.int32(0)
        if not want_c2:
            l2 = jnp.int32(0)

        if self._in_e[1] == self._out_e[1]:
            # equal max_cc_count: 1:1, no buffering (fit_and_scale's
            # first branch; counters pinned)
            emit = run
            le_ccp, le_1, le_2 = lccp, l1, l2
            sccp_n, sc1_n, sc2_n = ccp_w, c1_w, c2_w
            lsccp = jnp.int32(0)
            lsc1 = jnp.int32(0)
            lsc2 = jnp.int32(0)
            inf_out = jnp.int64(0)
            outf_out = jnp.int64(0)
        else:
            cmp = jnp.sign(a - b)
            emit = run & (cmp >= 0)
            cyc = run & (cmp == 0)
            inf = jnp.where(cyc, 0, inf)
            outf = jnp.where(cyc, 0, outf)
            extra_ccp = jnp.maximum(0, lccp - 3 * self._out_e[2])
            ccp_off = lccp - extra_ccp
            extra_1 = jnp.maximum(0, l1 - 2 * self._out_e[3])
            c1_off = l1 - extra_1
            # field-2 split (the "prefers field1" logic)
            extra_2 = jnp.where(
                extra_1 > 0, l2,
                jnp.maximum(0, l1 + l2 - 2 * self._out_e[3]))
            c2_off = l2 - extra_2
            if not want_ccp:
                extra_ccp = jnp.int32(0)
            if not want_c2:
                extra_2 = jnp.int32(0)
            overflow = (extra_ccp > 0) | (extra_1 > 0) | (extra_2 > 0)
            # emit=False -> store everything; emit&overflow -> store
            # tails; emit&!overflow -> clear scratch
            s_off_ccp = jnp.where(emit, ccp_off, 0)
            s_off_1 = jnp.where(emit, c1_off, 0)
            s_off_2 = jnp.where(emit, c2_off, 0)
            lsccp = jnp.where(emit, jnp.where(overflow, extra_ccp, 0),
                              lccp)
            lsc1 = jnp.where(emit, jnp.where(overflow, extra_1, 0), l1)
            lsc2 = jnp.where(emit, jnp.where(overflow, extra_2, 0), l2)
            sccp_n = self._xr_tail(ccp_w, s_off_ccp, lsccp, 384)
            sc1_n = self._xr_tail(c1_w, s_off_1, lsc1, 64)
            sc2_n = self._xr_tail(c2_w, s_off_2, lsc2, 64)
            le_ccp = jnp.where(emit, ccp_off, 0)
            le_1 = jnp.where(emit, c1_off, 0)
            le_2 = jnp.where(emit, c2_off, 0)
            inf_out = inf
            outf_out = outf + emit.astype(jnp.int64)

        out, seq_n = self._xr_combine_and_emit(
            ccp_w, le_ccp, c1_w, le_1, c2_w, le_2, st["seq"])
        new_st = {
            "seq": jnp.where(emit, seq_n, st["seq"]).astype(jnp.int32),
            "inf": jnp.where(run, inf_out, st["inf"]).astype(jnp.int64),
            "outf": jnp.where(run, outf_out,
                              st["outf"]).astype(jnp.int64),
            "sc_ccp": jnp.where(run, sccp_n,
                                st["sc_ccp"]).astype(jnp.int32),
            "sc_ccp_len": jnp.where(run, lsccp,
                                    st["sc_ccp_len"]).astype(jnp.int32),
            "sc_c1": jnp.where(run, sc1_n,
                               st["sc_c1"]).astype(jnp.int32),
            "sc_c1_len": jnp.where(run, lsc1,
                                   st["sc_c1_len"]).astype(jnp.int32),
            "sc_c2": jnp.where(run, sc2_n,
                               st["sc_c2"]).astype(jnp.int32),
            "sc_c2_len": jnp.where(run, lsc2,
                                   st["sc_c2_len"]).astype(jnp.int32),
        }
        return out, emit, new_st

    def _xr_process(self, state, batch: FrameBatch):
        require(not isinstance(batch.data, dict),
                "ccconverter: cross-framerate mode needs a standalone "
                "[B, W] caption stream")
        cc = batch.data.astype(jnp.int32)

        def step(st, inp):
            ccf, valid, pts = inp
            parsed = self._xr_parse_input(ccf)
            outs, emits = [], []
            for slot in range(self._slots):
                out, emit, st = self._xr_slot(st, parsed, slot == 0,
                                              valid)
                outs.append(out.astype(jnp.uint8))
                emits.append(emit)
            return st, (jnp.stack(outs), jnp.stack(emits),
                        jnp.full(self._slots, pts))

        state, (outs, emits, opts) = lax.scan(
            step, state, (cc, batch.valid, batch.pts))
        b = batch.batch
        W = outs.shape[-1]
        return state, FrameBatch.make(
            outs.reshape(self._slots * b, W),
            pts=opts.reshape(self._slots * b),
            valid=emits.reshape(self._slots * b))

    def process(self, params, state, batch: FrameBatch):
        if getattr(self, "_xr", False):
            return self._xr_process(state, batch)
        is_dict = isinstance(batch.data, dict)
        cc = batch.data["cc"] if is_dict else batch.data
        s334 = self._to_s334(cc, self.props["input-type"])
        out, state = self._from_s334(s334, self.props["output-type"],
                                     state)
        out = out.astype(jnp.uint8)
        if is_dict:
            return state, batch.with_data({**batch.data, "cc": out})
        return state, batch.with_data(out)


@register
class CeaCcOverlay(Element):
    """ceaccoverlay (ext/closedcaption/gstceaccoverlay.c): decode CEA-708
    DTVCC captions (io/cea708.py) and blend the caption windows onto
    AYUV video.

    Caption data arrives via `push_cc(data, pts_ns, kind)` before the
    run (the reference takes a caption sink pad; same host-push model as
    dvdspu/dvbsuboverlay): kind "cc-data" (raw triplets), "cdp" (the
    0x9669 packet — unwrapped via io/cea608.py like
    extract_ccdata_from_cdp, gstceaccoverlay.c:1575-1639) or "s334-1a"
    (608-only payloads carry no 708 data and render nothing).  Each feed
    that completes DTVCC windows snapshots an overlay shown from its PTS
    until the next snapshot; `silent` mutes rendering;
    `service-number` selects the DTVCC service (1-63, default 1).
    Rendering (r3): face=pango (the default when the library is
    present) runs the reference's ACTUAL render path — per-row span
    markup from the per-char pen states, 'serif 36' font desc, the
    shadow+outline cairo composite, image_to_ayuv's fixed-point
    matrix, and the create_and_push_buffer anchor walk with
    window-h-pos (center default like DEFAULT_PROP_WINDOW_H_POS) —
    io/cea708.render_overlay_pango.  face=fixed keeps the bitmap-face
    white-on-black raster as the library-free fallback."""

    NAME = "ceaccoverlay"
    PROPERTIES = (
        Property("silent", bool, False, static=True),
        Property("service-number", int, 1, 1, 63, static=True),
        Property("face", str, "auto", static=True,
                 doc="auto | pango | fixed"),
        Property("window-h-pos", str, "center", static=True,
                 doc="left | center | right | auto (the reference's "
                     "auto reads an never-assigned h_anchor — quirk "
                     "kept)"),
    )

    def __init__(self, **props):
        super().__init__(**props)
        from gstbad.io.cea708 import Cea708Decoder
        self._decoder = Cea708Decoder(
            int(self.props["service-number"]))
        self._snapshots = []      # (pts_ns, decoder-state snapshot fn)
        self._pending = []        # raw (pts, cc_data) feeds

    def push_cc(self, data: bytes, pts_ns: int = 0,
                kind: str = "cc-data") -> None:
        from gstbad.io import cea608
        if kind == "cdp":
            data, _fps = cea608.cdp_to_cc_data(bytes(data))
        elif kind == "s334-1a":
            data = cea608.s334_to_cc_data(bytes(data))
        elif kind != "cc-data":
            raise ValueError(f"ceaccoverlay: unknown kind {kind!r}")
        self._pending.append((int(pts_ns), bytes(data)))

    def negotiate(self, in_spec):
        require(in_spec.kind == "video"
                and in_spec.format == VideoFormat.AYUV,
                "ceaccoverlay: needs AYUV video (use videoconvert)")
        return in_spec

    def _render_snapshots(self, width: int, height: int):
        from gstbad.io import cea708
        face = self.props.get("face", "auto")
        if face == "pango" and not cea708.pango_available():
            raise ValueError("ceaccoverlay: face=pango but "
                             "pango/pangocairo is not available")
        use_pango = face in ("auto", "pango") \
            and cea708.pango_available()
        self._face = "pango" if use_pango else "fixed"
        out = []
        for pts, data in sorted(self._pending, key=lambda t: t[0]):
            if self._decoder.feed_cc_data(data):
                if use_pango:
                    canvas = cea708.render_overlay_pango(
                        self._decoder, width, height,
                        window_h_pos=self.props["window-h-pos"])
                else:
                    canvas = cea708.render_overlay(self._decoder,
                                                   width, height)
                out.append((pts, canvas))
        return out

    def process(self, params, state, batch: FrameBatch):
        if self.props["silent"] or not self._pending:
            return state, batch
        out = batch.data
        b, h, w, _ = out.shape
        if not self._snapshots:
            self._snapshots = self._render_snapshots(w, h)
        for i, (pts, canvas) in enumerate(self._snapshots):
            ov = jnp.asarray(canvas)
            a = ov[..., 0].astype(jnp.int32)
            active = batch.pts >= pts
            if i + 1 < len(self._snapshots):
                active = active & (batch.pts < self._snapshots[i + 1][0])
            act = active[:, None, None, None]
            d = out.astype(jnp.int32)
            s = ov.astype(jnp.int32)
            blended = (d * (256 - a[None, ..., None])
                       + s * a[None, ..., None]) >> 8
            blended = blended.at[..., 0].set(d[..., 0])
            out = jnp.where(act & (a[None] > 0)[..., None],
                            blended.astype(jnp.uint8), out)
        return state, batch.with_data(out)
