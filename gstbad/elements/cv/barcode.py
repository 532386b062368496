"""zbar / zxing barcode detectors (ext/zbar/gstzbar.c,
ext/zxing/gstzxing.cpp).

Both reference elements pass the 8-bit luma plane to an external
scanner library and post `barcode` element messages per detection;
video passes through untouched.  The scanning engines here are
io/qrdecode.py (QR incl. Reed-Solomon error correction, EAN-13/EAN-8
scanlines) and io/barcode1d.py (Code 128, Code 39, Code 93,
Interleaved 2-of-5, Codabar, UPC-E) — from-spec implementations of
libzbar's decoder set; the quality metric (scanline agreement votes,
not zbar's edge confidence) is the documented divergence.

zbar message fields (gstzbar.c:308-325): timestamp, stream-time,
running-time (all the buffer pts in this single-segment model), type
(libzbar symbol names: "QR-Code", "EAN-13", "EAN-8", "UPC-A",
"UPC-E", "CODE-128", "CODE-39", "CODE-93", "I2/5", "Codabar"),
symbol, quality, duration, and `frame` when attach-frame is set.  The
cache property suppresses symbols already reported on the immediately
preceding frame (libzbar's inter-frame consistency cache, simplified
to consecutive dedupe — documented).

zxing message fields (gstzxing.cpp:393-399): timestamp, stream-time,
running-time, type (zxing-cpp format names: "QR_CODE", "EAN_13",
"CODE_128", ...), symbol, plus `frame` with attach-frame.  `format`
narrows the symbology; aztec/maxicode/pdf_417/png nicks are accepted
but never match (no scanner in this build).  try-rotate scans the
three right-angle rotations as well; try-faster is accepted as a
no-op hint (it tunes libZXing internals)."""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from gstbad.core.element import Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import VideoFormat, require

_ZXING_FORMATS = ("all", "aztec", "codabar", "code_39", "code_93",
                  "code_128", "png", "ean_8", "ean_13", "itf",
                  "maxicode", "pdf_417", "qr_code", "upc_a", "upc_e")


class _BarcodeBase(Element):
    HOST = True

    def negotiate(self, in_spec):
        require(in_spec.kind == "video", f"{self.NAME}: needs video")
        require(in_spec.format in (VideoFormat.I420, VideoFormat.GRAY8,
                                   VideoFormat.AYUV),
                f"{self.NAME}: needs a luma plane (I420/GRAY8/AYUV; "
                "use videoconvert)")
        self._fmt = in_spec.format
        self._dur = in_spec.frame_duration_ns
        return in_spec

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def _luma(self, np_batch: FrameBatch, i: int) -> np.ndarray:
        data = np_batch.data
        if isinstance(data, dict):
            return np.asarray(data["y"][i])
        arr = np.asarray(data[i])
        if self._fmt == VideoFormat.GRAY8:
            return arr if arr.ndim == 2 else arr[..., 0]
        return arr[..., 1]                   # AYUV: Y at byte 1

    def _scan(self, gray: np.ndarray):
        """-> [(type_name, symbol, quality)] for the enabled set."""
        raise NotImplementedError

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        from gstbad.core.bus import Message
        prev = getattr(self, "_prev_symbols", set())
        for i in range(np_batch.batch):
            if not bool(np.asarray(np_batch.valid)[i]):
                continue
            gray = self._luma(np_batch, i)
            results = self._scan(gray)
            cur = {sym for (_t, sym, _q) in results}
            for (typ, sym, quality) in results:
                if getattr(self, "_cache", False) and sym in prev:
                    continue
                if not self.props["message"]:
                    continue
                pts = int(np.asarray(np_batch.pts)[i])
                fields = {"timestamp": pts, "stream-time": pts,
                          "running-time": pts, "type": typ,
                          "symbol": sym}
                fields.update(self._extra_fields(quality))
                if self.props["attach-frame"]:
                    if isinstance(np_batch.data, dict):
                        fields["frame"] = {
                            k: np.asarray(v[i]).copy()
                            for k, v in np_batch.data.items()}
                    else:
                        fields["frame"] = np.asarray(
                            np_batch.data[i]).copy()
                if bus is not None:
                    bus.post(Message(self.NAME, "barcode", pts, fields))
            prev = cur
        self._prev_symbols = prev

    def _extra_fields(self, quality):
        return {}


@register
class ZBar(_BarcodeBase):
    NAME = "zbar"
    PROPERTIES = (
        Property("message", bool, True, static=True),
        Property("attach-frame", bool, False, static=True),
        Property("cache", bool, False, static=True),
    )

    @property
    def _cache(self):
        return self.props["cache"]

    def _extra_fields(self, quality):
        f = {"quality": int(quality)}
        if self._dur:
            f["duration"] = int(self._dur)
        return f

    def _scan(self, gray):
        from gstbad.io import barcode1d as b1
        from gstbad.io import qrdecode as qd
        out = []
        for text, _info in qd.scan_qr(gray):
            out.append(("QR-Code", text, 1))
        ean = qd.scan_ean13(gray)
        if ean is not None:
            # libzbar's default config reports a leading-zero EAN-13
            # as UPC-A with the 12-digit symbol text
            if ean[0].startswith("0"):
                out.append(("UPC-A", ean[0][1:], ean[1]))
            else:
                out.append(("EAN-13", ean[0], ean[1]))
        ean8 = qd.scan_ean8(gray)
        if ean8 is not None:
            out.append(("EAN-8", ean8[0], ean8[1]))
        # the rest of libzbar's linear set (zbar symbol names)
        for name, scan in (("CODE-128", b1.scan_code128),
                           ("CODE-39", b1.scan_code39),
                           ("CODE-93", b1.scan_code93),
                           ("I2/5", b1.scan_itf),
                           ("Codabar", b1.scan_codabar),
                           ("UPC-E", b1.scan_upce),
                           ("EAN-2", b1.scan_ean2),
                           ("EAN-5", b1.scan_ean5)):
            got = scan(gray)
            if got is not None:
                out.append((name, got[0], got[1]))
        return out


@register
class ZXing(_BarcodeBase):
    NAME = "zxing"
    PROPERTIES = (
        Property("message", bool, True, static=True),
        Property("attach-frame", bool, False, static=True),
        Property("try-rotate", bool, False, static=True),
        Property("try-faster", bool, False, static=True),
        Property("format", str, "all", static=True,
                 doc="|".join(_ZXING_FORMATS)),
    )

    _cache = False

    def negotiate(self, in_spec):
        require(self.props["format"] in _ZXING_FORMATS,
                f"zxing: unknown format {self.props['format']!r}")
        return super().negotiate(in_spec)

    def _scan(self, gray):
        from gstbad.io import barcode1d as b1
        from gstbad.io import qrdecode as qd
        fmt = self.props["format"]
        planes = [gray]
        if self.props["try-rotate"]:
            planes += [np.rot90(gray, k) for k in (1, 2, 3)]
        out = []
        seen = set()
        linear = (("ean_13", "EAN_13", qd.scan_ean13),
                  ("ean_8", "EAN_8", qd.scan_ean8),
                  ("code_128", "CODE_128", b1.scan_code128),
                  ("code_39", "CODE_39", b1.scan_code39),
                  ("code_93", "CODE_93", b1.scan_code93),
                  ("itf", "ITF", b1.scan_itf),
                  ("codabar", "CODABAR", b1.scan_codabar),
                  ("upc_e", "UPC_E", b1.scan_upce))
        for g in planes:
            if fmt in ("all", "qr_code"):
                for text, _info in qd.scan_qr(g):
                    if text not in seen:
                        seen.add(text)
                        out.append(("QR_CODE", text, 1))
            for nick, name, scan in linear:
                if fmt not in ("all", nick):
                    continue
                got = scan(g)
                if got is not None and got[0] not in seen:
                    seen.add(got[0])
                    out.append((name, got[0], got[1]))
            if out and not self.props["try-rotate"]:
                break
        return out
