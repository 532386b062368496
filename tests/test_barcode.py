"""zbar / zxing elements and the io/qrdecode.py scanning engines
(ext/zbar/gstzbar.c, ext/zxing/gstzxing.cpp).  io/qr.py's encoder and
the EAN-13 renderer supply symbols; cv2.QRCodeDetector cross-checks."""

import fractions

import numpy as np
import jax.numpy as jnp
import pytest

import gstbad as gt
from gstbad.core.frame import FrameBatch
from gstbad.core.pipeline import Pipeline
from gstbad.core.spec import MediaSpec
from gstbad.io import qr as qrenc
from gstbad.io import qrdecode as qd


def _render_qr(m, ps=6, ox=20, oy=20, W=260, H=260):
    img = np.full((H, W), 255, np.uint8)
    n = m.shape[0]
    block = np.where(np.kron(m, np.ones((ps, ps), bool)), 20, 240
                     ).astype(np.uint8)
    img[oy:oy + n * ps, ox:ox + n * ps] = block
    return img


def test_rs_correct_and_limits(rng):
    data = bytes(rng.integers(0, 256, 20, dtype=np.uint8))
    ecc = qrenc._rs_ecc(data, 10)
    assert qd.rs_correct(data + ecc, 10) == (data, 0)
    for nerr in (1, 3, 5):
        blk = bytearray(data + ecc)
        for p in rng.choice(len(blk), nerr, replace=False):
            blk[p] ^= int(rng.integers(1, 256))
        res = qd.rs_correct(bytes(blk), 10)
        assert res is not None and res[0] == data and res[1] == nerr
    blk = bytearray(data + ecc)
    for p in range(6):                       # beyond t = 5
        blk[p] ^= 0xFF
    assert qd.rs_correct(bytes(blk), 10) is None


def test_qr_matrix_decode_roundtrip():
    cases = [("hello world", "M"), ("HELLO WORLD 123", "L"),
             ("1234567890987654321", "Q"), ("x" * 150, "H"),
             ('{"TIMESTAMP":33333,"N":"q0"}', "M")]
    for text, lvl in cases:
        r = qd.decode_matrix(qrenc.encode(text, lvl))
        assert r is not None and r[0] == text and r[1]["level"] == lvl


def test_qr_decode_with_damage(rng):
    m = qrenc.encode("error resilience test", "H")
    m2 = m.copy()
    for _ in range(12):
        y, x = rng.integers(9, m.shape[0] - 9, 2)
        m2[y, x] ^= True
    r = qd.decode_matrix(m2)
    assert r is not None and r[0] == "error resilience test"
    assert r[1]["corrected"] > 0


def test_qr_image_scan_positions():
    m = qrenc.encode("scan me 42", "M")
    for ps, ox, oy in ((6, 40, 30), (4, 10, 100), (9, 25, 25)):
        img = _render_qr(m, ps=ps, ox=ox, oy=oy, W=320, H=320)
        res = qd.scan_qr(img)
        assert [r[0] for r in res] == ["scan me 42"], (ps, ox, oy)


def test_ean13_roundtrip():
    for code in ("5901234123457", "4006381333931", "0123456789050"):
        assert qd.ean13_checksum_ok(code)
        for px in (2, 3, 5):
            res = qd.scan_ean13(qd.ean13_render(code, module_px=px))
            assert res is not None and res[0] == code
    # corrupt checksum digit -> rejected
    bad = qd.ean13_render("5901234123450", module_px=3)
    assert qd.scan_ean13(bad) is None


def _drive(name, frames_gray, **props):
    el = gt.make(name, **props)
    p = Pipeline([el])
    H, W = frames_gray.shape[1:3]
    p.negotiate(MediaSpec(kind="video", format="GRAY8", width=W,
                          height=H, framerate=fractions.Fraction(30)))
    dur = 10 ** 9 // 30
    pts = jnp.asarray([i * dur for i in range(len(frames_gray))],
                      jnp.int64)
    p.run(inputs=FrameBatch.make(jnp.asarray(frames_gray), pts=pts))
    return p.bus.pop(name="barcode"), el


def test_zbar_element_messages():
    m = qrenc.encode("zbar pipeline", "M")
    img = _render_qr(m)
    blank = np.full_like(img, 255)
    msgs, _ = _drive("zbar", np.stack([img, blank, img]))
    assert len(msgs) == 2
    for mi, want_pts in zip(msgs, (0, 2 * (10 ** 9 // 30))):
        assert mi["type"] == "QR-Code"
        assert mi["symbol"] == "zbar pipeline"
        assert mi["timestamp"] == want_pts == mi.pts
        assert mi["stream-time"] == mi["running-time"] == want_pts
        assert mi["quality"] == 1
        assert mi["duration"] == 10 ** 9 // 30
        assert "frame" not in mi.fields


def test_zbar_cache_and_attach_frame():
    m = qrenc.encode("cached", "M")
    img = _render_qr(m)
    frames = np.stack([img, img, img])
    msgs, _ = _drive("zbar", frames, cache=True,
                     **{"attach-frame": True})
    # consecutive repeats suppressed
    assert len(msgs) == 1
    np.testing.assert_array_equal(msgs[0]["frame"], img)
    # message=False posts nothing
    msgs2, _ = _drive("zbar", frames, message=False)
    assert msgs2 == []


def test_zbar_ean13():
    img = qd.ean13_render("4006381333931", module_px=3)
    msgs, _ = _drive("zbar", img[None])
    assert len(msgs) == 1
    assert msgs[0]["type"] == "EAN-13"
    assert msgs[0]["symbol"] == "4006381333931"
    assert msgs[0]["quality"] > 1


def test_zxing_element_format_and_rotate():
    m = qrenc.encode("zxing here", "M")
    img = _render_qr(m)
    msgs, _ = _drive("zxing", img[None])
    assert [mi["type"] for mi in msgs] == ["QR_CODE"]
    assert msgs[0]["symbol"] == "zxing here"
    # format narrowing: ean_13 only -> QR ignored
    msgs2, _ = _drive("zxing", img[None], format="ean_13")
    assert msgs2 == []
    # rotated 90 degrees: found only with try-rotate
    rot = np.rot90(img).copy()
    msgs3, _ = _drive("zxing", rot[None])
    msgs4, _ = _drive("zxing", rot[None], **{"try-rotate": True})
    assert msgs3 == [] and [mi["symbol"] for mi in msgs4] == ["zxing here"]


def test_cv2_cross_check():
    cv2 = pytest.importorskip("cv2")
    det = cv2.QRCodeDetector()
    m = qrenc.encode("agreement", "Q")
    img = _render_qr(m, ps=8, W=320, H=320)
    ours = qd.scan_qr(img)
    theirs, _, _ = det.detectAndDecode(img)
    assert ours[0][0] == theirs == "agreement"


def test_ean8_roundtrip_and_elements():
    for code in ("55123457", "96385074"):
        assert qd.ean8_checksum_ok(code)
        for px in (2, 3, 4):
            r = qd.scan_ean8(qd.ean8_render(code, module_px=px))
            assert r is not None and r[0] == code
    # an EAN-13 symbol must not decode as EAN-8
    assert qd.scan_ean8(qd.ean13_render("4006381333931")) is None
    img = qd.ean8_render("55123457", module_px=3)
    msgs, _ = _drive("zbar", img[None])
    assert [(m["type"], m["symbol"]) for m in msgs] == \
        [("EAN-8", "55123457")]
    msgs2, _ = _drive("zxing", img[None], format="ean_8")
    assert [(m["type"], m["symbol"]) for m in msgs2] == \
        [("EAN_8", "55123457")]
    msgs3, _ = _drive("zxing", img[None], format="ean_13")
    assert msgs3 == []


def test_zbar_upca_reporting():
    # leading-zero EAN-13 reports as UPC-A with 12 digits (libzbar
    # default-config behaviour)
    img = qd.ean13_render("0123456789050", module_px=3)
    msgs, _ = _drive("zbar", img[None])
    assert [(m["type"], m["symbol"]) for m in msgs] == \
        [("UPC-A", "123456789050")]
