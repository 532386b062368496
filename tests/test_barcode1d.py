"""io/barcode1d.py — the linear symbologies beyond EAN (Code 128,
Code 39, Code 93, Interleaved 2-of-5, Codabar, UPC-E) and their zbar /
zxing element surfaces (ext/zbar/gstzbar.c, ext/zxing/gstzxing.cpp)."""

import fractions

import numpy as np
import jax.numpy as jnp
import pytest

import gstbad as gt
from gstbad.core.frame import FrameBatch
from gstbad.core.pipeline import Pipeline
from gstbad.core.spec import MediaSpec
from gstbad.io import barcode1d as b1


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


# -- per-symbology round trips ----------------------------------------------

def test_code39_roundtrip():
    for text in ("HELLO-99 X", "A1B2C3", "$/+%", "CODE 39"):
        for px in (2, 3):
            for wide in (2, 3):
                got = b1.scan_code39(
                    b1.render_code39(text, module_px=px, wide=wide))
                assert got is not None and got[0] == text, \
                    (text, px, wide)


def test_code39_full_charset():
    text = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ-. $/+%"
    got = b1.scan_code39(b1.render_code39(text, module_px=2))
    assert got is not None and got[0] == text


def test_code128_setb_roundtrip():
    for text in ("Hello, World! 123", "a", "MixedCASE~{}",
                 "spaces   here"):
        for px in (2, 3):
            got = b1.scan_code128(b1.render_code128(text, module_px=px))
            assert got is not None and got[0] == text, (text, px)


def test_code128_setc_and_checksum_reject():
    img = b1.render_code128("0123456789", digits_as_c=True)
    got = b1.scan_code128(img)
    assert got is not None and got[0] == "0123456789"
    # flip one symbol's bars: checksum must reject the whole decode
    bad = img.copy()
    col = bad.shape[1] // 2
    bad[:, col:col + 8] = 255 - bad[:, col:col + 8]
    res = b1.scan_code128(bad)
    assert res is None or res[0] == "0123456789" and res[1] < got[1]


def test_code93_roundtrip_and_check_chars():
    for text in ("CODE 93 TEST", "WIKIPEDIA", "0123456789"):
        got = b1.scan_code93(b1.render_code93(text, module_px=2))
        assert got is not None and got[0] == text, text


def test_itf_roundtrip_incl_wide_tail_digits():
    # digits ending in 8/9 open their last pair with a wide bar — the
    # stop pattern lookalike the quiet-zone check disambiguates
    for digits in ("0123456789", "00998877", "123456", "080808"):
        for wide in (2, 3):
            got = b1.scan_itf(b1.render_itf(digits, wide=wide))
            assert got is not None and got[0] == digits, (digits, wide)


def test_codabar_roundtrip():
    for text in ("A40156B", "C1234:5/6D", "B$-.+A"):
        got = b1.scan_codabar(b1.render_codabar(text))
        assert got is not None and got[0] == text, text


def test_upce_roundtrip_and_expansion():
    # expansion rules (GS1): the last body digit selects the UPC-A shape
    assert b1.upce_expand("01234565") == "012345000065"   # last 5-9
    assert b1.upce_expand("01208302") == "012000000832"   # last 0-2
    assert b1.upce_expand("01234535") == "012300000455"   # last 3
    assert b1.upce_expand("01234145") == "012340000015"   # last 4
    for code in ("01234565", "00123457"):
        got = b1.scan_upce(b1.render_upce(code))
        assert got is not None and got[0] == code, code


def test_upce_number_system_1():
    from gstbad.io.qrdecode import ean13_checksum_ok
    # find a valid NS-1 code
    for check in range(10):
        code = f"1654321{check}"
        if ean13_checksum_ok("0" + b1.upce_expand(code)):
            break
    got = b1.scan_upce(b1.render_upce(code))
    assert got is not None and got[0] == code


def test_bad_checksum_rejected():
    # mod-43-free Code 39 has no checksum, but Code 93's C/K must gate
    img = b1.render_code93("GOOD")
    bad = img.copy()
    # invert a couple of symbol columns (not the quiet zone)
    w = bad.shape[1]
    bad[:, w // 2:w // 2 + 6] = 255 - bad[:, w // 2:w // 2 + 6]
    res = b1.scan_code93(bad)
    assert res is None or res[0] == "GOOD"


# -- element surfaces -------------------------------------------------------

def test_zbar_reports_new_symbologies():
    cases = (
        (b1.render_code128("PIPELINE 128"), "CODE-128", "PIPELINE 128"),
        (b1.render_code39("ZBAR-39"), "CODE-39", "ZBAR-39"),
        (b1.render_code93("ZBAR 93"), "CODE-93", "ZBAR 93"),
        (b1.render_itf("06543217"), "I2/5", "06543217"),
        (b1.render_codabar("A31117B"), "Codabar", "A31117B"),
        (b1.render_upce("01234565"), "UPC-E", "01234565"),
    )
    for img, typ, sym in cases:
        msgs, _ = _drive("zbar", img[None])
        assert len(msgs) == 1, typ
        assert msgs[0]["type"] == typ
        assert msgs[0]["symbol"] == sym
        assert msgs[0]["quality"] >= 1


def test_zxing_format_gating():
    img = b1.render_code128("GATED")
    msgs, _ = _drive("zxing", img[None], format="code_128")
    assert [m["type"] for m in msgs] == ["CODE_128"]
    assert msgs[0]["symbol"] == "GATED"
    # a non-matching narrow format posts nothing
    msgs2, _ = _drive("zxing", img[None], format="code_39")
    assert msgs2 == []


def test_zxing_try_rotate_linear():
    img = np.rot90(b1.render_code39("ROT39"))
    msgs, _ = _drive("zxing", img[None], format="code_39",
                     **{"try-rotate": True})
    assert [m["symbol"] for m in msgs] == ["ROT39"]
    msgs2, _ = _drive("zxing", img[None], format="code_39")
    assert msgs2 == []


def test_ean_addons_roundtrip():
    for d in ("05", "12", "99"):
        got = b1.scan_ean2(b1.render_ean2(d))
        assert got is not None and got[0] == d, d
    for d in ("54495", "00000", "12345"):
        got = b1.scan_ean5(b1.render_ean5(d))
        assert got is not None and got[0] == d, d
    # parity mismatch rejected: EAN-5 rendered with the wrong checksum
    # parity cannot decode as any other 5-digit value
    img = b1.render_ean5("54495")
    res2 = b1.scan_ean2(img)           # a 2-digit prefix parse must not fire
    assert res2 is None or res2[0] != "54"


def test_zbar_reports_ean_addons():
    msgs, _ = _drive("zbar", b1.render_ean5("54495")[None])
    assert [(m["type"], m["symbol"]) for m in msgs] == [("EAN-5", "54495")]
    msgs2, _ = _drive("zbar", b1.render_ean2("07")[None])
    assert [(m["type"], m["symbol"]) for m in msgs2] == [("EAN-2", "07")]


def test_no_false_positives_on_noise():
    rng = np.random.default_rng(11)
    scans = (b1.scan_code128, b1.scan_code39, b1.scan_code93,
             b1.scan_itf, b1.scan_codabar, b1.scan_upce,
             b1.scan_ean2, b1.scan_ean5)
    for _ in range(3):
        img = rng.integers(0, 256, (96, 360), dtype=np.uint8)
        for scan in scans:
            assert scan(img) is None, scan.__name__
