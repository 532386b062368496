"""qroverlay / debugqroverlay (ext/qroverlay/) and the io/qr.py encoder.

cv2.QRCodeDetector is the decode oracle (libqrencode is absent; any
spec-conformant decoder must read the symbols)."""

import fractions
import json

import numpy as np
import jax.numpy as jnp
import pytest

cv2 = pytest.importorskip("cv2")

import gstbad as gt
from gstbad.core.frame import FrameBatch
from gstbad.core.pipeline import Pipeline
from gstbad.core.spec import MediaSpec
from gstbad.golden import qroverlay as golden
from gstbad.io import qr

DET = cv2.QRCodeDetector()


def _decode_matrix(m, ps=8):
    n = m.shape[0]
    img = np.full(((n + 8) * ps, (n + 8) * ps), 255, np.uint8)
    img[4 * ps:-4 * ps, 4 * ps:-4 * ps] = np.where(
        np.kron(m, np.ones((ps, ps), bool)), 0, 255)
    s, _, _ = DET.detectAndDecode(img)
    return s


def test_qr_known_vectors():
    # format-information strings (ISO 18004 annex C examples)
    assert qr.format_bits("L", 0) == 0b111011111000100
    assert qr.format_bits("M", 0) == 0b101010000010010
    # version-information string for version 7
    assert qr.version_bits(7) == 0b000111110010010100
    # alignment-pattern rows/cols (spec table E.1 incl. the v32 case)
    assert qr.alignment_positions(2) == [6, 18]
    assert qr.alignment_positions(7) == [6, 22, 38]
    assert qr.alignment_positions(14) == [6, 26, 46, 66]
    assert qr.alignment_positions(32) == [6, 34, 60, 86, 112, 138]
    # Reed-Solomon: the classic HELLO WORLD 1-Q worked example
    data = bytes([0x20, 0x5B, 0x0B, 0x78, 0xD1, 0x72, 0xDC, 0x4D, 0x43,
                  0x40, 0xEC, 0x11, 0xEC])
    exp = bytes([0xA8, 0x48, 0x16, 0x52, 0xD9, 0x36, 0x9C, 0x00, 0x2E,
                 0x0F, 0xB4, 0x7A, 0x10])
    assert qr._rs_ecc(data, 13) == exp
    # segmentation + bitstream of the same example (alnum, v1 Q)
    segs = qr._segment(b"HELLO WORLD", 0)
    assert segs == [(qr._MODE_ALNUM, b"HELLO WORLD")]
    assert qr._encode_segments(segs, 1, "Q") == data


def test_qr_geometry_tables():
    # total codeword counts derived from symbol geometry match the
    # spec's table 1 values
    known = [26, 44, 70, 100, 134, 172, 196, 242, 292, 346, 404, 466,
             532, 581, 655, 733, 815, 901, 991, 1085, 1156, 1258, 1364,
             1474, 1588, 1706, 1828, 1921, 2051, 2185, 2323, 2465, 2611,
             2761, 2876, 3034, 3196, 3362, 3532, 3706]
    for v in range(1, 41):
        assert qr.total_codewords(v) == known[v - 1]
        for lvl in "LMQH":
            d = qr.data_codewords(v, lvl)
            assert 0 < d < qr.total_codewords(v)
    # spec data-capacity spot checks (table 7)
    assert qr.data_codewords(1, "M") == 16
    assert qr.data_codewords(5, "Q") == 62
    assert qr.data_codewords(10, "H") == 122
    assert qr.data_codewords(40, "L") == 2956


def test_qr_roundtrips():
    cases = [
        ("hello world", "M"),
        ("HELLO WORLD 123", "L"),
        ("1234567890123456789012345678901234567890", "Q"),
        ('{"TIMESTAMP":33333333,"BUFFERCOUNT":2,"FRAMERATE":"30/1",'
         '"NAME":"qroverlay0"}', "M"),
        ("x" * 150, "H"),          # version 12
        ("A" * 400, "M"),          # version 12, alnum
        ("mixed 123 ABC text 456789 end", "M"),
    ]
    for text, lvl in cases:
        assert _decode_matrix(qr.encode(text, lvl)) == text


def test_qr_all_masks_decode():
    for mk in range(8):
        m = qr.encode("mask probe 42", "M", mask=mk)
        assert _decode_matrix(m) == "mask probe 42", mk


def test_qr_forced_version():
    # forcing version 7 exercises the version-information blocks
    m = qr.encode("payload", "H", version=7)
    assert m.shape == (45, 45)
    assert _decode_matrix(m) == "payload"
    with pytest.raises(ValueError):
        qr.encode("this will not fit", "H", version=1)


def test_golden_draw_geometry():
    m = qr.encode("draw", "M")
    n = m.shape[0]
    ps = 3
    canvas = golden.draw_overlay(m, float(ps))
    sq = (n + 8) * ps
    assert canvas.shape == (sq, sq, 4)
    # BGRA: alpha byte stays 0xff everywhere at integer pixel sizes
    assert (canvas[..., 3] == 255).all()
    # the one-module-right-shift quirk (gstbaseqroverlay.c:170-173):
    # modules sit at rows 4..(4+n), cols 5..(5+n) in module units
    expected = np.zeros((sq, sq), bool)
    blk = np.kron(m, np.ones((ps, ps), bool))
    expected[4 * ps:(4 + n) * ps, 5 * ps:(5 + n) * ps] = blk
    assert ((canvas[..., 0] == 0) == expected).all()
    assert ((canvas[..., 1] == 0) == expected).all()
    assert ((canvas[..., 2] == 0) == expected).all()


def test_golden_position_rounding():
    # x rounds down to even, y to a multiple of 4
    # (GST_ROUND_DOWN_2 / _4, gstbaseqroverlay.c:180-183)
    x, y = golden.overlay_position(640, 480, 100, 50.0, 50.0)
    assert x == 270 and y == 188
    x, y = golden.overlay_position(641, 481, 100, 33.0, 77.0)
    assert x % 2 == 0 and y % 4 == 0
    assert x == int(int(641 - 100) * 0.33) & ~1


def test_qroverlay_element_roundtrip():
    W, H = 640, 480
    el = gt.make("qroverlay", data="gstbad qroverlay test",
                 **{"pixel-size": 4.0})
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="BGRx", width=W, height=H,
                          framerate=fractions.Fraction(30)))
    img = np.full((2, H, W, 4), 128, np.uint8)
    out = np.asarray(p.run(inputs=FrameBatch.make(jnp.asarray(img)))[0]
                     .data)
    s, _, _ = DET.detectAndDecode(out[0][..., :3])
    assert s == "gstbad qroverlay test"
    # both frames identical (one static overlay)
    np.testing.assert_array_equal(out[0], out[1])
    # empty data -> passthrough (get_content NULL draws nothing)
    el2 = gt.make("qroverlay")
    p2 = Pipeline([el2])
    p2.negotiate(MediaSpec(kind="video", format="BGRx", width=W,
                           height=H, framerate=fractions.Fraction(30)))
    out2 = np.asarray(p2.run(
        inputs=FrameBatch.make(jnp.asarray(img)))[0].data)
    np.testing.assert_array_equal(out2, img)


def test_qroverlay_position_property():
    W, H = 640, 480
    img = np.full((1, H, W, 4), 255, np.uint8)
    for xp, yp in ((0.0, 0.0), (100.0, 100.0)):
        el = gt.make("qroverlay", data="pos", x=xp, y=yp)
        p = Pipeline([el])
        p.negotiate(MediaSpec(kind="video", format="RGBx", width=W,
                              height=H, framerate=fractions.Fraction(30)))
        out = np.asarray(p.run(
            inputs=FrameBatch.make(jnp.asarray(img)))[0].data)
        dark_rows = np.where((out[0][..., 0] < 64).any(axis=1))[0]
        if yp == 0.0:
            assert dark_rows.min() < H // 4
        else:
            assert dark_rows.max() > 3 * H // 4


def test_debugqroverlay_json_schedule():
    W, H = 640, 480
    # pixel-size 4: cv2's detector misses one default-size symbol
    el = gt.make("debugqroverlay", **{
        "max-frames": 8, "extra-data-name": "W",
        "extra-data-array": "240,480,720",
        "extra-data-interval-buffers": 2, "pixel-size": 4.0})
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="RGBx", width=W, height=H,
                          framerate=fractions.Fraction(30)))
    img = np.full((6, H, W, 4), 200, np.uint8)
    out = np.asarray(p.run(inputs=FrameBatch.make(jnp.asarray(img)))[0]
                     .data)
    dur = 10 ** 9 // 30
    for i in range(6):
        s, _, _ = DET.detectAndDecode(out[i][..., 2::-1])
        obj = json.loads(s)
        assert obj["TIMESTAMP"] == i * dur
        assert obj["BUFFERCOUNT"] == i + 1
        assert obj["FRAMERATE"] == "30/1"
        assert obj["NAME"].startswith("debugqroverlay")
        # extra data on frames 1, 3, 5 (frame_number % 2 == 1), value
        # cycling 240 -> 480 -> 720 (span 1 advances every insertion)
        if i % 2 == 0:
            assert obj["W"] == ("240", "480", "720")[i // 2]
        else:
            assert "W" not in obj


def test_debugqroverlay_span_and_bank_limit():
    W, H = 640, 480
    el = gt.make("debugqroverlay", **{
        "max-frames": 3, "extra-data-name": "K",
        "extra-data-array": "a,b",
        "extra-data-interval-buffers": 10,
        "extra-data-span-buffers": 2})
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="RGBx", width=W, height=H,
                          framerate=fractions.Fraction(30)))
    img = np.full((5, H, W, 4), 200, np.uint8)
    out = np.asarray(p.run(inputs=FrameBatch.make(jnp.asarray(img)))[0]
                     .data)
    # span 2: frames 1 and 2 carry K=a (counter advances after the span)
    for i, want in enumerate(("a", "a", None)):
        s, _, _ = DET.detectAndDecode(out[i][..., 2::-1])
        obj = json.loads(s)
        assert obj.get("K") == want
    # beyond max-frames the bank is exhausted: passthrough
    np.testing.assert_array_equal(out[3], img[3])
    np.testing.assert_array_equal(out[4], img[4])


def test_debugqroverlay_interval_zero_rejected():
    el = gt.make("debugqroverlay", **{
        "extra-data-interval-buffers": 0, "extra-data-name": "K",
        "extra-data-array": "a"})
    p = Pipeline([el])
    with pytest.raises(Exception, match="divides by zero"):
        p.negotiate(MediaSpec(kind="video", format="RGBx", width=64,
                              height=64, framerate=fractions.Fraction(30)))


def test_golden_draw_fractional_pixel_size():
    # float pixel-size: every truncation point is per-expression like
    # the C (gstbaseqroverlay.c:151-178) — module rows/cols take
    # ceil(ps) pixels from a truncated float offset, so byte writes
    # can straddle pixel boundaries; just assert structural facts
    m = qr.encode("frac", "M")
    n = m.shape[0]
    ps = 2.5
    canvas = golden.draw_overlay(m, ps)
    sq = int((n + 8) * ps)
    assert canvas.shape == (sq, sq, 4)
    # ceil(2.5) = 3 pixels per dark module row/col: a lone dark module
    # paints 3x3 pixels worth of zeroed bytes starting at the
    # truncated offset; verify black coverage is within [floor, ceil]
    # module footprints of the matrix
    dark_modules = int(m.sum())
    black_px = int((canvas[..., 0] == 0).sum())
    assert dark_modules * 2 * 2 <= black_px <= dark_modules * 3 * 3 * 2
    # alpha bytes can be clobbered by straddling writes (the C writes
    # 3 consecutive bytes from a possibly mid-pixel offset)
    assert (canvas[..., 3] != 255).any()


def test_qroverlay_element_fractional_ps_blends():
    # fractional pixel-size produces non-uniform module widths (the
    # C's per-expression truncation, faithfully kept) — cv2 can't
    # decode such symbols, so assert the square's geometry instead
    W, H = 400, 300
    el = gt.make("qroverlay", data="frac ps", **{"pixel-size": 4.5})
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="BGRx", width=W, height=H,
                          framerate=fractions.Fraction(30)))
    img = np.full((1, H, W, 4), 128, np.uint8)
    out = np.asarray(p.run(inputs=FrameBatch.make(
        jnp.asarray(img)))[0].data)
    changed = (out[0] != img[0]).any(axis=-1)
    ys, xs = np.where(changed)
    n = qr.encode("frac ps", "M").shape[0]
    sq = int((n + 8) * 4.5)
    assert ys.max() - ys.min() + 1 <= sq
    assert xs.max() - xs.min() + 1 <= sq
    assert changed.sum() > sq * sq // 4       # substantial square
