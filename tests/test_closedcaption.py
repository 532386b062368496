"""closedcaption family: line21 waveform golden, encoder/decoder round
trip, cccombiner/ccextractor cc-plane flow (ext/closedcaption/)."""

import fractions

import numpy as np
import jax.numpy as jnp

import gstbad as gt
from gstbad.core.frame import FrameBatch
from gstbad.core.pipeline import Pipeline
from gstbad.core.spec import MediaSpec
from gstbad.golden import line21 as G
from gstbad.ops import line21 as O


def _pairs(rng, n):
    return np.stack(
        [[G.parity_byte(int(rng.integers(0, 128))),
          G.parity_byte(int(rng.integers(0, 128)))] for _ in range(n)]
    ).astype(np.uint8)


def test_ops_match_golden_and_roundtrip():
    rng = np.random.default_rng(0)
    pairs = _pairs(rng, 32)
    enc_g = np.stack([G.encode_line(int(p[0]), int(p[1])) for p in pairs])
    np.testing.assert_array_equal(
        np.asarray(O.encode_lines(jnp.asarray(pairs))), enc_g)
    found, dec = O.decode_lines(jnp.asarray(enc_g))
    assert np.asarray(found).all()
    np.testing.assert_array_equal(np.asarray(dec), pairs)
    # plain video content must not decode
    junk = rng.integers(0, 256, (6, 720)).astype(np.uint8)
    f2, _ = O.decode_lines(jnp.asarray(junk))
    assert not np.asarray(f2).any()


def _i420(b, h, w, rng):
    return {"y": jnp.asarray(rng.integers(16, 235, (b, h, w), np.uint8)),
            "u": jnp.asarray(rng.integers(16, 240, (b, h // 2, w // 2),
                                          np.uint8)),
            "v": jnp.asarray(rng.integers(16, 240, (b, h // 2, w // 2),
                                          np.uint8))}


def _s334(pairs_f1, pairs_f2):
    b = pairs_f1.shape[0]
    cc = np.zeros((b, 6), np.uint8)
    cc[:, 0] = 0x80
    cc[:, 1:3] = pairs_f1
    cc[:, 3] = 0x00
    cc[:, 4:6] = pairs_f2
    return cc


def test_encoder_decoder_pipeline_roundtrip():
    rng = np.random.default_rng(1)
    b, h, w = 4, 525, 720
    f1 = _pairs(rng, b)
    f2 = _pairs(rng, b)
    cc = _s334(f1, f2)

    enc = gt.make("line21encoder")
    dec = gt.make("line21decoder")
    p = Pipeline([enc, dec])
    p.negotiate(MediaSpec(kind="video", format="I420", width=w, height=h,
                          framerate=fractions.Fraction(30)))
    data = dict(_i420(b, h, w, rng))
    data["cc"] = jnp.asarray(cc)
    outs = p.run(inputs=FrameBatch.make(data))
    out = outs[0]
    got_cc = np.asarray(out.data["cc"])
    np.testing.assert_array_equal(got_cc[:, 1:3], f1)
    np.testing.assert_array_equal(got_cc[:, 4:6], f2)
    # waveform rows landed at 21/22 (gstline21enc.c:517-520)
    y = np.asarray(out.data["y"])
    for i in range(b):
        np.testing.assert_array_equal(
            y[i, 21], G.encode_line(int(f1[i, 0]), int(f1[i, 1])))
        np.testing.assert_array_equal(
            y[i, 22], G.encode_line(int(f2[i, 0]), int(f2[i, 1])))
    msgs = p.bus.pop(name="line21")
    assert len(msgs) == b


def test_reduced_height_uses_line_1():
    rng = np.random.default_rng(2)
    b, h, w = 2, 486, 720
    f1 = _pairs(rng, b)
    f2 = _pairs(rng, b)
    enc = gt.make("line21encoder")
    p = Pipeline([enc])
    p.negotiate(MediaSpec(kind="video", format="I420", width=w, height=h,
                          framerate=fractions.Fraction(30)))
    data = dict(_i420(b, h, w, rng))
    data["cc"] = jnp.asarray(_s334(f1, f2))
    out = p.run(inputs=FrameBatch.make(data))[0]
    y = np.asarray(out.data["y"])
    np.testing.assert_array_equal(
        y[0, 1], G.encode_line(int(f1[0, 0]), int(f1[0, 1])))
    np.testing.assert_array_equal(
        y[0, 2], G.encode_line(int(f2[0, 0]), int(f2[0, 1])))


def test_combiner_and_extractor():
    rng = np.random.default_rng(3)
    b, h, w = 3, 48, 64
    f1 = _pairs(rng, b)
    f2 = _pairs(rng, b)
    cc = _s334(f1, f2)

    from gstbad.core.pipeline import Node

    vsrc = gt.make("appsrc", format="I420", width=w, height=h)
    csrc = gt.make("appsrc", format="I420", width=6, height=1)
    comb = gt.make("cccombiner")
    ext = gt.make("ccextractor", **{"remove-caption-meta": True})
    nv, nc = Node(vsrc), Node(csrc)
    ncomb = Node(comb)
    ncomb.inputs = [nv, nc]
    next_ = Node(ext)
    next_.inputs = [ncomb]
    p = Pipeline(nodes=[nv, nc, ncomb, next_])
    p.negotiate()
    vsrc.push_frames(
        {k: np.asarray(v) for k, v in _i420(b, h, w, rng).items()})
    csrc.push_frames(cc)
    outs = p.run(window=b)
    out = outs[0]
    assert "cc" not in out.data                  # extractor stripped it
    msgs = p.bus.pop(name="cc-data")
    assert len(msgs) == b
    got = np.stack([np.asarray(m.fields["data"]) for m in msgs])
    np.testing.assert_array_equal(got, cc)


def test_decoder_no_false_positive_on_plain_video():
    rng = np.random.default_rng(4)
    b, h, w = 2, 525, 720
    dec = gt.make("line21decoder")
    p = Pipeline([dec])
    p.negotiate(MediaSpec(kind="video", format="I420", width=w, height=h,
                          framerate=fractions.Fraction(30)))
    out = p.run(inputs=FrameBatch.make(_i420(b, h, w, rng)))[0]
    cc = np.asarray(out.data["cc"])
    np.testing.assert_array_equal(
        cc, np.tile([0x80, 0x80, 0x80, 0, 0x80, 0x80], (b, 1)))
    assert not p.bus.pop(name="line21")


def test_cea608_io_conversions():
    """io/cea608.py vs hand-built vectors (gstccconverter.c paths)."""
    from gstbad.io import cea608 as C

    raw = bytes([0x94, 0x2C, 0x80, 0x80])
    s334 = C.raw_to_s334(raw)
    assert s334 == bytes([0x80, 0x94, 0x2C, 0x80, 0x80, 0x80])
    assert C.s334_to_raw(s334) == raw
    ccd = C.s334_to_cc_data(bytes([0x80, 1, 2, 0x00, 3, 4]))
    assert ccd == bytes([0xFC, 1, 2, 0xFD, 3, 4])
    assert C.cc_data_to_s334(ccd) == bytes([0x80, 1, 2, 0x00, 3, 4])

    cdp = C.cc_data_to_cdp(ccd, (30000, 1001), sequence=7)
    assert cdp[:2] == b"\x96\x69" and cdp[2] == len(cdp)
    assert cdp[3] == 0x4F                       # 29.97 fps idx
    assert (sum(cdp) & 0xFF) == 0               # additive checksum
    got, fps = C.cdp_to_cc_data(cdp)
    assert fps == (30000, 1001)
    assert got[:6] == ccd and set(got[6::3]) == {0xFA}
    # compact drops the padding triplets (not cc_valid)
    assert C.compact_cc_data(got) == ccd


def test_ccconverter_element_cdp_roundtrip():
    from gstbad.io import cea608 as C

    rng = np.random.default_rng(5)
    b, h, w = 3, 48, 64
    f1 = _pairs(rng, b)
    f2 = _pairs(rng, b)
    cc = _s334(f1, f2)

    enc = gt.make("ccconverter", **{"input-type": "s334-1a",
                                    "output-type": "cdp"})
    p = Pipeline([enc])
    p.negotiate(MediaSpec(kind="video", format="I420", width=w, height=h,
                          framerate=fractions.Fraction(30)))
    data = dict(_i420(b, h, w, rng))
    data["cc"] = jnp.asarray(cc)
    out = p.run(inputs=FrameBatch.make(data))[0]
    cdp = np.asarray(out.data["cc"])
    for i in range(b):
        # matches the io-layer spec byte for byte (sequence = frame index)
        want = C.cc_data_to_cdp(C.s334_to_cc_data(bytes(cc[i])),
                                (30, 1), sequence=i)
        np.testing.assert_array_equal(cdp[i], np.frombuffer(want, np.uint8))
    # and back
    dec = gt.make("ccconverter", **{"input-type": "cdp",
                                    "output-type": "s334-1a"})
    p2 = Pipeline([dec])
    p2.negotiate(MediaSpec(kind="video", format="I420", width=w, height=h,
                           framerate=fractions.Fraction(30)))
    d2 = dict(_i420(b, h, w, rng))
    d2["cc"] = jnp.asarray(cdp)
    out2 = p2.run(inputs=FrameBatch.make(d2))[0]
    np.testing.assert_array_equal(np.asarray(out2.data["cc"]), cc)


def _svc_block(service, payload):
    assert len(payload) <= 31
    return bytes([(service << 5) | len(payload)]) + payload


def _dtvcc_packet(service_payload, seq=0):
    body = service_payload
    # packet_size field: DTVCC_PKT_SIZE(n)*2-1 bytes follow; use the
    # padded convention: total (1 + len) even
    if len(body) % 2 == 0:
        body += b"\x00"
    size_code = (len(body) + 1) // 2
    return bytes([(seq << 6) | size_code]) + body


def _cc_data_from_dtvcc(pkt):
    """Wrap a DTVCC packet into cc_data triplets: first pair type 3,
    rest type 2 (gstceaccoverlay.c:1549-1560)."""
    if len(pkt) % 2:
        pkt += b"\x00"
    out = bytearray()
    for i in range(0, len(pkt), 2):
        t = 3 if i == 0 else 2
        out += bytes([0x04 | t, pkt[i], pkt[i + 1]])
    return bytes(out)


def test_cea708_decode_text_window():
    from gstbad.io import cea708 as C

    # DF0: visible window at anchor 0, 2 rows x 16 cols, then text
    df0 = bytes([C.CMD_DF0, 0x20, 10, 40, (0 << 4) | 1, 15, 0])
    text = b"HI 708"
    etx = bytes([0x03])
    payload = _svc_block(1, df0 + text + etx)
    pkt = _dtvcc_packet(payload)
    dec = C.Cea708Decoder()
    need1 = dec.feed_cc_data(_cc_data_from_dtvcc(pkt))
    # packet flushes when the NEXT one starts; push an empty starter
    need2 = dec.feed_cc_data(_cc_data_from_dtvcc(_dtvcc_packet(
        _svc_block(1, bytes([0x03])))))
    assert need1 or need2
    win = dec.windows[0]
    assert not win.deleted and win.visible
    row0 = "".join(chr(c) for c in win.text[0][:6])
    assert row0 == "HI 708"
    assert win.row_count == 2 and win.column_count == 16

    ov = C.render_overlay(dec, 320, 240)
    assert (ov[..., 0] == 255).any()          # window box present
    assert (ov[..., 1] > 0).any()             # glyph pixels


def test_cea708_commands_clear_hide_delete():
    from gstbad.io import cea708 as C

    dec = C.Cea708Decoder()
    df0 = bytes([C.CMD_DF0, 0x20, 10, 40, 0x01, 15, 0])
    seq = df0 + b"ABC" + bytes([C.CMD_HDW, 0x01])  # hide window 0
    dec.feed_cc_data(_cc_data_from_dtvcc(_dtvcc_packet(_svc_block(1, seq))))
    dec.feed_cc_data(_cc_data_from_dtvcc(_dtvcc_packet(
        _svc_block(1, bytes([0x03])))))
    assert not dec.windows[0].visible
    assert "".join(chr(c) for c in dec.windows[0].text[0][:3]) == "ABC"
    # display again, then CLW clears the text
    seq2 = bytes([C.CMD_DSW, 0x01, C.CMD_CLW, 0x01])
    dec.feed_cc_data(_cc_data_from_dtvcc(_dtvcc_packet(_svc_block(1, seq2))))
    dec.feed_cc_data(_cc_data_from_dtvcc(_dtvcc_packet(
        _svc_block(1, bytes([0x03])))))
    assert dec.windows[0].visible
    assert all(c == 0x20 for c in dec.windows[0].text[0])
    # DLW deletes
    dec.feed_cc_data(_cc_data_from_dtvcc(_dtvcc_packet(
        _svc_block(1, bytes([C.CMD_DLW, 0x01])))))
    dec.feed_cc_data(_cc_data_from_dtvcc(_dtvcc_packet(
        _svc_block(1, bytes([0x03])))))
    assert dec.windows[0].deleted


def test_ceaccoverlay_element():
    from gstbad.io import cea708 as C

    df0 = bytes([C.CMD_DF0, 0x20, 30, 50, 0x01, 15, 0])
    pkt1 = _dtvcc_packet(_svc_block(1, df0 + b"CAPTION" + bytes([0x03])))
    flusher = _dtvcc_packet(_svc_block(1, bytes([0x03])))

    el = gt.make("ceaccoverlay")
    el.push_cc(_cc_data_from_dtvcc(pkt1), pts_ns=0)
    el.push_cc(_cc_data_from_dtvcc(flusher), pts_ns=10)
    p = Pipeline([el])
    w, h = 320, 240
    p.negotiate(MediaSpec(kind="video", format="AYUV", width=w, height=h,
                          framerate=fractions.Fraction(30)))
    img = np.full((2, h, w, 4), 60, np.uint8)
    pts = jnp.asarray([10 ** 9, 2 * 10 ** 9], jnp.int64)
    outs = p.run(inputs=FrameBatch.make(jnp.asarray(img), pts=pts))
    out = np.concatenate([np.asarray(o.data) for o in outs])
    changed = (out[0] != img[0]).any(axis=-1)
    assert changed.any()                      # caption box blended
    # silent mutes everything
    el2 = gt.make("ceaccoverlay", silent=True)
    el2.push_cc(_cc_data_from_dtvcc(pkt1), pts_ns=0)
    p2 = Pipeline([el2])
    p2.negotiate(MediaSpec(kind="video", format="AYUV", width=w, height=h,
                           framerate=fractions.Fraction(30)))
    out2 = np.asarray(p2.run(
        inputs=FrameBatch.make(jnp.asarray(img), pts=pts))[0].data)
    np.testing.assert_array_equal(out2, img)


# -- ceaccoverlay pango face (r3): the reference's actual render path --------

import pytest


def _pango_ok():
    from gstbad.io import cea708 as C
    return C.pango_available()


needs_pango708 = pytest.mark.skipif(not _pango_ok(),
                                    reason="pango not present")


def _decoder_with_styled_text():
    from gstbad.io import cea708 as C
    dec = C.Cea708Decoder()
    df0 = bytes([C.CMD_DF0, 0x20, 30, 40, (0 << 4) | 1, 31, 0])
    # SPA: pen_size standard, italics+underline on the styled run
    spa_italic = bytes([C.CMD_SPA, 0x01, 0x80 | 0x40])
    spa_plain = bytes([C.CMD_SPA, 0x01, 0x00])
    # SPC: red foreground on black
    spc_red = bytes([C.CMD_SPC, 0x20, 0x00, 0x00])
    seq = (df0 + b"AB" + spa_italic + spc_red + b"CD"
           + spa_plain + b"EF" + bytes([0x03]))
    dec.feed_cc_data(_cc_data_from_dtvcc(_dtvcc_packet(
        _svc_block(1, seq[:31]))))
    # payload may exceed one service block: send the rest if any
    rest = seq[31:]
    if rest:
        dec.feed_cc_data(_cc_data_from_dtvcc(_dtvcc_packet(
            _svc_block(1, rest))))
    dec.feed_cc_data(_cc_data_from_dtvcc(_dtvcc_packet(
        _svc_block(1, bytes([0x03])))))
    return dec


def test_cea708_pen_state_snapshots():
    from gstbad.io import cea708 as C
    dec = _decoder_with_styled_text()
    win = dec.windows[0]
    assert "".join(chr(c) for c in win.text[0][:6]) == "ABCDEF"
    assert not win.pens[0][0].italics
    assert win.pens[0][2].italics and win.pens[0][2].underline
    assert win.pens[0][2].fg_color == C.COLOR_RED
    assert not win.pens[0][4].italics          # SPA reset
    assert win.pens[0][4].fg_color == C.COLOR_RED   # color persists


@needs_pango708
def test_cea708_window_markup_spans():
    from gstbad.io import cea708 as C
    dec = _decoder_with_styled_text()
    markup = C.window_markup(dec.windows[0])
    # default-pen text renders inside a white-on-black span
    assert markup.startswith("<span font_desc='serif 36' "
                             "foreground='white' background='black'>AB")
    assert (" underline='single' style='italic' font_desc='serif 36'"
            " foreground='red' background='black'>CD") in markup
    # SPA reset closes the styled span; red persists from SPC
    assert "foreground='red' background='black'>EF" in markup
    assert markup.count("</span>") >= 2


@needs_pango708
def test_cea708_render_overlay_pango_geometry():
    from gstbad.io import cea708 as C
    dec = _decoder_with_styled_text()
    ov = C.render_overlay_pango(dec, 640, 480)
    a = ov[..., 0]
    assert (a > 0).any()
    ys, xs = np.nonzero(a)
    # window-h-pos center: image centered horizontally
    mid = (xs.min() + xs.max()) / 2
    assert abs(mid - 320) < 40
    # red glyphs present: V plane high where fg=red
    red = (a > 200) & (ov[..., 3] > 180)
    assert red.any()


@needs_pango708
def test_ceaccoverlay_element_pango_face():
    import gstbad as gt
    from gstbad.core.pipeline import Pipeline
    from gstbad.io import cea708 as C
    df0 = bytes([C.CMD_DF0, 0x20, 30, 40, 0x01, 15, 0])
    seq = df0 + b"CAPTION" + bytes([0x03])
    cc = _cc_data_from_dtvcc(_dtvcc_packet(_svc_block(1, seq))) \
        + _cc_data_from_dtvcc(_dtvcc_packet(_svc_block(1,
                                                       bytes([0x03]))))
    el = gt.make("ceaccoverlay")
    el.push_cc(cc, pts_ns=0)
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="AYUV",
                          width=320, height=240))
    frames = np.full((2, 240, 320, 4), 64, np.uint8)
    outs = p.run(inputs=FrameBatch.make(jnp.asarray(frames)))
    out = np.asarray(outs[0].data)
    assert el._face == "pango"
    assert (out != frames).any()
    # face=fixed still renders (differently)
    el2 = gt.make("ceaccoverlay", face="fixed")
    el2.push_cc(cc, pts_ns=0)
    p2 = Pipeline([el2])
    p2.negotiate(MediaSpec(kind="video", format="AYUV",
                           width=320, height=240))
    outs2 = p2.run(inputs=FrameBatch.make(jnp.asarray(frames)))
    out2 = np.asarray(outs2[0].data)
    assert el2._face == "fixed"
    assert (out2 != frames).any()
    assert (out != out2).any()


# -- line21 waveform oracle: zvbi's REAL adaptive bit slicer ------------------

def _zvbi_ok():
    from gstbad.io import zvbi
    return zvbi.available()


needs_zvbi = pytest.mark.skipif(not _zvbi_ok(),
                                reason="libzvbi not present")


@needs_zvbi
def test_line21_golden_waveforms_slice_with_zvbi():
    """golden/line21 encode_line -> vbi_raw_decode round-trips every
    byte pair through the exact slicer the reference stack uses."""
    from gstbad.golden import line21 as G
    from gstbad.io import zvbi
    rng = np.random.default_rng(11)
    pairs = [(0x14, 0x2C), (0x00, 0x00), (0x7F, 0x7F)] + [
        tuple(rng.integers(0, 128, 2)) for _ in range(25)]
    for v0, v1 in pairs:
        b0, b1 = G.parity_byte(int(v0)), G.parity_byte(int(v1))
        got = zvbi.slice_caption_line(G.encode_line(b0, b1))
        assert got == (b0, b1), (hex(b0), hex(b1), got)


@needs_zvbi
def test_line21_device_encoder_slices_with_zvbi():
    """ops/line21.encode_lines (the device path) produces waveforms
    zvbi slices back byte-exact too."""
    from gstbad.golden import line21 as G
    from gstbad.io import zvbi
    rng = np.random.default_rng(12)
    vals = rng.integers(0, 128, (8, 2))
    pairs = np.asarray([[G.parity_byte(int(a)), G.parity_byte(int(b))]
                        for a, b in vals], np.int32)
    lines = np.asarray(O.encode_lines(jnp.asarray(pairs)))
    for k in range(len(pairs)):
        got = zvbi.slice_caption_line(lines[k].astype(np.uint8))
        assert got == (int(pairs[k][0]), int(pairs[k][1]))
