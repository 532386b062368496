"""vmncdec (gst/vmnc/vmncdec.c): io/vmnc.py decoder vs a test-side RFB
encoder + numpy framebuffer model."""

import struct

import numpy as np
import jax.numpy as jnp
import pytest

import gstbad as gt
from gstbad.core.pipeline import Pipeline
from gstbad.io import vmnc


def _rect(x, y, w, h, rtype, body=b""):
    return struct.pack(">HHHHI", x, y, w, h, rtype) + body


def _update(*rects):
    return struct.pack(">BBH", 0, 0, len(rects)) + b"".join(rects)


def _wmvi(w, h, bpp=32, rs=16, gs=8, bs=0, be=0):
    body = bytes([bpp, 24, be, 1]) + struct.pack(">HHH", 255, 255, 255) \
        + bytes([rs, gs, bs]) + b"\x00\x00\x00"
    return _rect(0, 0, w, h, vmnc.TYPE_WMVi, body)


def _px(r, g, b, rs=16, gs=8, bs=0):
    word = (r << rs) | (g << gs) | (b << bs)
    return struct.pack("<I", word)   # little-endian data


W, H = 64, 48


def test_raw_and_copy():
    dec = vmnc.VMncDecoder()
    raw = _px(10, 20, 30) * (8 * 8)
    pkt = _update(_wmvi(W, H),
                  _rect(4, 4, 8, 8, vmnc.TYPE_RAW, raw))
    assert dec.feed_packet(pkt) == len(pkt)
    out = dec.output_frame()
    model = np.zeros((H, W, 4), np.uint8)
    model[4:12, 4:12] = np.frombuffer(_px(10, 20, 30), np.uint8)
    np.testing.assert_array_equal(out, model)
    # copy the block elsewhere (including overlap handling)
    pkt2 = _update(_rect(6, 6, 8, 8, vmnc.TYPE_COPY,
                         struct.pack(">HH", 4, 4)))
    assert dec.feed_packet(pkt2) == len(pkt2)
    model[6:14, 6:14] = model[4:12, 4:12]    # numpy copies source first
    np.testing.assert_array_equal(dec.output_frame(), model)


def test_hextile():
    dec = vmnc.VMncDecoder()
    # rect 20x20 at (8, 8): tiles 16x16, 4x16, 16x4, 4x4
    # tile 1: bg+fg+subrects (flags 0x2|0x4|0x8)
    t1 = bytes([0x2 | 0x4 | 0x8]) + _px(1, 2, 3) + _px(9, 8, 7) \
        + bytes([2]) + bytes([(2 << 4) | 3, (4 << 4) | 5]) \
        + bytes([(0 << 4) | 0, (0 << 4) | 0])
    # tile 2 (4 wide): raw
    t2 = bytes([0x1]) + _px(5, 5, 5) * (4 * 16)
    # tile 3 (16x4): coloured subrects (flags 0x8|0x10), bg carries over
    t3 = bytes([0x8 | 0x10]) + bytes([1]) + _px(40, 41, 42) \
        + bytes([(1 << 4) | 1, (7 << 4) | 2])
    # tile 4 (4x4): background only (reuses carried bg)
    t4 = bytes([0x0])
    pkt = _update(_wmvi(W, H),
                  _rect(8, 8, 20, 20, vmnc.TYPE_HEXTILE,
                        t1 + t2 + t3 + t4))
    assert dec.feed_packet(pkt) == len(pkt)
    out = dec.output_frame()
    model = np.zeros((H, W, 4), np.uint8)
    bg = np.frombuffer(_px(1, 2, 3), np.uint8)
    fg = np.frombuffer(_px(9, 8, 7), np.uint8)
    model[8:24, 8:24] = bg                          # tile 1 bg
    model[8 + 3:8 + 3 + 6, 8 + 2:8 + 2 + 5] = fg   # subrect 1
    model[8:1 + 8, 8:1 + 8] = fg                   # subrect 2 (1x1)
    model[8:24, 24:28] = np.frombuffer(_px(5, 5, 5), np.uint8)
    model[24:28, 8:24] = bg                         # tile 3 bg carry
    c = np.frombuffer(_px(40, 41, 42), np.uint8)
    model[24 + 1:24 + 1 + 3, 8 + 1:8 + 1 + 8] = c  # coloured subrect
    model[24:28, 24:28] = bg                        # tile 4 bg carry
    np.testing.assert_array_equal(out, model)


def test_cursor_pseudo_encodings():
    dec = vmnc.VMncDecoder()
    base = _px(100, 100, 100) * (W * H)
    cur = _px(255, 0, 0) * 4                       # 2x2 cursor data
    # mask: AND 0 + XOR data -> replaces pixels
    data = b"\x00" + b"\x00" + b"\x00" * 16 + cur
    pkt = _update(
        _wmvi(W, H),
        _rect(0, 0, W, H, vmnc.TYPE_RAW, base),
        _rect(1, 1, 2, 2, vmnc.TYPE_WMVd,
              bytes([vmnc.CURSOR_COLOUR, 0]) + b"\x00" * 16 + cur),
        _rect(10, 10, 0, 0, vmnc.TYPE_WMVf),       # position (10, 10)
        _rect(0, 0, 0, 0, vmnc.TYPE_WMVe, struct.pack(">H", 1)))
    del data
    assert dec.feed_packet(pkt) == len(pkt)
    out = dec.output_frame()
    grey = np.frombuffer(_px(100, 100, 100), np.uint8)
    red = np.frombuffer(_px(255, 0, 0), np.uint8)
    model = np.tile(grey, (H, W, 1))
    # hotspot (1,1): cursor top-left at (9, 9); AND-plane 0 ^ red = red
    model[9:11, 9:11] = red
    np.testing.assert_array_equal(out, model)
    # the stored framebuffer stays cursor-free
    assert (dec.imagedata.reshape(H, W, 4) == grey).all()
    # hide the cursor again
    pkt2 = _update(_rect(0, 0, 0, 0, vmnc.TYPE_WMVe,
                         struct.pack(">H", 0)))
    dec.feed_packet(pkt2)
    assert (dec.output_frame() == grey).all()


def test_wmvi_byte_layouts_and_element():
    # BGRx layout: data LE with shifts r=16 g=8 b=0 -> byte order B,G,R,x
    packets = []
    base = _px(1, 2, 3) * (W * H)
    packets.append(_update(_wmvi(W, H),
                           _rect(0, 0, W, H, vmnc.TYPE_RAW, base)))
    packets.append(_update(_rect(2, 2, 4, 4, vmnc.TYPE_RAW,
                                 _px(200, 100, 50) * 16)))
    el = gt.make("vmncdec", framerate="25/1")
    for p in packets:
        el.push_packet(p)
    pipe = Pipeline([el])
    spec = pipe.negotiate(None)
    assert el.out_spec.format == "BGRx"
    assert el.out_spec.width == W and el.out_spec.height == H
    outs = pipe.run(n_frames=2)
    frames = np.concatenate([np.asarray(o.data) for o in outs])
    assert frames.shape[0] == 2
    # BGRx channel order: byte 0 = blue
    np.testing.assert_array_equal(frames[0][0, 0], [3, 2, 1, 0])
    np.testing.assert_array_equal(frames[1][2, 2], [50, 100, 200, 0])
    np.testing.assert_array_equal(frames[1][0, 0], [3, 2, 1, 0])
    assert np.asarray(outs[0].pts if hasattr(outs[0], "pts") else 0
                      )[1] == 10 ** 9 // 25


def test_wmvi_rgbx_and_gray8():
    # shifts r=0 g=8 b=16 on LE data -> byte order R,G,B,x = RGBx
    dec_pkt = _update(_wmvi(W, H, rs=0, gs=8, bs=16))
    el = gt.make("vmncdec")
    el.push_packet(dec_pkt)
    Pipeline([el]).negotiate(None)
    assert el.out_spec.format == "RGBx"
    # 8-bit -> GRAY8
    body8 = bytes([8, 8, 0, 1]) + struct.pack(">HHH", 7, 7, 3) \
        + bytes([5, 2, 0]) + b"\x00\x00\x00"
    pkt8 = _update(_rect(0, 0, W, H, vmnc.TYPE_WMVi, body8))
    el2 = gt.make("vmncdec")
    el2.push_packet(pkt8)
    Pipeline([el2]).negotiate(None)
    assert el2.out_spec.format == "GRAY8"


def test_error_paths():
    dec = vmnc.VMncDecoder()
    # rectangle before WMVi
    pkt = _update(_rect(0, 0, 4, 4, vmnc.TYPE_RAW, b"\x00" * 64))
    assert dec.feed_packet(pkt) == vmnc.ERROR_INVALID
    # truncated raw data
    dec2 = vmnc.VMncDecoder()
    pkt2 = _update(_wmvi(W, H), _rect(0, 0, 4, 4, vmnc.TYPE_RAW, b"xx"))
    assert dec2.feed_packet(pkt2) == vmnc.ERROR_INSUFFICIENT_DATA
    # paletted (truecolour flag 0) rejected
    dec3 = vmnc.VMncDecoder()
    body = bytes([32, 24, 0, 0]) + b"\x00" * 12
    pkt3 = _update(_rect(0, 0, W, H, vmnc.TYPE_WMVi, body))
    assert dec3.feed_packet(pkt3) == vmnc.ERROR_INVALID


def test_wmvi_16bit_565_and_555():
    """bpp=16 bit-field streams negotiate the RGB16/RGB15 family and the
    u16 plane carries the packed fields in native order."""
    # 565, LE: r mask 31 @11, g mask 63 @5, b mask 31 @0 -> RGB16
    body16 = bytes([16, 16, 0, 1]) + struct.pack(">HHH", 31, 63, 31) \
        + bytes([11, 5, 0]) + b"\x00\x00\x00"
    word = (7 << 11) | (33 << 5) | 19
    raw = struct.pack("<H", word) * (W * H)
    pkt = _update(_rect(0, 0, W, H, vmnc.TYPE_WMVi, body16),
                  _rect(0, 0, W, H, vmnc.TYPE_RAW, raw))
    el = gt.make("vmncdec")
    el.push_packet(pkt)
    pipe = Pipeline([el])
    pipe.negotiate(None)
    assert el.out_spec.format == "RGB16"
    out = np.asarray(pipe.run(n_frames=1)[0].data)
    assert out.dtype == np.uint16
    assert out[0, 0, 0] == word
    # 555 with b high -> BGR15
    body15 = bytes([16, 15, 0, 1]) + struct.pack(">HHH", 31, 31, 31) \
        + bytes([0, 5, 10]) + b"\x00\x00\x00"
    el2 = gt.make("vmncdec")
    el2.push_packet(_update(_rect(0, 0, W, H, vmnc.TYPE_WMVi, body15)))
    Pipeline([el2]).negotiate(None)
    assert el2.out_spec.format == "BGR15"


def test_wmvi_16bit_big_endian_bytes():
    """big-endian 16-bit stream bytes land in the same native u16."""
    body = bytes([16, 16, 1, 1]) + struct.pack(">HHH", 31, 63, 31) \
        + bytes([11, 5, 0]) + b"\x00\x00\x00"
    word = (1 << 11) | (2 << 5) | 3
    raw = struct.pack(">H", word) * (W * H)
    el = gt.make("vmncdec")
    el.push_packet(_update(_rect(0, 0, W, H, vmnc.TYPE_WMVi, body),
                           _rect(0, 0, W, H, vmnc.TYPE_RAW, raw)))
    pipe = Pipeline([el])
    pipe.negotiate(None)
    assert el.out_spec.format == "RGB16"
    out = np.asarray(pipe.run(n_frames=1)[0].data)
    assert out[0, 0, 0] == word
