"""DVB subtitle bitstream decode (io/dvbsub.py) + dvbsuboverlay element.

Segment streams are assembled byte-for-byte per ETSI EN 300 743 /
dvb-sub.c, independent of the parser.
"""

import fractions

import numpy as np
import jax.numpy as jnp

import gstbad as gt
from gstbad.core.frame import FrameBatch
from gstbad.core.pipeline import Pipeline
from gstbad.core.spec import MediaSpec
from gstbad.io import dvbsub


class BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, value, n):
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def bytes(self):
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(
            int("".join(map(str, bits[i:i + 8])), 2)
            for i in range(0, len(bits), 8))


def seg(stype, payload, page_id=1):
    return bytes([dvbsub.SYNC_BYTE, stype, page_id >> 8, page_id & 0xFF,
                  len(payload) >> 8, len(payload) & 0xFF]) + payload


def pes(*segs):
    return b"\x20\x00" + b"".join(segs) + b"\xFF"


def page_seg(regions, time_out=5, state=0):
    p = bytearray([time_out, state << 2])
    for rid, x, y in regions:
        p += bytes([rid, 0, x >> 8, x & 0xFF, y >> 8, y & 0xFF])
    return seg(dvbsub.SEGMENT_PAGE, bytes(p))


def region_seg(rid, w, h, depth, clut_id=0, bg=0, objects=()):
    exp = {2: 1, 4: 2, 8: 3}[depth]
    if depth == 8:
        tail = bytes([bg, 0])
    elif depth == 4:
        tail = bytes([0, bg << 4])
    else:
        tail = bytes([0, bg << 2])
    p = bytearray([rid, 1 << 3, w >> 8, w & 0xFF, h >> 8, h & 0xFF,
                   exp << 2, clut_id]) + tail
    for oid, x, y in objects:
        p += bytes([oid >> 8, oid & 0xFF, x >> 8, x & 0xFF,
                    y >> 8, y & 0xFF])
    return seg(dvbsub.SEGMENT_REGION, bytes(p))


def object_seg(oid, top, bottom=b""):
    p = bytes([oid >> 8, oid & 0xFF, 0, len(top) >> 8, len(top) & 0xFF,
               len(bottom) >> 8, len(bottom) & 0xFF]) + top + bottom
    return seg(dvbsub.SEGMENT_OBJECT, p)


def rle4_line(runs):
    """Encode [(count, color), ...] as a 4-bit pixel string + end."""
    bw = BitWriter()
    for count, color in runs:
        if color == 0:
            assert 3 <= count <= 9
            bw.put(0, 4)
            bw.put(0, 1)
            bw.put(count - 2, 3)
        elif count == 1:
            bw.put(color, 4)
        elif 4 <= count <= 7:
            bw.put(0, 4)
            bw.put(1, 1)
            bw.put(0, 1)
            bw.put(count - 4, 2)
            bw.put(color, 4)
        elif 9 <= count <= 24:
            bw.put(0, 4)
            bw.put(1, 1)
            bw.put(1, 1)
            bw.put(2, 2)
            bw.put(count - 9, 4)
            bw.put(color, 4)
        else:
            for _ in range(count):
                bw.put(color, 4)
    bw.put(0, 4)
    bw.put(0, 4)                  # 0000 0 000 = end of string
    return bw.bytes()


def test_default_cluts_spec_values():
    # dvb-sub.c:305-308 via the rgb_to_* fixed-point transforms
    def ay(v):
        return (v >> 24) & 0xFF, (v >> 16) & 0xFF

    a, y = ay(int(dvbsub.DEFAULT_CLUT4[0]))
    assert a == 0
    a, y = ay(int(dvbsub.DEFAULT_CLUT4[1]))
    assert a == 255 and y == 254         # 76+149+29 per-term truncation
    a, y = ay(int(dvbsub.DEFAULT_CLUT16[1]))   # pure red, full intensity
    assert a == 255 and y == 76
    assert (int(dvbsub.DEFAULT_CLUT256[1]) >> 24) == 63


def test_region_object_rle4_decode():
    line_a = rle4_line([(4, 3), (1, 1), (1, 1)])           # rest stays bg
    line_b = rle4_line([(6, 5), (1, 2)])
    top = b"\x11" + line_a + b"\xf0" + b"\x11" + line_b
    bot = b"\x11" + line_b + b"\xf0" + b"\x11" + line_a
    parser = dvbsub.DvbSubParser()
    sets = parser.feed(pes(
        page_seg([(1, 10, 20)]),
        region_seg(1, 8, 4, 4, objects=[(7, 0, 0)]),
        object_seg(7, top, bot),
        seg(dvbsub.SEGMENT_END_OF_DISPLAY_SET, b""),
    ), pts_ns=10 ** 9)
    assert len(sets) == 1
    ds = sets[0]
    assert ds.page_time_out == 5 and ds.pts_ns == 10 ** 9
    assert len(ds.rects) == 1
    r = ds.rects[0]
    assert (r.x, r.y, r.w, r.h, r.depth) == (10, 20, 8, 4, 4)
    a = [3, 3, 3, 3, 1, 1, 0, 0]
    b = [5, 5, 5, 5, 5, 5, 2, 0]
    np.testing.assert_array_equal(r.indices,
                                  np.array([a, b, b, a], np.uint8))


def test_clut_segment_and_transparency_quirk():
    # entry 3 full-range, entry 4 with y=0 -> forced transparent
    clut_payload = bytes([
        0, 0,                              # clut_id, version byte
        3, 0x40 | 1, 200, 100, 50, 16,     # 16-entry table, full range
        4, 0x40 | 1, 0, 10, 20, 5,         # y == 0 quirk
    ])
    parser = dvbsub.DvbSubParser()
    parser.feed(pes(seg(dvbsub.SEGMENT_CLUT, clut_payload)))
    clut = parser.cluts[0]
    assert int(clut["clut16"][3]) == ((255 - 16) << 24) | (200 << 16) | \
        (50 << 8) | 100
    assert (int(clut["clut16"][4]) >> 24) == 0
    # untouched entries keep the spec default
    assert int(clut["clut16"][1]) == int(dvbsub.DEFAULT_CLUT16[1])


def test_2bit_in_4bit_region_uses_map2to4():
    bw = BitWriter()
    bw.put(2, 2)                  # single pixel colour 2
    bw.put(0, 2)
    bw.put(1, 1)
    bw.put(5, 3)                  # run of 5+3=8? no: 3 bits value 5 -> 5+3
    bw.put(3, 2)                  # colour 3
    bw.put(0, 2)
    bw.put(0, 1)
    bw.put(0, 1)
    bw.put(0, 2)                  # end of string
    data = b"\x10" + bw.bytes()
    parser = dvbsub.DvbSubParser()
    sets = parser.feed(pes(
        page_seg([(1, 0, 0)]),
        region_seg(1, 12, 2, 4, objects=[(7, 0, 0)]),
        object_seg(7, data),
        seg(dvbsub.SEGMENT_END_OF_DISPLAY_SET, b""),
    ))
    r = sets[0].rects[0]
    # map2to4: 2 -> 0x8, 3 -> 0xF (dvb-sub.c:921); bottom field reuses top
    expect = [8] + [15] * 8 + [0, 0, 0]
    np.testing.assert_array_equal(r.indices[0], expect)
    np.testing.assert_array_equal(r.indices[1], expect)


def test_8bit_region_and_runs():
    bw = BitWriter()
    bw.put(77, 8)                 # single pixel colour 77
    bw.put(0, 8)
    bw.put(1, 1)
    bw.put(5, 7)                  # run of 5
    bw.put(200, 8)                # colour 200
    bw.put(0, 8)
    bw.put(0, 1)
    bw.put(0, 7)                  # end of string
    data = b"\x12" + bw.bytes()
    parser = dvbsub.DvbSubParser()
    sets = parser.feed(pes(
        page_seg([(2, 0, 0)]),
        region_seg(2, 8, 2, 8, bg=9, objects=[(1, 0, 0)]),
        object_seg(1, data),
        seg(dvbsub.SEGMENT_END_OF_DISPLAY_SET, b""),
    ))
    r = sets[0].rects[0]
    np.testing.assert_array_equal(r.indices[0],
                                  [77, 200, 200, 200, 200, 200, 9, 9])
    assert r.palette.shape[0] == 256


def test_dvbsuboverlay_element_timing():
    w, h = 32, 16
    line = rle4_line([(4, 1)])
    top = b"\x11" + line
    packet1 = pes(
        page_seg([(1, 0, 0)], time_out=1),
        region_seg(1, 4, 2, 4, objects=[(7, 0, 0)]),
        seg(dvbsub.SEGMENT_CLUT, bytes([0, 0, 1, 0x40 | 1, 180, 90, 60, 0])),
        object_seg(7, top),
        seg(dvbsub.SEGMENT_END_OF_DISPLAY_SET, b""),
    )
    clear = pes(page_seg([], time_out=1),
                seg(dvbsub.SEGMENT_END_OF_DISPLAY_SET, b""))

    el = gt.make("dvbsuboverlay")
    el.push_pes(packet1, pts_ns=0)
    el.push_pes(clear, pts_ns=500 * 10 ** 6)
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="AYUV", width=w, height=h,
                          framerate=fractions.Fraction(30)))
    img = np.full((3, h, w, 4), 64, np.uint8)
    pts = jnp.asarray([0, 400 * 10 ** 6, 600 * 10 ** 6], jnp.int64)
    outs = p.run(inputs=FrameBatch.make(jnp.asarray(img), pts=pts))
    out = np.concatenate([np.asarray(o.data) for o in outs])

    # display scales 720x576 -> 32x16: the 4x2 rect at (0,0) lands at
    # origin with scaled size max(4*32//720,0)=0 ... ensure non-degenerate
    # by checking the decoded set directly instead when scale collapses.
    ds = el._sets[0]
    canvas = dvbsub.display_set_to_ayuv(ds, 720, 576)
    assert (canvas[0, 0] == [255, 180, 60, 90]).all()   # AYUV order a,y,u,v
    # frames: with a 720x576 display on a 32x16 video the rect collapses
    # to zero size, so blending is a no-op — verify timing logic on a
    # matched-size video instead
    el2 = gt.make("dvbsuboverlay")
    el2.push_pes(packet1, pts_ns=0)
    el2.push_pes(clear, pts_ns=500 * 10 ** 6)
    p2 = Pipeline([el2])
    p2.negotiate(MediaSpec(kind="video", format="AYUV", width=720,
                           height=576, framerate=fractions.Fraction(30)))
    img2 = np.full((3, 576, 720, 4), 64, np.uint8)
    outs2 = p2.run(inputs=FrameBatch.make(jnp.asarray(img2), pts=pts))
    out2 = np.concatenate([np.asarray(o.data) for o in outs2])
    # frame 0: blended at the rect — video-blend's truncating >>8 with
    # a=255 gives (64*1 + 180*255) >> 8 = 179
    assert out2[0, 0, 0, 1] == 179 and out2[0, 0, 0, 2] == 60
    np.testing.assert_array_equal(out2[0, 10, 10], img2[0, 10, 10])
    # frame 1 (0.4 s): still shown; frame 2 (0.6 s): cleared by set 2
    assert out2[1, 0, 0, 1] == 179
    np.testing.assert_array_equal(out2[2], img2[2])


def test_page_timeout_expiry():
    line = rle4_line([(2, 1)])
    packet = pes(
        page_seg([(1, 0, 0)], time_out=1),
        region_seg(1, 2, 2, 4, objects=[(7, 0, 0)]),
        object_seg(7, b"\x11" + line),
        seg(dvbsub.SEGMENT_END_OF_DISPLAY_SET, b""),
    )
    el = gt.make("dvbsuboverlay")
    el.push_pes(packet, pts_ns=0)
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="AYUV", width=720,
                          height=576, framerate=fractions.Fraction(30)))
    img = np.full((2, 576, 720, 4), 50, np.uint8)
    pts = jnp.asarray([900 * 10 ** 6, 1500 * 10 ** 6], jnp.int64)
    outs = p.run(inputs=FrameBatch.make(jnp.asarray(img), pts=pts))
    out = np.concatenate([np.asarray(o.data) for o in outs])
    assert not (out[0, 0, 0] == img[0, 0, 0]).all()     # 0.9 s: shown
    np.testing.assert_array_equal(out[1], img[1])       # 1.5 s: expired


def test_scale_linearly_semantics():
    """_scale_linearly = the -base gst_video_blend_scale_linearly /
    vs_image_scale_linear_RGBA algorithm: 16.16 accumulator with
    ((src-1)<<16)/(dest-1) increments, 8-bit blend weights, exact
    endpoints, interpolated (not replicated) interiors."""
    from gstbad.io.dvbsub import _scale_linearly

    img = np.zeros((2, 2, 4), np.uint8)
    img[0, 0] = 0
    img[0, 1] = 255
    img[1, 0] = 255
    img[1, 1] = 0
    up = _scale_linearly(img, 5, 5)
    # corners exact
    assert tuple(up[0, 0]) == (0, 0, 0, 0)
    assert tuple(up[0, 4]) == (255, 255, 255, 255)
    assert tuple(up[4, 0]) == (255, 255, 255, 255)
    # interior interpolates: strictly between the corner values
    assert 0 < up[0, 2, 0] < 255 and 0 < up[2, 0, 0] < 255
    # identity when size matches
    rnd = np.random.default_rng(3).integers(0, 256, (7, 9, 4),
                                            dtype=np.uint8)
    np.testing.assert_array_equal(_scale_linearly(rnd, 7, 9), rnd)
    # monotone ramp stays monotone under upscale (no NN plateaus of
    # the full step size)
    ramp = np.tile(np.arange(0, 256, 32, dtype=np.uint8)[None, :, None],
                   (2, 1, 4))
    up2 = _scale_linearly(ramp, 2, 29)
    d = np.diff(up2[0, :, 0].astype(int))
    assert (d >= 0).all() and d.max() <= 16
