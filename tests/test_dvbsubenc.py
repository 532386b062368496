"""dvbsubenc (gst/dvbsubenc/): io/dvbsubenc.py encoder vs the
io/dvbsub.py EN 300 743 decoder as the round-trip oracle."""

import fractions

import numpy as np
import jax.numpy as jnp
import pytest

import gstbad as gt
from gstbad.core.frame import FrameBatch
from gstbad.core.pipeline import Pipeline
from gstbad.core.spec import MediaSpec
from gstbad.io import dvbsub as dec
from gstbad.io import dvbsubenc as enc

H, W = 40, 120


def _roundtrip(img, max_colours=16):
    pkt, x, y = enc.encode_frame(img, 0, max_colours)
    dss = dec.DvbSubParser().feed(pkt)
    assert len(dss) == 1
    full = dec.display_set_to_ayuv(dss[0], 720, 576)
    return full, (x, y), dss[0]


def test_subregion_scan():
    img = np.zeros((H, W, 4), np.uint8)
    img[7:23, 11:97, 0] = 255
    assert enc.find_largest_subregion(img) == (11, 96, 7, 22)
    assert enc.find_largest_subregion(np.zeros((H, W, 4), np.uint8)) \
        is None
    # content entirely in one horizontal half: the reference's
    # both-ends scan stops at the row middle and leaves a sentinel
    # (negative-width crop -> stream error); skipped here (documented)
    one_sided = np.zeros((H, W, 4), np.uint8)
    one_sided[10:20, 10:20, 0] = 255
    assert enc.find_largest_subregion(one_sided) is None


def test_histogram_palette_order():
    # palette sorted by descending big-endian AYUV word (highest alpha
    # first, gstdvbsubenc-util.c:85-93)
    img = np.zeros((4, 4, 4), np.uint8)
    img[0] = [255, 10, 10, 10]
    img[1] = [128, 200, 200, 200]
    img[2] = [255, 200, 10, 10]
    idx, pal, n = enc.ayuv_to_paletted(img, 16)
    assert n == 4
    words = (pal.astype(np.uint32)[:, 0] << 24) \
        | (pal.astype(np.uint32)[:, 1] << 16) \
        | (pal.astype(np.uint32)[:, 2] << 8) | pal[:, 3]
    assert (np.diff(words.astype(np.int64)) < 0).all()
    # indices consistent with the palette
    back = pal[idx]
    np.testing.assert_array_equal(back, img)


@pytest.mark.parametrize("colours,label", [(3, "2bit"), (10, "4bit"),
                                           (30, "8bit")])
def test_rle_roundtrip_exact(colours, label):
    rng = np.random.default_rng(colours)
    img = np.zeros((H, W, 4), np.uint8)
    # paint random rectangles from a small colour set (plus runs of
    # exactly 11/28 px to hit the 2-bit fall-through quirks)
    cset = [(255, 30 + 7 * i, 40 + 5 * i, 50 + 3 * i)
            for i in range(colours - 1)]
    for k in range(25):
        c = cset[k % len(cset)]
        yy = int(rng.integers(2, H - 6))
        xx = int(rng.integers(2, W - 30))
        ww = int(rng.integers(1, 29))
        img[yy:yy + 3, xx:xx + ww] = c
    img[1, 4:15] = cset[0]     # run of exactly 11
    img[2, 4:32] = cset[0]     # run of exactly 28
    full, (x, y), ds = _roundtrip(img, 256)
    r = ds.rects[0]
    l, rr, t, b = enc.find_largest_subregion(img)
    np.testing.assert_array_equal(full[y:y + r.h, x:x + r.w],
                                  img[t:b + 1, l:rr + 1],
                                  err_msg=label)
    # nothing painted outside the region
    mask = np.ones((576, 720), bool)
    mask[y:y + r.h, x:x + r.w] = False
    assert (full[mask] == 0).all()


def test_quantizer_path():
    img = np.zeros((H, W, 4), np.uint8)
    gy, gx = np.mgrid[0:H, 0:W]
    img[..., 0] = 255
    img[..., 1] = (gy * 6) % 256
    img[..., 2] = (gx * 2) % 256
    img[..., 3] = 128
    full, (x, y), ds = _roundtrip(img, max_colours=16)
    r = ds.rects[0]
    assert len(np.unique(r.indices)) <= 16
    sub = full[y:y + r.h, x:x + r.w].astype(int)
    assert np.abs(sub - img.astype(int)).mean() < 20


def test_element_posts_pes_and_end_packets():
    imgs = np.zeros((4, H, W, 4), np.uint8)
    imgs[0, 10:30, 20:100] = [255, 235, 128, 128]
    imgs[2, 5:20, 30:80] = [255, 81, 90, 240]
    # frames 1 and 3 are fully transparent -> skipped, but frame 1's
    # arrival flushes frame 0's end-of-page packet
    el = gt.make("dvbsubenc")
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="AYUV", width=W, height=H,
                          framerate=fractions.Fraction(25)))
    dur = 10 ** 9 // 25
    pts = jnp.asarray([i * dur for i in range(4)], jnp.int64)
    p.run(inputs=FrameBatch.make(jnp.asarray(imgs), pts=pts))
    msgs = p.bus.pop(name="dvbsub-pes")
    kinds = [(m["end"], m.pts) for m in msgs]
    # frame 3 arrives exactly AT frame 2's end time; the reference only
    # flushes when pts strictly exceeds it, so that end stays pending
    assert kinds == [(False, 0), (True, dur), (False, 2 * dur)]
    assert el._current_end_time == 3 * dur
    assert el._object_version == 3
    # the first packet decodes back to frame 0's region
    dss = dec.DvbSubParser().feed(msgs[0]["data"])
    full = dec.display_set_to_ayuv(dss[0], 720, 576)
    r = dss[0].rects[0]
    np.testing.assert_array_equal(
        full[msgs[0]["y"]:msgs[0]["y"] + r.h,
             msgs[0]["x"]:msgs[0]["x"] + r.w],
        imgs[0, 10:30, 20:100])
    # the end packet is an empty display set (clears the page)
    dss_end = dec.DvbSubParser().feed(msgs[1]["data"])
    assert len(dss_end) == 1 and dss_end[0].rects == []


def test_element_ts_offset():
    imgs = np.zeros((1, H, W, 4), np.uint8)
    imgs[0, 10:20, 40:80] = [255, 100, 128, 128]
    el = gt.make("dvbsubenc", **{"ts-offset": 500})
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="AYUV", width=W, height=H,
                          framerate=fractions.Fraction(25)))
    p.run(inputs=FrameBatch.make(jnp.asarray(imgs)))
    assert p.bus.pop(name="dvbsub-pes")[0].pts == 500
