"""ccconverter cross-framerate buffering (gstccconverter.c's
fit_and_scale/store/combine machinery): io/ccconv.py host engine is the
spec; the element's device scan must match it byte for byte."""

import fractions

import numpy as np
import jax.numpy as jnp
import pytest

import gstbad as gt
from gstbad.core.frame import FrameBatch
from gstbad.core.pipeline import Pipeline
from gstbad.core.spec import MediaSpec
from gstbad.io import cea608
from gstbad.io.ccconv import (CCConverterEngine, compact_cc_data,
                                  cc_data_extract_cea608)


def test_compact_and_extract():
    # invalid triplets dropped; 608 run splits by field; ccp follows
    cc = bytes([0xFC, 1, 2,        # valid 608 f1
                0x78, 9, 9,        # invalid (0x04 clear) -> dropped
                0xFD, 3, 4,        # valid 608 f2
                0xC7, 5, 6,        # 708 packet start
                0xC6, 7, 8])
    compacted = compact_cc_data(cc)
    assert compacted == bytes([0xFC, 1, 2, 0xFD, 3, 4,
                               0xC7, 5, 6, 0xC6, 7, 8])
    off, f1, f2 = cc_data_extract_cea608(compacted)
    assert off == 6 and f1 == bytes([1, 2]) and f2 == bytes([3, 4])


def test_engine_upsample_cadence():
    eng = CCConverterEngine("cc-data", "cdp", (24, 1), (60, 1))
    cadence = [len(eng.push(bytes([0xFC, 0x20 + i, 0x40])))
               for i in range(8)]
    # 60/24 = 2.5 outputs per input; output_frames seeds at 1
    # (reset_counters) so the cadence starts 2, 3, 2, 3, ...
    assert cadence == [2, 3, 2, 3, 2, 3, 2, 3]


def test_engine_downsample_cadence_and_order():
    eng = CCConverterEngine("cc-data", "cdp", (60, 1), (24, 1))
    sent, got = [], []
    cadence = []
    for i in range(20):
        pair = (0x20 + i, 0x40 + i)
        sent.append(pair)
        outs = eng.push(bytes([0xFC, pair[0], pair[1]]))
        cadence.append(len(outs))
        for o in outs:
            cc, _ = cea608.cdp_to_cc_data(o)
            got += [(cc[j + 1], cc[j + 2])
                    for j in range(0, len(cc), 3) if cc[j] == 0xFC]
    for o in eng.drain():
        cc, _ = cea608.cdp_to_cc_data(o)
        got += [(cc[j + 1], cc[j + 2])
                for j in range(0, len(cc), 3) if cc[j] == 0xFC]
    assert sum(cadence) == 8            # 20 * 24/60
    assert got == sent                  # carried via scratch, in order


def test_engine_equal_entries_one_to_one():
    # 30000/1001 and 30 share max_cc_count -> 1:1, no buffering
    eng = CCConverterEngine("cc-data", "cdp", (30000, 1001), (30, 1))
    for i in range(5):
        outs = eng.push(bytes([0xFC, 0x41 + i, 0x42]))
        assert len(outs) == 1
    assert eng.drain() == []


def test_engine_overflow_split():
    # 60fps CDP (max 10 triplets) -> 24fps: ccp data accumulates and
    # must split across outputs at the 22-triplet max_ccp boundary
    mk60 = CCConverterEngine("cc-data", "cdp", (60, 1), (60, 1))
    frames = []
    for i in range(10):
        ccd = bytes([0xFC, 0x20 + i, 0x41]) \
            + bytes([0xC7, i, 1, 0xC6, i, 2, 0xC6, i, 3])
        frames.append(mk60.push(ccd)[0])
    eng = CCConverterEngine("cdp", "cdp", (60, 1), (24, 1))
    payload_in = 0
    payload_out = 0
    outs_all = []
    for f in frames:
        ccd, _ = cea608.cdp_to_cc_data(f)
        payload_in += sum(1 for j in range(0, len(ccd), 3)
                          if ccd[j] not in (0xFA, 0xF8, 0xF9))
        outs_all += eng.push(f)
    outs_all += eng.drain()
    for o in outs_all:
        ccd, _ = cea608.cdp_to_cc_data(o)
        payload_out += sum(1 for j in range(0, len(ccd), 3)
                           if ccd[j] not in (0xFA, 0xF8, 0xF9))
    assert payload_out == payload_in    # nothing lost in the splits


def _drive_element(it, ot, infps, outfps, frames):
    el = gt.make("ccconverter", **{
        "input-type": it, "output-type": ot,
        "output-framerate": f"{outfps[0]}/{outfps[1]}"})
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="I420", width=64,
                          height=48,
                          framerate=fractions.Fraction(*infps)))
    arr = jnp.asarray(np.stack([np.frombuffer(f, np.uint8)
                                for f in frames]))
    outs = p.run(inputs=FrameBatch.make(arr))
    return np.concatenate([np.asarray(o.data) for o in outs])


def _check_element(it, ot, infps, outfps, frames):
    eng = CCConverterEngine(it, ot, infps, outfps)
    want = []
    for f in frames:
        want += eng.push(f)
    got = _drive_element(it, ot, infps, outfps, frames)
    assert got.shape[0] == len(want)
    for i, w in enumerate(want):
        wa = np.frombuffer(w, np.uint8)
        np.testing.assert_array_equal(got[i][:len(wa)], wa,
                                      err_msg=f"{it}->{ot} output {i}")


def _cdp_frames(n):
    mk30 = CCConverterEngine("cc-data", "cdp", (30, 1), (30, 1))
    frames = []
    for i in range(n):
        ccd = bytes([0xFC, 0x20 + i, 0x41, 0xFD, 0x22, 0x43,
                     0xC7, 0x10 + i, 0x55, 0xC6, 0x66, 0x77])
        frames.append(mk30.push(ccd)[0])
    return frames


@pytest.mark.parametrize("ot,outfps", [
    ("cdp", (60, 1)), ("cdp", (24, 1)),
    ("cc-data", (60, 1)), ("s334-1a", (24, 1)), ("raw", (24, 1)),
])
def test_element_matches_engine_cdp_input(ot, outfps):
    _check_element("cdp", ot, (30, 1), outfps, _cdp_frames(12))


def test_element_matches_engine_other_inputs():
    s334 = [bytes([0x80, 0x20 + i, 0x40, 0x00, 0x21 + i, 0x41])
            for i in range(10)]
    _check_element("s334-1a", "cdp", (30, 1), (60, 1), s334)
    raw = [bytes([0x20 + i, 0x40 + i]) for i in range(10)]
    _check_element("raw", "cdp", (25, 1), (50, 1), raw)
    ccd = [bytes([0xFC, 0x30 + i, 0x40]) for i in range(6)]
    _check_element("cc-data", "cdp", (30000, 1001), (30, 1), ccd)
    _check_element("cc-data", "cdp", (24, 1), (60, 1), ccd)


def test_element_output_framerate_negotiation():
    el = gt.make("ccconverter", **{
        "input-type": "cc-data", "output-type": "cdp",
        "output-framerate": "60/1"})
    p = Pipeline([el])
    spec = p.negotiate(MediaSpec(kind="video", format="I420", width=64,
                                 height=48,
                                 framerate=fractions.Fraction(24)))
    out_spec = el.out_spec
    assert out_spec.framerate == fractions.Fraction(60)
    del spec
    # non-CDP on both sides cannot rate-convert
    el2 = gt.make("ccconverter", **{
        "input-type": "raw", "output-type": "cc-data",
        "output-framerate": "60/1"})
    p2 = Pipeline([el2])
    with pytest.raises(Exception, match="CDP"):
        p2.negotiate(MediaSpec(kind="video", format="I420", width=64,
                               height=48,
                               framerate=fractions.Fraction(24)))
