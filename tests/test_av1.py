"""av1enc / av1dec (ext/aom) over the real libaom."""

import numpy as np
import pytest

import gstbad as gt
from gstbad.core.pipeline import Pipeline, parse_launch
from gstbad.io import av1

pytestmark = pytest.mark.skipif(not av1.available(),
                                reason="libaom not present")


def _frames(n, W=64, H=48):
    out = []
    for i in range(n):
        yy, xx = np.mgrid[0:H, 0:W]
        y = ((xx * 3 + yy * 2 + i * 16) % 256).astype(np.uint8)
        u = np.full((H // 2, W // 2), (100 + 7 * i) % 256, np.uint8)
        v = np.full((H // 2, W // 2), (200 - 5 * i) % 256, np.uint8)
        out.append((y, u, v))
    return out


def test_binding_roundtrip_quality():
    frames = _frames(5)
    enc = av1.AV1Encoder(64, 48, target_bitrate_kbps=800, cpu_used=8)
    packets = []
    for y, u, v in frames:
        d = enc.encode(y, u, v)
        if d:
            packets.append(d)
    packets += enc.flush()
    assert len(packets) == 5
    dec = av1.AV1Decoder()
    out = []
    for p in packets:
        out += dec.decode(p)
    assert len(out) == 5
    for i in range(5):
        err = np.abs(out[i]["y"].astype(int)
                     - frames[i][0].astype(int))
        assert err.mean() < 4, (i, err.mean())


def test_cfg_fields_take_effect():
    """Different target bitrates produce different stream sizes; a
    bad cfg field name raises."""
    frames = _frames(6)

    def total(kbps):
        enc = av1.AV1Encoder(64, 48, target_bitrate_kbps=kbps,
                             cpu_used=8,
                             cfg_fields={"rc_end_usage": 1})  # cbr
        n = 0
        for y, u, v in frames:
            n += len(enc.encode(y, u, v))
        for d in enc.flush():
            n += len(d)
        return n

    lo, hi = total(50), total(2000)
    assert hi > lo
    with pytest.raises(ValueError):
        av1.AV1Encoder(64, 48, cfg_fields={"nonsense": 1})


def test_elements_roundtrip():
    pipe = parse_launch(
        "videotestsrc pattern=bars width=64 height=48 format=I420 "
        "! av1enc cpu-used=8 usage-profile=realtime "
        "target-bitrate=800 ! fakesink")
    pipe.negotiate()
    pipe.run(n_frames=4)
    enc = pipe.elements[1]
    pipe.close()
    assert len(enc.packets) == 4

    ref = parse_launch(
        "videotestsrc pattern=bars width=64 height=48 format=I420 "
        "! fakesink")
    ref.negotiate()
    ry = np.concatenate([np.asarray(o.data["y"])
                         for o in ref.run(n_frames=4)])

    dec = gt.make("av1dec")
    for _pts, d in enc.packets:
        dec.push_packet(d)
    p2 = Pipeline([dec, gt.make("fakesink")])
    p2.negotiate(None)
    outs = p2.run(n_frames=4)
    dy = np.concatenate([np.asarray(o.data["y"]) for o in outs])[:4]
    # static bars at 800 kbps: near-exact
    assert np.abs(dy.astype(int) - ry[:4].astype(int)).mean() < 4


def test_av1enc_rejects_non_i420():
    pipe = parse_launch("videotestsrc width=64 height=48 format=BGRx "
                        "! av1enc ! fakesink")
    with pytest.raises(Exception):
        pipe.negotiate()
