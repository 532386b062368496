"""gsmenc / gsmdec (ext/gsm) over the real libgsm."""

import numpy as np
import pytest

import gstbad as gt
from gstbad.core.pipeline import Pipeline, parse_launch
from gstbad.io import gsmcodec

pytestmark = pytest.mark.skipif(not gsmcodec.available(),
                                reason="libgsm not present")


def test_binding_roundtrip_snr():
    t = np.arange(1600) / 8000.0
    sig = (np.sin(2 * np.pi * 440 * t) * 8000).astype(np.int16)
    enc = gsmcodec.GsmCodec()
    dec = gsmcodec.GsmCodec()
    out = []
    for k in range(0, 1600, 160):
        frame = enc.encode_frame(sig[k:k + 160])
        assert len(frame) == 33
        out.append(dec.decode_frame(frame))
    out = np.concatenate(out).astype(np.float64)
    ref = sig.astype(np.float64)
    # GSM 06.10 on a clean sine: comfortably > 10 dB SNR after the
    # first adaptation frame
    err = out[160:] - ref[160:]
    snr = 10 * np.log10((ref[160:] ** 2).mean() / (err ** 2).mean())
    assert snr > 10, snr


def test_gsmenc_element_frames():
    pipe = parse_launch(
        "audiotestsrc wave=sine freq=300 format=S16 rate=8000 "
        "channels=1 samplesperbuffer=400 ! gsmenc ! fakesink")
    pipe.negotiate()
    pipe.run(n_frames=4)
    enc = pipe.elements[1]
    # 4 x 400 = 1600 samples -> 10 whole frames
    assert len(enc.packets) == 10
    assert all(len(d) == 33 for _p, d in enc.packets)
    msgs = pipe.bus.pop(name="gsm-frame")
    assert len(msgs) == 10
    # pts advance by 20 ms per frame
    assert enc.packets[1][0] - enc.packets[0][0] == 160 * 10**9 // 8000


def test_element_roundtrip():
    pipe = parse_launch(
        "audiotestsrc wave=sine freq=440 format=S16 rate=8000 "
        "channels=1 samplesperbuffer=320 ! gsmenc ! fakesink")
    pipe.negotiate()
    pipe.run(n_frames=5)
    packets = pipe.elements[1].packets
    stream = b"".join(d for _p, d in packets)

    dec = gt.make("gsmdec", samplesperbuffer=320)
    dec.push_packet(stream)
    p2 = Pipeline([dec, gt.make("fakesink")])
    p2.negotiate(None)
    outs = p2.run(n_frames=8)
    pcm = np.concatenate([np.asarray(o.data) for o in outs])
    assert pcm.dtype == np.int16 and pcm.shape[1:] == (320, 1)
    flat = pcm.reshape(-1).astype(np.float64)
    n = len(packets) * 160
    assert np.abs(flat[160:n]).max() > 2000   # audible sine decoded


def test_gsmenc_rejects_wrong_caps():
    pipe = parse_launch(
        "audiotestsrc format=F32 rate=48000 channels=2 "
        "! gsmenc ! fakesink")
    with pytest.raises(Exception):
        pipe.negotiate()
