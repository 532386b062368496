"""Breadth elements: visualizers, accurip, segmentclip, speed, timecode,
autoconvert/switchbin, rawparse."""

import numpy as np
import jax.numpy as jnp
import pytest

import gstbad as gt
from gstbad.core.harness import Harness
from gstbad.core.spec import AudioFormat, MediaSpec


def test_spectrascope_pipeline():
    p = gt.parse_launch("audiotestsrc wave=sine freq=2000 channels=2 "
                        "samplesperbuffer=2048 ! spectrascope width=64 "
                        "height=32 ! fakesink")
    spec = p.negotiate()
    assert spec.kind == "video" and spec.width == 64
    outs = p.run(n_frames=2, window=2)
    img = np.asarray(outs[0].data)
    assert img.shape == (2, 32, 64, 4)
    assert img[..., 1].max() == 255  # some bars lit


@pytest.mark.parametrize("name", ["wavescope", "spacescope", "synaescope"])
def test_other_scopes(name):
    p = gt.parse_launch(f"audiotestsrc wave=sine channels=2 "
                        f"samplesperbuffer=1024 ! {name} width=64 height=32 "
                        "! fakesink")
    outs = p.run(n_frames=2, window=2)
    img = np.asarray(outs[0].data)
    assert img.shape == (2, 32, 64, 4)
    assert img.max() > 0


def test_accurip(rng):
    x = rng.integers(-32768, 32768, (2, 1000, 2)).astype(np.int16)
    h = Harness("accurip")
    h.set_src_spec(MediaSpec(kind="audio", format=AudioFormat.S16,
                             channels=2))
    h.push(x)
    el = h.element
    # independent recomputation of AccurateRip v1
    vals = x.reshape(-1, 2).astype(np.uint16)
    v = (vals[:, 1].astype(np.uint64) << 16) | vals[:, 0]
    idx = np.arange(1, len(v) + 1, dtype=np.uint64)
    assert el.crc == int((idx * v).sum() & 0xFFFFFFFF)


def test_segmentclip():
    p = gt.parse_launch("videotestsrc width=16 height=16 framerate=10/1 "
                        "! videosegmentclip start=250000000 stop=550000000 "
                        "! fakesink")
    outs = p.run(n_frames=10, window=10)
    pts = np.concatenate([np.asarray(o.pts) for o in outs])
    assert pts.min() >= 250000000 and pts.max() <= 550000000


def test_speed():
    from gstbad.golden.audio import speed_resample, speed_resample_indices

    p = gt.parse_launch("audiotestsrc wave=sine samplesperbuffer=480 "
                        "! speed speed=2.0 ! fakesink")
    outs = p.run(n_frames=2, window=2)
    # the reference walk restarts per buffer: i_float=0.5*(speed-1), i=ceil,
    # blend of last-selected sample with in[i] (gstspeed.c:474-511)
    _, idx, _ = speed_resample_indices(480, 2.0)
    assert outs[0].data.shape[1] == len(idx)
    # PTS follow the perfect-stream rule ts = scale(out_offset, 1e9, rate)
    pts = np.asarray(outs[0].pts)
    rate = 48000  # audiotestsrc default
    assert pts[0] == 0 and pts[1] == len(idx) * 10**9 // rate


def test_speed_matches_golden_walk(rng):
    from gstbad.golden.audio import speed_resample

    x = (rng.random((2, 256, 2), np.float64) * 2 - 1).astype(np.float32)
    for speed in (0.5, 1.0, 1.7, 2.0, 3.3):
        el = gt.make("speed", speed=speed)
        from gstbad.core.pipeline import Pipeline
        from gstbad.core.spec import MediaSpec
        from gstbad.core.frame import FrameBatch
        p = Pipeline([el])
        p.negotiate(MediaSpec(kind="audio", format="F32", rate=48000,
                              channels=2))
        outs = p.run(inputs=FrameBatch.make(jnp.asarray(x)))
        got = np.asarray(outs[0].data)
        want = np.stack([speed_resample(x[i], speed) for i in range(2)])
        np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)


def test_speed_s16_truncates_like_c_cast(rng):
    from gstbad.golden.audio import speed_resample

    x = rng.integers(-32768, 32768, (1, 128, 1), dtype=np.int16)
    el = gt.make("speed", speed=1.5)
    from gstbad.core.pipeline import Pipeline
    from gstbad.core.spec import MediaSpec
    from gstbad.core.frame import FrameBatch
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="audio", format="S16", rate=44100, channels=1))
    outs = p.run(inputs=FrameBatch.make(jnp.asarray(x)))
    got = np.asarray(outs[0].data)
    want = np.trunc(speed_resample(x[0], 1.5)).astype(np.int16)[None]
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_timecodestamper():
    p = gt.parse_launch("videotestsrc width=16 height=16 framerate=30/1 "
                        "! timecodestamper ! fakesink")
    p.run(n_frames=35, window=35)
    msgs = p.bus.pop(element="timecodestamper")
    assert msgs[0]["frames"] == 0 and msgs[0]["seconds"] == 0
    assert msgs[31]["seconds"] == 1 and msgs[31]["frames"] == 1


def test_autoconvert_picks_identity():
    p = gt.parse_launch("videotestsrc width=16 height=16 "
                        "! autoconvert ! fakesink")
    outs = p.run(n_frames=2, window=2)
    assert outs[0].data.shape[0] == 2


def test_autoconvert_factories_caps_selection():
    """Real caps-driven selection between two non-trivial converters
    (gstautoconvert.c:23-35): gaussianblur only negotiates AYUV, solarize
    only the BGRx family — the input format decides which one runs."""
    el = gt.make("autoconvert", factories="gaussianblur,solarize")
    el.set_info(MediaSpec(kind="video", format="BGRx", width=16, height=16))
    assert el.chosen.NAME == "solarize"
    el2 = gt.make("autoconvert", factories="gaussianblur,solarize")
    el2.set_info(MediaSpec(kind="video", format="AYUV", width=16, height=16))
    assert el2.chosen.NAME == "gaussianblur"
    # end to end: the chosen converter actually transforms the stream
    from gstbad.golden import gaudieffects as g
    p = gt.parse_launch(
        "videotestsrc pattern=ball width=16 height=16 format=BGRx "
        "! autoconvert factories=gaussianblur,solarize ! fakesink")
    outs = p.run(n_frames=2, window=2)
    ref = gt.parse_launch("videotestsrc pattern=ball width=16 height=16 "
                          "format=BGRx ! fakesink").run(n_frames=2, window=2)
    want = np.stack([g.solarize(f) for f in np.asarray(ref[0].data)])
    np.testing.assert_array_equal(np.asarray(outs[0].data), want)


def test_switchbin_paths_caps_selection(rng):
    """switchbin picks the FIRST path whose caps match (gstswitchbin.c:
    26-55), ANY as catch-all; a path may hold an element chain."""
    paths = ("video/x-raw,format=GRAY8 : zebrastripe threshold=90 ; "
             "video/x-raw : solarize ! burn ; ANY : identity")
    el = gt.make("switchbin", paths=paths)
    el.set_info(MediaSpec(kind="video", format="GRAY8", width=16, height=16,
                          framerate=__import__("fractions").Fraction(30)))
    assert el.chosen.NAME == "zebrastripe"
    el2 = gt.make("switchbin", paths=paths)
    el2.set_info(MediaSpec(kind="video", format="BGRx", width=16, height=16))
    assert [e.NAME for e in el2.chosen] == ["solarize", "burn"]
    el3 = gt.make("switchbin", paths=paths)
    el3.set_info(MediaSpec(kind="audio", format="F32", rate=48000,
                           channels=2))
    assert el3.chosen.NAME == "identity"
    # no match -> loud error
    el4 = gt.make("switchbin", paths="video/x-raw,format=AYUV : identity")
    with pytest.raises(ValueError):
        el4.set_info(MediaSpec(kind="audio", format="F32", rate=48000,
                               channels=2))


def test_videoparse(rng):
    raw = rng.integers(0, 256, (3 * 16 * 16,), dtype=np.uint8).tobytes()
    p = gt.parse_launch("videoparse format=GRAY8 width=16 height=16 "
                        "! identity ! fakesink")
    p.negotiate()
    p.elements[0].push_bytes(raw)
    outs = p.run(window=2)
    got = np.concatenate([np.asarray(o.data) for o in outs])
    np.testing.assert_array_equal(
        got, np.frombuffer(raw, np.uint8).reshape(3, 16, 16))


def test_audioparse(rng):
    raw = rng.integers(-100, 100, (2048 * 2,)).astype(np.int16).tobytes()
    p = gt.parse_launch("audioparse format=S16 channels=2 "
                        "samplesperbuffer=512 ! fakesink")
    p.negotiate()
    p.elements[0].push_bytes(raw)
    outs = p.run(window=2)
    assert sum(o.batch for o in outs) == 4


# ---------------------------------------------------------------------------
# digitalzoom (gst/camerabin2/gstdigitalzoom.c)
# ---------------------------------------------------------------------------


def _bilinear_window(img, left, top, cw, ch):
    """numpy transcription: center-aligned bilinear resample of the crop
    window back to the full plane size."""
    h, w = img.shape[:2]
    out = np.zeros_like(img, np.float64)
    ys = np.clip((np.arange(h) + 0.5) * (ch / h) + top - 0.5, 0, h - 1.0)
    xs = np.clip((np.arange(w) + 0.5) * (cw / w) + left - 0.5, 0, w - 1.0)
    y0 = np.floor(ys).astype(int); ay = ys - y0
    x0 = np.floor(xs).astype(int); ax = xs - x0
    y1 = np.minimum(y0 + 1, h - 1); x1 = np.minimum(x0 + 1, w - 1)
    f = img.astype(np.float64)
    for i in range(h):
        r = (1 - ay[i]) * f[y0[i]] + ay[i] * f[y1[i]]
        out[i] = ((1 - ax)[:, None] if img.ndim == 3 else (1 - ax)) \
            * r[x0].T.T + (ax[:, None] if img.ndim == 3 else ax) * r[x1]
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def test_digitalzoom_crop_math_and_bilinear(rng):
    from gstbad.core.harness import Harness
    from gstbad.core.spec import MediaSpec, VideoFormat
    x = rng.integers(0, 256, (2, 24, 32, 4), np.uint8)
    for zoom in (1.0, 1.7, 2.0, 4.0):
        h = Harness("digitalzoom", zoom=zoom)
        h.set_src_spec(MediaSpec(kind="video", format=VideoFormat.AYUV,
                                 width=32, height=24))
        got = h.push_pull(x)
        # reference integer crop (gstdigitalzoom.c:95-107)
        w2 = (32 - int(32 * 1.0 / zoom)) // 2
        h2 = (24 - int(24 * 1.0 / zoom)) // 2
        left = w2 & 0xFFFE
        cw, ch = 32 - left - w2, 24 - 2 * h2
        for b in range(2):
            want = _bilinear_window(x[b], left, h2, cw, ch)
            diff = np.abs(got[b].astype(int) - want.astype(int))
            assert diff.max() <= 1  # f32 vs f64 rounding at .5 boundaries
    # zoom=1 is exactly identity
    h = Harness("digitalzoom")
    h.set_src_spec(MediaSpec(kind="video", format=VideoFormat.AYUV,
                             width=32, height=24))
    np.testing.assert_array_equal(h.push_pull(x), x)


def test_digitalzoom_i420_planes(rng):
    from gstbad.core.harness import Harness
    from gstbad.core.spec import MediaSpec, VideoFormat
    data = {"y": rng.integers(0, 256, (1, 24, 32), np.uint8),
            "u": rng.integers(0, 256, (1, 12, 16), np.uint8),
            "v": rng.integers(0, 256, (1, 12, 16), np.uint8)}
    h = Harness("digitalzoom", zoom=2.0)
    h.set_src_spec(MediaSpec(kind="video", format=VideoFormat.I420,
                             width=32, height=24))
    got = h.push(data)
    y = np.asarray(got[0].data["y"])
    assert y.shape == (1, 24, 32)
    want_y = _bilinear_window(data["y"][0], 8, 6, 16, 12)
    assert np.abs(y[0].astype(int) - want_y.astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# chopmydata / testsrcbin / clockselect (gst/debugutils/)
# ---------------------------------------------------------------------------


def test_chopmydata_sizes_and_parser_fuzz(rng):
    from gstbad.io.chop import ChopMyData
    # size distribution: [min,max] quantized to step
    c = ChopMyData(min_size=10, max_size=64, step_size=8, seed=3)
    chunks = c.push(bytes(rng.integers(0, 256, 4096, np.uint8)))
    sizes = {len(ch) for ch in chunks}
    assert sizes and all(16 <= s <= 64 and s % 8 == 0 for s in sizes)
    assert len(sizes) > 1  # actually random
    tail = c.flush()
    assert all(len(t) == 10 for t in tail)
    # begin >= end degenerate case: fixed chunk size
    c2 = ChopMyData(min_size=32, max_size=32, step_size=32)
    assert {len(ch) for ch in c2.push(bytes(128))} == {32}
    # parser-boundary fuzz: chopped feed == contiguous feed
    raw = bytes(rng.integers(0, 256, 16 * 16 * 6, np.uint8))
    outs = []
    for feed in ("whole", "chopped"):
        p = gt.parse_launch("videoparse format=GRAY8 width=16 height=16 "
                            "! fakesink")
        src = p.elements[0]
        if feed == "whole":
            src.push_bytes(raw)
        else:
            c = ChopMyData(min_size=1, max_size=100, step_size=7, seed=9)
            for ch in c.push(raw) + c.flush():
                src.push_bytes(ch)
        got = p.run(n_frames=6, window=3)
        outs.append(np.concatenate([np.asarray(o.data) for o in got]))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_testsrcbin_inline_and_uri(rng):
    # inline single-stream: factory returns the configured inner source
    p = gt.parse_launch("testsrcbin stream-types=video,pattern=gradient,"
                        "width=16,height=16 ! fakesink")
    outs = p.run(n_frames=2, window=2)
    assert np.asarray(outs[0].data).shape == (2, 16, 16, 4)
    # reference comparison: identical to plain videotestsrc
    p2 = gt.parse_launch("videotestsrc pattern=gradient width=16 height=16 "
                         "! fakesink")
    np.testing.assert_array_equal(np.asarray(outs[0].data),
                                  np.asarray(p2.run(n_frames=2,
                                                    window=2)[0].data))
    # multi-stream URI -> disjoint chains
    from gstbad.session.testbin import parse_testbin_uri, testbin_launch
    streams = parse_testbin_uri("testbin://audio,freq=330+video,pattern=white")
    assert streams == [("audio", {"freq": "330"}),
                       ("video", {"pattern": "white"})]
    launch = testbin_launch("testbin://audio,freq=330+video,pattern=white,"
                            "width=16,height=16")
    p3 = gt.parse_launch(launch)
    p3.run(n_frames=2, window=2)
    # bad specs fail loudly
    import pytest as _pytest
    with _pytest.raises(ValueError):
        parse_testbin_uri("testbin://subtitle")
    with _pytest.raises(ValueError):
        gt.parse_launch("testsrcbin stream-types=audio+video ! fakesink")


def test_clockselect_paces_play():
    import time as _time
    from gstbad.session.play import Play
    p = gt.parse_launch("videotestsrc pattern=black width=8 height=8 "
                        "framerate=120/1 ! clockselect clock-id=realtime "
                        "! fakesink")
    play = Play(p, window=4, realtime=True, n_frames=8)
    assert play._clock() is _time.time
    t0 = _time.time()
    play.play()
    while play.state.value == "playing" and _time.time() - t0 < 5:
        _time.sleep(0.01)
    assert play.position > 0
    with np.testing.assert_raises(Exception):
        gt.parse_launch("videotestsrc ! clockselect clock-id=bogus "
                        "! fakesink")


# ---------------------------------------------------------------------------
# jpegparse (gst/jpegformat/gstjpegparse.c) — byte-domain framing
# ---------------------------------------------------------------------------


def _jpeg_seg(marker, payload):
    import struct
    return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) \
        + payload


def _fake_jpeg(w, h, subsamp=((2, 2), (1, 1), (1, 1))):
    import struct
    sof = bytes([8]) + struct.pack(">HH", h, w) + bytes([3])
    for i, (bw, bh) in enumerate(subsamp):
        sof += bytes([i + 1, (bw << 4) | bh, 0])
    entropy = bytes([0x12, 0xFF, 0x00, 0x34, 0xFF, 0xD0, 0x56] * 5)
    return (b"\xff\xd8" + _jpeg_seg(0xE0, b"JFIF\x00" + bytes(8))
            + _jpeg_seg(0xDB, bytes(65)) + _jpeg_seg(0xC0, sof)
            + _jpeg_seg(0xC4, bytes(20)) + _jpeg_seg(0xDA, bytes(10))
            + entropy + b"\xff\xd9")


def test_jpegparse_framing_and_headers():
    from gstbad.io.jpeg import JpegParse
    blob = (b"garbage!" + _fake_jpeg(640, 480)
            + _fake_jpeg(320, 240, ((2, 1), (1, 1), (1, 1)))
            + _fake_jpeg(64, 48, ((1, 1), (1, 1), (1, 1))))
    # arbitrary buffer boundaries (the chopmydata test pattern)
    p = JpegParse()
    imgs = []
    for i in range(0, len(blob), 13):
        imgs += p.push(blob[i:i + 13])
    assert [(im.width, im.height, im.format) for im in imgs] == \
        [(640, 480, "I420"), (320, 240, "UYVY"), (64, 48, "YV12")]
    for im in imgs:
        assert im.data.startswith(b"\xff\xd8")
        assert im.data.endswith(b"\xff\xd9")
        assert im.precision == 8 and im.n_components == 3


def test_jifmux_marker_rewrite():
    from gstbad.io.jpeg import JpegParse, jif_mux
    blob = _fake_jpeg(64, 48)
    out = jif_mux(blob, comment="test image", exif=b"\x01\x02")
    # still a valid parseable JPEG with the same image properties
    imgs = JpegParse().push(out)
    assert len(imgs) == 1 and imgs[0].width == 64
    # marker order: SOI, APP0(JFIF), APP1(Exif), COM, ...
    assert out[2:4] == b"\xff\xe0"
    i_exif = out.find(b"Exif\x00\x00")
    i_com = out.find(b"test image")
    assert 0 < i_exif < i_com


def test_jpegparse_fill_bytes_before_eoi():
    """Regression: a fill 0xFF before EOI (legal padding) must not stall
    the scan."""
    from gstbad.io.jpeg import JpegParse
    blob = _fake_jpeg(32, 32)
    # inject a fill byte right before the EOI marker
    padded = blob[:-2] + b"\xff" + blob[-2:]
    imgs = JpegParse().push(padded + _fake_jpeg(16, 16))
    assert [(im.width, im.height) for im in imgs] == [(32, 32), (16, 16)]


def test_timecodestamper_drop_frame():
    """SMPTE drop-frame at 30000/1001: frame numbers 0,1 skip at each
    minute except every tenth (gsttimecodestamper.c drop-frame)."""
    from gstbad.elements.misc import (frames_to_tc,
                                          tc_frames_since_daily_jam)
    import jax.numpy as jnp
    # first frame of minute 1 is 00:01:00;02 in DF
    fc = tc_frames_since_daily_jam(0, 0, 59, 29, 30, True) + 1
    h, m, s, f = (int(x) for x in frames_to_tc(jnp.int64(fc), 30, True))
    assert (h, m, s, f) == (0, 1, 0, 2)
    # minute 10 keeps frame 0
    fc10 = tc_frames_since_daily_jam(0, 9, 59, 29, 30, True) + 1
    h, m, s, f = (int(x) for x in frames_to_tc(jnp.int64(fc10), 30, True))
    assert (h, m, s, f) == (0, 10, 0, 0)
    # round trip across a range
    fcs = np.arange(0, 30 * 60 * 22, 379)
    for fc in fcs:
        h, m, s, f = (int(x) for x in frames_to_tc(jnp.int64(int(fc)),
                                                   30, True))
        assert tc_frames_since_daily_jam(h, m, s, f, 30, True) == fc


def test_timecodestamper_internal_start_and_offset():
    p = gt.parse_launch(
        "videotestsrc width=16 height=16 framerate=30/1 ! timecodestamper "
        "set-internal-timecode=01:00:00:00 timecode-offset=5 ! fakesink")
    p.run(n_frames=2, window=2)
    msgs = p.bus.pop(element="timecodestamper")
    assert msgs[0]["hours"] == 1 and msgs[0]["frames"] == 5


def test_avwait_video_and_audio_pads():
    """avwait 2-input in a launch graph: video gated at the target running
    time, audio passing only from the video start; `pad` pickers route the
    vsrc/asrc outputs to separate sinks."""
    p = gt.parse_launch(
        "videotestsrc width=16 height=16 framerate=10/1 ! w.  "
        "audiotestsrc samplesperbuffer=4800 ! w.  "
        "avwait name=w mode=running-time target-running-time=250000000  "
        "w. ! pad index=0 ! fakesink  "
        "w. ! pad index=1 ! fakesink")
    outs = p.run(n_frames=10, window=10)
    vpts = np.concatenate([np.asarray(o.pts) for o in outs[0]])
    apts = np.concatenate([np.asarray(o.pts) for o in outs[1]])
    assert vpts.min() >= 250_000_000  # gated at the target
    assert apts.min() >= vpts.min()   # audio never precedes video
    msgs = p.bus.pop(element="avwait")
    assert msgs and msgs[0]["dropping"] is False


def test_avwait_modes():
    from gstbad.core.frame import FrameBatch
    from gstbad.core.pipeline import Pipeline
    from gstbad.core.spec import MediaSpec
    import jax.numpy as jnp
    from fractions import Fraction

    vspec = MediaSpec(kind="video", format="GRAY8", width=8, height=8,
                      framerate=Fraction(10))
    aspec = MediaSpec(kind="audio", format="F32", rate=48000, channels=1)

    def drive(**props):
        el = gt.make("avwait", **props)
        el.set_info([vspec, aspec])
        vdata = jnp.zeros((10, 8, 8), jnp.uint8)
        vpts = jnp.arange(10, dtype=jnp.int64) * 100_000_000
        adata = jnp.zeros((10, 4800, 1), jnp.float32)
        v = FrameBatch.make(vdata, pts=vpts)
        a = FrameBatch.make(adata, pts=vpts)
        st, out, msgs = el.process(el.dynamic_params(),
                                   el.init_state(10), [v, a])
        return (np.asarray(out[0].valid), np.asarray(out[1].valid), msgs)

    # running-time mode: video from 300 ms, audio follows video start
    vv, av, _ = drive(mode="running-time",
                      **{"target-running-time": 300_000_000})
    assert vv.tolist() == [False] * 3 + [True] * 7
    assert av.tolist() == [False] * 3 + [True] * 7
    # timecode mode: 00:00:00:05 at 10 fps = 500 ms
    vv, av, _ = drive(mode="timecode",
                      **{"target-timecode-string": "00:00:00:05"})
    assert vv.tolist() == [False] * 5 + [True] * 5
    # video-first: video passes immediately, audio too (same pts grid)
    vv, av, _ = drive(mode="video-first")
    assert vv.all() and av.all()
    # end gate
    vv, av, _ = drive(mode="running-time",
                      **{"target-running-time": 200_000_000,
                         "end-running-time": 600_000_000})
    assert vv.tolist() == [False] * 2 + [True] * 4 + [False] * 4
    # recording=False drops everything
    vv, av, _ = drive(mode="video-first", recording=False)
    assert not vv.any() and not av.any()


def test_audiosegmentclip_sample_exact():
    """Boundary blocks are clipped to the sample like
    gst_audio_buffer_clip: the first surviving block starts AT `start`
    (shorter data, PTS restamped) and the total sample count is the
    exact segment length."""
    rate, spb = 48000, 4800
    p = gt.parse_launch(
        f"audiotestsrc samplesperbuffer={spb} "
        "! audiosegmentclip start=250000000 stop=550000000 ! fakesink")
    outs = p.run(n_frames=10, window=10)
    pts = [int(np.asarray(o.pts)[0]) for o in outs]
    lens = [o.data.shape[1] for o in outs]
    assert pts[0] == 250_000_000                  # clipped-buffer PTS
    assert lens[0] == spb // 2                    # half of the 100 ms block
    assert lens[-1] == spb // 2                   # tail clip at 550 ms
    assert sum(o.data.shape[0] * o.data.shape[1] for o in outs) \
        == (550 - 250) * rate // 1000             # exactly 300 ms of audio


def test_avwait_audio_sample_exact():
    """avwait clips the boundary audio block at the video start sample."""
    p = gt.parse_launch(
        "videotestsrc width=16 height=16 framerate=10/1 ! w.  "
        "audiotestsrc samplesperbuffer=3200 ! w.  "
        "avwait name=w mode=running-time target-running-time=250000000  "
        "w. ! pad index=0 ! fakesink  "
        "w. ! pad index=1 ! fakesink")
    outs = p.run(n_frames=10, window=10)
    # video gates at the next frame boundary (300 ms)...
    vpts = np.concatenate([np.asarray(o.pts) for o in outs[0]])
    assert vpts.min() == 300_000_000
    # ...and the audio starts at EXACTLY the video start, mid-block
    apts = [int(np.asarray(o.pts)[0]) for o in outs[1]]
    alens = [o.data.shape[1] for o in outs[1]]
    assert apts[0] == 300_000_000
    assert alens[0] == 3200 - 1600      # block 4 spans the 300 ms gate
    assert sum(o.data.shape[0] * o.data.shape[1] for o in outs[1]) \
        == 1600 + 5 * 3200              # gate..end of the 10 blocks


def test_gstbad_launch_cli(capsys):
    """gstbad-launch (gst-launch-1.0 analog) drives a pipeline from its
    CLI surface."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from gstbad.cli import launch_main
    rc = launch_main(["--cpu", "-n", "8", "-v",
                      "videotestsrc pattern=bars width=64 height=48 "
                      "format=BGRx ! solarize ! fakesink"])
    assert rc == 0
