"""Session layer: Play, Transcoder + CLI path, checkpoint/resume."""

import time

import numpy as np
import pytest

import gstbad as gt
from gstbad.core.spec import MediaSpec
from gstbad.io import y4m
from gstbad.session import Play, PlayState, Transcoder


def test_play_state_machine():
    got = []
    p = Play("videotestsrc pattern=ball width=32 height=32 format=GRAY8 "
             "! videoanalyse ! fakesink",
             window=4, realtime=False, n_frames=16,
             on_frame=lambda b, i: got.append(int(np.asarray(b.pts)[i])))
    p.play()
    deadline = time.time() + 30
    while p.state != PlayState.STOPPED and time.time() < deadline:
        time.sleep(0.02)
    assert p.state == PlayState.STOPPED
    assert len(got) == 16
    assert p.position > 0
    assert len(p.bus.pop(element="videoanalyse")) == 16


def test_play_pause_resume():
    p = Play("videotestsrc width=16 height=16 ! fakesink",
             window=2, realtime=False)
    p.play()
    time.sleep(0.3)
    p.pause()
    assert p.state == PlayState.PAUSED
    pos = p.position
    time.sleep(0.2)
    p.play()
    time.sleep(0.3)
    p.stop()
    assert p.state == PlayState.STOPPED


def test_transcoder_roundtrip(tmp_path, rng):
    spec = MediaSpec(kind="video", format="I420", width=32, height=16)
    planes = {"y": rng.integers(0, 256, (6, 16, 32), dtype=np.uint8),
              "u": rng.integers(0, 256, (6, 8, 16), dtype=np.uint8),
              "v": rng.integers(0, 256, (6, 8, 16), dtype=np.uint8)}
    src = tmp_path / "in.y4m"
    dst = tmp_path / "out.y4m"
    y4m.write_y4m(src, spec, planes)

    positions = []
    t = Transcoder(str(src), str(dst), "zebrastripe threshold=70",
                   window=3, on_position=lambda p, d: positions.append(p))
    n = t.run()
    assert n == 6
    spec2, planes2 = y4m.read_y4m(str(dst))
    assert planes2["y"].shape == (6, 16, 32)
    from gstbad.golden.videofilters import zebrastripe_y
    for i in range(6):
        np.testing.assert_array_equal(planes2["y"][i],
                                      zebrastripe_y(planes["y"][i], 70, i))
    np.testing.assert_array_equal(planes2["u"], planes["u"])
    assert positions


def test_checkpoint_resume(tmp_path, rng):
    """Stateful pipeline (zebrastripe phase) resumes identically."""
    frames = rng.integers(0, 256, (8, 16, 16), dtype=np.uint8)

    def fresh():
        p = gt.parse_launch("zebrastripe ! fakesink")
        p.negotiate(MediaSpec(kind="video", format="GRAY8",
                              width=16, height=16))
        return p

    from gstbad.core.frame import FrameBatch
    import jax.numpy as jnp

    def feed(p, arr):
        return p.run(inputs=FrameBatch.make(jnp.asarray(arr)), window=4)

    # continuous reference
    p_ref = fresh()
    ref = [np.asarray(o.data) for o in
           feed(p_ref, frames[:4]) + feed(p_ref, frames[4:])]

    # checkpointed: run half, save, restore into a NEW pipeline, run rest
    p1 = fresh()
    out1 = feed(p1, frames[:4])
    p1.save_checkpoint(tmp_path / "ck.pkl")
    p2 = fresh()
    p2.compile(4)
    p2.load_checkpoint(tmp_path / "ck.pkl")
    out2 = feed(p2, frames[4:])
    got = [np.asarray(o.data) for o in out1 + out2]
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_camera_image_and_video_capture(tmp_path):
    from gstbad.session.camera import Camera, MODE_VIDEO
    from gstbad.io import pnm, y4m
    import os
    os.chdir(tmp_path)
    cam = Camera(source="videotestsrc pattern=gradient width=64 height=48 "
                 "format=BGRx", zoom=2.0)
    loc = cam.start_capture()
    assert loc == "img_0.pnm"
    spec, img = pnm.read_pnm(loc)
    assert img.shape == (48, 64, 3)
    msgs = cam.bus.pop(name="image-done")
    assert msgs and msgs[0]["filename"] == "img_0.pnm"
    assert cam.start_capture() == "img_1.pnm"  # printf-index location

    cam2 = Camera(source="videotestsrc pattern=ball width=64 height=48 "
                  "format=I420", mode=MODE_VIDEO, window=4)
    cam2.start_capture()
    cam2.step()
    cam2.step()
    loc = cam2.stop_capture()
    assert loc == "vid_0.y4m"
    spec2, planes = y4m.read_y4m(loc)
    assert planes["y"].shape == (8, 48, 64)
    assert cam2.bus.pop(name="video-done")


def test_camera_image_capture_planar(tmp_path):
    from gstbad.session.camera import Camera
    from gstbad.io import pnm
    import os
    os.chdir(tmp_path)
    cam = Camera(source="videotestsrc pattern=gradient width=64 height=48 "
                 "format=I420")
    loc = cam.start_capture()
    spec, img = pnm.read_pnm(loc)
    assert img.shape == (48, 64)  # luma snapshot


def test_transcoder_pnm_profile(tmp_path, rng):
    """Encoding-profile analog: profile='pnm' writes a P6 sequence."""
    import numpy as np
    from gstbad.io import y4m
    from gstbad.io.pnm import read_pnm
    from gstbad.core.spec import MediaSpec
    from gstbad.session.transcoder import Transcoder

    src = str(tmp_path / "in.y4m")
    spec = MediaSpec(kind="video", format="I420", width=32, height=16)
    planes = {"y": rng.integers(0, 256, (4, 16, 32), dtype=np.uint8),
              "u": rng.integers(0, 256, (4, 8, 16), dtype=np.uint8),
              "v": rng.integers(0, 256, (4, 8, 16), dtype=np.uint8)}
    y4m.write_y4m(src, spec, planes)
    dst = str(tmp_path / "out_%03d.pnm")
    t = Transcoder(src, dst, filters="videoconvert format=RGBx",
                   profile="pnm", window=4)
    n = t.run()
    assert n == 4
    _, img0 = read_pnm(str(tmp_path / "out_000.pnm"))
    assert img0.shape == (16, 32, 3)


def test_transcoder_gdp_profile_roundtrip(tmp_path, rng):
    """profile='gdp' writes GDP packets that gdpfilesrc can replay."""
    import numpy as np
    import gstbad as gt
    from gstbad.io import y4m
    from gstbad.core.spec import MediaSpec
    from gstbad.session.transcoder import Transcoder

    src = str(tmp_path / "in.y4m")
    spec = MediaSpec(kind="video", format="I420", width=32, height=16)
    planes = {"y": rng.integers(0, 256, (4, 16, 32), dtype=np.uint8),
              "u": rng.integers(0, 256, (4, 8, 16), dtype=np.uint8),
              "v": rng.integers(0, 256, (4, 8, 16), dtype=np.uint8)}
    y4m.write_y4m(src, spec, planes)
    dst = str(tmp_path / "out.gdp")
    t = Transcoder(src, dst, filters="videoconvert format=GRAY8",
                   profile="gdp", window=4)
    assert t.run() == 4
    # replay through a gdp-input transcode back to y4m
    p = gt.parse_launch(f"gdpfilesrc location={dst} ! fakesink")
    outs = p.run(window=4)
    got = np.concatenate([np.asarray(o.data) for o in outs])
    assert got.shape == (4, 16, 32)
    np.testing.assert_array_equal(got, planes["y"])  # GRAY8 = luma


def test_transcoder_bad_profile_rejected(tmp_path):
    from gstbad.session.transcoder import Transcoder
    import pytest as _pytest
    with _pytest.raises(ValueError):
        Transcoder("a.y4m", "b.mkv", profile="matroska")
    with _pytest.raises(ValueError):
        Transcoder("a.y4m", "b.pnm", profile="pnm")  # no %d pattern


def test_camera_viewfinder_and_previews(tmp_path):
    """Viewfinder branch + post-previews/preview-caps
    (gstcamerabin2.c:33-76,713-756)."""
    from gstbad.session.camera import Camera, MODE_VIDEO

    seen = []
    cam = Camera(source="videotestsrc pattern=gradient width=64 height=48 "
                 "format=AYUV",
                 location=str(tmp_path / "img_%d.pnm"),
                 post_previews=True, preview_width=16, preview_height=12,
                 window=2)
    cam.set_viewfinder(lambda b, spec: seen.append(b.data.shape))
    assert cam.idle and cam.ready_for_capture
    cam.run_viewfinder(2)                    # idle preview, no capture
    assert len(seen) == 2
    cam.start_capture()
    assert len(seen) == 3                    # capture frames also flow
    msgs = cam.bus.pop(name="preview-image")
    assert len(msgs) == 1
    img = msgs[0].fields["buffer"]
    assert img.shape[:2] == (12, 16)         # preview-caps rescale
    assert msgs[0].fields["location"].endswith("img_0.pnm")

    cam2 = Camera(source="videotestsrc pattern=ball width=64 height=48 "
                  "format=AYUV", mode=MODE_VIDEO,
                  location=str(tmp_path / "vid_%d.raw"),
                  post_previews=True, window=2)
    cam2.start_capture()
    assert not cam2.idle
    cam2.step()
    out = cam2.stop_capture()
    assert out and cam2.idle
    pv = cam2.bus.pop(name="preview-image")
    assert len(pv) == 1 and pv[0].fields["location"].endswith("vid_0.raw")


def test_transcoder_hevc_profile_lossless(tmp_path, rng):
    """y4m -> x265enc (real libx265) -> .hevc; decodes back bit-exact
    through libde265dec."""
    from gstbad.io import h265
    if not h265.available():
        import pytest
        pytest.skip("libx265/libde265 not present")
    import gstbad as gt
    from gstbad.core.pipeline import Pipeline
    spec = MediaSpec(kind="video", format="I420", width=64, height=48)
    yy, xx = np.mgrid[0:48, 0:64]
    planes = {"y": np.stack([((xx * 3 + yy + i * 7) % 256)
                             .astype(np.uint8) for i in range(6)]),
              "u": np.full((6, 24, 32), 90, np.uint8),
              "v": np.full((6, 24, 32), 170, np.uint8)}
    src = tmp_path / "in.y4m"
    dst = tmp_path / "out.hevc"
    y4m.write_y4m(src, spec, planes)
    t = Transcoder(str(src), str(dst), window=3,
                   profile="hevc:lossless")
    assert t.run() == 6
    dec = gt.make("libde265dec")
    dec.push_packet(dst.read_bytes())
    p = Pipeline([dec, gt.make("fakesink")])
    p.negotiate(None)
    outs = p.run(n_frames=6)
    dy = np.concatenate([np.asarray(o.data["y"]) for o in outs])[:6]
    assert np.array_equal(dy, planes["y"])


def test_transcoder_av1_ivf_profile(tmp_path):
    """y4m -> av1enc (real libaom) -> IVF; the repo's own ivfparse
    reads it back and av1dec decodes every frame."""
    from gstbad.io import av1 as av1io
    if not av1io.available():
        import pytest
        pytest.skip("libaom not present")
    from gstbad.io import ivf
    spec = MediaSpec(kind="video", format="I420", width=64, height=48)
    yy, xx = np.mgrid[0:48, 0:64]
    planes = {"y": np.stack([((xx * 2 + yy * 3 + i * 11) % 256)
                             .astype(np.uint8) for i in range(5)]),
              "u": np.full((5, 24, 32), 100, np.uint8),
              "v": np.full((5, 24, 32), 160, np.uint8)}
    src = tmp_path / "in.y4m"
    dst = tmp_path / "out.ivf"
    y4m.write_y4m(src, spec, planes)
    t = Transcoder(str(src), str(dst), window=5,
                   profile="av1:bitrate=900")
    assert t.run() == 5
    parser = ivf.IvfParse()
    frames = parser.push(dst.read_bytes())
    assert parser.header.media_type == "video/x-av1"
    assert len(frames) == 5
    dec = av1io.AV1Decoder()
    out = []
    for _pts, payload in frames:
        out += dec.decode(payload)
    assert len(out) == 5
    err = np.abs(out[0]["y"].astype(int)
                 - planes["y"][0].astype(int)).mean()
    assert err < 4
