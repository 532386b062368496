"""GstPlay/GstPlayer API parity (gst-libs/gst/play/gstplay.c,
gst-libs/gst/player/gstplayer.c) — the upstream
tests/check/libs/play.c scenario matrix transcribed onto testbin://
sources, plus the compute surfaces (volume gain, color balance,
visualization, snapshot) the reference delegates to playbin."""

import time

import numpy as np
import pytest

from gstbad.session import (Play, PlayState, Player, QueuedDispatcher,
                                SignalAdapter)

AV_URI = ("testbin://video,width=32,height=32,format=GRAY8"
          "+audio,rate=8000,samplesperbuffer=256,channels=1")
A_URI = "testbin://audio,rate=8000,samplesperbuffer=256,channels=1"
V_URI = "testbin://video,width=32,height=32,format=GRAY8"


def wait_for(pred, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def msgs(play, name):
    return play.message_bus.pop(name=name)


def run_to_eos(play, timeout=60):
    play.play()
    assert wait_for(lambda: play.state == PlayState.STOPPED, timeout), \
        "did not reach EOS"
    play.stop()


# -- play.c test_create_and_free / test_set_and_get_uri ---------------------

def test_create_and_free():
    p = Play()
    assert p.state == PlayState.STOPPED
    assert p.get_uri() is None
    assert p.position == 0 and p.duration is None
    p.stop()


def test_set_and_get_uri():
    p = Play()
    p.set_uri(A_URI)
    assert p.get_uri() == A_URI
    p.set_uri(V_URI)
    assert p.get_uri() == V_URI


# -- play.c test_set_and_get_position_update_interval ------------------------

def test_set_and_get_position_update_interval():
    p = Play()
    assert p.get_config()["position-update-interval"] == 100  # default
    assert p.set_config(position_update_interval=500)
    assert p.get_config()["position-update-interval"] == 500
    # set_config fails while not stopped (gstplay.c gst_play_set_config)
    p.set_uri(V_URI)
    p.n_frames = 64
    p.realtime = False
    p.play()
    assert not p.set_config(position_update_interval=10)
    p.stop()
    assert p.set_config(position_update_interval=100)


def test_play_position_update_interval():
    # 30 fps video, window 4 -> 133ms per window; 200ms interval ->
    # a post every other window
    p = Play(window=4, realtime=False, n_frames=32)
    p.set_config(position_update_interval=200)
    p.set_uri(V_URI)
    run_to_eos(p)
    pos = [m["position"] for m in msgs(p, "position-updated")]
    assert 3 <= len(pos) <= 10
    assert pos == sorted(pos)
    # interval 0 disables the tick (gst_play_config_set_position_update_
    # interval(0))
    p2 = Play(window=4, realtime=False, n_frames=16)
    p2.set_config(position_update_interval=0)
    p2.set_uri(V_URI)
    run_to_eos(p2)
    assert len(msgs(p2, "position-updated")) <= 1   # only the EOS tick


# -- play.c test_play_audio_eos / test_play_audio_video_eos ------------------

def test_play_audio_eos():
    p = Play(window=4, realtime=False, n_frames=16)
    p.set_uri(A_URI)
    run_to_eos(p)
    assert len(msgs(p, "end-of-stream")) == 1
    states = [m["state"] for m in msgs(p, "state-changed")]
    assert states[0] == PlayState.PLAYING
    assert states[-1] == PlayState.STOPPED


def test_play_audio_video_eos():
    got = {"video": 0, "audio": 0}

    def on_frame(b, i):
        kind = "video" if np.asarray(
            b.data if not isinstance(b.data, dict)
            else next(iter(b.data.values()))).dtype == np.uint8 else "audio"
        got[kind] += 1

    p = Play(window=4, realtime=False, n_frames=16, on_frame=on_frame)
    p.set_uri(AV_URI)
    run_to_eos(p)
    assert got["video"] == 16 and got["audio"] == 16
    assert len(msgs(p, "end-of-stream")) == 1
    assert len(msgs(p, "uri-loaded")) == 1


# -- play.c test_play_error_invalid_uri[_and_play] ----------------------------

def test_play_error_invalid_uri():
    p = Play(realtime=False)
    p.set_uri("foo://bar")
    p.play()
    assert wait_for(lambda: msgs(p, "error"))
    assert p.state == PlayState.STOPPED
    assert "foo://bar" in msgs(p, "error")[0]["reason"] \
        or msgs(p, "error")[0].fields.get("uri") == "foo://bar"


# -- play.c test_play_media_info ----------------------------------------------

def test_play_media_info():
    p = Play(window=4, realtime=False, n_frames=8)
    p.set_uri(AV_URI)
    info = p.media_info
    assert info.number_of_video_streams == 1
    assert info.number_of_audio_streams == 1
    assert info.number_of_subtitle_streams == 0
    assert info.number_of_streams == 2
    v = info.video_streams[0]
    assert (v.width, v.height) == (32, 32)
    assert v.framerate == (30, 1)
    a = info.audio_streams[0]
    assert a.sample_rate == 8000 and a.channels == 1
    assert info.seekable
    assert info.duration == 8 * (10**9 // 30)
    assert msgs(p, "media-info-updated")
    assert msgs(p, "video-dimensions-changed")[0].fields == {
        "width": 32, "height": 32}
    for s in info.stream_list:
        assert s.stream_type in ("video", "audio")


# -- play.c test_play_stream_disable ------------------------------------------

def test_play_stream_disable():
    p = Play(window=4, realtime=False)
    p.set_uri(AV_URI)
    assert p.get_current_audio_track() is not None
    p.set_audio_track_enabled(False)
    assert p.get_current_audio_track() is None
    assert p.get_current_video_track() is not None
    p.set_subtitle_track_enabled(False)
    assert p.get_current_subtitle_track() is None
    # re-enable restores the track (and its compute)
    p.set_audio_track_enabled(True)
    assert p.get_current_audio_track() is not None


def test_play_stream_disable_stops_compute():
    """Disabled tracks are not computed (playbin's unselected branches
    don't decode): with audio disabled no float batches are dispatched."""
    dtypes = set()
    p = Play(window=4, realtime=False, n_frames=8,
             on_frame=lambda b, i: dtypes.add(
                 np.asarray(b.data if not isinstance(b.data, dict)
                            else next(iter(b.data.values()))).dtype.kind))
    p.set_uri(AV_URI)
    p.set_audio_track_enabled(False)
    run_to_eos(p)
    assert dtypes == {"u"}          # only u8 video reached the sinks


# -- play.c test_play_stream_switch_audio -------------------------------------

def _dominant_zero_crossings(batches):
    x = np.concatenate([np.asarray(b) for b in batches]).ravel()
    return int((np.diff(np.signbit(x)) != 0).sum())


def test_play_stream_switch_audio():
    uri = ("testbin://audio,rate=8000,samplesperbuffer=256,channels=1,"
           "freq=100+audio,rate=8000,samplesperbuffer=256,channels=1,"
           "freq=200")
    grabbed = []
    p = Play(window=4, realtime=False,
             on_frame=lambda b, i: grabbed.append(np.asarray(b.data[i])))
    p.set_uri(uri)
    assert p.media_info.number_of_audio_streams == 2
    assert p.get_current_audio_track().index == 0
    assert not p.set_audio_track(5)        # OOB -> FALSE
    p.play()
    assert wait_for(lambda: len(grabbed) >= 8)
    p.pause()
    first = grabbed[:8]
    assert p.set_audio_track(1)
    assert p.get_current_audio_track().index == 1
    n0 = len(grabbed)
    p.play()
    assert wait_for(lambda: len(grabbed) >= n0 + 8)
    p.stop()
    second = grabbed[n0:n0 + 8]
    # 100 Hz vs 200 Hz at 8 kHz: zero crossings double
    zc1 = _dominant_zero_crossings(first)
    zc2 = _dominant_zero_crossings(second)
    assert zc2 > zc1 * 1.5, (zc1, zc2)


# -- play.c test_play_external_suburi / error_invalid_external_suburi ---------

def test_play_external_suburi(tmp_path):
    srt = tmp_path / "subs.srt"
    srt.write_text("1\n00:00:00,000 --> 00:00:00,300\nhello\n\n"
                   "2\n00:00:00,500 --> 00:00:00,800\nworld\n\n")
    texts = []
    p = Play(window=4, realtime=False, n_frames=30,
             on_subtitle=lambda t, cue: texts.append(t))
    p.set_uri(V_URI)
    assert p.set_subtitle_uri(str(srt))
    assert p.get_subtitle_uri() == str(srt)
    assert p.media_info.number_of_subtitle_streams == 1
    assert p.get_current_subtitle_track() is not None
    run_to_eos(p)
    assert texts == ["hello", "world"]


def test_play_error_invalid_external_suburi(tmp_path):
    bad = tmp_path / "bad.srt"
    bad.write_text("this is not a subtitle file")
    p = Play(window=4, realtime=False, n_frames=8)
    p.set_uri(V_URI)
    assert not p.set_subtitle_uri(str(bad))
    assert msgs(p, "warning")              # warning, not error
    run_to_eos(p)                          # playback unaffected
    assert len(msgs(p, "end-of-stream")) == 1
    assert p.media_info.number_of_subtitle_streams == 0


def test_play_stream_switch_subtitle(tmp_path):
    srt = tmp_path / "s.srt"
    srt.write_text("1\n00:00:00,000 --> 00:00:01,000\nx\n\n")
    p = Play(window=4, realtime=False)
    p.set_uri(V_URI)
    p.set_subtitle_uri(str(srt))
    assert p.set_subtitle_track(0)
    assert not p.set_subtitle_track(1)     # only the external track


# -- play.c test_play_forward_rate / test_play_backward_rate ------------------

def test_play_forward_rate():
    p = Play(window=4, realtime=False, n_frames=64)
    p.set_uri(V_URI)
    assert p.get_rate() == 1.0             # default rate 1.0
    dur = p.duration
    p.seek(int(dur * 0.2))                 # seek 20% like the upstream cb
    assert msgs(p, "seek-done")
    p.set_rate(1.5)
    assert p.get_rate() == 1.5
    run_to_eos(p)
    pos = [m["position"] for m in msgs(p, "position-updated")]
    assert len(pos) >= 2 and pos == sorted(pos)
    assert pos[-1] > pos[0]


def test_play_backward_rate():
    p = Play(window=4, realtime=False)
    p.set_uri(V_URI)
    p.seek(16 * (10**9 // 30))             # frame 16
    p.set_rate(-1.0)
    assert p.get_rate() == -1.0
    run_to_eos(p)                          # EOS at stream start
    pos = [m["position"] for m in msgs(p, "position-updated")]
    assert len(pos) >= 2
    assert pos == sorted(pos, reverse=True)
    assert len(msgs(p, "end-of-stream")) == 1


def test_backward_rate_frames_reversed():
    """Negative rate emits frames in decreasing pts order."""
    pts = []
    p = Play(window=4, realtime=False,
             on_frame=lambda b, i: pts.append(int(np.asarray(b.pts)[i])))
    p.set_uri(V_URI)
    p.seek(8 * (10**9 // 30))
    p.set_rate(-1.0)
    run_to_eos(p)
    assert len(pts) >= 8
    assert pts == sorted(pts, reverse=True)
    assert pts[-1] == 0


def test_set_rate_zero_rejected():
    p = Play()
    with pytest.raises(ValueError):
        p.set_rate(0.0)


# -- play.c test_play_audio_video_seek_done -----------------------------------

def test_play_audio_video_seek_done():
    p = Play(window=4, realtime=False, n_frames=64)
    p.set_uri(AV_URI)
    target = 10 * (10**9 // 30)
    p.seek(target)
    done = msgs(p, "seek-done")
    assert len(done) == 1
    assert abs(done[0]["position"] - target) <= 10**9 // 30
    # seek repositions the actual dispatched frames
    pts = []
    p.on_frame = lambda b, i: pts.append(int(np.asarray(b.pts)[i]))
    p.play()
    assert wait_for(lambda: len(pts) >= 4)
    p.stop()
    assert min(pts[:4]) >= target - 10**9 // 30


def test_seek_accurate_vs_keyframe():
    dur = 10**9 // 30
    p = Play(window=4, realtime=False)
    p.set_uri(V_URI)
    # keyframe mode (default): floors to the latest sync point
    p.seek(int(2.9 * dur))
    assert p.position == 2 * dur
    p.stop()
    assert p.set_config(seek_accurate=True)
    p.seek(int(2.9 * dur))                 # accurate: nearest frame
    assert p.position == 3 * dur


# -- play.c test_restart / test_user_agent ------------------------------------

def test_restart():
    first = []
    p = Play(window=4, realtime=False, n_frames=8,
             on_frame=lambda b, i: first.append(int(np.asarray(b.pts)[i])))
    p.set_uri(V_URI)
    run_to_eos(p)
    assert first[0] == 0
    second = []
    p.on_frame = lambda b, i: second.append(int(np.asarray(b.pts)[i]))
    run_to_eos(p)                          # play again restarts from 0
    assert second[0] == 0 and len(second) == 8


def test_user_agent():
    p = Play()
    assert "GstPlay" in p.get_config()["user-agent"]
    assert p.set_config(user_agent="test/1.0")
    assert p.get_config()["user-agent"] == "test/1.0"


# -- volume / mute (playbin volume property -> _PlayVolume gain stage) --------

def test_volume_is_compute():
    grabbed = []
    p = Play(window=4, realtime=False,
             on_frame=lambda b, i: grabbed.append(np.asarray(b.data[i])))
    p.set_uri(A_URI)
    assert p.get_volume() == 1.0 and not p.get_mute()
    p.play()
    assert wait_for(lambda: len(grabbed) >= 4)
    p.pause()
    base = grabbed[:4]
    p.seek(0)
    p.set_volume(0.5)
    assert msgs(p, "volume-changed")[0]["volume"] == 0.5
    n0 = len(grabbed)
    p.play()
    assert wait_for(lambda: len(grabbed) >= n0 + 4)
    p.pause()
    halved = grabbed[n0:n0 + 4]
    for a, b in zip(base, halved):         # f32 * 0.5 is exact
        np.testing.assert_array_equal(a.astype(np.float64) * 0.5, b)
    # mute -> silence
    p.seek(0)
    p.set_mute(True)
    assert msgs(p, "mute-changed")[0]["muted"] is True
    n1 = len(grabbed)
    p.play()
    assert wait_for(lambda: len(grabbed) >= n1 + 2)
    p.stop()
    assert not np.asarray(grabbed[n1]).any()


# -- audio-video offset --------------------------------------------------------

def test_audio_video_offset():
    pts = []
    p = Play(window=4, realtime=False, n_frames=8,
             on_frame=lambda b, i: pts.append(int(np.asarray(b.pts)[i]))
             if np.asarray(b.data).dtype.kind == "f" else None)
    p.set_uri(A_URI)
    p.set_audio_video_offset(7_000_000)
    assert p.get_audio_video_offset() == 7_000_000
    run_to_eos(p)
    assert pts[0] == 7_000_000


# -- color balance (playbin colorbalance -> _ColorBalance stage) ---------------

def test_color_balance():
    grabbed = []
    p = Play(window=4, realtime=False,
             on_frame=lambda b, i: grabbed.append(np.asarray(b.data[i])))
    p.set_uri(V_URI)                        # GRAY8
    assert p.has_color_balance()
    assert p.get_color_balance("brightness") == 0.5
    p.play()
    assert wait_for(lambda: len(grabbed) >= 2)
    p.pause()
    base = grabbed[0].copy()
    p.seek(0)
    p.set_color_balance("brightness", 1.0)  # full brightness
    assert p.get_color_balance("brightness") == 1.0
    n0 = len(grabbed)
    p.play()
    assert wait_for(lambda: len(grabbed) >= n0 + 2)
    p.stop()
    bright = grabbed[n0]
    assert bright.mean() > base.mean() + 50
    assert bright.max() == 255


# -- visualization (playbin vis -> audiovisualizer tee) -------------------------

def test_visualization():
    shapes = []
    p = Play(window=4, realtime=False, n_frames=8,
             on_frame=lambda b, i: shapes.append(
                 np.asarray(b.data[i]).shape))
    p.set_uri(A_URI)
    assert not p.set_visualization("no-such-element")
    assert p.set_visualization("wavescope")
    p.set_visualization_enabled(True)
    assert p.get_current_visualization() == "wavescope"
    run_to_eos(p)
    # both the audio blocks and the vis video frames were dispatched
    assert (256, 1) in shapes
    assert (240, 320, 4) in shapes


# -- snapshot -------------------------------------------------------------------

def test_video_snapshot():
    p = Play(window=4, realtime=False, n_frames=8)
    p.set_uri("testbin://video,width=32,height=16,format=AYUV")
    assert p.get_video_snapshot() is None   # nothing played yet
    run_to_eos(p)
    spec, frame = p.get_video_snapshot()
    assert spec.format == "AYUV" and frame.shape == (16, 32, 4)
    spec2, frame2 = p.get_video_snapshot("I420")
    assert spec2.format == "I420"
    assert frame2["y"].shape == (16, 32)


# -- multiview plumb ------------------------------------------------------------

def test_multiview_roundtrip():
    p = Play()
    assert p.get_multiview_mode() == "none"
    p.set_multiview_mode("side-by-side")
    p.set_multiview_flags(3)
    assert p.get_multiview_mode() == "side-by-side"
    assert p.get_multiview_flags() == 3


# -- Player / signal adapter (gstplayer.c + gstplay-signal-adapter.c) -----------

def test_player_signals_direct():
    events = []
    player = Player(window=4, realtime=False, n_frames=8)
    player.connect("state-changed", lambda s: events.append(("state", s)))
    player.connect("end-of-stream", lambda: events.append(("eos",)))
    player.connect("position-updated",
                   lambda pos: events.append(("pos", pos)))
    with pytest.raises(KeyError):
        player.connect("no-such-signal", lambda: None)
    player.set_uri(V_URI)
    player.play()
    assert wait_for(lambda: player.state == PlayState.STOPPED)
    player.stop()
    kinds = [e[0] for e in events]
    assert "state" in kinds and "eos" in kinds and "pos" in kinds
    states = [e[1] for e in events if e[0] == "state"]
    assert states[0] == PlayState.PLAYING
    assert PlayState.STOPPED in states


def test_player_queued_dispatcher():
    """The GMainContext dispatcher analog: emissions queue until the
    application drains them from its own thread."""
    disp = QueuedDispatcher()
    events = []
    player = Player(window=4, realtime=False, n_frames=8,
                    dispatcher=disp)
    player.connect("end-of-stream", lambda: events.append("eos"))
    player.set_uri(V_URI)
    player.play()
    assert wait_for(lambda: player.state == PlayState.STOPPED)
    assert events == []                    # nothing emitted yet
    disp.dispatch_pending()
    assert events == ["eos"]
    player.stop()


def test_player_control_forwarding():
    player = Player(window=4, realtime=False, n_frames=16)
    player.set_uri(AV_URI)
    assert player.get_uri() == AV_URI
    player.set_volume(0.25)
    assert player.get_volume() == 0.25
    player.set_rate(2.0)
    assert player.get_rate() == 2.0
    assert player.media_info.number_of_audio_streams == 1
    assert player.get_current_video_track() is not None
    player.set_video_track_enabled(False)
    assert player.get_current_video_track() is None
    player.stop()


def test_signal_adapter_standalone():
    """GstPlaySignalAdapter: bridges an existing Play without owning it."""
    p = Play(window=4, realtime=False, n_frames=8)
    got = []
    adapter = SignalAdapter(p)
    adapter.connect("uri-loaded", lambda uri: got.append(uri))
    p.set_uri(V_URI)
    run_to_eos(p)
    assert got == [V_URI]
