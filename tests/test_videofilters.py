"""Fidelity: zebrastripe, videodiff, scenechange, smooth, videoanalyse."""

import numpy as np
import pytest

from gstbad.core.harness import Harness
from gstbad.core.spec import MediaSpec, VideoFormat
from gstbad.golden import videofilters as golden


def _gray_spec(w, h):
    return MediaSpec(kind="video", format=VideoFormat.GRAY8,
                     width=w, height=h)


def test_zebrastripe(rng):
    ys = rng.integers(0, 256, (3, 24, 31), dtype=np.uint8)
    h = Harness("zebrastripe", threshold=70)
    h.set_src_spec(_gray_spec(31, 24))
    got = h.push_pull(ys)
    for t in range(3):
        np.testing.assert_array_equal(got[t],
                                      golden.zebrastripe_y(ys[t], 70, t))


def test_zebrastripe_t_advances_across_windows(rng):
    ys = rng.integers(0, 256, (4, 16, 16), dtype=np.uint8)
    h = Harness("zebrastripe")
    h.set_src_spec(_gray_spec(16, 16))
    got1 = h.push_pull(ys[:2])
    got2 = h.push_pull(ys[2:])
    np.testing.assert_array_equal(got2[1],
                                  golden.zebrastripe_y(ys[3], 90, 3))


def test_videodiff(rng):
    ys = rng.integers(0, 256, (4, 20, 26), dtype=np.uint8)
    ys[1] = ys[0]  # static frame -> no marks
    h = Harness("videodiff")
    h.set_src_spec(_gray_spec(26, 20))
    got = h.push_pull(ys)
    np.testing.assert_array_equal(got[0], ys[0])  # first frame passthrough
    for t in range(1, 4):
        np.testing.assert_array_equal(
            got[t], golden.videodiff_y(ys[t], ys[t - 1], 10, 0))


def test_scenechange_detects_cut(rng):
    frames = np.broadcast_to(
        rng.integers(0, 40, (24, 32), dtype=np.uint8), (10, 24, 32)).copy()
    # tiny wiggle so diffs are nonzero
    frames[1::2] += 1
    cut = rng.integers(180, 256, (24, 32), dtype=np.uint8)
    frames[7] = cut
    frames[8] = cut
    frames[9] = cut
    h = Harness("scenechange")
    h.set_src_spec(_gray_spec(32, 24))
    h.push(frames)
    msgs = h.bus.pop(element="scenechange")
    assert len(msgs) == 1
    assert msgs[0].pts == 7 * int(1e9 / 30)

    # golden agreement frame by frame
    st = golden.SceneChangeState()
    changes = []
    for t in range(1, 10):
        changes.append(st.update(golden.sad_score(frames[t - 1], frames[t])))
    assert changes == [False] * 6 + [True, False, False]


def test_scenechange_state_spans_windows(rng):
    frames = np.broadcast_to(
        rng.integers(0, 40, (16, 16), dtype=np.uint8), (10, 16, 16)).copy()
    frames[1::2] += 1
    frames[8:] = rng.integers(180, 256, (16, 16), dtype=np.uint8)
    h = Harness("scenechange")
    h.set_src_spec(_gray_spec(16, 16))
    h.push(frames[:5])
    h.push(frames[5:])
    msgs = h.bus.pop(element="scenechange")
    assert len(msgs) == 1


@pytest.mark.parametrize("tol,fs", [(8, 3), (30, 2)])
def test_smooth(rng, tol, fs):
    y = rng.integers(0, 256, (18, 22), dtype=np.uint8)
    h = Harness("smooth", tolerance=tol, **{"filter-size": fs})
    h.set_src_spec(_gray_spec(22, 18))
    got = h.push_pull(y[None])[0]
    want = golden.smooth_y(y, tol, fs)
    np.testing.assert_array_equal(got, want)


def test_videoanalyse_matches_golden(rng):
    y = rng.integers(0, 256, (16, 16), dtype=np.uint8)
    h = Harness("videoanalyse")
    h.set_src_spec(_gray_spec(16, 16))
    h.push(y[None])
    msg = h.bus.pop(element="videoanalyse")[0]
    avg, var = golden.videoanalyse(y)
    assert msg["luma-average"] == pytest.approx(avg, abs=1e-12)
    assert msg["luma-variance"] == pytest.approx(var, abs=1e-12)


def test_simplevideomark_roundtrip(rng):
    import gstbad as gt
    p = gt.parse_launch(
        "videotestsrc pattern=gradient width=64 height=48 format=GRAY8 "
        "! simplevideomark pattern-data=13 "
        "! simplevideomarkdetect ! fakesink")
    p.run(n_frames=2, window=2)
    msgs = p.bus.pop(element="simplevideomarkdetect")
    assert len(msgs) == 2
    assert msgs[0]["have-pattern"]
    assert msgs[0]["pattern-data"] == 13


def test_smooth_chroma(rng):
    import gstbad as gt
    from gstbad.core.frame import FrameBatch
    import jax.numpy as jnp
    data = {"y": rng.integers(0, 256, (1, 16, 16), dtype=np.uint8),
            "u": rng.integers(0, 256, (1, 8, 8), dtype=np.uint8),
            "v": rng.integers(0, 256, (1, 8, 8), dtype=np.uint8)}
    el = gt.make("smooth", **{"luma-only": False})
    el.set_info(MediaSpec(kind="video", format="I420", width=16, height=16))
    _, out, *_ = el(FrameBatch.make({k: jnp.asarray(v)
                                     for k, v in data.items()}))
    got_u = np.asarray(out.data["u"][0])
    np.testing.assert_array_equal(got_u, golden.smooth_y(data["u"][0]))


def test_alphacombine(rng):
    import gstbad as gt
    p = gt.parse_launch(
        "videotestsrc pattern=bars width=16 height=16 format=I420 name=v "
        "! comb. "
        "videotestsrc pattern=gradient width=16 height=16 format=GRAY8 "
        "! comb. "
        "alphacombine name=comb ! fakesink")
    spec = p.negotiate()
    assert spec.format == "A420"
    outs = p.run(n_frames=2, window=2)
    assert "a" in outs[0].data
    assert outs[0].data["a"].shape == (2, 16, 16)


def test_suboverlay(rng):
    import gstbad as gt
    p = gt.parse_launch(
        "videotestsrc pattern=black width=16 height=16 format=AYUV name=v "
        "! ovl. "
        "videotestsrc pattern=white width=16 height=16 format=AYUV "
        "! ovl. "
        "suboverlay name=ovl ! fakesink")
    outs = p.run(n_frames=1, window=1)
    out = np.asarray(outs[0].data[0])
    # overlay alpha=255 -> video replaced by overlay (white: Y=235)
    assert abs(int(out[0, 0, 1]) - 235) <= 1
