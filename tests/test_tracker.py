"""cvtracker (ext/opencv/gstcvtracker.cpp) with the MOSSE engine."""

import fractions

import numpy as np
import jax.numpy as jnp

import gstbad as gt
from gstbad.core.frame import FrameBatch
from gstbad.core.pipeline import Pipeline
from gstbad.core.spec import MediaSpec
from gstbad.ops import mosse

H, W = 96, 128


def _frames(n, start=(40, 40), step=(2, 1), obj_seed=0):
    rng = np.random.default_rng(obj_seed)
    obj = rng.integers(100, 256, (16, 16)).astype(np.uint8)
    out = []
    cs = []
    for t in range(n):
        cx = start[0] + step[0] * t
        cy = start[1] + step[1] * t
        img = np.random.default_rng(100 + t).integers(
            0, 60, (H, W)).astype(np.uint8)
        img[cy - 8:cy + 8, cx - 8:cx + 8] = obj
        out.append(np.repeat(img[..., None], 3, axis=-1))
        cs.append((cx, cy))
    return np.stack(out), cs


def test_mosse_tracks_and_detects_loss():
    frames, cs = _frames(12)
    gray = frames[..., 0]
    st = mosse.init_state(jnp.asarray(gray[0]), (28, 28, 24, 24))
    for t in range(1, 12):
        st, ok, cy, cx = mosse.update(st, jnp.asarray(gray[t]), 24, 24)
        assert bool(ok)
        assert abs(float(cx) - cs[t][0]) <= 2
        assert abs(float(cy) - cs[t][1]) <= 2
    blank = np.random.default_rng(999).integers(0, 60, (H, W)
                                                ).astype(np.uint8)
    _, ok, _, _ = mosse.update(st, jnp.asarray(blank), 24, 24)
    assert not bool(ok)


def test_element_messages_and_rect():
    frames, cs = _frames(8)
    el = gt.make("cvtracker", **{"object-initial-x": 28,
                                 "object-initial-y": 28,
                                 "object-initial-width": 24,
                                 "object-initial-height": 24})
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="RGB", width=W, height=H,
                          framerate=fractions.Fraction(30)))
    outs = p.run(inputs=FrameBatch.make(jnp.asarray(frames)), window=4)
    out = np.concatenate([np.asarray(o.data) for o in outs])
    msgs = p.bus.pop(name="object")
    # init frame posts nothing (gstcvtracker.cpp: init has no message)
    assert len(msgs) == 7
    for i, m in enumerate(msgs):
        cx, cy = cs[i + 1]
        assert abs(int(m["x"]) + 12 - cx) <= 2
        assert abs(int(m["y"]) + 12 - cy) <= 2
        assert int(m["width"]) == 24 and int(m["height"]) == 24
    # tracked frames paint the (255, 0, 0) thickness-2 rectangle
    red = (out[3] == [255, 0, 0]).all(axis=-1)
    assert red.sum() > 100
    # the init frame draws nothing
    assert not (out[0] == [255, 0, 0]).all(axis=-1).any()


def test_element_rejects_unknown_algorithm():
    el = gt.make("cvtracker", algorithm="kcf")
    p = Pipeline([el])
    import pytest
    with pytest.raises(Exception, match="mosse"):
        p.negotiate(MediaSpec(kind="video", format="RGB", width=W,
                              height=H, framerate=fractions.Fraction(30)))
