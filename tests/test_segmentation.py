"""segmentation element (ext/opencv/gstsegmentation.cpp): golden vs the
cv2 oracle (MOG2 / cvtColor / morphology are the exact library calls the
reference makes), JAX ops vs golden, and element windows with state carry.
"""

import fractions

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import gstbad as gt
from gstbad.core.frame import FrameBatch
from gstbad.core.pipeline import Pipeline
from gstbad.core.spec import MediaSpec
from gstbad.golden import segmentation as G
from gstbad.ops import segmentation as S

cv2 = pytest.importorskip("cv2")

T, H, W = 48, 6, 8
LR = 0.01


def _video(seed=3):
    rng = np.random.default_rng(seed)
    bg = rng.integers(0, 256, (H, W, 3), np.uint8)
    frames = np.repeat(bg[None], T, 0).copy()
    for t in range(T):
        frames[t, 2:4, t % (W - 1):t % (W - 1) + 1] = [210, 50, 80]
        if 20 <= t < 32:
            frames[t] = (frames[t] * 0.5).astype(np.uint8)   # shadow dips
    return frames


def _yccs(frames):
    return np.stack([G.rgb2ycrcb_u8(f) for f in frames])


def test_golden_mog2_and_ycrcb_match_cv2():
    frames = _video()
    sub = cv2.createBackgroundSubtractorMOG2()
    st = G.mog2_new_state(H, W)
    for t in range(T):
        ycc_cv = cv2.cvtColor(frames[t], cv2.COLOR_RGB2YCrCb)
        np.testing.assert_array_equal(G.rgb2ycrcb_u8(frames[t]), ycc_cv)
        mc = sub.apply(ycc_cv, learningRate=LR)
        mn = G.mog2_step(G.rgb2ycrcb_u8(frames[t]), st, LR)
        np.testing.assert_array_equal(mn, mc)


def test_golden_morphology_matches_cv2():
    rng = np.random.default_rng(5)
    m = (rng.integers(0, 2, (16, 20)) * 255).astype(np.uint8)
    opened = cv2.morphologyEx(m, cv2.MORPH_OPEN, None)
    closed = cv2.morphologyEx(opened, cv2.MORPH_CLOSE, None)
    np.testing.assert_array_equal(G.morph_open_close(m), closed)


def test_ops_match_golden_all_methods():
    frames = _video()
    yccs = _yccs(frames)
    np.testing.assert_array_equal(
        np.asarray(S.rgb2ycrcb_u8(jnp.asarray(frames))), yccs)

    stg, stj = G.mog2_new_state(H, W), S.mog2_new_state(H, W)
    step2 = jax.jit(S.mog2_frame)
    bad = 0
    for t in range(T):
        mg = G.mog2_step(yccs[t], stg, LR)
        stj, mj = step2(stj, jnp.asarray(yccs[t]), LR)
        bad += int((np.asarray(mj) != mg).sum())
    # f32 device math vs the golden's f64-on-f32: allow stray boundary px
    assert bad <= T * H * W // 500
    np.testing.assert_array_equal(np.asarray(stj["nmodes"]), stg["nmodes"])

    stg2, stj2 = G.mog_new_state(H, W), S.mog_new_state(H, W)
    stepm = jax.jit(S.mog_frame)
    for t in range(T):
        mg = G.mog_step(yccs[t], stg2, LR)
        stj2, mj = stepm(stj2, jnp.asarray(yccs[t]), LR)
        np.testing.assert_array_equal(np.asarray(mj), mg)

    masks_g = G.codebook_video(yccs, LR)
    stc = S.codebook_new_state(H, W)
    upd, diff = jax.jit(S.codebook_update), jax.jit(S.codebook_diff)
    interval = int(1 / LR)
    for t in range(T):
        fc = t + 1
        if fc < G.CB_LEARN_FRAMES:
            stc = upd(stc, jnp.asarray(yccs[t]), True)
            mj = np.zeros((H, W), np.uint8)
        else:
            stc = upd(stc, jnp.asarray(yccs[t]), fc % interval == 0)
            mj = np.asarray(diff(stc, jnp.asarray(yccs[t])))
        np.testing.assert_array_equal(mj, masks_g[t])

    m = (np.random.default_rng(6).integers(0, 2, (3, 12, 14)) * 255
         ).astype(np.uint8)
    np.testing.assert_array_equal(
        np.asarray(S.morph_open_close(jnp.asarray(m))),
        np.stack([G.morph_open_close(x) for x in m]))


def _run_element(frames_rgba, windows, **props):
    el = gt.make("segmentation")
    for k, v in props.items():
        el.set_property(k, v)
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="video", format="RGBA", width=W, height=H,
                          framerate=fractions.Fraction(30)))
    outs = []
    n = frames_rgba.shape[0] // windows
    for i in range(windows):
        chunk = jnp.asarray(frames_rgba[i * n:(i + 1) * n])
        pts = jnp.arange(i * n, (i + 1) * n, dtype=jnp.int64) * (10 ** 9
                                                                 // 30)
        outs += [np.asarray(o.data)
                 for o in p.run(inputs=FrameBatch.make(chunk, pts=pts))]
    return np.concatenate(outs)


def test_element_mog2_windows_carry_state():
    frames = _video()
    rgba = np.concatenate(
        [frames, np.full((T, H, W, 1), 9, np.uint8)], axis=-1)
    out = _run_element(rgba, windows=3, **{"test-mode": True})
    # element across 3 windows == one golden stream
    st = G.mog2_new_state(H, W)
    for t in range(T):
        mg = G.mog2_step(G.rgb2ycrcb_u8(frames[t]), st, LR)
        for c in range(4):
            np.testing.assert_array_equal(out[t, :, :, c], mg)


def test_element_codebook_learning_and_cleanup():
    frames = _video()
    rgba = np.concatenate(
        [frames, np.zeros((T, H, W, 1), np.uint8)], axis=-1)
    out = _run_element(rgba, windows=2, method="codebook",
                       **{"test-mode": True})
    masks = np.stack([G.morph_open_close(m)
                      for m in G.codebook_video(_yccs(frames), LR)])
    np.testing.assert_array_equal(out[..., 0], masks)
    # learning phase emits black frames (cvFG starts zeroed)
    assert (out[:G.CB_LEARN_FRAMES - 1] == 0).all()


def test_element_output_quirks():
    frames = _video()
    rgba = np.concatenate(
        [frames, np.full((T, H, W, 1), 77, np.uint8)], axis=-1)
    # reference 5-channel merge quirk: without test-mode, passthrough
    out = _run_element(rgba, windows=1)
    np.testing.assert_array_equal(out, rgba)
    # non-reference escape hatch: mask lands in alpha
    out2 = _run_element(rgba, windows=1, **{"mask-to-alpha": True})
    np.testing.assert_array_equal(out2[..., :3], rgba[..., :3])
    st = G.mog2_new_state(H, W)
    for t in range(T):
        mg = G.mog2_step(G.rgb2ycrcb_u8(frames[t]), st, LR)
        np.testing.assert_array_equal(out2[t, :, :, 3], mg)
