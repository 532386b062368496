"""audiovisualizer styles vs the golden C transcription
(gstwavescope.c / gstspacescope.c / gstdrawhelpers.h)."""

import numpy as np
import jax.numpy as jnp
import pytest

import gstbad as gt
from gstbad.core.frame import FrameBatch
from gstbad.core.pipeline import Pipeline
from gstbad.core.spec import AudioFormat, MediaSpec
from gstbad.golden import visualizers as gv

W, H, S, B = 64, 32, 128, 2


def _audio(rng, channels=2):
    return rng.integers(-32768, 32768, (B, S, channels), dtype=np.int16)


def _golden_frames(adata, scope, style, shader="fade", amount=0x0A0A0A):
    b, s, c = adata.shape
    prev = np.zeros((H, W, 4), np.uint8)
    flt = np.zeros(6 * c if scope == "wave" else 12, np.float64)
    outs = []
    for i in range(b):
        if shader == "fade":
            base = gv.shader_fade(prev, amount)
        else:
            base = np.zeros_like(prev)
        vd = gv.canvas(W, H)
        vd[:H * W] = base.reshape(H * W, 4).view("<u4").reshape(-1)
        if scope == "wave":
            gv.wavescope_render(vd, adata[i].reshape(-1), c, W, H, style,
                                flt)
        else:
            gv.spacescope_render(vd, adata[i].reshape(-1), W, H, style, flt)
        img = gv.crop(vd, W, H).view("<u4").reshape(H * W, 1)
        img = img.view(np.uint8).reshape(H, W, 4)
        outs.append(img)
        prev = img
    return np.stack(outs)


def _run_element(name, adata, style, shader="fade"):
    el = gt.make(name, style=style, width=W, height=H, shader=shader)
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="audio", format=AudioFormat.S16, rate=44100,
                          channels=adata.shape[2]))
    outs = p.run(inputs=FrameBatch.make(jnp.asarray(adata)))
    return np.concatenate([np.asarray(o.data) for o in outs])


@pytest.mark.parametrize("style", ["dots", "color-dots"])
def test_wavescope_dots_bitexact(rng, style):
    adata = _audio(rng)
    got = _run_element("wavescope", adata, style)
    want = _golden_frames(adata, "wave", style)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("style", ["lines", "color-lines"])
def test_wavescope_lines_close(rng, style):
    """AA line intensities accumulate-then-saturate vs the C's per-dot
    truncation: positions exact, values within a few LSB at overlaps.
    (shader=none so a 1-LSB intensity diff can't flip the NEXT frame's
    faded support.)"""
    adata = _audio(rng)
    got = _run_element("wavescope", adata, style, shader="none")
    want = _golden_frames(adata, "wave", style, shader="none")
    assert np.array_equal(got > 0, want > 0)  # support (positions) exact
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 6
    # with fade: intensities stay close across the carried canvas
    gotf = _run_element("wavescope", adata, style)
    wantf = _golden_frames(adata, "wave", style)
    assert np.abs(gotf.astype(int) - wantf.astype(int)).max() <= 8


@pytest.mark.parametrize("style", ["dots", "color-dots"])
def test_spacescope_dots_bitexact(rng, style):
    adata = _audio(rng)
    got = _run_element("spacescope", adata, style)
    want = _golden_frames(adata, "space", style)
    np.testing.assert_array_equal(got, want)


def test_spacescope_color_lines_close(rng):
    adata = _audio(rng)
    got = _run_element("spacescope", adata, "color-lines", shader="none")
    want = _golden_frames(adata, "space", "color-lines", shader="none")
    assert np.array_equal(got > 0, want > 0)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 6


def test_shader_fade_carries_across_windows(rng):
    """Window 2's first frame starts from window 1's last frame faded."""
    adata = _audio(rng)
    el = gt.make("wavescope", style="dots", width=W, height=H)
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="audio", format=AudioFormat.S16, rate=44100,
                          channels=2))
    o1 = p.run(inputs=FrameBatch.make(jnp.asarray(adata)))
    o2 = p.run(inputs=FrameBatch.make(jnp.asarray(adata)))
    last = np.asarray(o1[-1].data)[-1]
    nxt = np.asarray(o2[0].data)[0]
    faded = gv.shader_fade(last, 0x0A0A0A)
    # every pixel not overdrawn by window 2's dots equals the faded carry
    drawn = (nxt != faded).any(axis=-1)
    assert drawn.sum() < 0.2 * H * W
    np.testing.assert_array_equal(nxt[~drawn], faded[~drawn])


def test_shader_none_and_moves(rng):
    adata = _audio(rng)
    got = _run_element("wavescope", adata, "dots", shader="none")
    want = _golden_frames(adata, "wave", "dots", shader="none")
    np.testing.assert_array_equal(got, want)
    # move variants smoke: run and check shapes
    for sh in ("fade-and-move-up", "fade-and-move-down",
               "fade-and-move-left", "fade-and-move-right"):
        out = _run_element("wavescope", adata, "dots", shader=sh)
        assert out.shape == (B, H, W, 4)


# -- spectrascope / synaescope (gst_fft_s16 model + exact renders) ----------

from gstbad.golden import ffts16 as gf


def test_ffts16_model_properties():
    # kiss factorization order: powers of 4, then 2/3/odd primes
    assert gf.kf_factor(256) == [4, 4, 4, 4]
    assert gf.kf_factor(320 // 2) == [4, 4, 2, 5]
    assert gf.kf_factor(64) == [4, 4, 4]
    # a full-scale tone lands its energy in the right bin at the
    # fixed-point scale (~ amplitude/2 at the bin, DFT/N overall; the
    # round-2 model's extra /2 was a bug caught by the exact kissfft —
    # see golden/ffts16.fft_scale)
    n = 128
    tone = (16384 * np.cos(2 * np.pi * 8 * np.arange(n) / n)
            ).astype(np.int16)
    f = gf.fft_s16(tone)
    mags = np.abs(f)
    assert mags.argmax() == 8
    assert abs(mags[8] - 16384 / 2) / (16384 / 2) < 0.01
    # device model matches golden bit-for-bit on CPU
    from gstbad.ops import ffts16 as df
    r, i = df.fft_s16(jnp.asarray(tone[None].astype(np.int32)))
    np.testing.assert_array_equal(np.asarray(r)[0], f.real)
    np.testing.assert_array_equal(np.asarray(i)[0], f.imag)
    # hamming window truncation matches
    w = gf.window_hamming(tone)
    wd = np.asarray(df.window_hamming(jnp.asarray(tone[None]
                                                  .astype(np.int32))))[0]
    np.testing.assert_array_equal(w, wd)


def _golden_spectra_frames(adata, shader="fade", amount=0x0A0A0A):
    b, s, c = adata.shape
    prev = np.zeros((H, W, 4), np.uint8)
    outs = []
    for i in range(b):
        base = gv.shader_fade(prev, amount) if shader == "fade" \
            else np.zeros_like(prev)
        vd = gv.canvas(W, H)
        vd[:H * W] = base.reshape(H * W, 4).view("<u4").reshape(-1)
        mono = gf.spectrascope_mono_mix(adata[i], c) if c > 1 \
            else adata[i][:, 0]
        fdata = gf.fft_s16(gf.window_hamming(mono[:2 * W]))
        gf.spectrascope_render(vd, fdata, W, H)
        img = gv.crop(vd, W, H).view("<u4").reshape(H * W, 1)
        img = img.view(np.uint8).reshape(H, W, 4)
        outs.append(img)
        prev = img
    return np.stack(outs)


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_spectrascope_bitexact(rng, channels):
    adata = _audio(rng, channels)          # S = 128 = 2*W exactly
    want = _golden_spectra_frames(adata)
    got = _run_element_noprops("spectrascope", adata)
    np.testing.assert_array_equal(got, want)


def _run_element_noprops(name, adata, w=W, h=H, shader="fade"):
    el = gt.make(name, width=w, height=h, shader=shader)
    p = Pipeline([el])
    p.negotiate(MediaSpec(kind="audio", format=AudioFormat.S16, rate=44100,
                          channels=adata.shape[2]))
    outs = p.run(inputs=FrameBatch.make(jnp.asarray(adata)))
    return np.concatenate([np.asarray(o.data) for o in outs])


def _golden_synae_frames(adata, w, h, amount=0x0A0A0A):
    b = adata.shape[0]
    prev = np.zeros((h, w, 4), np.uint8)
    outs = []
    for i in range(b):
        base = gv.shader_fade(prev, amount)
        vd = gv.canvas(w, h)
        vd[:h * w] = base.reshape(h * w, 4).view("<u4").reshape(-1)
        n = 2 * h
        fl = gf.fft_s16(adata[i][:n, 0].astype(np.int16))
        fr = gf.fft_s16(adata[i][:n, 1].astype(np.int16))
        gf.synaescope_render(vd, fl, fr, w, h)
        img = vd[:h * w].reshape(h, w).copy().view("<u4")
        img = img.view(np.uint8).reshape(h, w, 4)
        outs.append(img)
        prev = img
    return np.stack(outs)


def test_synaescope_bitexact_border(rng):
    # H=32 < 2*sl: every star takes the bounds-checked border branch
    adata = _audio(rng, 2)
    want = _golden_synae_frames(adata, W, H)
    got = _run_element_noprops("synaescope", adata)
    np.testing.assert_array_equal(got, want)


def test_synaescope_bitexact_interior(rng):
    w = h = 96                             # interior (unchecked) branch
    adata = rng.integers(-32768, 32768, (2, 2 * h, 2), dtype=np.int16)
    want = _golden_synae_frames(adata, w, h)
    got = _run_element_noprops("synaescope", adata, w=w, h=h)
    np.testing.assert_array_equal(got, want)


def test_synaescope_silence_no_stars():
    # all-zero audio: the reference hits 0.0/0.0 NaN indexing (OOB
    # write); here silent bins draw nothing (documented fix)
    adata = np.zeros((2, S, 2), np.int16)
    got = _run_element_noprops("synaescope", adata)
    assert (got == 0).all()
