"""spandsp elements (ext/spandsp/): tonegeneratesrc, dtmfdetect,
spanplc — from-published-algorithm DSP (module doc has the libspandsp
divergence story); synthesized signals are the ground truth."""

import numpy as np
import jax.numpy as jnp
import pytest

import gstbad as gt
from gstbad.core.frame import FrameBatch
from gstbad.core.pipeline import Pipeline
from gstbad.core.spec import AudioFormat, MediaSpec

RATE = 8000


def _audio_spec():
    return MediaSpec(kind="audio", format=AudioFormat.S16, rate=RATE,
                     channels=1)


def test_tonegeneratesrc_amplitude_and_cadence():
    p = gt.parse_launch("tonegeneratesrc freq=440 volume=6 "
                        "samplesperbuffer=800 ! fakesink")
    outs = p.run(n_frames=4)
    a = np.concatenate([np.asarray(o.data)
                        for o in outs])[..., 0].reshape(-1)
    want = 32767 * 10 ** (-6 / 20)
    assert abs(a.max() - want) < want * 0.01
    # dual tone with cadence: 100 ms on / 100 ms off, no repeat
    p2 = gt.parse_launch(
        "tonegeneratesrc freq=350 freq2=440 on-time=100 off-time=100 "
        "samplesperbuffer=800 ! fakesink")
    outs2 = p2.run(n_frames=4)
    a2 = np.concatenate([np.asarray(o.data)
                         for o in outs2])[..., 0].reshape(-1)
    on = a2[:800]
    off = a2[900:1600]
    assert np.abs(on).max() > 30000          # two full-scale tones sum
    assert (off == 0).all()
    assert (a2[1600:] == 0).all()            # no repeat -> silence
    # repeat=true cycles the cadence
    p3 = gt.parse_launch(
        "tonegeneratesrc freq=350 on-time=100 off-time=100 repeat=true "
        "samplesperbuffer=800 ! fakesink")
    outs3 = p3.run(n_frames=4)
    a3 = np.concatenate([np.asarray(o.data)
                         for o in outs3])[..., 0].reshape(-1)
    assert np.abs(a3[1600:2400]).max() > 20000


def _dtmf_tone(row, col, n):
    t = np.arange(n) / RATE
    return (8000 * np.sin(2 * np.pi * row * t)
            + 8000 * np.sin(2 * np.pi * col * t)).astype(np.int16)


def test_dtmfdetect_digits_and_silence():
    # digit 5 = 770/1336; digit D = 941/1633 (event 15)
    sil = np.zeros(2000, np.int16)
    sig = np.concatenate([_dtmf_tone(770, 1336, 2000), sil,
                          _dtmf_tone(941, 1633, 2000), sil])
    frames = sig.reshape(4, 2000, 1)
    el = gt.make("dtmfdetect")
    p = Pipeline([el])
    p.negotiate(_audio_spec())
    p.run(inputs=FrameBatch.make(jnp.asarray(frames)))
    msgs = p.bus.pop(name="dtmf-event")
    events = [int(n) for m in msgs
              for n in np.asarray(m["number"]).tolist() if n >= 0]
    assert events == [5, 15]
    for m in msgs:
        assert (np.asarray(m["type"]) == 1).all()
        assert (np.asarray(m["method"]) == 2).all()
    # noise posts nothing
    rng = np.random.default_rng(0)
    noise = rng.integers(-2000, 2000, (2, 2000, 1)).astype(np.int16)
    el2 = gt.make("dtmfdetect")
    p2 = Pipeline([el2])
    p2.negotiate(_audio_spec())
    p2.run(inputs=FrameBatch.make(jnp.asarray(noise)))
    assert p2.bus.pop(name="dtmf-event") == []


def test_dtmfdetect_digit_held_posts_once():
    frames = _dtmf_tone(697, 1209, 8000).reshape(4, 2000, 1)  # '1'
    el = gt.make("dtmfdetect")
    p = Pipeline([el])
    p.negotiate(_audio_spec())
    p.run(inputs=FrameBatch.make(jnp.asarray(frames)))
    msgs = p.bus.pop(name="dtmf-event")
    events = [int(n) for m in msgs
              for n in np.asarray(m["number"]).tolist() if n >= 0]
    assert events == [1]


def test_spanplc_conceals_sine():
    t = np.arange(8000) / RATE
    sig = (10000 * np.sin(2 * np.pi * 200 * t)).astype(np.int16)
    frames = sig.reshape(4, 2000, 1)
    el = gt.make("spanplc")
    p = Pipeline([el])
    p.negotiate(_audio_spec())
    valid = jnp.asarray([True, True, False, True])
    outs = p.run(inputs=FrameBatch.make(jnp.asarray(frames),
                                        valid=valid))
    out = np.concatenate([np.asarray(o.data) for o in outs])[..., 0]
    assert out.shape[0] == 4                  # gap frame regenerated
    # the lead-in (10 ms, no attenuation) continues the sine closely
    lead = out[2][:80].astype(int)
    ref = frames[2, :80, 0].astype(int)
    assert np.abs(lead - ref).mean() < 800
    # attenuation silences a long gap tail
    assert np.abs(out[2][-200:]).max() < np.abs(ref).max() // 4
    # good frames pass through untouched
    np.testing.assert_array_equal(out[0], frames[0, :, 0])
    msgs = p.bus.pop(name="spanplc-stats")
    st = msgs[-1]
    assert int(np.asarray(st["num-gap"])) == 1
    assert int(np.asarray(st["num-pushed"])) == 4
    assert int(np.asarray(st["plc-num-samples"])) == 2000
    assert int(np.asarray(st["pitch"])) == 200


def test_spanplc_passthrough_when_no_gaps():
    rng = np.random.default_rng(1)
    frames = rng.integers(-5000, 5000, (3, 1600, 1)).astype(np.int16)
    el = gt.make("spanplc")
    p = Pipeline([el])
    p.negotiate(_audio_spec())
    outs = p.run(inputs=FrameBatch.make(jnp.asarray(frames)))
    out = np.concatenate([np.asarray(o.data) for o in outs])
    np.testing.assert_array_equal(out, frames)
