"""Fidelity: audio chain vs golden (mixmatrix exact, freeverb float32
faithful, VAD exact)."""

import numpy as np
import pytest

import gstbad as gt
from gstbad.core.harness import Harness
from gstbad.core.spec import AudioFormat, MediaSpec
from gstbad.golden import audio as golden


def _spec(fmt, ch, rate=48000):
    return MediaSpec(kind="audio", format=fmt, rate=rate, channels=ch)


MATRIX_4_2 = "<<1.0,0.0,0.5,0.0>,<0.0,1.0,0.0,0.5>>"
NP_MATRIX_4_2 = np.array([[1.0, 0.0, 0.5, 0.0], [0.0, 1.0, 0.0, 0.5]])


def test_mixmatrix_f32(rng):
    x = (rng.random((2, 64, 4)) - 0.5).astype(np.float32)
    h = Harness("audiomixmatrix", matrix=MATRIX_4_2)
    h.set_src_spec(_spec(AudioFormat.F32, 4))
    got = h.push_pull(x)
    for b in range(2):
        np.testing.assert_array_equal(
            got[b], golden.mixmatrix_f32(x[b], NP_MATRIX_4_2))


def test_mixmatrix_f64(rng):
    x = (rng.random((1, 32, 4)) - 0.5).astype(np.float64)
    h = Harness("audiomixmatrix", matrix=MATRIX_4_2)
    h.set_src_spec(_spec(AudioFormat.F64, 4))
    got = h.push_pull(x)
    np.testing.assert_allclose(
        got[0], golden.mixmatrix_f64(x[0], NP_MATRIX_4_2), rtol=0, atol=0)


def test_mixmatrix_s16(rng):
    x = rng.integers(-32768, 32768, (1, 128, 4)).astype(np.int16)
    h = Harness("audiomixmatrix", matrix=MATRIX_4_2)
    h.set_src_spec(_spec(AudioFormat.S16, 4))
    got = h.push_pull(x)
    np.testing.assert_array_equal(
        got[0], golden.mixmatrix_s16(x[0], NP_MATRIX_4_2))


def test_mixmatrix_s32(rng):
    x = rng.integers(-2**31, 2**31, (1, 64, 4)).astype(np.int32)
    h = Harness("audiomixmatrix", matrix=MATRIX_4_2)
    h.set_src_spec(_spec(AudioFormat.S32, 4))
    got = h.push_pull(x)
    np.testing.assert_array_equal(
        got[0], golden.mixmatrix_s32(x[0], NP_MATRIX_4_2))


def test_mixmatrix_first_channels(rng):
    x = rng.integers(-32768, 32768, (1, 16, 4)).astype(np.int16)
    h = Harness("audiomixmatrix", mode="first-channels",
                **{"out-channels": 2})
    h.set_src_spec(_spec(AudioFormat.S16, 4))
    got = h.push_pull(x)
    m = golden.mixmatrix_first_channels(4, 2)
    np.testing.assert_array_equal(got[0], golden.mixmatrix_s16(x[0], m))


def test_audiochannelmix(rng):
    x = rng.integers(-32768, 32768, (1, 100, 2)).astype(np.int16)
    props = {"left-to-left": 0.7, "left-to-right": 0.3,
             "right-to-left": -0.2, "right-to-right": 1.0}
    h = Harness("audiochannelmix", **props)
    h.set_src_spec(_spec(AudioFormat.S16, 2))
    got = h.push_pull(x)
    want = golden.audiochannelmix(x[0], 0.7, 0.3, -0.2, 1.0)
    # XLA fuses mul+add into FMA; at exact .5 half-boundaries rint can land
    # one LSB away from the non-fused C evaluation.  Within the 1e-3 gate.
    diff = np.abs(got[0].astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.05


@pytest.mark.parametrize("rate", [44100, 48000])
def test_freeverb_stereo_float(rng, rate):
    x = ((rng.random((1, 256, 2)) - 0.5) * 0.8).astype(np.float32)
    h = Harness("freeverb")
    h.set_src_spec(_spec(AudioFormat.F32, 2, rate))
    got = h.push_pull(x)[0]
    fv = golden.Freeverb(rate)
    want = fv.process_stereo_float(x[0])
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_freeverb_state_spans_windows(rng):
    x = ((rng.random((4, 128, 2)) - 0.5) * 0.8).astype(np.float32)
    h = Harness("freeverb")
    h.set_src_spec(_spec(AudioFormat.F32, 2, 44100))
    got1 = h.push_pull(x[:2])
    got2 = h.push_pull(x[2:])
    fv = golden.Freeverb(44100)
    want = fv.process_stereo_float(x.reshape(-1, 2))
    got = np.concatenate([got1.reshape(-1, 2), got2.reshape(-1, 2)])
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_freeverb_mono_s16(rng):
    x = rng.integers(-20000, 20000, (1, 200, 1)).astype(np.int16)
    h = Harness("freeverb")
    h.set_src_spec(_spec(AudioFormat.S16, 1, 44100))
    got = h.push_pull(x)[0]
    fv = golden.Freeverb(44100)
    want_f = fv.process_mono_float(x[0, :, 0].astype(np.float32))
    want = np.clip(np.trunc(want_f), -32768, 32767).astype(np.int16)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1  # float association differences at int boundaries


def test_vad_block_matches_golden(rng):
    from gstbad.ops import audio as ops
    import jax.numpy as jnp
    data = rng.integers(-30000, 30000, (1000,)).astype(np.int16)
    gold = golden.VAD(hysteresis=480, threshold_db=-60)
    st = ops.vad_init_state()
    for blk in np.split(data, 10):
        want_state = gold.update(blk)
        st, got_state = ops.vad_block(st, jnp.asarray(blk),
                                      jnp.int64(gold.threshold),
                                      jnp.int64(480))
        assert int(got_state) == want_state
        assert int(st["power"]) == gold.power


def test_removesilence_drops_silence():
    rate = 48000
    n_blocks, s = 12, 480
    loud = (np.sin(np.arange(s) * 0.5) * 20000).astype(np.int16)
    quiet = np.zeros(s, np.int16)
    blocks = [loud] * 4 + [quiet] * 4 + [loud] * 4
    x = np.stack(blocks)[:, :, None]
    h = Harness("removesilence", remove=True, silent=False)
    h.set_src_spec(_spec(AudioFormat.S16, 1, rate))
    outs = h.push(x)
    kept = sum(o.batch for o in outs)
    assert kept < n_blocks  # silent region dropped
    msgs = h.bus.pop(element="removesilence")
    assert any(m["silence_detected"] for m in msgs)
    assert any(m["silence_finished"] for m in msgs)


def test_audiobuffersplit(rng):
    x = (rng.random((3, 100, 2)) - 0.5).astype(np.float32)
    h = Harness("audiobuffersplit", **{"output-buffer-duration": "1/600"})
    # 48000/600 = 80-sample output blocks from 100-sample inputs
    h.set_src_spec(_spec(AudioFormat.F32, 2))
    outs = h.push(x)
    got = np.concatenate([np.asarray(o.data) for o in outs]).reshape(-1, 2)
    want = x.reshape(-1, 2)
    np.testing.assert_array_equal(got[:len(want) // 80 * 80],
                                  want[:len(want) // 80 * 80])
    assert all(o.data.shape[1] == 80 for o in outs)


def test_audiobuffersplit_pts():
    h = Harness("audiobuffersplit", **{"output-buffer-duration": "1/100"})
    h.set_src_spec(_spec(AudioFormat.F32, 1))
    x = np.zeros((4, 480, 1), np.float32)
    outs = h.push(x)
    pts = np.concatenate([np.asarray(o.pts) for o in outs])
    assert pts[0] == 0
    assert np.all(np.diff(pts) == int(1e9 / 100))


def test_videoframe_audiolevel(rng):
    x = ((rng.random((2, 1600, 2)) - 0.5)).astype(np.float32)
    h = Harness("videoframe-audiolevel")
    h.set_src_spec(_spec(AudioFormat.F32, 2))
    h.push(x)
    msgs = h.bus.pop(element="videoframe-audiolevel")
    assert len(msgs) == 2
    want = np.sqrt((x[0].astype(np.float64) ** 2).mean(axis=0))
    np.testing.assert_allclose(msgs[0]["rms"], want, atol=1e-9)


def test_audio_pipeline_end_to_end():
    p = gt.parse_launch(
        "audiotestsrc wave=sine channels=4 format=F32 samplesperbuffer=256 "
        f"! audiomixmatrix matrix={MATRIX_4_2!r} "
        "! freeverb ! fakesink")
    outs = p.run(n_frames=2, window=2)
    assert outs[0].data.shape == (2, 256, 2)


def test_videoframe_audiolevel_av_sync(rng):
    """2-input A/V form: audio binned to video frames by PTS."""
    p = gt.parse_launch(
        "videotestsrc pattern=black width=16 height=16 framerate=25/1 "
        "! lvl. "
        "audiotestsrc wave=sine channels=2 rate=48000 samplesperbuffer=1920 "
        "! lvl. "
        "videoframe-audiolevel name=lvl ! fakesink")
    spec = p.negotiate()
    assert spec.kind == "video"
    # 1920 samples @48k = 40ms = one 25fps video frame per audio block
    p.run(n_frames=4, window=4)
    msgs = p.bus.pop(element="videoframe-audiolevel")
    assert len(msgs) == 4
    # full-scale 0.8 sine RMS ~ 0.566
    assert msgs[1]["rms"][0] == pytest.approx(0.8 / np.sqrt(2), rel=0.05)


# ---------------------------------------------------------------------------
# bs2b crossfeed
# ---------------------------------------------------------------------------


def test_bs2b_float_matches_golden(rng):
    x = ((rng.random((2, 256, 2)) - 0.5) * 1.6).astype(np.float32)
    h = Harness("bs2b")
    h.set_src_spec(_spec(AudioFormat.F32, 2, 44100))
    got = h.push_pull(x)
    g = golden.Bs2b(rate=44100)
    want = g.process_float(x.reshape(-1, 2).astype(np.float64))
    want = np.clip(want, -1.0, 1.0).astype(np.float32).reshape(2, 256, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)


def test_bs2b_state_spans_windows(rng):
    x = ((rng.random((4, 64, 2)) - 0.5)).astype(np.float64)
    h = Harness("bs2b", fcut=900, feed=80)
    h.set_src_spec(_spec(AudioFormat.F64, 2, 48000))
    got_a = h.push_pull(x[:2])
    got_b = h.push_pull(x[2:])
    g = golden.Bs2b(rate=48000, fcut=900, feed=80)
    want = g.process_float(x.reshape(-1, 2))
    want = np.clip(want, -1.0, 1.0).reshape(4, 64, 2)
    np.testing.assert_allclose(
        np.concatenate([got_a, got_b]), want, rtol=0, atol=1e-12)


def test_bs2b_s16_clips_and_truncates(rng):
    x = rng.integers(-32768, 32768, (1, 512, 2)).astype(np.int16)
    h = Harness("bs2b")
    h.set_src_spec(_spec(AudioFormat.S16, 2, 44100))
    got = h.push_pull(x)
    g = golden.Bs2b(rate=44100)
    want = g.process_s16(x.reshape(-1, 2)).reshape(1, 512, 2)
    assert got.dtype == np.int16
    # scan reassociation can flip the final truncation by 1 LSB
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_bs2b_presets_and_mono_passthrough(rng):
    xs = ((rng.random((1, 128, 2)) - 0.5)).astype(np.float64)
    outs = {}
    for preset in ("default", "cmoy", "jmeier"):
        h = Harness("bs2b", preset=preset)
        h.set_src_spec(_spec(AudioFormat.F64, 2, 44100))
        outs[preset] = h.push_pull(xs)
        fcut, feed = golden.BS2B_PRESETS[preset]
        g = golden.Bs2b(rate=44100, fcut=fcut, feed=feed)
        want = np.clip(g.process_float(xs.reshape(-1, 2)), -1, 1)
        np.testing.assert_allclose(outs[preset].reshape(-1, 2), want,
                                   rtol=0, atol=1e-12)
    assert not np.allclose(outs["default"], outs["jmeier"])

    mono = ((rng.random((1, 64, 1)) - 0.5)).astype(np.float32)
    h = Harness("bs2b")
    h.set_src_spec(_spec(AudioFormat.F32, 1, 44100))
    np.testing.assert_array_equal(h.push_pull(mono), mono)


# ---------------------------------------------------------------------------
# webrtcdsp / webrtcechoprobe
# ---------------------------------------------------------------------------


def _sine(rate, n, freq, amp, dc=0.0, noise=0.0, rng=None, ch=1):
    t = np.arange(n) / rate
    x = amp * np.sin(2 * np.pi * freq * t) + dc
    if noise and rng is not None:
        x = x + noise * rng.standard_normal(n)
    return np.clip(x, -32768, 32767).astype(np.int16).reshape(1, n, ch)


def _band_db(x, rate, lo, hi):
    spec = np.abs(np.fft.rfft(x.astype(np.float64).ravel() / 32768.0))
    freqs = np.fft.rfftfreq(x.size, 1 / rate)
    sel = (freqs >= lo) & (freqs < hi)
    return 20 * np.log10(np.sqrt(np.mean(spec[sel] ** 2)) + 1e-12)


def test_webrtcdsp_highpass_kills_dc(rng):
    rate = 16000
    x = _sine(rate, 3200, 440, 8000, dc=3000)
    h = Harness("webrtcdsp", **{"noise-suppression": False,
                                "gain-control": False,
                                "echo-cancel": False})
    h.set_src_spec(_spec(AudioFormat.S16, 1, rate))
    got = h.push_pull(x)
    assert abs(got[:, 200:].mean()) < 100  # DC gone after settle
    # 440 Hz survives
    assert _band_db(got[:, 200:], rate, 400, 500) > \
        _band_db(x[:, 200:], rate, 400, 500) - 3


def test_webrtcdsp_noise_suppression_improves_snr(rng):
    rate = 16000
    n = 16 * 160  # 16 x 10ms frames
    # noise-only lead-in (the floor estimate bootstraps from it, like the
    # APM adapting during speech pauses), then tone + noise
    lead = np.clip(600 * rng.standard_normal(n), -32768, 32767
                   ).astype(np.int16).reshape(1, n, 1)
    x = _sine(rate, n, 440, 9000, noise=600, rng=rng)
    h = Harness("webrtcdsp", **{"high-pass-filter": False,
                                "gain-control": False,
                                "echo-cancel": False,
                                "noise-suppression-level": "very-high"})
    h.set_src_spec(_spec(AudioFormat.S16, 1, rate))
    h.push_pull(lead)
    got = h.push_pull(x)
    tail = slice(n // 4, None)
    noise_in = _band_db(x[:, tail], rate, 2000, 7000)
    noise_out = _band_db(got[:, tail], rate, 2000, 7000)
    sig_in = _band_db(x[:, tail], rate, 400, 500)
    sig_out = _band_db(got[:, tail], rate, 400, 500)
    assert noise_in - noise_out > 6.0       # noise floor dropped
    assert sig_in - sig_out < 3.0           # tone kept


def test_webrtcdsp_agc_modes(rng):
    rate = 16000
    quiet = _sine(rate, 3200, 440, 800)     # ~ -32 dBFS
    # fixed-digital: flat compression-gain-db
    h = Harness("webrtcdsp", **{"high-pass-filter": False,
                                "noise-suppression": False,
                                "echo-cancel": False,
                                "gain-control-mode": "fixed-digital",
                                "compression-gain-db": 12})
    h.set_src_spec(_spec(AudioFormat.S16, 1, rate))
    got = h.push_pull(quiet)
    gain_db = (20 * np.log10(np.abs(got.astype(np.float64)).max()
                             / np.abs(quiet).max()))
    assert 10.0 < gain_db < 13.0
    # adaptive: gain ramps toward target across windows, never above cap
    h2 = Harness("webrtcdsp", **{"high-pass-filter": False,
                                 "noise-suppression": False,
                                 "echo-cancel": False,
                                 "compression-gain-db": 30,
                                 "target-level-dbfs": 3})
    h2.set_src_spec(_spec(AudioFormat.S16, 1, rate))
    peaks = []
    for _ in range(6):
        out = h2.push_pull(quiet)
        peaks.append(np.abs(out.astype(np.float64)).max())
    assert peaks[-1] > peaks[0] * 2          # ramped up
    assert peaks[-1] <= np.abs(quiet).max() * 10 ** (30 / 20) + 1


def test_webrtcdsp_voice_detection_messages(rng):
    rate = 16000
    talk = _sine(rate, 1600, 300, 12000)
    hush = np.zeros((1, 1600, 1), np.int16)
    x = np.concatenate([hush, talk, talk, hush], axis=0)
    h = Harness("webrtcdsp", **{"voice-detection": True,
                                "high-pass-filter": False,
                                "noise-suppression": False,
                                "gain-control": False,
                                "echo-cancel": False})
    h.set_src_spec(_spec(AudioFormat.S16, 1, rate))
    h.push(x)
    msgs = h.bus.pop(name="voice-activity")
    states = [m.fields["stream-has-voice"] for m in msgs]
    assert states and states[0] in (True, 1)   # silence -> voice edge
    assert any(not bool(v) for v in states)    # voice -> silence edge


def test_webrtcdsp_echo_probe_suppression(rng):
    """Echo cancellation via the 2-input graph form: the far-end branch
    routes through webrtcechoprobe into the DSP's second input."""
    rate = 16000
    n = 3200
    far = _sine(rate, n, 1000, 12000)
    kw = ("high-pass-filter=false noise-suppression=false "
          "gain-control=false")
    # without a probe input: echo-cancel warns and passes through
    h0 = Harness("webrtcdsp", **{"high-pass-filter": False,
                                 "noise-suppression": False,
                                 "gain-control": False})
    h0.set_src_spec(_spec(AudioFormat.S16, 1, rate))
    ref = h0.push_pull(far)
    # 2-input pipeline: near-end (the echo) + probe fed the same signal
    p = gt.parse_launch(
        "appsrc name=near kind=audio format=S16 rate=16000 channels=1 "
        "! dsp.  "
        "appsrc name=farsrc kind=audio format=S16 rate=16000 channels=1 "
        "! webrtcechoprobe ! dsp.  "
        f"webrtcdsp name=dsp {kw} echo-suppression-level=high ! fakesink")
    p.negotiate()
    p.get_by_name("near").push_frames(far)
    p.get_by_name("farsrc").push_frames(far)
    outs = p.run(window=1)
    got = np.concatenate([np.asarray(o.data) for o in outs])
    assert (_band_db(ref[:, 400:], rate, 900, 1100)
            - _band_db(got[:, 400:], rate, 900, 1100)) > 10.0
    # silent probe: the AEC releases once the far FIFO drains (the
    # extended filter holds 16 blocks = 160 ms of far history — a real
    # echo-path hangover, unlike the old instant spectral subtraction);
    # after one drain window, the next window must pass through clean
    hush = np.zeros_like(far)
    p.get_by_name("near").push_frames(far)
    p.get_by_name("farsrc").push_frames(hush)
    p.run(window=1)                      # drain window (release transient)
    p.get_by_name("near").push_frames(far)
    p.get_by_name("farsrc").push_frames(hush)
    outs2 = p.run(window=1)
    got2 = np.concatenate([np.asarray(o.data) for o in outs2])
    assert (_band_db(ref[:, 400:], rate, 900, 1100)
            - _band_db(got2[:, 400:], rate, 900, 1100)) < 2.0


def test_webrtcdsp_aec_converges_on_real_echo_path(rng):
    """The PBFDAF linear stage actually IDENTIFIES the echo path (delayed
    + decaying taps), not just suppresses: ERLE on the second half of a
    1 s white-noise run must exceed 15 dB with the NLP bypassed
    (ops/audio.aec_cancel overdrive=0)."""
    from gstbad.ops import audio as ops
    import jax.numpy as jnp
    frame = 160
    N = frame * 100
    h = np.zeros(400)
    h[80], h[130], h[260] = 0.7, -0.3, 0.15
    far = (6000 * rng.standard_normal(N)).astype(np.float32)
    echo = np.convolve(far, h)[:N].astype(np.float32)
    st = ops.aec_init(frame, 1, 8)
    out, st1 = ops.aec_cancel(jnp.asarray(echo[:, None]),
                              jnp.asarray(far[:, None]), st, overdrive=0.0)
    out = np.asarray(out)[:, 0]
    seg = slice(N // 2, N)
    erle = 10 * np.log10(np.sum(echo[seg] ** 2)
                         / (np.sum(out[seg] ** 2) + 1e-9))
    assert erle > 15.0
    # streaming continuity: split run == whole run, exactly
    outa, sta = ops.aec_cancel(jnp.asarray(echo[:N // 2, None]),
                               jnp.asarray(far[:N // 2, None]), st,
                               overdrive=2.0)
    outb, _ = ops.aec_cancel(jnp.asarray(echo[N // 2:, None]),
                             jnp.asarray(far[N // 2:, None]), sta,
                             overdrive=2.0)
    whole, _ = ops.aec_cancel(jnp.asarray(echo[:, None]),
                              jnp.asarray(far[:, None]), st, overdrive=2.0)
    two = np.concatenate([np.asarray(outa), np.asarray(outb)])
    assert np.abs(two - np.asarray(whole)).max() == 0.0


def test_webrtcdsp_aec_double_talk_keeps_near_speech(rng):
    """Coherence NLP: with a converged filter, near-end speech during
    far-end activity survives within 3 dB while the echo stays
    cancelled (the double-talk property the reference trades off via
    echo-suppression-level)."""
    from gstbad.ops import audio as ops
    import jax.numpy as jnp
    rate, frame = 16000, 160
    N = frame * 100
    h = np.zeros(400)
    h[80], h[130] = 0.7, -0.3
    far = (6000 * rng.standard_normal(N)).astype(np.float32)
    echo = np.convolve(far, h)[:N].astype(np.float32)
    st = ops.aec_init(frame, 1, 8)
    _, st1 = ops.aec_cancel(jnp.asarray(echo[:, None]),
                            jnp.asarray(far[:, None]), st, overdrive=2.0)
    t = np.arange(N) / rate
    speech = (8000 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    near = echo + speech
    seg = slice(N // 2, N)

    def speech_loss(overdrive):
        out, _ = ops.aec_cancel(jnp.asarray(near[:, None]),
                                jnp.asarray(far[:, None]), st1,
                                overdrive=overdrive)
        out = np.asarray(out)[:, 0]
        return (_band_db(near[seg].astype(np.int16).reshape(1, -1, 1),
                         rate, 400, 500)
                - _band_db(out[seg].astype(np.int16).reshape(1, -1, 1),
                           rate, 400, 500))

    lo, hi = speech_loss(1.0), speech_loss(4.0)
    assert lo < 3.0            # low suppression keeps near speech
    # "A higher level trades off double-talk performance for increased
    # echo suppression" (gstwebrtcdsp.cpp:1009-1011)
    assert hi > lo


# ---------------------------------------------------------------------------
# pitch (ext/soundtouch)
# ---------------------------------------------------------------------------


def _dom_freq(sig, rate):
    sig = np.asarray(sig).ravel()
    spec = np.abs(np.fft.rfft(sig * np.hanning(sig.size)))
    return np.fft.rfftfreq(sig.size, 1 / rate)[np.argmax(spec)]


@pytest.mark.parametrize("kw,exp_len,exp_f", [
    ({"pitch": 2.0}, 4096, 880.0),   # octave up, duration kept
    ({"tempo": 2.0}, 2048, 440.0),   # half duration, pitch kept
    ({"rate": 2.0}, 2048, 880.0),    # resample: both change
    ({"pitch": 0.5}, 4096, 220.0),   # octave down
])
def test_pitch_semantics(kw, exp_len, exp_f):
    rate = 48000
    t = np.arange(4 * 1024) / rate
    x = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32
                                                   ).reshape(4, 1024, 1)
    h = Harness("pitch", **kw)
    h.set_src_spec(_spec(AudioFormat.F32, 1, rate))
    outs = h.push(x)
    y = np.concatenate([np.asarray(o.data) for o in outs], axis=1)
    assert abs(y.shape[1] - exp_len) <= 64  # hop quantization
    f = _dom_freq(y[0, y.shape[1] // 2:], rate)
    assert abs(f - exp_f) < 0.06 * exp_f    # within vocoder accuracy
    # amplitude roughly preserved (OLA normalization correct)
    assert 0.3 < np.abs(y[0, y.shape[1] // 2:]).max() < 0.75


def test_pitch_identity_and_state_continuity():
    rate = 48000
    t = np.arange(8 * 1024) / rate
    x = (0.5 * np.sin(2 * np.pi * 1000 * t)).astype(np.float32
                                                    ).reshape(8, 1024, 1)
    h = Harness("pitch")  # all factors 1.0
    h.set_src_spec(_spec(AudioFormat.F32, 1, rate))
    y1 = np.concatenate([np.asarray(o.data)
                         for o in h.push(x[:4])], axis=1)
    y2 = np.concatenate([np.asarray(o.data)
                         for o in h.push(x[4:])], axis=1)
    y = np.concatenate([y1, y2], axis=1)[0]
    assert y.shape[0] == 8 * 1024
    # steady state reproduces the tone without window-boundary glitches
    tail = y[2048:]
    assert abs(_dom_freq(tail, rate) - 1000.0) < 25
    rms = np.sqrt(np.mean(tail ** 2))
    assert 0.3 < rms < 0.4  # 0.5/sqrt(2) ~ 0.354


def test_bpmdetect_click_track():
    rate = 48000
    for want_bpm in (120.0, 90.0):
        period = int(rate * 60 / want_bpm)
        n = rate * 10
        sig = np.zeros(n, np.float32)
        for i in range(0, n - 200, period):
            sig[i:i + 200] = 0.9 * np.sin(np.arange(200) * 0.5)
        x = sig.reshape(-1, 4800, 1)
        h = Harness("bpmdetect")
        h.set_src_spec(_spec(AudioFormat.F32, 1, rate))
        for i in range(0, x.shape[0], 2):
            h.push(x[i:i + 2])
        msgs = h.bus.pop(name="bpm")
        assert msgs, f"no bpm message for {want_bpm}"
        got = float(msgs[-1].fields["bpm"])
        assert abs(got - want_bpm) <= 2.0


def test_audiolatency_tick_roundtrip():
    """gstaudiolatency.c: 1 Hz ticks, |x|>0.7 detection, ring-of-5
    average, "latency" message in microseconds."""
    rate = 48000
    n = rate * 3
    sig = np.zeros((n,), np.float32)
    for sec in range(3):  # loopback echo arriving 37 ms after each second
        start = sec * rate + int(0.037 * rate)
        tt = np.arange(480) / rate
        sig[start:start + 480] = 0.8 * np.sin(2 * np.pi * 440 * tt)
    x = sig.reshape(-1, 4800, 1)
    pts = np.arange(x.shape[0], dtype=np.int64) * (4800 * 10**9 // rate)
    h = Harness("audiolatency")
    h.set_src_spec(_spec(AudioFormat.F32, 1, rate))
    outs = h.push(x, pts=pts)
    msgs = h.bus.pop(name="latency")
    lats = [int(m.fields["last-latency"]) for m in msgs]
    assert len(lats) == 3
    for lat in lats:
        assert abs(lat - 37000) < 1500  # ~37 ms in us
    assert abs(int(msgs[-1].fields["average-latency"]) - 37000) < 1500
    # output carries the generated tick train at each second boundary
    y = np.concatenate([np.asarray(o.data) for o in outs], axis=1).ravel()
    burst = np.where(np.abs(y) > 0.7)[0]
    assert burst.size and burst[0] < 480
    assert np.any((burst >= rate) & (burst < rate + 480))


def test_audiobuffersplit_discont_resync():
    """GstAudioStreamAlign semantics: drift past alignment-threshold
    sustained for discont-wait resyncs output PTS and flags DISCONT."""
    from gstbad.core.frame import FLAG_DISCONT
    h = Harness("audiobuffersplit",
                **{"output-buffer-duration": "1/100",
                   "alignment-threshold": 40_000_000,
                   "discont-wait": 0})
    h.set_src_spec(_spec(AudioFormat.F32, 1))
    x = np.zeros((2, 480, 1), np.float32)
    dur = 480 * 10**9 // 48000
    # aligned window, then a window 5 s ahead (sustained gap)
    outs1 = h.push(x, pts=np.array([0, dur]))
    pts_jump = 5 * 10**9
    outs2 = h.push(x, pts=np.array([pts_jump, pts_jump + dur]))
    p1 = np.concatenate([np.asarray(o.pts) for o in outs1])
    p2 = np.concatenate([np.asarray(o.pts) for o in outs2])
    f2 = np.concatenate([np.asarray(o.flags) for o in outs2])
    assert p1[0] == 0
    assert p2[0] == pts_jump          # resynced to the input timeline
    assert f2[0] & FLAG_DISCONT
    # small drift below threshold: no resync
    h2 = Harness("audiobuffersplit", **{"output-buffer-duration": "1/100"})
    h2.set_src_spec(_spec(AudioFormat.F32, 1))
    h2.push(x, pts=np.array([0, dur]))
    outs = h2.push(x, pts=np.array([2 * dur + 1_000_000,
                                    3 * dur + 1_000_000]))
    pts = np.concatenate([np.asarray(o.pts) for o in outs])
    assert pts[0] == 2 * dur          # continuous timeline kept


# ---------------------------------------------------------------------------
# adpcmdec (gst/adpcmdec/)
# ---------------------------------------------------------------------------


def _ima_block(rng, channels, groups=8):
    hdr = b""
    for c in range(channels):
        s0 = int(rng.integers(-2000, 2000))
        hdr += int(s0 & 0xFFFF).to_bytes(2, "little") \
            + bytes([int(rng.integers(0, 89)), 0])
    return hdr + rng.integers(0, 256, groups * 4 * channels,
                              dtype=np.uint8).tobytes()


def _ms_block(rng, channels, nbytes=32):
    hdr = bytes(int(rng.integers(0, 7)) for _ in range(channels))
    for _ in range(channels):  # ideltas
        hdr += int(rng.integers(16, 4000)).to_bytes(2, "little")
    for _ in range(2 * channels):  # two initial samples per channel
        hdr += int(int(rng.integers(-3000, 3000)) & 0xFFFF).to_bytes(
            2, "little")
    return hdr + rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("channels", [1, 2])
def test_adpcmdec_dvi_matches_golden(rng, channels):
    blocks = [_ima_block(rng, channels) for _ in range(4)]
    bs = len(blocks[0])
    p = gt.parse_launch(
        f"adpcmdec layout=dvi blocksize={bs} rate=22050 "
        f"channels={channels} ! fakesink")
    p.elements[0].push_bytes(b"".join(blocks))
    outs = p.run(window=4)
    got = np.concatenate([np.asarray(o.data) for o in outs])
    for i, blk in enumerate(blocks):
        want = golden.adpcm_decode_ima_block(
            np.frombuffer(blk, np.uint8), channels
        ).reshape(-1, channels)
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("channels", [1, 2])
def test_adpcmdec_microsoft_matches_golden(rng, channels):
    blocks = [_ms_block(rng, channels) for _ in range(4)]
    bs = len(blocks[0])
    p = gt.parse_launch(
        f"adpcmdec layout=microsoft blocksize={bs} rate=44100 "
        f"channels={channels} ! fakesink")
    p.elements[0].push_bytes(b"".join(blocks))
    outs = p.run(window=4)
    got = np.concatenate([np.asarray(o.data) for o in outs])
    for i, blk in enumerate(blocks):
        want = golden.adpcm_decode_ms_block(
            np.frombuffer(blk, np.uint8), channels
        ).reshape(-1, channels)
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("channels", [1, 2])
def test_adpcmenc_matches_golden_and_roundtrips(rng, channels):
    groups = 8
    n = 1 + 8 * groups
    bs = 4 * channels + groups * 4 * channels
    t = np.arange(3 * n)
    sig = np.stack([(3000 * np.sin(t * 0.05 * (c + 1)))
                    for c in range(channels)], 1).astype(np.int16)
    x = sig.reshape(3, n, channels)
    h = Harness("adpcmenc", blocksize=bs)
    h.set_src_spec(_spec(AudioFormat.S16, channels, 22050))
    got = h.push_pull(x)
    enc = golden.AdpcmEncIma(channels)
    for i in range(3):
        want = enc.encode_block(x[i], bs)
        assert np.asarray(got[i]).tobytes() == want
    # enc -> dec roundtrip approximates the input once the step adapts
    p = gt.parse_launch(
        f"adpcmdec layout=dvi blocksize={bs} rate=22050 "
        f"channels={channels} ! fakesink")
    p.elements[0].push_bytes(b"".join(np.asarray(g).tobytes()
                                      for g in got))
    outs = p.run(window=3)
    dec = np.concatenate([np.asarray(o.data) for o in outs]
                         ).reshape(-1, channels)
    tail = slice(n, None)  # skip the adaptation ramp
    err = np.abs(dec[tail].astype(int) - sig[tail].astype(int))
    assert err.mean() < 200  # lossy 4-bit codec, but tracking


@pytest.mark.parametrize("damping", [0.65, 0.8])
def test_freeverb_fused_damp_branches(rng, damping):
    """The fused comb walk solves the triangular filterstore system as a
    banded FIR when damp1 <= _FIR_DAMP_MAX and as the power-matrix matmul
    above it (ops/audio.py r5); both must track the serial C oracle at any
    damping."""
    x = ((rng.random((1, 4096, 2)) - 0.5) * 0.8).astype(np.float32)
    h = Harness("freeverb", damping=damping)
    h.set_src_spec(_spec(AudioFormat.F32, 2, 44100))
    got = h.push_pull(x)[0]
    fv = golden.Freeverb(44100, damping=damping)
    want = fv.process_stereo_float(x[0])
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_freeverb_past_ring_wrap(rng):
    """Regression: ring reads must wrap at each line's own delay length,
    not the bank-padded buffer (caught diverging after the shortest comb
    delay, 1116 samples)."""
    x = ((rng.random((1, 4096, 2)) - 0.5) * 0.8).astype(np.float32)
    h = Harness("freeverb")
    h.set_src_spec(_spec(AudioFormat.F32, 2, 44100))
    got = h.push_pull(x)[0]
    fv = golden.Freeverb(44100)
    want = fv.process_stereo_float(x[0])
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_audiobuffersplit_resync_after_discont_wait():
    """Regression: a sustained PTS jump must trigger resync once
    discont-wait elapses (the expected timeline must not self-heal)."""
    from gstbad.core.frame import FLAG_DISCONT
    h = Harness("audiobuffersplit",
                **{"output-buffer-duration": "1/100",
                   "discont-wait": 25_000_000})  # 25 ms
    h.set_src_spec(_spec(AudioFormat.F32, 1))
    x = np.zeros((2, 480, 1), np.float32)
    dur = 480 * 10**9 // 48000  # 10 ms
    h.push(x, pts=np.array([0, dur]))
    jump = 5 * 10**9
    flags_seen = []
    pts_first = []
    for w in range(4):  # sustained jumped timeline, 20 ms per window
        base = jump + (2 + 2 * w) * dur
        outs = h.push(x, pts=np.array([base, base + dur]))
        flags_seen += [np.asarray(o.flags) for o in outs]
        pts_first += [np.asarray(o.pts)[0] for o in outs]
    flags = np.concatenate(flags_seen)
    assert (flags & FLAG_DISCONT).any()   # resync fired
    assert pts_first[-1] >= jump          # output timeline re-anchored


def test_adpcmdec_stereo_pts_per_channel(rng):
    """Regression: stereo block duration counts per-channel samples."""
    blocks = [_ima_block(rng, 2) for _ in range(2)]
    bs = len(blocks[0])
    p = gt.parse_launch(
        f"adpcmdec layout=dvi blocksize={bs} rate=22050 channels=2 "
        "! fakesink")
    p.elements[0].push_bytes(b"".join(blocks))
    outs = p.run(window=2)
    pts = np.concatenate([np.asarray(o.pts) for o in outs])
    per_ch = outs[0].data.shape[1]  # samples per channel per block
    assert pts[1] - pts[0] == per_ch * 10**9 // 22050


def test_audiobuffersplit_gapless_silence_fill():
    """gapless=true: a forward PTS gap within max-silence-time is filled
    with silence and the output timeline stays continuous, no DISCONT
    (gstaudiobuffersplit.c:543-610)."""
    from gstbad.core.frame import FLAG_DISCONT
    h = Harness("audiobuffersplit",
                **{"output-buffer-duration": "1/100",
                   "gapless": True,
                   "max-silence-time": 200_000_000})
    h.set_src_spec(_spec(AudioFormat.F32, 1))
    x = np.full((2, 480, 1), 0.5, np.float32)
    dur = 480 * 10**9 // 48000  # 10 ms
    h.push(x, pts=np.array([0, dur]))
    # next window arrives 100 ms late -> 4800 samples of silence
    base = 12 * dur
    outs = h.push(x, pts=np.array([base, base + dur]))
    data = np.concatenate([np.asarray(o.data) for o in outs]).reshape(-1)
    pts = np.concatenate([np.asarray(o.pts) for o in outs])
    flags = np.concatenate([np.asarray(o.flags) for o in outs])
    assert len(data) == 4800 + 960            # silence + this window's data
    np.testing.assert_array_equal(data[:4800], 0.0)
    np.testing.assert_array_equal(data[4800:], 0.5)
    assert pts[0] == 2 * dur                  # continuous, no resync
    assert np.all(np.diff(pts) == dur)
    assert not (flags & FLAG_DISCONT).any()


def test_audiobuffersplit_gapless_too_big_gap_resyncs():
    """gapless=true but gap > max-silence-time: falls through to the
    discont path like the reference (gstaudiobuffersplit.c:574-580)."""
    from gstbad.core.frame import FLAG_DISCONT
    h = Harness("audiobuffersplit",
                **{"output-buffer-duration": "1/100",
                   "gapless": True,
                   "max-silence-time": 50_000_000,
                   "discont-wait": 0})
    h.set_src_spec(_spec(AudioFormat.F32, 1))
    x = np.full((2, 480, 1), 0.5, np.float32)
    dur = 480 * 10**9 // 48000
    h.push(x, pts=np.array([0, dur]))
    base = 5 * 10**9  # 5 s gap >> 50 ms budget
    outs = h.push(x, pts=np.array([base, base + dur]))
    pts = np.concatenate([np.asarray(o.pts) for o in outs])
    flags = np.concatenate([np.asarray(o.flags) for o in outs])
    assert pts[0] == base                     # resynced
    assert (flags & FLAG_DISCONT).any()


def test_audiobuffersplit_gapless_drop_overlap():
    """gapless=true: a backward PTS jump (overlap) drops the overlapping
    samples from the front of the input instead of resyncing
    (gstaudiobuffersplit.c:610-618, clip_buffer_start_for_gapless)."""
    from gstbad.core.frame import FLAG_DISCONT
    h = Harness("audiobuffersplit",
                **{"output-buffer-duration": "1/100", "gapless": True,
                   "alignment-threshold": 5_000_000})
    h.set_src_spec(_spec(AudioFormat.F32, 1))
    dur = 480 * 10**9 // 48000
    x1 = np.full((2, 480, 1), 0.25, np.float32)
    h.push(x1, pts=np.array([0, dur]))
    # next window overlaps by one buffer (10 ms = 480 samples)
    x2 = np.concatenate([np.full((1, 480, 1), 0.75, np.float32),
                         np.full((1, 480, 1), 1.0, np.float32)])
    outs = h.push(x2, pts=np.array([dur, 2 * dur]))
    data = np.concatenate([np.asarray(o.data) for o in outs]).reshape(-1)
    pts = np.concatenate([np.asarray(o.pts) for o in outs])
    flags = np.concatenate([np.asarray(o.flags) for o in outs])
    assert len(data) == 480                   # one buffer's worth dropped
    np.testing.assert_array_equal(data, 1.0)  # the overlapping 0.75 went
    assert pts[0] == 2 * dur
    assert not (flags & FLAG_DISCONT).any()


def test_chromaprint_fingerprint(rng):
    """chromaprint surface (ext/chromaprint/gstchromaprint.c): S16
    passthrough, fingerprint posted as a tag message at the duration cap
    or EOS; deterministic and robust to small perturbations (the exact
    Acoustid bit patterns live in libchromaprint - documented)."""
    t = np.arange(48000 * 4) / 48000.0
    sig = (0.5 * np.sin(2 * np.pi * 440 * t)
           + 0.3 * np.sin(2 * np.pi * 660 * (t + 0.2 * t * t))
           ).astype(np.float32)
    x = sig.reshape(4, -1, 1)
    h = Harness("chromaprint", duration=3)
    h.set_src_spec(_spec(AudioFormat.F32, 1))
    outs = h.push(x)
    # passthrough
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(o.data) for o in outs]), x)
    msgs = h.bus.pop(element="chromaprint")
    assert msgs and msgs[0]["chromaprint-fingerprint"]
    fp1 = msgs[0]["chromaprint-fingerprint"]
    # deterministic
    h2 = Harness("chromaprint", duration=3)
    h2.set_src_spec(_spec(AudioFormat.F32, 1))
    h2.push(x)
    assert h2.bus.pop(element="chromaprint")[0][
        "chromaprint-fingerprint"] == fp1
    # robust to tiny noise
    h3 = Harness("chromaprint", duration=3)
    h3.set_src_spec(_spec(AudioFormat.F32, 1))
    h3.push(x + 1e-4 * np.random.default_rng(0)
            .standard_normal(x.shape).astype(np.float32))
    fp3 = h3.bus.pop(element="chromaprint")[0]["chromaprint-fingerprint"]
    same = sum(a == b for a, b in zip(fp1, fp3)) / max(len(fp1), 1)
    assert same > 0.9
    # and different content -> different print
    h4 = Harness("chromaprint", duration=3)
    h4.set_src_spec(_spec(AudioFormat.F32, 1))
    h4.push(np.ascontiguousarray(x[::-1] * 0.2) + 0.3)
    assert h4.bus.pop(element="chromaprint")[0][
        "chromaprint-fingerprint"] != fp1


def test_ofa_eos_fingerprint(rng):
    x = (rng.random((2, 4800, 2)) - 0.5).astype(np.float32)
    h = Harness("ofa")
    h.set_src_spec(_spec(AudioFormat.F32, 2))
    h.push(x)
    el = h.element
    assert el.fingerprint is None  # below the 135 s cap, waits for EOS
    el.eos(h.bus)
    msgs = h.bus.pop(element="ofa")
    assert msgs and msgs[0]["ofa-fingerprint"] == el.fingerprint


def test_webrtcdsp_ns_attenuation_cap(rng):
    """Stationary noise with no speech: the Wiener gain converges to the
    mode's attenuation cap (low = 6 dB, very-high = 25 dB) — the WebRTC
    NS denoise bounds."""
    rate = 16000
    n = 32 * 160
    mk = lambda: np.clip(800 * rng.standard_normal(n), -32768, 32767
                         ).astype(np.int16).reshape(1, n, 1)
    outs = {}
    for level, cap_db in (("low", 6.0), ("very-high", 25.0)):
        h = Harness("webrtcdsp", **{"high-pass-filter": False,
                                    "gain-control": False,
                                    "echo-cancel": False,
                                    "noise-suppression-level": level})
        h.set_src_spec(_spec(AudioFormat.S16, 1, rate))
        h.push_pull(mk())                       # converge
        got = h.push_pull(mk())
        atten = (_band_db(mk()[:, n // 2:], rate, 500, 7000)
                 - _band_db(got[:, n // 2:], rate, 500, 7000))
        outs[level] = atten
        # a decision-directed Wiener floor-clips only the quiet bins;
        # fluctuation spikes ride above it, so average attenuation on
        # stationary noise lands below the cap (the real NS behaves the
        # same) — but it scales with the mode and never exceeds the cap
        assert atten > cap_db * 0.4, (level, atten)
        assert atten < cap_db + 3.0, (level, atten)
    assert outs["very-high"] > outs["low"] + 4.0


def test_webrtcdsp_ns_quantile_tracks_floor_change(rng):
    """The staggered log-quantile estimator follows a noise-floor step:
    after the floor drops 20 dB the estimate falls with it (windows
    promote every END_STARTUP/SIMULT frames)."""
    from gstbad.ops import audio as ops

    rate, frame = 16000, 160
    bins = frame // 2 + 1
    st = ops.ns_init(bins, 1)
    g_min = np.float32(10 ** (-25 / 20))

    def run_block(amp, nframes, st):
        x = (amp * rng.standard_normal((nframes * 80, 1))
             ).astype(np.float32)
        frames, _ = ops.stft_frames(
            x, np.zeros((80, 1), np.float32), frame)
        out, st = ops.noise_suppress(frames, st, g_min)
        return st
    st = run_block(3000.0, 300, st)
    loud = float(np.median(np.asarray(st["quantile"])))
    st = run_block(30.0, 300, st)
    quiet = float(np.median(np.asarray(st["quantile"])))
    assert quiet < loud / 10.0                  # tracked the 40 dB drop


def test_webrtcdsp_ns_speech_probability_bounds(rng):
    """Speech probability stays in [0, 1] and goes high for a loud tone
    appearing over a converged noise floor."""
    from gstbad.ops import audio as ops

    rate, frame = 16000, 160
    bins = frame // 2 + 1
    st = ops.ns_init(bins, 1)
    g_min = np.float32(10 ** (-25 / 20))
    noise = (500 * rng.standard_normal((300 * 80, 1))).astype(np.float32)
    frames, _ = ops.stft_frames(noise, np.zeros((80, 1), np.float32),
                                frame)
    _, st = ops.noise_suppress(frames, st, g_min)
    assert 0.0 <= float(st["prior_speech"][0]) <= 1.0
    p_noise = float(st["prior_speech"][0])
    t = np.arange(40 * 80) / rate
    tone = (12000 * np.sin(2 * np.pi * 1000 * t)[:, None]
            + 500 * rng.standard_normal((40 * 80, 1))).astype(np.float32)
    frames2, _ = ops.stft_frames(tone, np.zeros((80, 1), np.float32),
                                 frame)
    _, st2 = ops.noise_suppress(frames2, st, g_min)
    assert float(st2["prior_speech"][0]) > p_noise + 0.2
    assert 0.0 <= float(st2["prior_speech"][0]) <= 1.0


def test_chromaprint_library_acoustid_compatible():
    """engine=auto binds the REAL libchromaprint (the exact library the
    reference wraps): the element's tag is byte-identical to a direct
    chromaprint_feed/get_fingerprint of the same S16 stream — i.e.
    Acoustid-compatible."""
    from gstbad.io import chromaprint as cp
    if not cp.available():
        pytest.skip("libchromaprint not present")
    rate = 44100
    t = np.arange(rate * 5) / rate
    sig = np.clip(12000 * np.sin(2 * np.pi * 440 * t)
                  + 6000 * np.sin(2 * np.pi * 660 * (t + 0.1 * t * t)),
                  -32768, 32767).astype(np.int16)
    x = sig.reshape(5, -1, 1)
    h = Harness("chromaprint", duration=4)
    h.set_src_spec(_spec(AudioFormat.S16, 1, rate))
    for i in range(5):       # 1 s windows: cap crossed exactly at 4 s
        h.push(x[i:i + 1])
    got = h.bus.pop(element="chromaprint")[0]["chromaprint-fingerprint"]
    # whole buffers are fed until nsamples >= duration*rate (the
    # reference's feed-then-check walk, gstchromaprint.c) -> exactly 4 s
    want = cp.fingerprint(sig[:4 * rate], rate)
    assert got == want
    # engine=native still produces its own (non-Acoustid) fingerprint
    h2 = Harness("chromaprint", duration=4, engine="native")
    h2.set_src_spec(_spec(AudioFormat.S16, 1, rate))
    for i in range(5):
        h2.push(x[i:i + 1])
    fp_n = h2.bus.pop(element="chromaprint")[0][
        "chromaprint-fingerprint"]
    assert fp_n and fp_n != got


def test_audioconvert_f32_to_s16_mono(rng):
    """audioconvert (the gst-base dependency config 3 needs): F32 stereo
    -> S16 mono = equal-average downmix, scale 2^15, round half away,
    clamp."""
    x = ((rng.random((2, 64, 2)) - 0.5) * 2.2).astype(np.float32)
    h = Harness("audioconvert", format="S16", channels=1)
    h.set_src_spec(_spec(AudioFormat.F32, 2))
    got = h.push_pull(x)
    mono = x.astype(np.float64).mean(axis=-1, keepdims=True)
    want = np.clip(np.round(mono * 32768.0), -32768, 32767).astype(np.int16)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int16


def test_audioconvert_s16_roundtrip(rng):
    """S16 -> F32 -> S16 is lossless (scale by exactly 2^15)."""
    x = rng.integers(-32768, 32768, (1, 128, 2), dtype=np.int16)
    h1 = Harness("audioconvert", format="F32")
    h1.set_src_spec(_spec(AudioFormat.S16, 2))
    f = h1.push_pull(x)
    assert f.dtype == np.float32
    h2 = Harness("audioconvert", format="S16")
    h2.set_src_spec(_spec(AudioFormat.F32, 2))
    back = h2.push_pull(f)
    np.testing.assert_array_equal(back, x)


def test_audioconvert_mix_matrix_override(rng):
    x = (rng.random((1, 32, 4)) - 0.5).astype(np.float32)
    h = Harness("audioconvert", **{"mix-matrix": MATRIX_4_2})
    h.set_src_spec(_spec(AudioFormat.F32, 4))
    got = h.push_pull(x)
    want = np.einsum("bsc,oc->bso", x.astype(np.float64),
                     NP_MATRIX_4_2).astype(np.float32)
    np.testing.assert_allclose(got, want, atol=1e-7)


def test_vad_window_matches_folded_vad_block(rng):
    import jax.numpy as jnp
    from gstbad.ops import audio as ops
    nb, n = 5, 480
    thr = jnp.int64(int((10.0 ** -6) * 4294967295))
    hys = jnp.int64(480)
    st = ops.vad_init_state()
    st2 = ops.vad_init_state()
    for loud, scale in ((True, 32767), (False, 900)):
        data = jnp.asarray(rng.integers(-scale, scale, (nb, n),
                                        dtype=np.int16))
        fts = []
        for k in range(nb):
            st, ft = ops.vad_block(st, data[k], thr, hys)
            fts.append(int(ft))
        st2, ft2 = ops.vad_window(st2, data, thr, hys)
        assert fts == [int(x) for x in ft2]
        for key in st:
            np.testing.assert_array_equal(np.asarray(st[key]),
                                          np.asarray(st2[key]), key)


def test_vad_bracket_and_serial_fallback_exact():
    """The r5 bracketed-parallel power path (ops/audio.py
    _vad_powers_bracket): per-block recurrences bracketed by the extreme
    initial powers run in parallel; a non-coalescing bracket (constant
    DC power — the contraction's floor boundary can persist) falls back
    to the serial recurrence.  Both paths must equal the per-sample
    reference recurrence (vad_private.c:117) bit-for-bit."""
    import jax.numpy as jnp
    from gstbad.ops import audio as A

    def oracle(p0, sq):
        a, b = A.VAD_POWER_ALPHA, A._VAD_B
        p = int(p0)
        for row in sq:
            for s in row:
                p = a * int(s) + ((b * p) >> 16)
        return p

    rng2 = np.random.default_rng(7)
    cases = {
        "noise": rng2.integers(-32768, 32768, (16, 512)).astype(np.int16),
        "dc-fallback": np.full((16, 512), 30000, np.int16),
        "silence": np.zeros((16, 512), np.int16),
    }
    for name, data in cases.items():
        st = A.vad_init_state()
        st["power"] = jnp.int64(123456789)
        sq = ((data.astype(np.int64) ** 2) >> 14) & 0xFFFF
        lo, hi = A._vad_powers_bracket(jnp.asarray(sq))
        if name == "dc-fallback":
            assert not bool((np.asarray(lo) == np.asarray(hi)).all())
        new, _ = A.vad_window(st, jnp.asarray(data), jnp.int64(10 ** 9),
                              jnp.int64(480))
        assert int(new["power"]) == oracle(123456789, sq), name


def test_vad_powers_serial_matches_oracle():
    """The serial limb recurrence (ops/audio._vad_powers_serial) gives
    every block's end power of the per-sample reference
    (vad_private.c:117), carried across blocks."""
    import jax.numpy as jnp
    from gstbad.ops import audio as A

    rng2 = np.random.default_rng(4)
    data = rng2.integers(-32768, 32768, (3, 300)).astype(np.int64)
    sq = ((data ** 2) >> 14) & 0xFFFF
    p = 0xABCDE
    want = []
    for row in sq:
        for s in row:
            p = A.VAD_POWER_ALPHA * int(s) + ((A._VAD_B * p) >> 16)
        want.append(p)
    p0 = jnp.asarray([0xABCDE >> 16, 0xABCDE & 0xFFFF], jnp.int32)
    hl = np.asarray(A._vad_powers_serial(p0, jnp.asarray(sq, jnp.int32)))
    np.testing.assert_array_equal((hl[:, 0].astype(np.int64) << 16)
                                  | hl[:, 1], want)
