"""LADSPA host (ext/ladspa) — io/ladspa.py over the in-repo native
fixture library (native/ladspa_plugins.c), since the environment ships
no system LADSPA plugins."""

import numpy as np
import pytest

import gstbad as gt
from gstbad.io import ladspa as L


@pytest.fixture(scope="module")
def plugin_dir():
    try:
        return L.build_test_plugins()
    except Exception as e:  # no toolchain
        pytest.skip(f"cannot build ladspa fixture: {e}")


@pytest.fixture(scope="module")
def plugins(plugin_dir):
    return {p.label: p for p in L.scan(plugin_dir)}


@pytest.fixture(scope="module")
def registered(plugin_dir):
    from gstbad.elements.audio.ladspa import \
        register_ladspa_elements
    register_ladspa_elements(plugin_dir)
    return True


# ----------------------------------------------------------- discovery

def test_scan_classifies_by_audio_ports(plugins):
    """gstladspa.c:158-233: 0 audio-in -> src, 0 audio-out -> sink,
    else filter; names are lowercased + canonicalized."""
    assert plugins["amp_mono"].element_name \
        == "ladspa-gstbadtest-amp-mono"
    assert plugins["sine_osc"].element_name \
        == "ladspasrc-gstbadtest-sine-osc"
    assert plugins["peak_meter"].element_name \
        == "ladspasink-gstbadtest-peak-meter"


def test_property_specs_from_hints(plugins):
    """gstladspautils.c:344-452 hint mapping."""
    amp = plugins["amp_mono"]
    gain, = amp.in_props
    # BOUNDED 0.01..10, LOGARITHMIC, DEFAULT_1
    assert gain.name == "gain"
    assert gain.type is float
    assert gain.default == 1.0
    assert gain.minimum == pytest.approx(0.01)
    assert gain.maximum == 10.0

    st = plugins["amp_stereo"]
    g, mute, delay = st.in_props
    assert g.default == 2.0                # DEFAULT_MIDDLE of 0..4
    assert mute.type is bool and mute.default is False  # TOGGLED
    assert delay.type is int               # INTEGER hint
    assert (delay.minimum, delay.maximum, delay.default) == (0, 64, 0)

    osc = plugins["sine_osc"]
    freq, amp_prop = osc.in_props
    # SAMPLE_RATE bounds scale by the reference's fixed 44100
    assert freq.name == "frequency--hz-"   # non-alnum -> '-'
    assert freq.maximum == pytest.approx(0.5 * 44100)
    assert freq.default == 440.0           # DEFAULT_440
    assert amp_prop.default == 1.0         # DEFAULT_MAXIMUM

    meter = plugins["peak_meter"]
    assert meter.in_props == []
    peak, = meter.out_props
    assert peak.name == "peak" and not peak.writable


def test_control_only_plugins_skipped(plugins):
    assert set(plugins) == {"amp_mono", "amp_stereo", "sine_osc",
                            "peak_meter"}


# ------------------------------------------------------------- running

def test_mono_filter_run(plugins):
    inst = plugins["amp_mono"].instantiate(48000)
    inst.set_control("gain", 2.0)
    x = np.linspace(-1, 1, 256, dtype=np.float32)[:, None]
    y = inst.run(256, x)
    np.testing.assert_allclose(y, x * 2.0, rtol=1e-6)
    inst.close()


def test_stereo_interleave_roundtrip(plugins):
    """gst_ladspa_transform de-interleaves in and re-interleaves out
    (gstladspautils.c:73-166): channels must not swap."""
    inst = plugins["amp_stereo"].instantiate(48000)
    inst.set_control("gain", 1.0)
    left = np.full(64, 0.25, np.float32)
    right = np.full(64, -0.5, np.float32)
    y = inst.run(64, np.stack([left, right], axis=1))
    np.testing.assert_allclose(y[:, 0], left)
    np.testing.assert_allclose(y[:, 1], right)
    inst.set_control("mute", True)
    y = inst.run(64, np.stack([left, right], axis=1))
    assert np.all(y == 0)
    inst.close()


def test_source_and_sink(plugins):
    osc = plugins["sine_osc"].instantiate(48000)
    osc.set_control("frequency--hz-", 1000.0)
    osc.set_control("amplitude", 0.5)
    y = osc.run(4800)  # 100 ms
    t = np.arange(4800) / 48000.0
    np.testing.assert_allclose(
        y[:, 0], 0.5 * np.sin(2 * np.pi * 1000 * t), atol=1e-4)
    meter = plugins["peak_meter"].instantiate(48000)
    meter.activate()
    meter.run(4800, y)
    assert meter.get_control("peak") == pytest.approx(0.5, abs=1e-4)
    osc.close()
    meter.close()


# ------------------------------------------------------------- elements

def test_registered_elements(registered):
    el = gt.make("ladspa-gstbadtest-amp-mono", gain=3.0)
    x = np.full((128, 1), 0.1, np.float32)
    y = el.chain(x)
    np.testing.assert_allclose(y, x * 3.0, rtol=1e-6)
    assert el.get_property("gain") == pytest.approx(3.0)
    el.close()


def test_registered_source_chain_to_sink(registered):
    src = gt.make("ladspasrc-gstbadtest-sine-osc",
                  **{"frequency--hz-": 440.0, "amplitude": 0.25})
    sink = gt.make("ladspasink-gstbadtest-peak-meter")
    block = src.create(1024)
    assert block.shape == (1024, 1)
    sink.chain(block)
    assert sink.get_property("peak") == pytest.approx(0.25, abs=1e-3)
    src.close()
    sink.close()


def test_registered_stereo_properties(registered):
    el = gt.make("ladspa-gstbadtest-amp-stereo")
    assert el.get_property("gain") == pytest.approx(2.0)  # default
    el.set_property("mute", True)
    y = el.chain(np.ones((32, 2), np.float32))
    assert np.all(y == 0)
    el.set_property("mute", False)
    el.set_property("gain", 0.5)
    y = el.chain(np.ones((32, 2), np.float32))
    np.testing.assert_allclose(y, 0.5)
    el.close()


def test_property_out_of_range_rejected(registered):
    el = gt.make("ladspa-gstbadtest-amp-stereo")
    with pytest.raises((ValueError, KeyError)):
        el.set_property("nonexistent", 1)
    el.close()
