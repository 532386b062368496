"""frei0r plugin host (io/frei0r.py + elements/video/frei0r.py vs
gst/frei0r/gstfrei0r*.c), driven by the in-repo fixture plugins
(native/frei0r_plugins.c) — the LADSPA fixture pattern.

Each fixture's C math is replicated in numpy here and compared
bit-exactly through the dlopen boundary.
"""

import numpy as np
import pytest

from gstbad.io import frei0r as f0r
from gstbad.elements.video.frei0r import (register_frei0r_elements,
                                              _canon, _prop_name)


@pytest.fixture(scope="module")
def plugins():
    d = f0r.build_fixture_plugins()
    return {p.name: p for p in f0r.scan([d])}


@pytest.fixture(scope="module")
def elements():
    return register_frei0r_elements()


def _rng_frame(h, w, seed=7):
    return np.random.default_rng(seed).integers(
        0, 256, (h, w, 4), dtype=np.uint8)


# ------------------------------------------------------------- host

def test_scan_finds_all_four(plugins):
    assert sorted(plugins) == ["fixblend", "fixbrightness",
                               "fixgradient", "fixlabeler"]
    assert plugins["fixbrightness"].info.plugin_type == \
        f0r.PLUGIN_TYPE_FILTER
    assert plugins["fixgradient"].info.plugin_type == \
        f0r.PLUGIN_TYPE_SOURCE
    assert plugins["fixblend"].info.plugin_type == f0r.PLUGIN_TYPE_MIXER2


def test_param_info_and_defaults(plugins):
    br = plugins["fixbrightness"]
    assert [(p.name, p.type) for p in br.params] == \
        [("level", f0r.PARAM_DOUBLE), ("invert", f0r.PARAM_BOOL)]
    assert br.defaults == [0.5, False]
    assert plugins["fixblend"].defaults == [0.5, (0.25, 0.75)]
    assert plugins["fixgradient"].defaults == [(1.0, 1.0, 1.0)]
    assert plugins["fixlabeler"].defaults == ["f0r"]


def test_filter_matches_c_math(plugins):
    inst = plugins["fixbrightness"].instantiate(16, 8)
    frame = _rng_frame(8, 16)
    for level, invert in [(0.5, False), (0.8, False), (0.3, True),
                          (1.0, True)]:
        inst.set_param(0, level)
        inst.set_param(1, 1.0 if invert else 0.0)
        got = inst.update(0.0, frame)
        exp = frame.copy()
        scaled = np.minimum(
            frame[..., :3].astype(np.float64) * (2 * level),
            255).astype(np.uint8)
        exp[..., :3] = (255 - scaled) if invert else scaled
        assert np.array_equal(got, exp), (level, invert)


def test_source_matches_c_math(plugins):
    inst = plugins["fixgradient"].instantiate(24, 16)
    inst.set_param(0, (0.5, 1.0, 0.25))
    t = 2.0
    got = inst.update(t, None)
    xs = np.arange(24) & 0xFF
    ys = np.arange(16) & 0xFF
    exp = np.empty((16, 24, 4), np.uint8)
    exp[..., 0] = np.minimum(xs[None, :] * 0.25, 255).astype(np.uint8)
    exp[..., 1] = np.minimum(ys[:, None] * 1.0, 255).astype(np.uint8)
    exp[..., 2] = np.uint8(min((int(t * 25.5) & 0xFF) * 0.5, 255))
    exp[..., 3] = 255
    assert np.array_equal(got, exp)


def test_mixer2_matches_c_math(plugins):
    inst = plugins["fixblend"].instantiate(16, 8)
    a = _rng_frame(8, 16, seed=1)
    b = _rng_frame(8, 16, seed=2)
    inst.set_param(0, 0.25)
    got = inst.update2(0.0, a, b)
    exp = np.clip(a * 0.75 + b * 0.25, 0, 255).astype(np.uint8)
    assert np.array_equal(got, exp)
    # position marshalling round-trips
    inst.set_param(1, (0.125, 0.875))
    assert inst.get_param(1) == (0.125, 0.875)


def test_string_param(plugins):
    inst = plugins["fixlabeler"].instantiate(8, 8)
    assert inst.get_param(0) == "f0r"
    inst.set_param(0, "hello-frei0r")
    assert inst.get_param(0) == "hello-frei0r"
    frame = _rng_frame(8, 8)
    out = inst.update(0.0, frame)
    assert out.reshape(-1)[0] == len("hello-frei0r")
    assert np.array_equal(out.reshape(-1)[4:], frame.reshape(-1)[4:])


def test_resolution_constraints(plugins):
    with pytest.raises(f0r.Frei0rError):
        plugins["fixbrightness"].instantiate(10, 8)   # not 8-aligned
    with pytest.raises(f0r.Frei0rError):
        plugins["fixbrightness"].instantiate(8, 4096)


# --------------------------------------------------------- elements

def test_element_names_and_registry(elements):
    assert sorted(elements) == [
        "frei0r-filter-fixbrightness", "frei0r-filter-fixlabeler",
        "frei0r-mixer-fixblend", "frei0r-src-fixgradient"]
    from gstbad.core import registry
    for name in elements:
        assert name in registry.element_names()


def test_name_canonicalization():
    """gstfrei0rfilter.c:277-279: lowercase + [a-z0-9-+] canon."""
    assert _canon("3 Point Color Balance!") == "3-point-color-balance-"
    assert _prop_name("3 point") == "param-3-point"
    assert _prop_name("Surface Warp") == "surface-warp"


def test_element_properties_and_transform(elements):
    cls = elements["frei0r-filter-fixbrightness"]
    el = cls(width=16, height=8, level=1.0)
    frames = np.stack([_rng_frame(8, 16, s) for s in range(3)])
    out = el.transform(frames)
    exp = frames.copy()
    exp[..., :3] = np.minimum(frames[..., :3].astype(np.int32) * 2,
                              255).astype(np.uint8)
    assert np.array_equal(out, exp)
    # live property change reaches the plugin instance
    el.set_property("invert", True)
    out2 = el.transform(frames)
    assert np.array_equal(out2[..., :3], 255 - exp[..., :3])
    assert el.read_param("invert") is True


def test_element_color_and_position_props(elements):
    src = elements["frei0r-src-fixgradient"](width=24, height=16)
    assert src.props["tint-r"] == 1.0
    src.set_property("tint-b", 0.25)
    assert src.read_param("tint") == (1.0, 1.0, 0.25)
    frames = src.create(2, t0=0.0, fps=10.0)
    assert frames.shape == (2, 16, 24, 4)
    # time advances between frames: R channel differs
    assert frames[0][0, 0, 2] != frames[1][0, 0, 2]

    mix = elements["frei0r-mixer-fixblend"](width=16, height=8)
    assert mix.props["anchor-x"] == 0.25
    assert mix.props["anchor-y"] == 0.75
    mix.set_property("anchor-x", 0.5)
    assert mix.read_param("anchor") == (0.5, 0.75)
    a = np.zeros((2, 8, 16, 4), np.uint8)
    b = np.full((2, 8, 16, 4), 200, np.uint8)
    mix.set_property("mix", 0.5)
    out = mix.mix(a, b)
    assert np.all(out == 100)


def test_element_string_prop(elements):
    el = elements["frei0r-filter-fixlabeler"](width=8, height=8)
    el.set_property("tag", "abcd")
    out = el.transform(np.zeros((1, 8, 8, 4), np.uint8))
    assert out.reshape(-1)[0] == 4
