"""LV2 host (ext/lv2) — io/lv2.py's Turtle parser, world model and
ctypes host over the in-repo fixture bundle (native/lv2_plugins.c +
.ttl manifests), since the environment ships no system LV2 bundles
and no lilv."""

import numpy as np
import pytest

import gstbad as gt
from gstbad.io import lv2 as L


@pytest.fixture(scope="module")
def bundle_dir():
    try:
        return L.build_test_plugins()
    except Exception as e:                      # pragma: no cover
        pytest.skip(f"cannot build lv2 fixture: {e}")


@pytest.fixture(scope="module")
def plugins(bundle_dir):
    return {p.uri: p for p in L.scan(bundle_dir)}


@pytest.fixture(scope="module")
def registered(bundle_dir):
    from gstbad.elements.audio.lv2 import register_lv2_elements
    register_lv2_elements(bundle_dir)


# -- turtle parser ----------------------------------------------------------

def test_turtle_basics():
    tp = L.TurtleParser().parse("""
@prefix ex: <http://example.org/> .
@prefix rdfs: <http://www.w3.org/2000/01/rdf-schema#> .
<urn:s> a ex:Thing ;
    rdfs:label "hello \\"quoted\\"" ;
    ex:num 4.25 , 3 ;
    ex:flag true .
""")
    g = tp.graph["urn:s"]
    assert g[L.RDF + "type"] == [L.URI("http://example.org/Thing")]
    assert g[L.RDFS + "label"] == ['hello "quoted"']
    assert g["http://example.org/num"] == [4.25, 3]
    assert g["http://example.org/flag"] == [True]


def test_turtle_blank_nodes_and_collections():
    tp = L.TurtleParser().parse("""
@prefix ex: <http://example.org/> .
<urn:s> ex:port [ ex:index 0 ; ex:sym "a" ] ,
                [ ex:index 1 ; ex:sym "b" ] ;
        ex:list ( 1 2 3 ) .
""")
    g = tp.graph["urn:s"]
    ports = g["http://example.org/port"]
    assert len(ports) == 2
    assert tp.graph[ports[0]]["http://example.org/index"] == [0]
    assert tp.graph[ports[1]]["http://example.org/sym"] == ["b"]
    lst = g["http://example.org/list"][0]
    assert tp.graph[lst][L.RDF + "list"] == [1, 2, 3]


def test_turtle_typed_literal_and_comments():
    tp = L.TurtleParser().parse("""
@prefix xsd: <http://www.w3.org/2001/XMLSchema#> .
# a comment line
<urn:s> <urn:p> "42"^^xsd:integer .  # trailing comment
""")
    assert tp.graph["urn:s"]["urn:p"] == ["42"]


def test_turtle_errors():
    with pytest.raises(L.Lv2Error):
        L.TurtleParser().parse("<urn:s> unknown:prefix 1 .")
    with pytest.raises(L.Lv2Error):
        L.TurtleParser().parse("<urn:s> <urn:p> 1 ")   # missing '.'


# -- world / discovery ------------------------------------------------------

def test_discovery_and_required_feature_skip(plugins):
    assert set(plugins) == {"urn:gstbad:lv2:amp", "urn:gstbad:lv2:width",
                            "urn:gstbad:lv2:sine",
                            "urn:gstbad:lv2:statefilter"}
    # urn:gstbad:lv2:needsfeature declares lv2:requiredFeature urid:map
    # and must be dropped (gstlv2utils.c:105-140)


def test_element_naming():
    # gstlv2.c:187-193: protocol cut + canon; urn: has no '://'
    assert L.element_name_of("http://lv2plug.in/plugins/eg-amp") \
        == "lv2plug-in-plugins-eg-amp"
    assert L.element_name_of("urn:gstbad:lv2:amp") == "urn-gstbad-lv2-amp"


def test_port_classification(plugins):
    amp = plugins["urn:gstbad:lv2:amp"]
    assert [p.symbol for p in amp.audio_in] == ["in"]
    assert [p.symbol for p in amp.audio_out] == ["out"]
    assert [p.symbol for p in amp.control_in] == ["gain", "invert",
                                                  "offset"]
    assert [p.symbol for p in amp.control_out] == ["peak"]
    specs = {s.name: s for s in amp.in_props}
    assert specs["gain"].type is float and specs["gain"].default == 1.0 \
        and specs["gain"].maximum == 4.0
    assert specs["invert"].type is bool and specs["invert"].default is False
    assert specs["offset"].type is int and specs["offset"].minimum == -100
    off = specs["offset"].port
    assert off.scale_points == (("none", 0.0), ("one", 1.0))


def test_port_groups_count_once(plugins):
    width = plugins["urn:gstbad:lv2:width"]
    assert len(width.audio_in) == 2 and len(width.audio_out) == 2
    assert width.audio_group_counts() == (1, 1)


def test_prop_name_canon():
    taken = set()
    assert L._prop_name("gain", taken) == "gain"
    assert L._prop_name("gain", taken) == "gain-1"     # dedupe
    assert L._prop_name("3dB", taken) == "param-3dB"   # leading digit
    assert L._prop_name("a b/c", taken) == "a-b-c"


# -- host math --------------------------------------------------------------

def test_amp_run_matches_c_math(plugins):
    inst = plugins["urn:gstbad:lv2:amp"].instantiate(48000)
    x = np.linspace(-1, 1, 64).astype(np.float32)
    inst.set_control("gain", 2.5)
    y = inst.run(64, x)
    np.testing.assert_allclose(y[:, 0], 2.5 * x, rtol=1e-6)
    inst.set_control("invert", True)
    inst.set_control("offset", 10)
    y = inst.run(64, x)
    np.testing.assert_allclose(y[:, 0], -2.5 * x + 0.01, rtol=1e-5)
    # output control port reads back the block peak
    assert abs(inst.get_control("peak") - np.abs(y[:, 0]).max()) < 1e-6
    inst.close()


def test_width_mid_side(plugins):
    inst = plugins["urn:gstbad:lv2:width"].instantiate(48000)
    rng = np.random.default_rng(3)
    lr = rng.standard_normal((128, 2)).astype(np.float32)
    inst.set_control("width", 0.25)
    out = inst.run(128, lr)
    mid = 0.5 * (lr[:, 0] + lr[:, 1])
    side = 0.5 * (lr[:, 0] - lr[:, 1]) * 0.25
    np.testing.assert_allclose(out[:, 0], mid + side, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(out[:, 1], mid - side, rtol=1e-5,
                               atol=1e-6)
    inst.close()


def test_sine_phase_and_activate_reset(plugins):
    inst = plugins["urn:gstbad:lv2:sine"].instantiate(48000)
    inst.set_control("freq", 1000.0)
    a = inst.run(480)
    b = inst.run(480)
    t = np.arange(960) / 48000.0
    ref = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    np.testing.assert_allclose(
        np.concatenate([a[:, 0], b[:, 0]]), ref, atol=1e-4)
    inst.deactivate()
    inst.activate()                              # phase reset
    c = inst.run(480)
    np.testing.assert_allclose(c[:, 0], a[:, 0], atol=1e-7)
    inst.close()


# -- elements ---------------------------------------------------------------

def test_element_registration(registered):
    from gstbad.core import registry
    names = registry.element_names()
    assert "urn-gstbad-lv2-amp" in names
    assert "urn-gstbad-lv2-width" in names
    assert "urn-gstbad-lv2-sine" in names
    assert "urn-gstbad-lv2-needsfeature" not in names


def test_filter_element_chain_and_props(registered):
    el = gt.make("urn-gstbad-lv2-amp", gain=3.0)
    x = np.linspace(-1, 1, 32).astype(np.float32)
    y = el.chain(x)
    np.testing.assert_allclose(y[:, 0], 3.0 * x, rtol=1e-6)
    el.set_property("invert", True)
    y = el.chain(x)
    np.testing.assert_allclose(y[:, 0], -3.0 * x, rtol=1e-6)
    assert el.get_property("peak") == pytest.approx(3.0, rel=1e-6)
    el.close()


def test_source_element_create(registered):
    el = gt.make("urn-gstbad-lv2-sine", freq=220.0, amplitude=1.0)
    blk = el.create(960)
    t = np.arange(960) / 44100.0
    np.testing.assert_allclose(
        blk[:, 0], np.sin(2 * np.pi * 220.0 * t), atol=1e-4)
    el.close()


def test_presets_discovered(plugins):
    amp = plugins["urn:gstbad:lv2:amp"]
    assert set(amp.presets) == {"hot", "unity"}
    assert amp.presets["hot"] == {"gain": 3.5, "invert": 1.0,
                                  "offset": 7.0}
    # width declares none
    assert plugins["urn:gstbad:lv2:width"].presets == {}


def test_element_load_preset(registered):
    el = gt.make("urn-gstbad-lv2-amp")
    assert el.get_preset_names() == ["hot", "unity"]
    assert el.load_preset("hot")
    x = np.ones(8, np.float32)
    y = el.chain(x)
    np.testing.assert_allclose(y[:, 0], -3.5 + 0.007, rtol=1e-5)
    assert el.load_preset("unity")
    np.testing.assert_allclose(el.chain(x)[:, 0], 1.0, rtol=1e-6)
    assert not el.load_preset("nope")
    el.close()


def test_turtle_triple_quoted_strings():
    tp = L.TurtleParser().parse('''
@prefix rdfs: <http://www.w3.org/2000/01/rdf-schema#> .
<urn:s> rdfs:comment """A long
multi-line comment with "quotes" inside.""" ;
        rdfs:label "short" .
''')
    g = tp.graph["urn:s"]
    assert g[L.RDFS + "comment"] == [
        'A long\nmulti-line comment with "quotes" inside.']
    assert g[L.RDFS + "label"] == ["short"]


def test_state_extension_preset_roundtrip():
    """The LV2 State extension (state/state.h; lilv_state_restore's
    binary-property half that gstlv2utils.c gets through lilv):
    a pset:Preset's state:state block (base64Binary blob + string)
    restores through the plugin's LV2_State_Interface using
    host-mapped URIDs, changes the DSP observably, and save_state
    round-trips the restored values (r5 ledger close)."""
    import os
    import numpy as np
    from gstbad.io import lv2

    bundle_dir = lv2.build_test_plugins()
    plugins = {p.uri: p for p in lv2.scan(bundle_dir)}
    sf = plugins["urn:gstbad:lv2:statefilter"]

    # the world model parsed the state:state block with decoded types
    st = sf.preset_state["steps"]
    table_blob, table_type = st["urn:gstbad:lv2:statefilter#table"]
    assert table_type.endswith("#Chunk") and len(table_blob) == 16
    tag, tag_type = st["urn:gstbad:lv2:statefilter#tag"]
    assert tag == "bright" and tag_type.endswith("#String")

    inst = sf.instantiate(48000)
    assert inst.has_state_interface()
    x = np.ones(8, np.float32)
    np.testing.assert_array_equal(inst.run(8, x).ravel(),
                                  np.ones(8, np.float32))
    assert inst.restore_state(st)
    np.testing.assert_array_equal(
        inst.run(8, x).ravel(),
        np.tile(np.array([2.0, 0.5, 1.5, 1.0], np.float32), 2))

    snap = inst.save_state()
    assert snap["urn:gstbad:lv2:statefilter#tag"][0] == "bright"
    assert snap["urn:gstbad:lv2:statefilter#table"][0] == table_blob

    # element surface: load_preset applies the state half too
    from gstbad.elements.audio.lv2 import register_lv2_elements
    import gstbad as gt
    register_lv2_elements(bundle_dir)
    el = gt.make("urn-gstbad-lv2-statefilter")
    from gstbad.core.spec import MediaSpec
    el.set_info(MediaSpec(kind="audio", format="F32", rate=48000,
                          channels=1))
    assert "steps" in el.get_preset_names()
    assert el.load_preset("steps")
    y = el.chain(np.ones(8, np.float32))
    np.testing.assert_array_equal(
        np.asarray(y).ravel(),
        np.tile(np.array([2.0, 0.5, 1.5, 1.0], np.float32), 2))
