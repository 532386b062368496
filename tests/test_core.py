"""Core framework tests: spec negotiation, registry, parse_launch, harness,
messages — the GstHarness-style smoke layer."""

import numpy as np
import pytest

import gstbad as gt
from gstbad.core.harness import Harness
from gstbad.core.spec import MediaSpec, VideoFormat, SpecError


def test_registry_has_priority_elements():
    names = gt.element_names()
    for n in ["burn", "chromium", "dilate", "dodge", "exclusion", "solarize",
              "gaussianblur", "coloreffects", "chromahold", "zebrastripe",
              "videodiff", "scenechange", "smooth", "videoanalyse",
              "videotestsrc", "audiotestsrc", "identity", "fakesink"]:
        assert n in names, n


def test_parse_launch_simple():
    p = gt.parse_launch("videotestsrc pattern=bars width=64 height=32 "
                        "! burn adjustment=100 ! fakesink")
    spec = p.negotiate()
    assert spec.width == 64 and spec.height == 32
    assert spec.format == VideoFormat.BGRx
    outs = p.run(n_frames=4, window=4)
    assert outs[0].data.shape == (4, 32, 64, 4)


def test_format_negotiation_error():
    p = gt.parse_launch("videotestsrc format=AYUV ! burn")
    with pytest.raises(SpecError):
        p.negotiate()


def test_property_validation():
    with pytest.raises(ValueError):
        gt.make("burn", adjustment=300)
    with pytest.raises(KeyError):
        gt.make("burn", no_such_prop=1)


def test_harness_roundtrip(rng):
    h = Harness("identity")
    h.set_src_spec(MediaSpec(kind="video", format="BGRx", width=16, height=8))
    img = rng.integers(0, 256, (2, 8, 16, 4), dtype=np.uint8)
    out = h.push_pull(img)
    np.testing.assert_array_equal(out, img)


def test_pipeline_chain_fuses(rng):
    """A 3-element chain compiles and runs as one window function."""
    p = gt.parse_launch(
        "videotestsrc pattern=gradient width=64 height=48 "
        "! burn ! solarize ! dodge ! fakesink")
    outs = p.run(n_frames=8, window=4)
    assert len(outs) == 2
    assert outs[0].data.shape == (4, 48, 64, 4)


def test_videoanalyse_messages():
    p = gt.parse_launch("videotestsrc pattern=white width=32 height=16 "
                        "format=I420 ! videoanalyse ! fakesink")
    p.run(n_frames=3, window=3)
    msgs = p.bus.pop(element="videoanalyse")
    assert len(msgs) == 3
    assert msgs[0]["luma-average"] > 0.9


def test_checksumsink():
    p = gt.parse_launch("videotestsrc pattern=bars width=32 height=16 "
                        "! checksumsink")
    p.run(n_frames=2, window=2)
    sink = p.elements[-1]
    assert len(sink.checksums) == 2
    assert sink.checksums[0] == sink.checksums[1]  # static pattern


def test_dag_tee_and_fanin(rng):
    """Branch a source through two filters and join at a 2-input compare."""
    p = gt.parse_launch(
        "videotestsrc pattern=gradient width=32 height=16 format=BGRx "
        "name=src ! tee name=t "
        "t. ! queue ! identity ! cmp. "
        "t. ! queue ! burn ! cmp. "
        "compare name=cmp method=max ! fakesink")
    outs = p.run(n_frames=2, window=2)
    assert outs[0].data.shape == (2, 16, 32, 4)
    msgs = p.bus.pop(element="compare")
    assert len(msgs) == 2
    assert msgs[0]["delta"] > 0  # burn changed the pixels


def test_dag_iqa_two_branches(rng):
    p = gt.parse_launch(
        "videotestsrc pattern=gradient width=32 height=32 format=GRAY8 "
        "! tee name=t "
        "t. ! iqa_el. "
        "t. ! smooth ! iqa_el. "
        "iqa name=iqa_el ! fakesink")
    p.run(n_frames=2, window=2)
    msgs = p.bus.pop(element="iqa")
    assert len(msgs) == 2
    assert 0 <= msgs[0]["dssim"] < 0.5


def test_dag_multi_leaf(rng):
    p = gt.parse_launch(
        "videotestsrc pattern=bars width=16 height=16 format=BGRx name=s "
        "! burn ! fakesink "
        "s. ! dodge ! fakesink")
    outs = p.run(n_frames=2, window=2)
    assert isinstance(outs, dict) and len(outs) == 2


def test_multi_leaf_host_sinks_see_only_their_branch(rng):
    """A tee fan-out with two HOST sinks: each checksumsink must hash only
    its own branch's frames, not a cross-product of both leaves."""
    p = gt.parse_launch(
        "videotestsrc pattern=bars width=16 height=16 format=BGRx name=s "
        "! burn ! checksumsink name=a "
        "s. ! dodge ! checksumsink name=b")
    p.run(n_frames=4, window=2)
    a = p.get_by_name("a")
    b = p.get_by_name("b")
    assert len(a.checksums) == 4
    assert len(b.checksums) == 4
    assert a.checksums != b.checksums

    # each branch's checksums equal the standalone single-branch run
    pa = gt.parse_launch(
        "videotestsrc pattern=bars width=16 height=16 format=BGRx "
        "! burn ! checksumsink name=a")
    pa.run(n_frames=4, window=2)
    assert pa.get_by_name("a").checksums == a.checksums
    pb = gt.parse_launch(
        "videotestsrc pattern=bars width=16 height=16 format=BGRx "
        "! dodge ! checksumsink name=b")
    pb.run(n_frames=4, window=2)
    assert pb.get_by_name("b").checksums == b.checksums


def test_midgraph_host_element_gets_own_stream(rng):
    """A mid-graph HOST element (accurip) must see ITS node's batches even
    when a downstream filter changes the data before the leaf."""
    import gstbad.core.pipeline as pl

    p = gt.parse_launch(
        "audiotestsrc wave=sine channels=2 format=S16 samplesperbuffer=256 "
        "! accurip name=rip ! audiochannelmix left-to-left=0.5 ! fakesink")
    p.run(n_frames=2, window=2)
    crc_through_filter = (p.get_by_name("rip")._crc_v1,
                          p.get_by_name("rip")._crc_v2)

    p2 = gt.parse_launch(
        "audiotestsrc wave=sine channels=2 format=S16 samplesperbuffer=256 "
        "! accurip name=rip ! fakesink")
    p2.run(n_frames=2, window=2)
    assert (p2.get_by_name("rip")._crc_v1,
            p2.get_by_name("rip")._crc_v2) == crc_through_filter


def test_control_curves(rng):
    """GST_PARAM_CONTROLLABLE analog: per-frame property automation."""
    from gstbad.golden.gaudieffects import burn as g_burn
    p = gt.parse_launch("videotestsrc pattern=gradient width=24 height=16 "
                        "format=BGRx ! burn ! fakesink")
    el = p.elements[1]
    el.set_control("adjustment", lambda pts: (pts // int(1e9 / 30)) * 50 % 257)
    outs = p.run(n_frames=4, window=4)
    got = np.asarray(outs[0].data)
    src = np.asarray(p.elements[0]._bg)
    for i in range(4):
        np.testing.assert_array_equal(got[i], g_burn(src, (i * 50) % 257))


def test_control_rejects_non_controllable():
    el = gt.make("gaussianblur")
    with pytest.raises(ValueError):
        el.set_control("sigma", lambda pts: pts)


def test_pipeline_tracer():
    from gstbad.utils import PipelineTracer
    p = gt.parse_launch("videotestsrc width=16 height=16 ! burn ! fakesink")
    tracer = PipelineTracer(p)
    p.run(n_frames=4, window=4)
    rep = tracer.report()
    assert rep["frames"] == 4 and rep["wall_s"] > 0


def test_multiple_host_sources_route_independently(rng):
    """Regression (core): each input-less node must receive ITS OWN
    host-source window — previously every branch got source[0]'s batch."""
    import gstbad as gt
    a = rng.integers(0, 256, (4, 8, 8, 4), np.uint8)
    b = rng.integers(0, 256, (4, 8, 8, 4), np.uint8)
    p = gt.parse_launch(
        "appsrc name=s1 width=8 height=8 format=BGRx ! cmp.  "
        "appsrc name=s2 width=8 height=8 format=BGRx ! cmp.  "
        "compare name=cmp method=max ! fakesink")
    p.negotiate()
    p.get_by_name("s1").push_frames(a)
    p.get_by_name("s2").push_frames(b)
    outs = p.run(window=4)
    # compare's output stream is the second input; its delta message is
    # |s2 - s1| per frame
    got = np.concatenate([np.asarray(o.data) for o in outs])
    np.testing.assert_array_equal(got, b)
    msgs = p.bus.pop(element="compare")
    want = [np.abs(b[i].astype(int) - a[i].astype(int)).max()
            for i in range(4)]
    assert [int(m["delta"]) for m in msgs] == want


def test_debug_taps_match_standalone(rng):
    """Pipeline.compile(taps=...) materializes an intermediate element's
    output from the FUSED program; it must equal the standalone element's
    output on the same input (SURVEY.md §7 hard-part 5)."""
    import gstbad as gt
    from gstbad.core.harness import Harness
    from gstbad.core.spec import MediaSpec, VideoFormat

    p = gt.parse_launch(
        "videotestsrc pattern=bars width=32 height=16 format=BGRx "
        "! burn name=b ! dodge ! solarize ! fakesink")
    p.negotiate()
    step = p.compile(2, taps=["b"], donate_state=False)
    _, leaf, _ = step(p.params(), p.init_states(2), None)
    taps = p.taps_of(leaf)
    assert set(taps) == {"b"}
    tapped = np.asarray(taps["b"].data)

    # standalone: videotestsrc ! burn only
    p2 = gt.parse_launch(
        "videotestsrc pattern=bars width=32 height=16 format=BGRx "
        "! burn ! fakesink")
    outs = p2.run(n_frames=2, window=2)
    np.testing.assert_array_equal(tapped, np.asarray(outs[0].data))

    # final leaf numerics unchanged by tapping
    p3 = gt.parse_launch(
        "videotestsrc pattern=bars width=32 height=16 format=BGRx "
        "! burn ! dodge ! solarize ! fakesink")
    p3.negotiate()
    step3 = p3.compile(2, donate_state=False)
    _, leaf3, _ = step3(p3.params(), p3.init_states(2), None)
    np.testing.assert_array_equal(np.asarray(leaf[0].data),
                                  np.asarray(leaf3[0].data))


def test_tracer_per_element_profile(rng):
    import gstbad as gt
    from gstbad.utils.trace import PipelineTracer

    p = gt.parse_launch(
        "videotestsrc pattern=bars width=64 height=32 format=BGRx "
        "! burn ! dodge ! fakesink")
    tracer = PipelineTracer(p)
    rep = tracer.profile_elements(window=2, reps=2)
    assert "_total_ms" in rep and rep["_total_ms"] > 0
    assert "burn" in rep and "dodge" in rep
    assert all(v >= 0 for v in rep.values())


# ---------------------------------------------------------------------------
# runtime graph editing (insertbin analog, gst-libs/gst/insertbin/)
# ---------------------------------------------------------------------------


def test_insert_after_live():
    """Insert a filter into a RUNNING pipeline: the edit recompiles, the
    source's frame counter carries across (window 2 continues the stream),
    and the inserted element takes effect."""
    from gstbad.golden import gaudieffects as g

    p = gt.parse_launch("videotestsrc name=src pattern=bars width=128 "
                        "height=16 format=BGRx ! burn name=b ! fakesink")
    ref = gt.parse_launch("videotestsrc pattern=bars width=128 height=16 "
                          "format=BGRx ! burn ! fakesink")
    o1 = p.run(n_frames=2, window=2)
    r1 = ref.run(n_frames=2, window=2)
    np.testing.assert_array_equal(np.asarray(o1[0].data),
                                  np.asarray(r1[0].data))
    p.insert_after("b", gt.make("solarize"), "sol")
    o2 = p.run(n_frames=2, window=2)
    r2 = ref.run(n_frames=2, window=2)  # same source position: carried
    want = np.stack([g.solarize(f) for f in np.asarray(r2[0].data)])
    np.testing.assert_array_equal(np.asarray(o2[0].data), want)
    # and remove it again
    el = p.remove("sol")
    assert el.NAME == "solarize"
    o3 = p.run(n_frames=2, window=2)
    r3 = ref.run(n_frames=2, window=2)
    np.testing.assert_array_equal(np.asarray(o3[0].data),
                                  np.asarray(r3[0].data))


def test_insert_before_and_state_carry():
    """insert_before reroutes the input edge; stateful downstream elements
    (scenechange's 5-frame ring) keep their carry across the edit."""
    p = gt.parse_launch("videotestsrc pattern=ball width=64 height=32 "
                        "format=GRAY8 framerate=30/1 "
                        "! scenechange name=sc ! fakesink")
    p.run(n_frames=4, window=4)
    st_before = p._snapshot_states()
    p.insert_before("sc", gt.make("identity"), "id0")
    # the scenechange node's state object survived the rebuild
    order_els = [n.element.NAME for n in p._order]
    assert "identity" in order_els
    p.run(n_frames=4, window=4)  # recompiles cleanly and keeps running
    assert st_before  # sanity: there was live state to carry


def test_set_static_property_live_pitch():
    """Live tempo change mid-stream (gstpitch.cc:248-258): the pipeline
    recompiles, pitch's vocoder state migrates (OLA tail re-shaped), and
    the output block length changes accordingly."""
    p = gt.parse_launch("audiotestsrc wave=sine samplesperbuffer=1024 "
                        "format=F32 ! pitch name=pt tempo=1.0 ! fakesink")
    o1 = p.run(n_frames=2, window=2)
    n1 = o1[0].data.shape[1]
    p.set_static_property("pt", "tempo", 2.0)
    o2 = p.run(n_frames=2, window=2)
    n2 = o2[0].data.shape[1]
    # tempo 2 halves the duration (+- hop quantization)
    assert 0.4 * n1 <= n2 <= 0.6 * n1


def test_remove_aggregation_point_rejected():
    p = gt.parse_launch("videotestsrc name=src width=16 height=16 ! cmp.  "
                        "src. ! cmp.  compare name=cmp ! fakesink")
    with pytest.raises(SpecError):
        p.remove("cmp")


def test_lut_chain_fusion_bitexact(rng):
    """solarize!chromium!dodge!burn composes to ONE byte-LUT pass
    (Element.byte_map); output must be bit-identical to fuse_luts=False."""
    import jax.numpy as jnp
    from gstbad.core.frame import FrameBatch

    img = rng.integers(0, 256, (4, 16, 128, 4), dtype=np.uint8)
    outs = {}
    for fuse in (True, False):
        p = gt.parse_launch("solarize ! chromium ! dodge ! burn ! fakesink")
        p.negotiate(MediaSpec(kind="video", format="BGRx", width=128,
                              height=16))
        p.compile(4, fuse_luts=fuse)
        res = p.run(inputs=FrameBatch.make(jnp.asarray(img)))
        outs[fuse] = np.asarray(res[0].data)
    np.testing.assert_array_equal(outs[True], outs[False])


def test_lut_chain_fusion_respects_taps(rng):
    """A debug tap on an interior LUT node must still see that node's own
    output (the run breaks at protected nodes)."""
    import jax.numpy as jnp
    from gstbad.core.frame import FrameBatch
    from gstbad.golden import gaudieffects as g

    img = rng.integers(0, 256, (2, 16, 128, 4), dtype=np.uint8)
    p = gt.parse_launch("solarize ! dodge ! burn ! fakesink")
    p.negotiate(MediaSpec(kind="video", format="BGRx", width=128, height=16))
    step = p.compile(2, taps=["dodge"])
    states = p.init_states(2)
    _, leaf_batches, _ = step(p.params(), states,
                              FrameBatch.make(jnp.asarray(img)))
    tap = np.asarray(p.taps_of(leaf_batches)["dodge"].data)
    want = np.stack([g.dodge(g.solarize(f)) for f in img])
    np.testing.assert_array_equal(tap, want)
