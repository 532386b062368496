"""Fidelity: fieldanalysis metrics + decision tree vs golden."""

import numpy as np
import jax.numpy as jnp
import pytest

from gstbad.core.frame import (FLAG_INTERLACED, FLAG_ONEFIELD, FLAG_RFF,
                                   FLAG_TFF)
from gstbad.core.harness import Harness
from gstbad.core.spec import MediaSpec, VideoFormat
from gstbad.golden import fieldanalysis as golden
from gstbad.ops import fieldanalysis as ops

H, W = 32, 48


def _spec():
    return MediaSpec(kind="video", format=VideoFormat.GRAY8,
                     width=W, height=H)


class TestMetrics:
    @pytest.mark.parametrize("p0,p1", [(0, 0), (1, 1), (0, 1)])
    def test_sad_ssd(self, rng, p0, p1):
        f0 = rng.integers(0, 256, (H, W), dtype=np.uint8)
        f1 = rng.integers(0, 256, (H, W), dtype=np.uint8)
        got = float(ops.same_parity_sad(jnp.asarray(f0), jnp.int32(p0),
                                        jnp.asarray(f1), jnp.int32(p1), 16))
        assert got == pytest.approx(
            golden.same_parity_sad(f0, p0, f1, p1), rel=1e-6)
        got = float(ops.same_parity_ssd(jnp.asarray(f0), jnp.int32(p0),
                                        jnp.asarray(f1), jnp.int32(p1), 16))
        assert got == pytest.approx(
            golden.same_parity_ssd(f0, p0, f1, p1), rel=1e-6)

    def test_3_tap(self, rng):
        f0 = rng.integers(0, 256, (H, W), dtype=np.uint8)
        f1 = rng.integers(0, 256, (H, W), dtype=np.uint8)
        got = float(ops.same_parity_3_tap(jnp.asarray(f0), jnp.int32(0),
                                          jnp.asarray(f1), jnp.int32(0), 16))
        assert got == pytest.approx(
            golden.same_parity_3_tap(f0, 0, f1, 0), rel=1e-6)

    @pytest.mark.parametrize("p0", [0, 1])
    def test_5_tap(self, rng, p0):
        f0 = rng.integers(0, 256, (H, W), dtype=np.uint8)
        f1 = rng.integers(0, 256, (H, W), dtype=np.uint8)
        got = float(ops.opposite_parity_5_tap(
            jnp.asarray(f0), jnp.int32(p0), jnp.asarray(f1), 16))
        assert got == pytest.approx(
            golden.opposite_parity_5_tap(f0, p0, f1), rel=1e-6)

    @pytest.mark.parametrize("p0", [0, 1])
    def test_windowed_comb(self, rng, p0):
        # combed content: fields from different sources
        a = rng.integers(0, 256, (H, W), dtype=np.uint8)
        b = 255 - a
        f0 = a.copy()
        f0[1::2] = b[1::2]
        f1 = rng.integers(0, 256, (H, W), dtype=np.uint8)
        got = float(ops.windowed_comb(jnp.asarray(f0), jnp.int32(p0),
                                      jnp.asarray(f1), 9, 16, 16, 80, 2,
                                      False))
        want = golden.opposite_parity_windowed_comb(f0, p0, f1)
        assert got == want

    def test_windowed_comb_clean(self, rng):
        f = np.tile(rng.integers(0, 256, (1, W), dtype=np.uint8), (H, 1))
        got = float(ops.windowed_comb(jnp.asarray(f), jnp.int32(0),
                                      jnp.asarray(f), 9, 16, 16, 80, 2,
                                      False))
        assert got == 0.0


def _telecine_seq(rng, n_prog=6):
    """2:3-ish telecined GRAY8 sequence with realistic structure."""
    base = rng.integers(0, 200, (H, W), dtype=np.uint8)
    prog = [np.roll(base, 3 * i, axis=1) for i in range(n_prog)]
    # P P | weave | P ... build frames: A, A/B, B, C, C ...
    frames = []
    for i in range(0, n_prog - 1, 2):
        A, B = prog[i], prog[i + 1]
        frames.append(A)
        mixed = A.copy()
        mixed[1::2] = B[1::2]
        frames.append(mixed)
        frames.append(B)
    return np.stack(frames)


class TestElement:
    def _run(self, frames):
        h = Harness("fieldanalysis")
        h.set_src_spec(_spec())
        outs = h.push(frames.copy())
        data = (np.concatenate([np.asarray(o.data) for o in outs])
                if outs else np.zeros((0, H, W), np.uint8))
        flags = (np.concatenate([np.asarray(o.flags) for o in outs])
                 if outs else np.zeros(0, np.int32))
        msgs = h.bus.pop(element="fieldanalysis")
        return data, flags, msgs

    def test_matches_golden_telecine(self, rng):
        frames = _telecine_seq(rng)
        data, flags, msgs = self._run(frames)

        g = golden.GoldenFieldAnalysis()
        want = []
        for f in frames:
            want.extend(g.push(f))
        assert data.shape[0] == len(want)
        for i, (wf, wflags, wconcl) in enumerate(want):
            np.testing.assert_array_equal(data[i], wf)
            assert bool(flags[i] & FLAG_TFF) == wflags["tff"], (i, wflags)
            assert bool(flags[i] & FLAG_ONEFIELD) == wflags["onefield"], i
            assert bool(flags[i] & FLAG_RFF) == wflags["rff"], i
            assert bool(flags[i] & FLAG_INTERLACED) == wflags["interlaced"], i
            assert msgs[i]["conclusion"] == wconcl, i

    def test_matches_golden_progressive(self, rng):
        base = rng.integers(0, 200, (H, W), dtype=np.uint8)
        frames = np.stack([np.roll(base, i, axis=0) for i in range(6)])
        data, flags, msgs = self._run(frames)
        g = golden.GoldenFieldAnalysis()
        want = []
        for f in frames:
            want.extend(g.push(f))
        assert data.shape[0] == len(want)
        for i, (wf, wflags, wconcl) in enumerate(want):
            np.testing.assert_array_equal(data[i], wf)
            assert msgs[i]["conclusion"] == wconcl, (i, msgs[i].fields)

    def test_matches_golden_interlaced(self, rng):
        # every frame combed from two distinct noise fields
        frames = []
        for i in range(6):
            a = rng.integers(0, 256, (H, W), dtype=np.uint8)
            b = rng.integers(0, 256, (H, W), dtype=np.uint8)
            f = a.copy()
            f[1::2] = b[1::2]
            frames.append(f)
        frames = np.stack(frames)
        data, flags, msgs = self._run(frames)
        g = golden.GoldenFieldAnalysis()
        want = []
        for f in frames:
            want.extend(g.push(f))
        for i, (wf, wflags, wconcl) in enumerate(want):
            assert msgs[i]["conclusion"] == wconcl, (i, msgs[i].fields)
            assert bool(flags[i] & FLAG_INTERLACED) == wflags["interlaced"]
        assert any(m["conclusion"] == golden.INTERLACED for m in msgs)

    def test_state_spans_windows(self, rng):
        frames = _telecine_seq(rng)
        h = Harness("fieldanalysis")
        h.set_src_spec(_spec())
        outs = h.push(frames[:4].copy()) + h.push(frames[4:].copy())
        msgs = h.bus.pop(element="fieldanalysis")
        g = golden.GoldenFieldAnalysis()
        want = []
        for f in frames:
            want.extend(g.push(f))
        assert len(msgs) == len(want)
        for i, (wf, wflags, wconcl) in enumerate(want):
            assert msgs[i]["conclusion"] == wconcl, i


def test_eos_drain_matches_golden_flush(rng):
    frames = _telecine_seq(rng)
    h = Harness("fieldanalysis")
    h.set_src_spec(_spec())
    h.push(frames.copy())
    drained = h.pipeline.send_eos()
    assert "fieldanalysis" in drained
    last = drained["fieldanalysis"][0]

    g = golden.GoldenFieldAnalysis()
    for f in frames:
        g.push(f)
    flush = g.flush()
    assert len(flush) == 1
    wf, wflags, wconcl = flush[0]
    np.testing.assert_array_equal(np.asarray(last.data)[0], wf)
    assert bool(last.flags[0] & FLAG_ONEFIELD) == wflags["onefield"]
    assert bool(last.flags[0] & FLAG_TFF) == wflags["tff"]
    # second drain is a no-op
    assert h.pipeline.send_eos() == {}
