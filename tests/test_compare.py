"""Fidelity: on-device SSIM vs the golden gstcompare transcription."""

import numpy as np
import jax.numpy as jnp
import pytest

from gstbad.core.harness import Harness
from gstbad.core.spec import MediaSpec, VideoFormat
from gstbad.golden import ssim as golden
from gstbad.ops import ssim as ops


@pytest.mark.parametrize("h,w", [(32, 48), (24, 24), (17, 31), (100, 7)])
def test_ssim_plane_matches_golden(rng, h, w):
    a = rng.integers(0, 256, (h, w), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-20, 20, (h, w)), 0,
                255).astype(np.uint8)
    got = float(ops.ssim_plane(jnp.asarray(a[None]), jnp.asarray(b[None]))[0])
    want = golden.ssim_component(a, b)
    assert got == pytest.approx(want, abs=1e-12)


def test_ssim_identical_is_one(rng):
    a = rng.integers(0, 256, (32, 32), dtype=np.uint8)
    got = float(ops.ssim_plane(jnp.asarray(a[None]), jnp.asarray(a[None]))[0])
    assert got == pytest.approx(1.0, abs=1e-9)


def test_compare_element_ssim(rng):
    a = rng.integers(0, 256, (2, 32, 48), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-10, 10, a.shape), 0,
                255).astype(np.uint8)
    h = Harness("compare", method="ssim", threshold=0.5)
    h.set_src_spec(MediaSpec(kind="video", format=VideoFormat.GRAY8,
                             width=48, height=32))
    h.element.set_reference(b)
    h.push(a)
    msgs = h.bus.pop(element="compare")
    assert len(msgs) == 2
    want = golden.ssim([a[0]], [b[0]], is_yuv=True)
    assert msgs[0]["delta"] == pytest.approx(want, abs=1e-12)
    assert msgs[0]["passed"]


def test_compare_element_mem_and_max(rng):
    a = rng.integers(0, 256, (1, 16, 16), dtype=np.uint8)
    b = a.copy()
    b[0, 3, 4] += 7
    h = Harness("compare", method="max")
    h.set_src_spec(MediaSpec(kind="video", format=VideoFormat.GRAY8,
                             width=16, height=16))
    h.element.set_reference(b)
    h.push(a)
    assert h.bus.pop(element="compare")[0]["delta"] == 7.0


def test_iqa_element(rng):
    a = rng.integers(0, 256, (1, 32, 32), dtype=np.uint8)
    noise = rng.integers(-30, 30, a.shape)
    b = np.clip(a.astype(int) + noise, 0, 255).astype(np.uint8)
    h = Harness("iqa", **{"ssim-error-threshold": 0.01})
    h.set_src_spec(MediaSpec(kind="video", format=VideoFormat.GRAY8,
                             width=32, height=32))
    h.element.set_reference(b)
    h.push(a)
    msg = h.bus.pop(element="iqa")[0]
    assert 0.0 < msg["dssim"] < 0.5
    assert msg["exceeded"] == (msg["dssim"] > 0.01)


def test_iqa_n_pad_aggregation(rng):
    """iqa.c:336-400: first pad = reference, every other pad scored; the
    IQA message carries a dssim per pad."""
    import gstbad as gt
    p = gt.parse_launch(
        "videotestsrc pattern=gradient width=32 height=32 format=AYUV "
        "name=ref ! m.  "
        "ref. ! identity ! m.  "
        "ref. ! gaussianblur sigma=3 ! m.  "
        "iqa name=m ! fakesink")
    p.run(n_frames=2, window=2)
    msgs = p.bus.pop(element="iqa")
    assert msgs, "no IQA messages"
    f = msgs[-1].fields
    # identical branch: dssim ~ 0; blurred branch: clearly worse
    assert f["dssim-pad-1"] < 1e-9
    assert f["dssim-pad-2"] > f["dssim-pad-1"] + 1e-4
    assert f["dssim"] == f["dssim-pad-1"]


# ---------------------------------------------------------------------------
# multiscale DSSIM (ops/dssim.py, the kornelski/dssim algorithm behind
# ext/iqa/iqa.c:195-290)
# ---------------------------------------------------------------------------


def test_dssim_identical_is_zero(rng):
    import jax.numpy as jnp
    from gstbad.ops import dssim as d
    img = jnp.asarray(rng.integers(0, 256, (2, 96, 128, 3), dtype=np.uint8))
    score, fmap = d.dssim_rgb(img, img)
    assert np.asarray(score).max() < 1e-4
    assert fmap.shape == (2, 96, 128)
    assert np.asarray(fmap).min() > 0.99


def test_dssim_orders_degradations(rng):
    """More degradation -> larger dssim; 0 = identical (1/ssim - 1)."""
    import jax.numpy as jnp
    from gstbad.ops import dssim as d
    img = rng.integers(0, 256, (1, 96, 128, 3), dtype=np.uint8)
    mild = np.clip(img.astype(int)
                   + rng.normal(0, 4, img.shape), 0, 255).astype(np.uint8)
    harsh = np.clip(img.astype(int)
                    + rng.normal(0, 40, img.shape), 0, 255).astype(np.uint8)
    s0, _ = d.dssim_rgb(jnp.asarray(img), jnp.asarray(img))
    s1, _ = d.dssim_rgb(jnp.asarray(mild), jnp.asarray(img))
    s2, _ = d.dssim_rgb(jnp.asarray(harsh), jnp.asarray(img))
    assert float(s0[0]) < float(s1[0]) < float(s2[0])


def test_dssim_multiscale_sees_lowfreq(rng):
    """A low-frequency luminance shift must register (single-scale SSIM on
    tiny windows underweights it; the coarse pyramid scales catch it)."""
    import jax.numpy as jnp
    from gstbad.ops import dssim as d
    img = rng.integers(64, 192, (1, 128, 128, 3), dtype=np.uint8)
    grad = (np.linspace(0, 30, 128)[None, :, None, None]
            .transpose(0, 1, 2, 3))
    shifted = np.clip(img + grad.astype(int), 0, 255).astype(np.uint8)
    s, _ = d.dssim_rgb(jnp.asarray(shifted), jnp.asarray(img))
    assert float(s[0]) > 1e-3


def test_iqa_multiscale_dssim_in_pipeline(rng):
    import gstbad as gt
    p2 = gt.parse_launch(
        "videotestsrc pattern=gradient width=64 height=48 format=GRAY8 "
        "! tee name=t  t. ! iqa_el.  t. ! smooth ! iqa_el. "
        "iqa name=iqa_el ! fakesink")
    p2.run(n_frames=2, window=2)
    msgs = p2.bus.pop(element="iqa")
    assert len(msgs) == 2
    assert msgs[0]["dssim"] >= 0.0
    # identical branches -> ~0
    p3 = gt.parse_launch(
        "videotestsrc pattern=gradient width=64 height=48 format=RGBA "
        "! tee name=t  t. ! iqa_el.  t. ! identity ! iqa_el. "
        "iqa name=iqa_el ! fakesink")
    p3.run(n_frames=2, window=2)
    m3 = p3.bus.pop(element="iqa")
    assert m3[0]["dssim"] < 1e-4
