"""Fidelity tests: JAX gaudieffects elements vs the golden C transcriptions.

BASELINE.md gate: <= 1e-3 max per-element pixel error vs the C reference;
the integer elements must be bit-exact, the float blur within 1 LSB.
"""

import numpy as np
import pytest

import gstbad as gt
from gstbad.core.harness import Harness
from gstbad.core.spec import MediaSpec, VideoFormat
from gstbad.golden import gaudieffects as golden


def _img(rng, h=33, w=47):
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    # include the edge cases: all-0, all-255
    img[0, 0] = 0
    img[0, 1] = 255
    return img


def _run(name, img, fmt=VideoFormat.BGRx, **props):
    h = Harness(name, **props)
    h.set_src_spec(MediaSpec(kind="video", format=fmt,
                             width=img.shape[1], height=img.shape[0]))
    return h.push_pull(img[None])[0]


@pytest.mark.parametrize("adjustment", [0, 1, 100, 175, 256])
def test_burn(rng, adjustment):
    img = _img(rng)
    np.testing.assert_array_equal(
        _run("burn", img, adjustment=adjustment),
        golden.burn(img, adjustment))


@pytest.mark.parametrize("edge_a,edge_b", [(200, 1), (0, 0), (31, 255)])
def test_chromium(rng, edge_a, edge_b):
    img = _img(rng)
    got = _run("chromium", img, **{"edge-a": edge_a, "edge-b": edge_b})
    np.testing.assert_array_equal(got, golden.chromium(img, edge_a, edge_b))


def test_dodge(rng):
    img = _img(rng)
    np.testing.assert_array_equal(_run("dodge", img), golden.dodge(img))


@pytest.mark.parametrize("factor", [1, 80, 175])
def test_exclusion(rng, factor):
    img = _img(rng)
    np.testing.assert_array_equal(
        _run("exclusion", img, factor=factor), golden.exclusion(img, factor))


@pytest.mark.parametrize("thr,start,end", [
    (127, 50, 185), (0, 0, 256), (256, 0, 256), (50, 50, 50), (10, 200, 40)])
def test_solarize(rng, thr, start, end):
    img = _img(rng)
    got = _run("solarize", img, threshold=thr, start=start, end=end)
    np.testing.assert_array_equal(got, golden.solarize(img, thr, start, end))


@pytest.mark.parametrize("erode", [False, True])
def test_dilate(rng, erode):
    img = _img(rng)
    np.testing.assert_array_equal(
        _run("dilate", img, erode=erode), golden.dilate(img, erode))


@pytest.mark.parametrize("sigma", [1.2, 0.5, 4.0, -2.0, 0.0])
def test_gaussianblur(rng, sigma):
    img = _img(rng, h=24, w=31)
    got = _run("gaussianblur", img, fmt=VideoFormat.AYUV, sigma=sigma)
    want = golden.gaussianblur(img, sigma)
    # float accumulation order differs from the C loop; allow 1 LSB
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, f"max diff {diff.max()}"
    assert (diff > 0).mean() < 0.01


def test_burn_batch_matches_per_frame(rng):
    imgs = rng.integers(0, 256, (3, 16, 20, 4), dtype=np.uint8)
    h = Harness("burn")
    h.set_src_spec(MediaSpec(kind="video", format="BGRx", width=20, height=16))
    got = h.push_pull(imgs)
    for i in range(3):
        np.testing.assert_array_equal(got[i], golden.burn(imgs[i]))


@pytest.mark.parametrize("sigma", [1.2, 0.5, 3.0, -2.0])
def test_gaussianblur_op_batch(rng, sigma):
    """ops/blur.gaussian_blur on a batch of frames (the element's one
    path) is within 1 LSB of the golden C transcription per frame."""
    import jax.numpy as jnp
    from gstbad.ops import blur as blur_ops

    b, h, w = 2, 32, 128
    img = rng.integers(0, 256, (b, h, w, 4), dtype=np.uint8)
    kern, rows, cols = blur_ops.make_blur_tables(sigma, h, w)
    got = np.asarray(blur_ops.gaussian_blur(
        jnp.asarray(img), kern, jnp.asarray(rows), jnp.asarray(cols)))
    want = np.stack([golden.gaussianblur(f, sigma) for f in img])
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, f"max diff {diff.max()}"
    assert (diff > 0).mean() < 0.01


def test_gaussianblur_static_source_graph():
    """videotestsrc bars (a broadcast word base) through gaussianblur:
    every frame of both windows is the golden blur of the bars frame."""
    p = gt.parse_launch("videotestsrc pattern=bars width=64 height=24 "
                        "format=AYUV ! gaussianblur sigma=1.2 ! fakesink")
    src = gt.parse_launch("videotestsrc pattern=bars width=64 height=24 "
                          "format=AYUV ! fakesink").run(n_frames=1,
                                                        window=1)
    want = golden.gaussianblur(np.asarray(src[0].data[0]), 1.2)
    out = np.concatenate([np.asarray(b.data)
                          for b in p.run(n_frames=4, window=2)])
    assert out.shape == (4, 24, 64, 4)
    for f in out:
        diff = np.abs(f.astype(int) - want.astype(int))
        assert diff.max() <= 1, f"max diff {diff.max()}"


@pytest.mark.parametrize("sigma,shape", [(1.2, (2, 40, 300)),
                                         (-2.0, (1, 37, 64)),
                                         (3.0, (1, 70, 260))])
def test_gaussianblur_kernel_interpret(sigma, shape):
    """The Triton blur kernel (interpret mode here) against the XLA
    reference and the golden, including halo rows across band edges,
    partial lane blocks and the sharpen (negative sigma) window."""
    import jax.numpy as jnp
    from gstbad.ops import blur as blur_ops

    b, h, w = shape
    img = np.random.default_rng(h * w).integers(0, 256, (b, h, w, 4),
                                                dtype=np.uint8)
    kern, rows, cols = blur_ops.make_blur_tables(sigma, h, w)
    got = np.asarray(blur_ops._blur_pallas(
        jnp.asarray(img), tuple(float(k) for k in kern),
        jnp.asarray(np.repeat(cols, 4)), jnp.asarray(rows),
        interpret=True))
    ref = np.asarray(blur_ops._blur_reference(
        jnp.asarray(img), kern, jnp.asarray(rows), cols))
    want = np.stack([golden.gaussianblur(f, sigma) for f in img])
    for other in (ref, want):
        diff = np.abs(got.astype(int) - other.astype(int))
        assert diff.max() <= 1, f"max diff {diff.max()}"
        assert (diff > 0).mean() < 0.01


@pytest.mark.parametrize("backend,center,want", [
    ("gpu", 3, True), ("gpu", 9, False), ("cpu", 3, False),
    ("metal", 3, None)])
def test_gaussianblur_backend_choice(monkeypatch, backend, center, want):
    import jax
    from gstbad.ops import blur as blur_ops

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if want is None:
        with pytest.raises(NotImplementedError, match="backend"):
            blur_ops._use_kernel(center)
    else:
        assert blur_ops._use_kernel(center) is want


@pytest.mark.gpu
def test_gaussianblur_kernel_on_card(gpu):
    """The blur kernel compiled for the card vs the XLA reference at
    1080p, within 1 LSB."""
    import jax.numpy as jnp
    from gstbad.ops import blur as blur_ops

    img = np.random.default_rng(3).integers(0, 256, (2, 1080, 1920, 4),
                                            dtype=np.uint8)
    kern, rows, cols = blur_ops.make_blur_tables(1.2, 1080, 1920)
    got = np.asarray(blur_ops.gaussian_blur(
        jnp.asarray(img), kern, jnp.asarray(rows), jnp.asarray(cols)))
    ref = np.asarray(blur_ops._blur_reference(
        jnp.asarray(img), kern, jnp.asarray(rows), cols))
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
