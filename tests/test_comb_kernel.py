"""The comb chain's GPU kernel (ops/comb._comb_pallas, Pallas through
Triton) and the per-op backend choice.  Off the card the kernel runs in
Pallas interpret mode against the XLA reference (_scan_rows) and the
golden C recurrence; tests marked gpu compile it for the card."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gstbad.golden import ivtc as g_ivtc
from gstbad.ops import comb


def _combed(rng, n, h, w):
    y = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    y[:, 1::2, w // 3:] = 255
    return y


@pytest.mark.parametrize("n,h,w", [(2, 21, 1280), (3, 37, 150),
                                   (1, 10, 33), (2, 16, 128)])
def test_comb_kernel_interpret_matches_reference(n, h, w):
    """Mask mode, including W = 1280 (padded to 2048 lanes), odd row
    counts and a power-of-two width."""
    y = _combed(np.random.default_rng(n * h + w), n, h, w)
    ids = jnp.arange(n, dtype=jnp.int32)
    score, over = comb._comb_pallas(jnp.asarray(y), ids, ids,
                                    emit_mask=True, interpret=True)
    over_r, score_r = comb._mask_reference(jnp.asarray(y), 2, 2)
    np.testing.assert_array_equal(np.asarray(over), np.asarray(over_r))
    np.testing.assert_array_equal(np.asarray(score), np.asarray(score_r))
    np.testing.assert_array_equal(
        np.asarray(score), [g_ivtc.get_comb_score(f, f) for f in y])


def test_comb_kernel_woven_pairs_interpret():
    """Score mode weaves even rows of top with odd rows of bottom."""
    rng = np.random.default_rng(5)
    pool = _combed(rng, 4, 24, 200)
    pool[2, 1::2] = 0
    ti = np.array([0, 1, 2, 3, 2], np.int32)
    bi = np.array([1, 0, 3, 3, 0], np.int32)
    got = comb._comb_pallas(jnp.asarray(pool), jnp.asarray(ti),
                            jnp.asarray(bi), interpret=True)
    np.testing.assert_array_equal(
        np.asarray(got),
        [g_ivtc.get_comb_score(pool[t], pool[b]) for t, b in zip(ti, bi)])


@pytest.mark.parametrize("backend,want", [("gpu", True), ("cpu", False),
                                          ("metal", None)])
def test_comb_backend_choice(monkeypatch, backend, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if want is None:
        with pytest.raises(NotImplementedError, match="backend"):
            comb._use_kernel()
    else:
        assert comb._use_kernel() is want


def test_comb_mask_kernel_path(monkeypatch):
    """comb_mask's GPU branch (reshape of the leading axes, band
    placement) with the kernel run in interpret mode."""
    y = _combed(np.random.default_rng(2), 6, 20, 96).reshape(2, 3, 20, 96)
    want_m, want_s = comb.comb_mask(jnp.asarray(y))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(comb, "_comb_pallas", functools.partial(
        comb._comb_pallas, interpret=True))
    got_m, got_s = comb.comb_mask(jnp.asarray(y))
    assert got_m.shape == y.shape and got_s.shape == (2, 3)
    np.testing.assert_array_equal(np.asarray(got_m), np.asarray(want_m))
    np.testing.assert_array_equal(np.asarray(got_s), np.asarray(want_s))


@pytest.mark.parametrize("n,chunk", [(7, 3), (5, 5), (3, 8), (4, 1)])
def test_comb_score_pairs_chunking(n, chunk):
    """The XLA reference streams `chunk` pairs per step and pads the last
    chunk: any n and chunk give the unchunked scores."""
    rng = np.random.default_rng(n + chunk)
    pool = _combed(rng, 5, 18, 70)
    ti = rng.integers(0, 5, n).astype(np.int32)
    bi = rng.integers(0, 5, n).astype(np.int32)
    got = comb.comb_score_pairs(jnp.asarray(pool), jnp.asarray(ti),
                                jnp.asarray(bi), chunk=chunk)
    want = comb.comb_score(jnp.asarray(pool[ti]), jnp.asarray(pool[bi]))
    assert got.shape == (n,)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("emit_mask", [True, False])
def test_comb_kernel_lowers_for_cuda(emit_mask):
    """Every primitive of the kernel has a Triton lowering (the card's
    compiler itself runs only on the card)."""
    pool = jnp.zeros((3, 720, 1280), jnp.uint8)
    ids = jnp.arange(3, dtype=jnp.int32)
    f = jax.jit(functools.partial(comb._comb_pallas, emit_mask=emit_mask))
    text = f.trace(pool, ids, ids).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "triton" in text


@pytest.mark.gpu
@pytest.mark.parametrize("emit_mask", [True, False])
def test_comb_kernel_on_card(gpu, emit_mask):
    """The kernel compiled for the card == the XLA reference at 720p."""
    rng = np.random.default_rng(9)
    pool = jnp.asarray(_combed(rng, 6, 720, 1280))
    ti = jnp.asarray(rng.integers(0, 6, 9), jnp.int32)
    bi = jnp.asarray(rng.integers(0, 6, 9), jnp.int32)
    if emit_mask:
        over, score = comb._mask_kernel(pool, 2, 2)
        over_r, score_r = comb._mask_reference(pool, 2, 2)
        np.testing.assert_array_equal(np.asarray(over), np.asarray(over_r))
    else:
        score = comb._comb_pallas(pool, ti, bi)
        score_r = comb._pairs_reference(pool, ti, bi, 4)
    np.testing.assert_array_equal(np.asarray(score), np.asarray(score_r))
