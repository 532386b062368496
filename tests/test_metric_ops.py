"""The window metric ops behind fieldanalysis and ivtc, on their one
plain path each, against the golden C transcriptions: the five default
fieldanalysis metrics as the element computes them (vmap over the window)
and ivtc's comb pair scores (comb_score_pairs: its XLA reference here,
and the Triton kernel in interpret mode)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gstbad.golden import fieldanalysis as g_fa
from gstbad.golden import ivtc as g_ivtc
from gstbad.ops import comb as comb_ops
from gstbad.ops import fieldanalysis as fa_ops


@pytest.mark.parametrize("shape", [(4, 48, 64), (3, 50, 66), (5, 8, 4),
                                   (2, 96, 256)])
def test_default_metrics_match_golden(shape):
    b, h, w = shape
    rng = np.random.default_rng(1)
    y = rng.integers(0, 256, (b, h, w), np.uint8)
    p = rng.integers(0, 256, (b, h, w), np.uint8)
    nf = jnp.int32(16)

    def metrics(yi, pi):
        return (fa_ops.opposite_parity_5_tap(yi, jnp.int32(0), yi, nf),
                fa_ops.same_parity_ssd(yi, jnp.int32(0), pi,
                                       jnp.int32(0), nf),
                fa_ops.same_parity_ssd(yi, jnp.int32(1), pi,
                                       jnp.int32(1), nf),
                fa_ops.opposite_parity_5_tap(yi, jnp.int32(0), pi, nf),
                fa_ops.opposite_parity_5_tap(yi, jnp.int32(1), pi, nf))

    got = jax.vmap(metrics)(jnp.asarray(y), jnp.asarray(p))
    for i in range(b):
        want = (g_fa.opposite_parity_5_tap(y[i], 0, y[i]),
                g_fa.same_parity_ssd(y[i], 0, p[i], 0),
                g_fa.same_parity_ssd(y[i], 1, p[i], 1),
                g_fa.opposite_parity_5_tap(y[i], 0, p[i]),
                g_fa.opposite_parity_5_tap(y[i], 1, p[i]))
        for name, g, w_ in zip(["f", "t", "b", "t_b", "b_t"], got, want):
            assert float(g[i]) == pytest.approx(w_, rel=1e-6), (name, i)


@pytest.mark.parametrize("cfg", [(12, 48, 64, 11), (6, 50, 130, 40),
                                 (5, 24, 320, 5)])
def test_comb_score_pairs_matches_golden(cfg):
    pcount, h, w, n = cfg
    rng = np.random.default_rng(3)
    pool = rng.integers(0, 256, (pcount, h, w), np.uint8)
    pool[:, 1::2, : w // 2] = 250      # a combed region
    ti = rng.integers(0, pcount, n).astype(np.int32)
    bi = rng.integers(0, pcount, n).astype(np.int32)
    want = [g_ivtc.get_comb_score(pool[t], pool[b]) for t, b in zip(ti, bi)]
    args = (jnp.asarray(pool), jnp.asarray(ti), jnp.asarray(bi))
    ref = np.asarray(comb_ops.comb_score_pairs(*args, chunk=4))
    kern = np.asarray(comb_ops._comb_pallas(*args, interpret=True))
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(kern, want)
