"""GrabCut segmentation core (ext/opencv/gstgrabcut.cpp wraps
cv::grabCut; this is the JAX implementation of the algorithm from
modules/imgproc/src/grabcut.cpp / Rother et al. 2004).

Faithful pieces: the mask convention (BGD=0, FGD=1, PR_BGD=2, PR_FGD=3),
rect/mask initialization, the 5-component full-covariance color GMMs
refit each iteration, beta = 1/(2 E||z_m - z_n||^2) over the 4 neighbor
directions, gamma = 50 smoothness weights with the 1/sqrt(2) diagonal
scaling, lambda = 9*gamma hard constraints.

Documented divergences: cv::grabCut seeds its GMMs with kmeans++ on
OpenCV's RNG (not reproducible), so components initialize with a
deterministic quantile-seeded kmeans; the min-cut (Boykov-Kolmogorov)
step is replaced with checkerboard ICM sweeps over the same energy —
masks agree with cv2.grabCut to high IoU on separable scenes
(tests/test_grabcut.py) but are not pixel-identical.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

GC_BGD, GC_FGD, GC_PR_BGD, GC_PR_FGD = 0, 1, 2, 3
N_COMPONENTS = 5
GAMMA = 50.0
LAMBDA = 9 * GAMMA
ICM_SWEEPS = 10


def _kmeans(x: jnp.ndarray, weights: jnp.ndarray, iters: int = 10
            ) -> jnp.ndarray:
    """Deterministic k-means over [N, 3] f32 with sample weights
    (0-weight samples are padding): quantile seeds along luminance,
    10 Lloyd iterations (cv::kmeans uses 10 too, but kmeans++ RNG
    seeding — divergence documented)."""
    lum = x @ jnp.asarray([0.299, 0.587, 0.114], jnp.float32)
    lum = jnp.where(weights > 0, lum, jnp.nan)
    qs = jnp.nanquantile(lum, jnp.linspace(0.1, 0.9, N_COMPONENTS))
    # seed centers: weighted mean of samples nearest each quantile
    centers = []
    for k in range(N_COMPONENTS):
        d = jnp.abs(lum - qs[k])
        i = jnp.nanargmin(d)
        centers.append(x[i])
    c = jnp.stack(centers)
    for _ in range(iters):
        d2 = jnp.sum((x[:, None, :] - c[None]) ** 2, -1)      # [N, K]
        lbl = jnp.argmin(d2, axis=1)
        onehot = (lbl[:, None] == jnp.arange(N_COMPONENTS)[None]
                  ) * weights[:, None]
        tot = jnp.maximum(onehot.sum(0), 1e-6)
        c = (onehot.T @ x) / tot[:, None]
    d2 = jnp.sum((x[:, None, :] - c[None]) ** 2, -1)
    return jnp.argmin(d2, axis=1)


def _fit_gmm(x: jnp.ndarray, weights: jnp.ndarray, comp: jnp.ndarray):
    """Weighted per-component mean/cov/pi (grabcut.cpp GMM::endLearning;
    the same 0.01 diagonal regularization when a covariance collapses)."""
    onehot = (comp[:, None] == jnp.arange(N_COMPONENTS)[None]
              ) * weights[:, None]                            # [N, K]
    n_k = onehot.sum(0)                                       # [K]
    pi = n_k / jnp.maximum(weights.sum(), 1e-6)
    mean = (onehot.T @ x) / jnp.maximum(n_k, 1e-6)[:, None]   # [K, 3]
    d = x[:, None, :] - mean[None]                            # [N, K, 3]
    cov = jnp.einsum("nk,nki,nkj->kij", onehot, d, d) \
        / jnp.maximum(n_k, 1e-6)[:, None, None]
    # regularize singular covariances (grabcut.cpp: += 0.01 on diag)
    det = jnp.linalg.det(cov)
    eye = jnp.eye(3)[None] * 0.01
    cov = jnp.where((det <= 1e-6)[:, None, None], cov + eye, cov)
    return pi, mean, cov


def _gmm_nll(x: jnp.ndarray, pi, mean, cov) -> jnp.ndarray:
    """-log sum_k pi_k N(x; mean_k, cov_k) for [N, 3] samples."""
    inv = jnp.linalg.inv(cov)                                 # [K, 3, 3]
    det = jnp.maximum(jnp.linalg.det(cov), 1e-12)
    d = x[:, None, :] - mean[None]                            # [N, K, 3]
    m = jnp.einsum("nki,kij,nkj->nk", d, inv, d)
    logp = (jnp.log(jnp.maximum(pi, 1e-12))[None]
            - 0.5 * jnp.log(det)[None] - 0.5 * m)
    mx = jnp.max(logp, axis=1, keepdims=True)
    return -(mx[:, 0] + jnp.log(jnp.sum(jnp.exp(logp - mx), axis=1)))


def _gmm_assign(x, pi, mean, cov) -> jnp.ndarray:
    inv = jnp.linalg.inv(cov)
    det = jnp.maximum(jnp.linalg.det(cov), 1e-12)
    d = x[:, None, :] - mean[None]
    m = jnp.einsum("nki,kij,nkj->nk", d, inv, d)
    logp = (jnp.log(jnp.maximum(pi, 1e-12))[None]
            - 0.5 * jnp.log(det)[None] - 0.5 * m)
    return jnp.argmax(logp, axis=1)


def _beta(img: jnp.ndarray) -> jnp.ndarray:
    """beta = 1 / (2 <||z_m - z_n||^2>) over left/upleft/up/upright
    neighbor pairs, divided by the exact pair count 4wh - 3w - 3h + 2
    (calcBeta, grabcut.cpp)."""
    f = img.astype(jnp.float32)
    h, w, _ = img.shape
    diffs = (f[:, 1:] - f[:, :-1],          # left
             f[1:, 1:] - f[:-1, :-1],       # upleft
             f[1:, :] - f[:-1, :],          # up
             f[1:, :-1] - f[:-1, 1:])       # upright
    tot = sum(jnp.sum(d * d) for d in diffs)
    beta = tot / (4.0 * w * h - 3.0 * w - 3.0 * h + 2.0)
    return jnp.where(beta <= 1e-16, 0.0, 1.0 / (2.0 * beta))


def _smooth_weights(img: jnp.ndarray, beta):
    """gamma-weighted exp terms for the 4 undirected neighbor
    directions: W (left), NW, N, NE (calcNWeights)."""
    f = img.astype(jnp.float32)
    h, w, _ = img.shape
    gd = GAMMA / np.sqrt(2.0)

    def wmap(dy, dx, g):
        # weight between (y, x) and (y - dy, x - dx)
        a = f
        b = jnp.roll(jnp.roll(f, dy, axis=0), dx, axis=1)
        d2 = jnp.sum((a - b) ** 2, -1)
        wgt = g * jnp.exp(-beta * d2)
        yy = jnp.arange(h)[:, None]
        xx = jnp.arange(w)[None, :]
        valid = (yy - dy >= 0) & (yy - dy < h) & (xx - dx >= 0) \
            & (xx - dx < w)
        return jnp.where(valid, wgt, 0.0)

    return (wmap(0, 1, GAMMA), wmap(1, 1, gd), wmap(1, 0, GAMMA),
            wmap(1, -1, gd))


def _icm(data_bg, data_fg, weights, init_fg, hard_bg, hard_fg,
         sweeps: int = ICM_SWEEPS):
    """Checkerboard ICM over the grabcut energy (the min-cut stand-in):
    label 1 = foreground.  Hard pixels are clamped."""
    h, w = data_bg.shape
    wl, wul, wu, wur = weights
    fg = init_fg
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    parity = (yy + xx) % 2

    def neighbor_cost(fg, want):
        """Sum of smoothness weights to neighbors whose label != want.
        wmap[y, x] is the weight of the (y, x) <-> (y-dy, x-dx) edge."""
        cost = jnp.zeros((h, w), jnp.float32)
        f = fg.astype(jnp.float32)
        for (dy, dx, wmap) in ((0, 1, wl), (1, 1, wul), (1, 0, wu),
                               (1, -1, wur)):
            # minus side: neighbor at (y-dy, x-dx), edge weight wmap[y,x]
            nb_m = jnp.roll(jnp.roll(f, dy, axis=0), dx, axis=1)
            valid_m = (yy - dy >= 0) & (yy - dy < h) \
                & (xx - dx >= 0) & (xx - dx < w)
            cost = cost + jnp.where(valid_m, (nb_m != want) * wmap, 0.0)
            # plus side: neighbor at (y+dy, x+dx), edge weight
            # wmap[y+dy, x+dx]
            nb_p = jnp.roll(jnp.roll(f, -dy, axis=0), -dx, axis=1)
            w_p = jnp.roll(jnp.roll(wmap, -dy, axis=0), -dx, axis=1)
            valid_p = (yy + dy >= 0) & (yy + dy < h) \
                & (xx + dx >= 0) & (xx + dx < w)
            cost = cost + jnp.where(valid_p, (nb_p != want) * w_p, 0.0)
        return cost

    # graduated non-convexity: ramp the smoothness in over the sweeps so
    # the data terms first snap labels to their color class (a plain ICM
    # at full gamma cannot move the initial rect boundary past the
    # ~gamma-high single-pixel barrier the way a min-cut moves it
    # region-at-once)
    for s in range(sweeps):
        anneal = np.float32(s / max(sweeps - 1, 1))
        for p in (0, 1):
            cost_bg = data_bg + anneal * neighbor_cost(fg, 0.0)
            cost_fg = data_fg + anneal * neighbor_cost(fg, 1.0)
            new_fg = cost_fg < cost_bg
            upd = (parity == p) & ~hard_bg & ~hard_fg
            fg = jnp.where(upd, new_fg, fg)
    return fg


@partial(jax.jit, static_argnames=("iterations",))
def grabcut(img: jnp.ndarray, mask: jnp.ndarray,
            iterations: int = 1):
    """img [H, W, 3] u8, mask [H, W] u8 in GC_* values -> refined mask.
    (cv::grabCut body: assign components, learn GMMs, segment —
    grabcut.cpp GCApplication loop.)"""
    h, w, _ = img.shape
    f = img.astype(jnp.float32).reshape(-1, 3)
    m = mask.reshape(-1)
    beta = _beta(img)
    weights = _smooth_weights(img, beta)
    hard_bg = (mask == GC_BGD)
    hard_fg = (mask == GC_FGD)
    fg = ((mask == GC_FGD) | (mask == GC_PR_FGD))

    for _ in range(iterations):
        fg_w = fg.reshape(-1).astype(jnp.float32)
        bg_w = 1.0 - fg_w
        comp_f = _kmeans(f, fg_w)
        comp_b = _kmeans(f, bg_w)
        pi_f, mu_f, cov_f = _fit_gmm(f, fg_w, comp_f)
        pi_b, mu_b, cov_b = _fit_gmm(f, bg_w, comp_b)
        # one assign/learn refinement round (grabcut.cpp iter body)
        comp_f = _gmm_assign(f, pi_f, mu_f, cov_f)
        comp_b = _gmm_assign(f, pi_b, mu_b, cov_b)
        pi_f, mu_f, cov_f = _fit_gmm(f, fg_w, comp_f)
        pi_b, mu_b, cov_b = _fit_gmm(f, bg_w, comp_b)
        data_fg = _gmm_nll(f, pi_f, mu_f, cov_f).reshape(h, w)
        data_bg = _gmm_nll(f, pi_b, mu_b, cov_b).reshape(h, w)
        # hard constraints (lambda terms)
        data_fg = jnp.where(hard_bg, LAMBDA, jnp.where(hard_fg, 0.0,
                                                       data_fg))
        data_bg = jnp.where(hard_fg, LAMBDA, jnp.where(hard_bg, 0.0,
                                                       data_bg))
        fg = _icm(data_bg, data_fg, weights, fg, hard_bg, hard_fg)

    out = jnp.where(hard_bg, GC_BGD,
                    jnp.where(hard_fg, GC_FGD,
                              jnp.where(fg, GC_PR_FGD, GC_PR_BGD)))
    return out.astype(jnp.uint8)


def init_mask_from_rect(h: int, w: int, rect) -> jnp.ndarray:
    """GC_INIT_WITH_RECT: inside = PR_FGD, outside = BGD."""
    x, y, rw, rh = rect
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    inside = (xx >= x) & (xx < x + rw) & (yy >= y) & (yy < y + rh)
    return jnp.where(inside, GC_PR_FGD, GC_BGD).astype(jnp.uint8)
