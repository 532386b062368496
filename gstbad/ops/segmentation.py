"""JAX kernels for the segmentation element (ext/opencv/gstsegmentation.cpp).

Per-pixel streaming background models, vectorized over the whole frame
(the reference's per-pixel C loops become [H, W, K]-shaped lane math; the
sequential per-pixel mode scans and insertion sorts are reformulated as
static K-step index computations + one gather).  State lives in f32/i32
arrays carried through `lax.scan` over the frame axis, so windows stay
one fused XLA program.

The MOG2 math is the golden/segmentation.py transcription (itself
bit-exact vs cv2); on device it runs in float32 like OpenCV, so masks can
differ from the float64-intermediate golden by the odd pixel at decision
boundaries — tests bound that.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import jax.numpy as jnp
from jax import lax

from gstbad.golden.segmentation import (
    CB_BOUNDS, CB_MAX_MOD, CB_MIN_MOD,
    MOG2_CT, MOG2_K, MOG2_SHADOW, MOG2_TAU, MOG2_TB, MOG2_Tb, MOG2_Tg,
    MOG2_VAR_INIT, MOG2_VAR_MAX, MOG2_VAR_MIN,
    MOG_BACKGROUND_RATIO, MOG_INITIAL_WEIGHT, MOG_K, MOG_NOISE_SIGMA,
    MOG_VAR_THRESHOLD,
)

CB_CAP = 16   # fixed codebook capacity (the reference grows unboundedly;
              # beyond CAP new codewords are dropped — documented)

F = jnp.float32


def rgb2ycrcb_u8(rgb: jnp.ndarray) -> jnp.ndarray:
    """cv::cvtColor RGB2YCrCb 8-bit fixed point ([..., 3] u8), bit-exact
    (golden/segmentation.rgb2ycrcb_u8)."""
    r = rgb[..., 0].astype(jnp.int32)
    g = rgb[..., 1].astype(jnp.int32)
    b = rgb[..., 2].astype(jnp.int32)
    half = 1 << 13
    y = (r * 4899 + g * 9617 + b * 1868 + half) >> 14
    delta = 128 << 14
    cr = ((r - y) * 11682 + delta + half) >> 14
    cb = ((b - y) * 9241 + delta + half) >> 14
    out = jnp.stack([y, cr, cb], axis=-1)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# MOG2
# ---------------------------------------------------------------------------


def mog2_new_state(h: int, w: int) -> Dict[str, jnp.ndarray]:
    return {
        "weight": jnp.zeros((h, w, MOG2_K), F),
        "mean": jnp.zeros((h, w, MOG2_K, 3), F),
        "var": jnp.zeros((h, w, MOG2_K), F),
        "nmodes": jnp.zeros((h, w), jnp.int32),
    }


def mog2_frame(state: Dict[str, jnp.ndarray], ycc: jnp.ndarray,
               alpha_t: jnp.ndarray
               ) -> Tuple[Dict[str, jnp.ndarray], jnp.ndarray]:
    """One frame of MOG2 (bgfg_gaussmix2.cpp MOG2Invoker), vectorized.

    ycc [H, W, 3] u8 -> mask [H, W] u8 in {0, 127, 255}.  Faithful to the
    C loop's visit order: weights decay + prune in place (zeroed entries
    stay mid-array, nmodes drops), the matched mode gets +alphaT and its
    mean/var update, then bubbles up past final (post-prune) weights of
    earlier modes; renormalization covers only the first nmodes entries;
    an unmatched pixel replaces/appends a mode and bubbles it by literal
    alphaT; shadow detection runs on the post-update state.
    """
    w = state["weight"]
    m = state["mean"]
    v = state["var"]
    n = state["nmodes"]
    data = ycc.astype(F)
    alpha_t = jnp.asarray(alpha_t, F)
    alpha1 = 1.0 - alpha_t
    prune = -alpha_t * MOG2_CT

    ks = jnp.arange(MOG2_K, dtype=jnp.int32)[None, None]        # [1,1,K]
    valid = ks < n[..., None]
    d = m - data[:, :, None, :]
    dist2 = jnp.sum(d * d, axis=-1)                             # [H,W,K]
    fit = valid & (dist2 < MOG2_Tg * v)
    has_fit = fit.any(-1)
    k_m = jnp.argmax(fit, axis=-1).astype(jnp.int32)            # first fit
    match_hot = (ks == k_m[..., None]) & has_fit[..., None]

    # visit-order weight pipeline: decay -> +alphaT at match -> prune
    w1 = jnp.where(valid, alpha1 * w + prune, w)
    w1m = jnp.where(match_hot, w1 + alpha_t, w1)
    pruned = valid & (w1m < -prune)
    w2 = jnp.where(pruned, F(0), w1m)
    n1 = n - pruned.sum(-1).astype(jnp.int32)

    # matched-mode mean/var update (k = alphaT / post-+alphaT weight,
    # computed before the prune check like the C)
    km_i = k_m[..., None]
    w1m_at = jnp.take_along_axis(w1m, km_i, -1)[..., 0]
    kfac = alpha_t / jnp.maximum(w1m_at, F(1e-30))
    d_at = jnp.take_along_axis(d, km_i[..., None], -2)[..., 0, :]
    mean_at = jnp.take_along_axis(m, km_i[..., None], -2)[..., 0, :]
    var_at = jnp.take_along_axis(v, km_i, -1)[..., 0]
    dist2_at = jnp.take_along_axis(dist2, km_i, -1)[..., 0]
    mean_new = mean_at - kfac[..., None] * d_at
    var_new = jnp.clip(var_at + kfac * (dist2_at - var_at),
                       MOG2_VAR_MIN, MOG2_VAR_MAX)

    # background flag: while !fitsPDF (k <= k_m), totalWeight-so-far is
    # the exclusive prefix sum of final weights in visit order
    cumw_excl = jnp.cumsum(w2, -1) - w2
    limit = jnp.where(has_fit, k_m, jnp.int32(MOG2_K))
    bg_k = valid & (cumw_excl < MOG2_TB) & (dist2 < MOG2_Tb * v) \
        & (ks <= limit[..., None])
    background = bg_k.any(-1)

    # bubble the matched mode up: it stops at the nearest earlier mode
    # whose (final) weight beats its PRE-prune weight
    blocked = (ks < km_i) & (w2 > w1m_at[..., None])
    p = jnp.max(jnp.where(blocked, ks + 1, 0), -1).astype(jnp.int32)
    m3 = jnp.where(match_hot[..., None], mean_new[:, :, None, :], m)
    v3 = jnp.where(match_hot, var_new[..., None], v)
    in_range = (ks >= p[..., None]) & (ks <= km_i) & has_fit[..., None]
    src = jnp.where(in_range,
                    jnp.where(ks == p[..., None], km_i, ks - 1), ks)
    w4 = jnp.take_along_axis(w2, src, -1)
    v4 = jnp.take_along_axis(v3, src, -1)
    m4 = jnp.take_along_axis(m3, src[..., None], -2)

    # renormalize the first n1 entries only (C: `for mode < nmodes`
    # after the prune decrements)
    total = jnp.sum(jnp.where(valid, w2, F(0)), -1)
    inv = jnp.where(total != 0, 1.0 / total, jnp.inf).astype(F)
    w5 = jnp.where(ks < n1[..., None], w4 * inv[..., None], w4)

    # new mode when nothing fit (and learning is on)
    create = (~has_fit) & (alpha_t > 0)
    idx = jnp.where(n1 == MOG2_K, MOG2_K - 1, n1).astype(jnp.int32)
    n2 = jnp.where(create & (n1 < MOG2_K), n1 + 1, n1)
    single = n2 == 1
    scale_others = create & ~single
    w6 = jnp.where(scale_others[..., None] & (ks < (n2 - 1)[..., None]),
                   w5 * alpha1, w5)
    idx_hot = (ks == idx[..., None]) & create[..., None]
    w6 = jnp.where(idx_hot, jnp.where(single[..., None], F(1), alpha_t), w6)
    m6 = jnp.where(idx_hot[..., None], data[:, :, None, :], m4)
    v6 = jnp.where(idx_hot, F(MOG2_VAR_INIT), v4)
    blocked2 = (ks < idx[..., None]) & (w6 > alpha_t)
    p2 = jnp.max(jnp.where(blocked2, ks + 1, 0), -1).astype(jnp.int32)
    in2 = (ks >= p2[..., None]) & (ks <= idx[..., None]) & create[..., None]
    src2 = jnp.where(in2,
                     jnp.where(ks == p2[..., None], idx[..., None], ks - 1),
                     ks)
    w7 = jnp.take_along_axis(w6, src2, -1)
    v7 = jnp.take_along_axis(v6, src2, -1)
    m7 = jnp.take_along_axis(m6, src2[..., None], -2)

    # detectShadowGMM on the final state: sequential scan with early
    # exits, emulated as K static steps with a decided/result carry
    # (0 = undecided; C returns false on denom == 0)
    result = jnp.zeros(background.shape, jnp.int32)
    t_w = jnp.zeros(background.shape, F)
    for mode in range(MOG2_K):
        mm = m7[:, :, mode, :]
        active = (result == 0) & (mode < n2)
        numer = jnp.sum(data * mm, -1)
        denom = jnp.sum(mm * mm, -1)
        result = jnp.where(active & (denom == 0), 255, result)
        act = active & (denom != 0)
        a = numer / jnp.where(denom == 0, F(1), denom)
        cond_a = (numer <= denom) & (numer >= MOG2_TAU * denom)
        dd = a[..., None] * mm - data
        dist2a = jnp.sum(dd * dd, -1)
        is_sh = cond_a & (dist2a < MOG2_Tb * v7[:, :, mode] * a * a)
        result = jnp.where(act & is_sh, MOG2_SHADOW, result)
        t_w = t_w + jnp.where(act & ~is_sh, w7[:, :, mode], F(0))
        result = jnp.where(act & ~is_sh & (t_w > MOG2_TB), 255, result)
    result = jnp.where(result == 0, 255, result)
    mask = jnp.where(background, 0, result).astype(jnp.uint8)

    return {"weight": w7, "mean": m7, "var": v7,
            "nmodes": n2.astype(jnp.int32)}, mask


# ---------------------------------------------------------------------------
# Codebook
# ---------------------------------------------------------------------------


def codebook_new_state(h: int, w: int) -> Dict[str, jnp.ndarray]:
    return {
        "lhigh": jnp.zeros((h, w, CB_CAP, 3), jnp.int32),
        "llow": jnp.zeros((h, w, CB_CAP, 3), jnp.int32),
        "vmax": jnp.zeros((h, w, CB_CAP, 3), jnp.int32),
        "vmin": jnp.zeros((h, w, CB_CAP, 3), jnp.int32),
        "n": jnp.zeros((h, w), jnp.int32),
    }


_CB_BOUNDS = np.asarray(CB_BOUNDS, np.int32)
_CB_MIN = np.asarray(CB_MIN_MOD, np.int32)
_CB_MAX = np.asarray(CB_MAX_MOD, np.int32)


def codebook_update(state: Dict[str, jnp.ndarray], ycc: jnp.ndarray,
                    enable: jnp.ndarray) -> Dict[str, jnp.ndarray]:
    """update_codebook (gstsegmentation.cpp:476-556) for every pixel.
    `enable` is a scalar bool (the learning cadence is a per-frame
    decision); when False the state passes through unchanged.  The stale
    machinery is dead code in the reference (frozen t) and is omitted —
    see golden/segmentation.CodeBookPixel."""
    p = ycc.astype(jnp.int32)                       # [H,W,3]
    bounds = jnp.asarray(_CB_BOUNDS)
    high = jnp.minimum(p + bounds, 255)
    low = jnp.maximum(p - bounds, 0)

    n = state["n"]
    ks = jnp.arange(CB_CAP, dtype=jnp.int32)[None, None]
    valid = ks < n[..., None]                       # [H,W,CAP]
    pk = p[:, :, None, :]
    inb = ((state["llow"] <= pk) & (pk <= state["lhigh"])).all(-1) & valid
    has = inb.any(-1)
    i_m = jnp.argmax(inb, -1).astype(jnp.int32)

    match_hot = (ks == i_m[..., None]) & has[..., None]
    vmax = jnp.where(match_hot[..., None], jnp.maximum(state["vmax"], pk),
                     state["vmax"])
    vmin = jnp.where(match_hot[..., None], jnp.minimum(state["vmin"], pk),
                     state["vmin"])

    append = (~has) & (n < CB_CAP)
    app_hot = (ks == n[..., None]) & append[..., None]
    lhigh = jnp.where(app_hot[..., None], high[:, :, None, :],
                      state["lhigh"])
    llow = jnp.where(app_hot[..., None], low[:, :, None, :], state["llow"])
    vmax = jnp.where(app_hot[..., None], pk, vmax)
    vmin = jnp.where(app_hot[..., None], pk, vmin)
    n1 = n + append.astype(jnp.int32)

    # learning-bounds creep on the touched entry (matched or appended)
    touch = match_hot | app_hot
    lhigh = jnp.where(touch[..., None] & (lhigh < high[:, :, None, :]),
                      lhigh + 1, lhigh)
    llow = jnp.where(touch[..., None] & (llow > low[:, :, None, :]),
                     llow - 1, llow)

    new = {"lhigh": lhigh, "llow": llow, "vmax": vmax, "vmin": vmin,
           "n": n1}
    enable = jnp.asarray(enable, jnp.bool_)
    return {k: jnp.where(_bcast(enable, new[k].ndim), new[k], state[k])
            for k in new}


def _bcast(x: jnp.ndarray, ndim: int) -> jnp.ndarray:
    return x.reshape((1,) * ndim)


def codebook_diff(state: Dict[str, jnp.ndarray], ycc: jnp.ndarray
                  ) -> jnp.ndarray:
    """background_diff (gstsegmentation.cpp:636-660): 255 when no
    codeword's [min - minMod, max + maxMod] box covers the pixel."""
    p = ycc.astype(jnp.int32)[:, :, None, :]
    ks = jnp.arange(CB_CAP, dtype=jnp.int32)[None, None]
    valid = ks < state["n"][..., None]
    cover = ((state["vmin"] - jnp.asarray(_CB_MIN) <= p)
             & (p <= state["vmax"] + jnp.asarray(_CB_MAX))).all(-1) & valid
    return jnp.where(cover.any(-1), 0, 255).astype(jnp.uint8)


def morph_open_close(mask: jnp.ndarray) -> jnp.ndarray:
    """find_connected_components' cleanup (gstsegmentation.cpp:702-703):
    3x3 OPEN then CLOSE, borders per cv2 morphology defaults (erode pads
    255, dilate pads 0).  mask [..., H, W] u8."""
    def erode(x):
        return lax.reduce_window(x, jnp.uint8(255), lax.min,
                                 (1,) * (x.ndim - 2) + (3, 3),
                                 (1,) * x.ndim,
                                 [(0, 0)] * (x.ndim - 2) + [(1, 1), (1, 1)])

    def dilate(x):
        return lax.reduce_window(x, jnp.uint8(0), lax.max,
                                 (1,) * (x.ndim - 2) + (3, 3),
                                 (1,) * x.ndim,
                                 [(0, 0)] * (x.ndim - 2) + [(1, 1), (1, 1)])

    return erode(dilate(dilate(erode(mask))))


# ---------------------------------------------------------------------------
# MOG (Stauffer-Grimson; spec = golden/segmentation.mog_step)
# ---------------------------------------------------------------------------


def mog_new_state(h: int, w: int) -> Dict[str, jnp.ndarray]:
    return {
        "weight": jnp.zeros((h, w, MOG_K), F),
        "mean": jnp.zeros((h, w, MOG_K, 3), F),
        "var": jnp.full((h, w, MOG_K), MOG_NOISE_SIGMA ** 2, F),
        "nmodes": jnp.zeros((h, w), jnp.int32),
    }


def mog_frame(state: Dict[str, jnp.ndarray], ycc: jnp.ndarray,
              alpha_t: jnp.ndarray
              ) -> Tuple[Dict[str, jnp.ndarray], jnp.ndarray]:
    a = jnp.asarray(alpha_t, F)
    data = ycc.astype(F)
    w8, m8, v8, nm = (state["weight"], state["mean"], state["var"],
                      state["nmodes"])
    ks = jnp.arange(MOG_K, dtype=jnp.int32)[None, None]
    valid = ks < nm[..., None]
    d = m8 - data[:, :, None, :]
    dist2 = jnp.sum(d * d, -1)
    fit = valid & (dist2 < MOG_VAR_THRESHOLD * v8)
    has_fit = fit.any(-1)
    k_m = jnp.argmax(fit, -1).astype(jnp.int32)
    one_hot = (ks == k_m[..., None]) & has_fit[..., None]

    w1 = jnp.where(valid, w8 * (1 - a), w8)
    w1 = jnp.where(one_hot, w1 + a, w1)
    rho = a / jnp.maximum(w1, a)
    m1 = jnp.where(one_hot[..., None],
                   m8 + rho[..., None] * (data[:, :, None, :] - m8), m8)
    v1 = jnp.where(one_hot, v8 + rho * (dist2 - v8), v8)

    grow = (~has_fit) & (nm < MOG_K)
    nm1 = nm + grow.astype(jnp.int32)
    repl_idx = jnp.where(grow, nm, jnp.maximum(nm - 1, 0)).astype(jnp.int32)
    repl_hot = (ks == repl_idx[..., None]) & (~has_fit[..., None])
    w1 = jnp.where(repl_hot, F(MOG_INITIAL_WEIGHT), w1)
    m1 = jnp.where(repl_hot[..., None], data[:, :, None, :], m1)
    v1 = jnp.where(repl_hot, F(MOG_NOISE_SIGMA ** 2), v1)

    valid1 = ks < nm1[..., None]
    tot = jnp.sum(jnp.where(valid1, w1, F(0)), -1, keepdims=True)
    w1 = jnp.where(valid1, w1 / jnp.maximum(tot, F(1e-12)), F(0))

    order = jnp.argsort(-w1, axis=-1, stable=True).astype(jnp.int32)
    w2 = jnp.take_along_axis(w1, order, -1)
    v2 = jnp.take_along_axis(v1, order, -1)
    m2 = jnp.take_along_axis(m1, order[..., None], -2)
    src = jnp.where(has_fit, k_m, repl_idx)
    pos = jnp.argmax(order == src[..., None], -1).astype(jnp.int32)

    cum = jnp.cumsum(w2, -1)
    cum_excl = cum - w2
    n_bg = jnp.sum(cum_excl < MOG_BACKGROUND_RATIO, -1).astype(jnp.int32)
    is_bg = has_fit & (pos < n_bg)
    mask = jnp.where(is_bg, 0, 255).astype(jnp.uint8)
    return {"weight": w2, "mean": m2, "var": v2, "nmodes": nm1}, mask
