"""Stereo correspondence (ext/opencv/gstdisparity.cpp wraps
cv::StereoBM / cv::StereoSGBM; these are the JAX engines).

StereoBM is transcribed to BIT-EXACTNESS against cv2 (which this
environment ships) for the element's configuration with the left-right
check disabled: XSobel prefilter with the reflect-at-border rows and
ftzero clamp, 9x9 SAD over the prefiltered pair, the INVERTED disparity
scan's tie-breaking (ties keep the highest disparity), the
(p + n - 2*mind + |p - n|) subpixel denominator with C-truncating
(p - n) * 256 division, the (mind*256 + sub + 15) >> 4 fixed-point
output and the (mindisp - 1) * 16 FILTERED borders
(tests/test_disparity.py asserts == vs cv2.StereoBM).

The disp12 left-right check implements the published validateDisparity
algorithm (right map by scatter-min of per-pixel costs); OpenCV's
internal claim tie-breaking is not observable from cv2 and differs on a
few percent of ambiguous pixels — documented divergence.

StereoSGBM is the published SGM shape (pixelwise absolute-difference
cost on the prefiltered images aggregated along 8 directions with
P1/P2), not a transcription of cv's BT-subpixel block cost — masks
correlate with cv2.StereoSGBM but are not bit-identical (documented)."""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def prefilter_xsobel(img: jnp.ndarray, ftzero: int = 32) -> jnp.ndarray:
    """OpenCV prefilterXSobel: horizontal [-1 0 1] x vertical [1 2 1]
    derivative clamped to [0, 2*ftzero] around ftzero; first/last
    columns = ftzero; border rows REFLECT (row 1 / rows-2)."""
    i32 = img.astype(jnp.int32)
    up = jnp.concatenate([i32[1:2], i32[:-1]], axis=0)
    dn = jnp.concatenate([i32[1:], i32[-2:-1]], axis=0)
    def dx(a):
        return jnp.pad(a[:, 2:] - a[:, :-2], ((0, 0), (1, 1)))
    v = dx(up) + 2 * dx(i32) + dx(dn)
    out = jnp.clip(v + ftzero, 0, 2 * ftzero)
    out = out.at[:, 0].set(ftzero).at[:, -1].set(ftzero)
    return out.astype(jnp.uint8)


def _box9(x: jnp.ndarray, w2: int) -> jnp.ndarray:
    """(2*w2+1)^2 box sum, valid-centered (edges garbage, masked by the
    caller's FILTERED borders)."""
    k = 2 * w2 + 1
    c = jnp.cumsum(jnp.pad(x, ((1, 0), (0, 0)), ), axis=0)
    rows = c[k:] - c[:-k]
    rows = jnp.pad(rows, ((w2, w2), (0, 0)))
    c2 = jnp.cumsum(jnp.pad(rows, ((0, 0), (1, 0))), axis=1)
    cols = c2[:, k:] - c2[:, :-k]
    return jnp.pad(cols, ((0, 0), (w2, w2)))


def _trunc_div(num: jnp.ndarray, den: jnp.ndarray) -> jnp.ndarray:
    """C integer division (truncation toward zero)."""
    q = jnp.abs(num) // jnp.maximum(jnp.abs(den), 1)
    return jnp.where(jnp.sign(num) * jnp.sign(den) < 0, -q, q)


@partial(jax.jit, static_argnames=("ndisp", "block", "disp12_max_diff"))
def stereo_bm(left: jnp.ndarray, right: jnp.ndarray, ndisp: int = 32,
              block: int = 9, disp12_max_diff: int = 0) -> jnp.ndarray:
    """[H, W] u8 pair -> CV_16S-style disparity*16 map (gstdisparity's
    sbm settings: preFilterCap 32, all other post-filters off)."""
    h, w = left.shape
    w2 = block // 2
    pl = prefilter_xsobel(left).astype(jnp.int32)
    pr = prefilter_xsobel(right).astype(jnp.int32)

    sads = []
    for d in range(ndisp):
        shifted = jnp.pad(pr, ((0, 0), (d, 0)))[:, :w]
        sads.append(_box9(jnp.abs(pl - shifted), w2))
    sadv = jnp.stack(sads, axis=0)                       # [D, H, W]

    # inverted scan tie-break: ties keep the HIGHEST disparity
    mind = (ndisp - 1 - jnp.argmin(sadv[::-1], axis=0)).astype(jnp.int32)
    minv = jnp.min(sadv, axis=0)
    dgrid = jnp.arange(ndisp, dtype=jnp.int32)[:, None, None]
    p = jnp.sum(jnp.where(dgrid == mind[None] - 1, sadv, 0), axis=0)
    n = jnp.sum(jnp.where(dgrid == mind[None] + 1, sadv, 0), axis=0)
    dd = p + n - 2 * minv + jnp.abs(p - n)
    sub = jnp.where((mind > 0) & (mind < ndisp - 1) & (dd != 0),
                    _trunc_div((p - n) * 256, dd), 0)
    disp = ((mind * 256 + sub + 15) >> 4).astype(jnp.int16)

    FILTERED = jnp.int16(-16)                            # (mindisp-1)*16
    yy = jnp.arange(h, dtype=jnp.int32)[:, None]
    xx = jnp.arange(w, dtype=jnp.int32)[None, :]
    valid = ((yy >= w2) & (yy < h - w2)
             & (xx >= ndisp + w2 - 1) & (xx < w - w2))
    disp = jnp.where(valid, disp, FILTERED)

    if disp12_max_diff >= 0:
        # validateDisparity: right map via scatter-min of packed
        # (cost, x) keys; ambiguity tie-breaks documented divergent
        dint = (disp.astype(jnp.int32) + 8) >> 4
        x2 = jnp.clip(xx - dint, 0, w - 1)
        key = (minv.astype(jnp.int32) << 13) | xx
        key = jnp.where(valid, key, jnp.int32(2 ** 30))
        claimed = jnp.full((h, w), 2 ** 30, jnp.int32)
        claimed = claimed.at[yy + jnp.zeros_like(x2), x2].min(key)
        win_x = jnp.take_along_axis(claimed, x2, axis=1) & ((1 << 13) - 1)
        win_d = jnp.take_along_axis(disp.astype(jnp.int32), win_x, axis=1)
        bad = valid & (jnp.abs(win_d - disp) > disp12_max_diff * 16)
        disp = jnp.where(bad, FILTERED, disp)
    return disp


@partial(jax.jit, static_argnames=("ndisp", "min_disp", "p1", "p2"))
def stereo_sgm(left: jnp.ndarray, right: jnp.ndarray, ndisp: int = 64,
               min_disp: int = 1, p1: int = 200, p2: int = 255
               ) -> jnp.ndarray:
    """Semi-global matching (Hirschmuller) with the element's SGBM
    settings (blockSize 3 cost window, MODE_HH's 8 directions).  Returns
    disparity*16 i16.  Published-algorithm implementation, not a
    cv::StereoSGBM transcription (see module docstring)."""
    h, w = left.shape
    pl = prefilter_xsobel(left).astype(jnp.int32)
    pr = prefilter_xsobel(right).astype(jnp.int32)

    costs = []
    for d in range(min_disp, min_disp + ndisp):
        shifted = jnp.pad(pr, ((0, 0), (d, 0)))[:, :w]
        c = _box9(jnp.abs(pl - shifted), 1)              # 3x3 block
        costs.append(c)
    cost = jnp.stack(costs, axis=-1).astype(jnp.float32)  # [H, W, D]

    def aggregate(cost, axis, reverse):
        """DP along rows/cols: L(p, d) = C + min(L_prev(d),
        L_prev(d±1)+P1, min L_prev + P2) - min L_prev."""
        moved = jnp.moveaxis(cost, axis, 0)              # [N, M, D]

        def step(prev, c):
            m = jnp.min(prev, axis=-1, keepdims=True)
            shift_p = jnp.pad(prev, ((0, 0), (1, 0)),
                              constant_values=jnp.inf)[:, :-1]
            shift_n = jnp.pad(prev, ((0, 0), (0, 1)),
                              constant_values=jnp.inf)[:, 1:]
            best = jnp.minimum(jnp.minimum(prev, shift_p + p1),
                               jnp.minimum(shift_n + p1, m + p2))
            out = c + best - m
            return out, out

        xs = moved[::-1] if reverse else moved
        _, agg = lax.scan(step, xs[0], xs[1:])
        agg = jnp.concatenate([xs[:1], agg], axis=0)
        if reverse:
            agg = agg[::-1]
        return jnp.moveaxis(agg, 0, axis)

    total = jnp.zeros_like(cost)
    for axis in (0, 1):
        for rev in (False, True):
            total = total + aggregate(cost, axis, rev)
    # diagonal directions: approximate by aggregating the transpose-
    # shifted volumes is costly; MODE_HH's four diagonals are summed as
    # row+column passes over the diagonally rolled volume
    for sign in (1, -1):
        sheared = jax.vmap(
            lambda row, i: jnp.roll(row, sign * i, axis=0),
            in_axes=(0, 0))(cost, jnp.arange(h))
        for rev in (False, True):
            agg = aggregate(sheared, 0, rev)
            unsheared = jax.vmap(
                lambda row, i: jnp.roll(row, -sign * i, axis=0),
                in_axes=(0, 0))(agg, jnp.arange(h))
            total = total + unsheared

    mind = jnp.argmin(total, axis=-1).astype(jnp.int32)
    minv = jnp.min(total, axis=-1)
    dgrid = jnp.arange(ndisp, dtype=jnp.int32)[None, None]
    p_ = jnp.sum(jnp.where(dgrid == mind[..., None] - 1, total, 0), -1)
    n_ = jnp.sum(jnp.where(dgrid == mind[..., None] + 1, total, 0), -1)
    denom = jnp.maximum(p_ + n_ - 2 * minv, 1e-6)
    sub = jnp.where((mind > 0) & (mind < ndisp - 1),
                    (p_ - n_) * 8 / denom, 0.0)
    disp = ((mind + min_disp) * 16 + sub).astype(jnp.int16)
    xx = jnp.arange(w)[None, :]
    valid = xx >= min_disp + ndisp - 1
    return jnp.where(valid, disp, jnp.int16((min_disp - 1) * 16))


def normalize_minmax_u8(x: jnp.ndarray) -> jnp.ndarray:
    """cv::normalize(NORM_MINMAX, 0, 255) to u8 (the element's display
    conversion, gstdisparity.cpp:564-566): saturate(round(scaled))."""
    lo = jnp.min(x).astype(jnp.float64)
    hi = jnp.max(x).astype(jnp.float64)
    scale = jnp.where(hi > lo, 255.0 / (hi - lo), 0.0)
    v = (x.astype(jnp.float64) - lo) * scale
    return jnp.clip(jnp.round(v), 0, 255).astype(jnp.uint8)
