"""Viola-Jones Haar cascade evaluation in JAX (the engine behind
handdetect, ext/opencv/gsthanddetect.cpp, using the IN-TREE fist.xml /
palm.xml models).

Every rect sum over every sliding window is four SLICES of the integral
image (no gathers): for windows at stride s, the sum of rect (rx, ry,
rw, rh) across all windows is ii[ry+rh:, rx+rw:] - ii[ry:, rx+rw:] -
ii[ry+rh:, rx:] + ii[ry:, rx:] sliced to the window grid.  Tilted
(45-degree) features use the rotated integral (RSAT) with OpenCV's
corner formula.  Stage sums short-circuit logically; here all stages
evaluate vectorized and AND their pass masks (same result).

cv2 5.0 removed objdetect, so OpenCV's exact detectMultiScale stepping
and pruning heuristics cannot be cross-checked in this environment; the
engine implements the published algorithm (image pyramid at scale-factor
steps, stride-2 sweep, full-window variance normalization,
neighbor-count confirmation) — documented divergence, validated against
hand-computed synthetic cascades in tests/test_haar.py.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from gstbad.io.haarcascade import HaarCascade

STRIDE = 2


class _Node(NamedTuple):
    rects: Tuple[Tuple[int, int, int, int, float], ...]
    tilted: bool
    threshold: float
    left_val: float
    right_val: float
    left_node: int      # -1 = leaf
    right_node: int


def _compile(cascade: HaarCascade):
    stages = []
    for st in cascade.stages:
        trees = []
        for tr in st.trees:
            nodes = []
            for n in tr.nodes:
                nodes.append(_Node(
                    tuple(n.rects), n.tilted, n.threshold,
                    0.0 if n.left_val is None else n.left_val,
                    0.0 if n.right_val is None else n.right_val,
                    -1 if n.left_node is None else n.left_node,
                    -1 if n.right_node is None else n.right_node))
            trees.append(nodes)
        stages.append((trees, st.threshold))
    return stages


def integral(x: jnp.ndarray) -> jnp.ndarray:
    """[H, W] -> [H+1, W+1] zero-padded summed-area table (f32)."""
    ii = jnp.cumsum(jnp.cumsum(x.astype(jnp.float32), axis=0), axis=1)
    return jnp.pad(ii, ((1, 0), (1, 0)))


TILT_PAD = 64    # left margin for (x - h) corner lookups


def tilted_integral(x: jnp.ndarray) -> jnp.ndarray:
    """OpenCV RSAT (cv2.integral3's third output), with margins.

    Recurrence (verified cell-for-cell against cv2.integral3):
    t[y+1, x] = t[y, x-1] + t[y, x+1] - t[y-1, x] + I[y, x-1]
                + I[y-1, x-1].
    The image is zero-padded TILT_PAD columns left and (H + TILT_PAD)
    columns right: beyond x >= W + y the true RSAT is exactly zero, so
    zero-extension keeps the recurrence exact everywhere the real
    corner lookups land.  Returns [H+1, Wp+1] f32 where column
    TILT_PAD corresponds to image x = 0."""
    h, w = x.shape
    xf = jnp.pad(x.astype(jnp.float32),
                 ((0, 0), (TILT_PAD, h + TILT_PAD)))
    wp = xf.shape[1]

    def step(carry, i_rows):
        prev, prev2 = carry                       # t rows y, y-1 [Wp+1]
        i_row, i_prev_row = i_rows
        left = jnp.concatenate([jnp.zeros(1), prev[:-1]])
        right = jnp.concatenate([prev[1:], jnp.zeros(1)])
        i1 = jnp.concatenate([jnp.zeros(1), i_row])        # I[y, x-1]
        i2 = jnp.concatenate([jnp.zeros(1), i_prev_row])   # I[y-1, x-1]
        new = left + right - prev2 + i1 + i2
        return (new, prev), new

    i_prev = jnp.concatenate([jnp.zeros((1, wp)), xf[:-1]], axis=0)
    (_, _), rows = jax.lax.scan(
        step, (jnp.zeros(wp + 1), jnp.zeros(wp + 1)), (xf, i_prev))
    return jnp.concatenate([jnp.zeros((1, wp + 1)), rows], axis=0)


def _rect_sum(ii: jnp.ndarray, ny: int, nx: int, rx: int, ry: int,
              rw: int, rh: int) -> jnp.ndarray:
    """Sum of rect (rx, ry, rw, rh) for every stride-STRIDE window."""
    def grid(yo, xo):
        return ii[yo:yo + ny * STRIDE:STRIDE, xo:xo + nx * STRIDE:STRIDE]
    return (grid(ry + rh, rx + rw) - grid(ry, rx + rw)
            - grid(ry + rh, rx) + grid(ry, rx))


def _tilted_sum(tii: jnp.ndarray, ny: int, nx: int, rx: int, ry: int,
                rw: int, rh: int) -> jnp.ndarray:
    """OpenCV tilted rect sum (cvhaar's p0 - p1 - p2 + p3 corners):
    t(y, x) - t(y+h, x-h) - t(y+w, x+w) + t(y+w+h, x+w-h), verified
    against cv2.integral3 one-hot coefficient maps.  tii comes from
    tilted_integral (bottom rows may be clipped for corners past H —
    pad row reads at the bottom)."""
    tpad = jnp.pad(tii, ((0, 64), (0, 0)))

    def grid(yo, xo):
        xo = xo + TILT_PAD
        return tpad[yo:yo + ny * STRIDE:STRIDE,
                    xo:xo + nx * STRIDE:STRIDE]
    return (grid(ry, rx) - grid(ry + rh, rx - rh)
            - grid(ry + rw, rx + rw) + grid(ry + rw + rh, rx + rw - rh))


def eval_cascade(gray: jnp.ndarray, cascade: HaarCascade
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Evaluate the base-scale cascade over all stride-2 windows of
    gray [H, W] u8.  Returns (pass mask [ny, nx], final stage sum)."""
    stages = _compile(cascade)
    ww, wh = cascade.window
    h, w = gray.shape
    ny = max((h - wh) // STRIDE + 1, 0)
    nx = max((w - ww) // STRIDE + 1, 0)
    ii = integral(gray)
    sq = integral(gray.astype(jnp.float32) ** 2)
    any_tilted = any(n.tilted for trees, _ in stages for tr in trees
                     for n in tr)
    tii = tilted_integral(gray) if any_tilted else None
    area = float(ww * wh)
    total = _rect_sum(ii, ny, nx, 0, 0, ww, wh)
    total_sq = _rect_sum(sq, ny, nx, 0, 0, ww, wh)
    mean = total / area
    variance = jnp.maximum(total_sq / area - mean * mean, 0.0)
    vnorm = jnp.where(variance > 0, jnp.sqrt(variance), 1.0)

    passed = jnp.ones((ny, nx), bool)
    score = jnp.zeros((ny, nx), jnp.float32)
    for trees, st_thresh in stages:
        st_sum = jnp.zeros((ny, nx), jnp.float32)
        for nodes in trees:
            # evaluate every node's feature, then walk the (tiny) tree
            fvals = []
            for n in nodes:
                acc = jnp.zeros((ny, nx), jnp.float32)
                for (rx, ry, rw, rh, wgt) in n.rects:
                    s = (_tilted_sum(tii, ny, nx, rx, ry, rw, rh)
                         if n.tilted else
                         _rect_sum(ii, ny, nx, rx, ry, rw, rh))
                    acc = acc + np.float32(wgt) * s
                fvals.append(acc / area)
            # traversal: value[] computed leaf-up is awkward with
            # forward child indices; walk iteratively from node 0
            idx = jnp.zeros((ny, nx), jnp.int32)
            done = jnp.zeros((ny, nx), bool)
            val = jnp.zeros((ny, nx), jnp.float32)
            for _ in range(len(nodes)):
                for k, n in enumerate(nodes):
                    at_k = (idx == k) & ~done
                    go_left = fvals[k] < np.float32(n.threshold) * vnorm
                    leaf_l = n.left_node < 0
                    leaf_r = n.right_node < 0
                    val = jnp.where(
                        at_k & go_left & leaf_l, np.float32(n.left_val),
                        jnp.where(at_k & ~go_left & leaf_r,
                                  np.float32(n.right_val), val))
                    done = done | (at_k & ((go_left & leaf_l)
                                           | (~go_left & leaf_r)))
                    nxt = jnp.where(go_left,
                                    np.int32(max(n.left_node, 0)),
                                    np.int32(max(n.right_node, 0)))
                    idx = jnp.where(at_k & ~done, nxt, idx)
            st_sum = st_sum + val
        passed = passed & (st_sum >= np.float32(st_thresh))
        score = st_sum
    return passed, score


def detect_multi_scale(gray: jnp.ndarray, cascade: HaarCascade,
                       scale_factor: float = 1.1,
                       min_neighbors: int = 2,
                       max_scales: int = 16) -> List[dict]:
    """Image-pyramid sweep; returns one dict per scale with the pass
    mask, confirmation counts (3x3 neighbor passes) and geometry.
    Neighbor-count confirmation replaces cv::groupRectangles
    (documented divergence)."""
    ww, wh = cascade.window
    h, w = gray.shape
    out = []
    factor = 1.0
    for _ in range(max_scales):
        sh, sw = int(h / factor), int(w / factor)
        if sh < wh or sw < ww:
            break
        scaled = jax.image.resize(gray.astype(jnp.float32), (sh, sw),
                                  "linear")
        passed, score = eval_cascade(scaled, cascade)
        counts = jnp.zeros_like(passed, jnp.int32)
        p = passed.astype(jnp.int32)
        pad = jnp.pad(p, 1)
        for dy in range(3):
            for dx in range(3):
                counts = counts + pad[dy:dy + p.shape[0],
                                      dx:dx + p.shape[1]]
        out.append({"passed": passed, "counts": counts, "score": score,
                    "factor": factor,
                    "size": (int(ww * factor), int(wh * factor))})
        factor *= scale_factor
    return out


# -- data-driven evaluator for BIG cascades ---------------------------------
# The unrolled eval_cascade traces one op chain per node — fine for the
# ~150-feature in-tree hand models, unusable for the ~2000-feature
# /usr/share/opencv4 face cascades (gstfacedetect.cpp/gstfaceblur.cpp
# defaults).  This path packs the cascade into dense arrays and scans
# over trees: per step, T_max<=2 node evaluations whose rect sums are
# dynamic slices of the integral image; stage boundaries fold into the
# scan carry (sum, pass-mask), so memory stays O(ny*nx).

class CascadeArrays(NamedTuple):
    rect_xy: np.ndarray      # [N, R, 2] int32 (ry, rx)
    rect_wh: np.ndarray      # [N, R, 2] int32 (rh, rw)
    rect_w: np.ndarray       # [N, R] float32 (0 = unused slot)
    thr: np.ndarray          # [N] float32
    leaf_l: np.ndarray       # [N] float32
    leaf_r: np.ndarray       # [N] float32
    child_l: np.ndarray      # [N] int32 local tree index, -1 = leaf
    child_r: np.ndarray      # [N] int32
    tree_nodes: np.ndarray   # [Ntrees, T_max] int32 global idx, -1 pad
    stage_end: np.ndarray    # [Ntrees] bool: last tree of its stage
    stage_thr: np.ndarray    # [Ntrees] float32 (valid where stage_end)
    window: Tuple[int, int]  # (w, h)


def compile_arrays(cascade: HaarCascade) -> CascadeArrays:
    if any(n.tilted for s in cascade.stages for t in s.trees
           for n in t.nodes):
        raise ValueError("haar arrays: tilted features unsupported here")
    nodes = [n for s in cascade.stages for t in s.trees for n in t.nodes]
    n_nodes = len(nodes)
    r_max = max(len(n.rects) for n in nodes)
    t_max = max(len(t.nodes) for s in cascade.stages for t in s.trees)
    rect_xy = np.zeros((n_nodes, r_max, 2), np.int32)
    rect_wh = np.zeros((n_nodes, r_max, 2), np.int32)
    rect_w = np.zeros((n_nodes, r_max), np.float32)
    thr = np.zeros(n_nodes, np.float32)
    leaf_l = np.zeros(n_nodes, np.float32)
    leaf_r = np.zeros(n_nodes, np.float32)
    child_l = np.full(n_nodes, -1, np.int32)
    child_r = np.full(n_nodes, -1, np.int32)
    tree_rows = []
    stage_end = []
    stage_thr = []
    gi = 0
    for s in cascade.stages:
        for ti, t in enumerate(s.trees):
            row = []
            for n in t.nodes:
                for ri, (rx, ry, rw, rh, wgt) in enumerate(n.rects):
                    rect_xy[gi, ri] = (ry, rx)
                    rect_wh[gi, ri] = (rh, rw)
                    rect_w[gi, ri] = wgt
                thr[gi] = n.threshold
                leaf_l[gi] = 0.0 if n.left_val is None else n.left_val
                leaf_r[gi] = 0.0 if n.right_val is None else n.right_val
                child_l[gi] = -1 if n.left_node is None else n.left_node
                child_r[gi] = -1 if n.right_node is None else n.right_node
                row.append(gi)
                gi += 1
            tree_rows.append(row + [-1] * (t_max - len(row)))
            stage_end.append(ti == len(s.trees) - 1)
            stage_thr.append(s.threshold)
    return CascadeArrays(
        rect_xy, rect_wh, rect_w, thr, leaf_l, leaf_r, child_l, child_r,
        np.asarray(tree_rows, np.int32), np.asarray(stage_end),
        np.asarray(stage_thr, np.float32), cascade.window)


def eval_cascade_arrays(gray: jnp.ndarray, arrs: CascadeArrays
                        ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Data-driven eval_cascade: same stride-2 window grid, same
    variance normalization, scan over trees."""
    ww, wh = arrs.window
    t_max = arrs.tree_nodes.shape[1]
    if t_max > 2:
        raise ValueError("haar arrays: trees deeper than 2 nodes "
                         "unsupported (face cascades are stumps/pairs)")
    h, w = gray.shape
    ny = max((h - wh) // STRIDE + 1, 0)
    nx = max((w - ww) // STRIDE + 1, 0)
    ii = integral(gray)
    sq = integral(gray.astype(jnp.float32) ** 2)
    area = np.float32(ww * wh)
    total = _rect_sum(ii, ny, nx, 0, 0, ww, wh)
    total_sq = _rect_sum(sq, ny, nx, 0, 0, ww, wh)
    mean = total / area
    variance = jnp.maximum(total_sq / area - mean * mean, 0.0)
    vnorm = jnp.where(variance > 0, jnp.sqrt(variance), 1.0)

    sh = (STRIDE * (ny - 1) + 1, STRIDE * (nx - 1) + 1)
    iif = ii.astype(jnp.float32)

    def corner(dy, dx):
        return lax.dynamic_slice(
            iif, (dy.astype(jnp.int32), dx.astype(jnp.int32)),
            sh)[::STRIDE, ::STRIDE]

    def node_value(gidx):
        gidx = jnp.maximum(gidx, 0)
        acc = jnp.zeros((ny, nx), jnp.float32)
        for r in range(arrs.rect_w.shape[1]):
            ry = jnp.asarray(arrs.rect_xy)[gidx, r, 0]
            rx = jnp.asarray(arrs.rect_xy)[gidx, r, 1]
            rh = jnp.asarray(arrs.rect_wh)[gidx, r, 0]
            rw = jnp.asarray(arrs.rect_wh)[gidx, r, 1]
            wgt = jnp.asarray(arrs.rect_w)[gidx, r]
            s = (corner(ry + rh, rx + rw) - corner(ry, rx + rw)
                 - corner(ry + rh, rx) + corner(ry, rx))
            acc = acc + wgt * s
        return acc / area

    thr = jnp.asarray(arrs.thr)
    leaf_l = jnp.asarray(arrs.leaf_l)
    leaf_r = jnp.asarray(arrs.leaf_r)
    child_l = jnp.asarray(arrs.child_l)
    child_r = jnp.asarray(arrs.child_r)

    def tree_step(carry, inp):
        st_sum, passed, score = carry
        row, is_end, s_thr = inp
        n0 = row[0]
        f0 = node_value(n0)
        go_l0 = f0 < thr[n0] * vnorm
        if t_max == 2:
            n1 = row[1]
            f1 = node_value(n1)
            go_l1 = f1 < thr[n1] * vnorm
            v1 = jnp.where(go_l1, leaf_l[n1], leaf_r[n1])
            has1 = (n1 >= 0).astype(jnp.float32)
            v_left = jnp.where(child_l[n0] >= 0, v1 * has1, leaf_l[n0])
            v_right = jnp.where(child_r[n0] >= 0, v1 * has1, leaf_r[n0])
        else:
            v_left = jnp.broadcast_to(leaf_l[n0], f0.shape)
            v_right = jnp.broadcast_to(leaf_r[n0], f0.shape)
        v = jnp.where(go_l0, v_left, v_right)
        st_sum = st_sum + v
        end = is_end.astype(jnp.float32)
        new_passed = passed & ((st_sum >= s_thr) | ~is_end)
        new_score = jnp.where(is_end, st_sum, score)
        st_sum = st_sum * (1.0 - end)
        return (st_sum, new_passed, new_score), None

    init = (jnp.zeros((ny, nx), jnp.float32),
            jnp.ones((ny, nx), bool),
            jnp.zeros((ny, nx), jnp.float32))
    (st_sum, passed, score), _ = lax.scan(
        tree_step, init,
        (jnp.asarray(arrs.tree_nodes), jnp.asarray(arrs.stage_end),
         jnp.asarray(arrs.stage_thr)))
    return passed, score


def detect_multi_scale_arrays(gray: jnp.ndarray, arrs: CascadeArrays,
                              scale_factor: float = 1.1,
                              max_scales: int = 16) -> List[dict]:
    """detect_multi_scale over the data-driven evaluator."""
    ww, wh = arrs.window
    h, w = gray.shape
    out = []
    factor = 1.0
    for _ in range(max_scales):
        sh2, sw2 = int(h / factor), int(w / factor)
        if sh2 < wh or sw2 < ww:
            break
        scaled = jax.image.resize(gray.astype(jnp.float32), (sh2, sw2),
                                  "linear")
        passed, score = eval_cascade_arrays(scaled, arrs)
        counts = jnp.zeros_like(passed, jnp.int32)
        p = passed.astype(jnp.int32)
        pad = jnp.pad(p, 1)
        for dy in range(3):
            for dx in range(3):
                counts = counts + pad[dy:dy + p.shape[0],
                                      dx:dx + p.shape[1]]
        out.append({"passed": passed, "counts": counts, "score": score,
                    "factor": factor,
                    "size": (int(ww * factor), int(wh * factor))})
        factor *= scale_factor
    return out
