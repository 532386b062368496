"""Generate the face-detection test fixture (gstbad/data/face_fixture.npz).

This environment has the OpenCV Haar face models
(/usr/share/opencv4/haarcascades) but no face photos and no
cv2.objdetect, so the deterministic test input is OPTIMIZED: a 41x41
gray patch, embedded at a known position in a 161x161 frame, is driven
by gradient ascent (through a sigmoid-relaxed copy of the cascade
evaluator, including the pyramid resize the detector applies) until the
stride-grid window covering it at pyramid factor 2.0 passes every
stage of haarcascade_frontalface_alt2 with margin — so the REAL
detector (ops/haar.eval_cascade_arrays, hard thresholds, quantized u8
frame) confirms it.  The fixture is a frame region, not a photo;
it validates the engine + element plumbing end-to-end against the real
model files.

Run: PYTHONPATH=. python tools/gen_face_fixture.py
"""

import os

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

CASCADE = "/usr/share/opencv4/haarcascades/haarcascade_frontalface_alt2.xml"
FRAME = 161          # odd so the stride grid is stable
FACE_XY = (48, 40)   # (x, y) of the embedded patch in the frame
FACE_N = 41          # patch size -> ~40x40 detection (factor 2.0)
FACTOR = 2.0


def soft_margins(frame, arrs, k=8.0):
    """Per-stage (margin) map [S, ny, nx] of the sigmoid-relaxed cascade
    at pyramid FACTOR over `frame` — differentiable w.r.t. frame."""
    from gstbad.ops import haar

    ww, wh = arrs.window
    sh2, sw2 = int(FRAME / FACTOR), int(FRAME / FACTOR)
    scaled = jax.image.resize(frame, (sh2, sw2), "linear")
    h, w = scaled.shape
    ny = (h - wh) // haar.STRIDE + 1
    nx = (w - ww) // haar.STRIDE + 1
    ii = haar.integral(scaled)
    sq = haar.integral(scaled.astype(jnp.float32) ** 2)
    area = np.float32(ww * wh)
    total = haar._rect_sum(ii, ny, nx, 0, 0, ww, wh)
    total_sq = haar._rect_sum(sq, ny, nx, 0, 0, ww, wh)
    mean = total / area
    # grad-safe variance normalization: sqrt at var=0 has an inf
    # gradient and jnp.where does not block it (the constant-background
    # windows outside the patch would NaN the whole backward pass)
    var = jnp.maximum(total_sq / area - mean * mean, 1e-4)
    vnorm = jnp.sqrt(var)
    iif = ii.astype(jnp.float32)
    shp = (haar.STRIDE * (ny - 1) + 1, haar.STRIDE * (nx - 1) + 1)

    def corner(dy, dx):
        return lax.dynamic_slice(
            iif, (dy.astype(jnp.int32), dx.astype(jnp.int32)),
            shp)[::haar.STRIDE, ::haar.STRIDE]

    thr = jnp.asarray(arrs.thr)
    ll = jnp.asarray(arrs.leaf_l)
    lr = jnp.asarray(arrs.leaf_r)
    cl = jnp.asarray(arrs.child_l)
    cr = jnp.asarray(arrs.child_r)

    def node_value(g):
        g = jnp.maximum(g, 0)
        acc = jnp.zeros((ny, nx), jnp.float32)
        for r in range(arrs.rect_w.shape[1]):
            ry = jnp.asarray(arrs.rect_xy)[g, r, 0]
            rx = jnp.asarray(arrs.rect_xy)[g, r, 1]
            rh = jnp.asarray(arrs.rect_wh)[g, r, 0]
            rw = jnp.asarray(arrs.rect_wh)[g, r, 1]
            wgt = jnp.asarray(arrs.rect_w)[g, r]
            acc = acc + wgt * (corner(ry + rh, rx + rw)
                               - corner(ry, rx + rw)
                               - corner(ry + rh, rx) + corner(ry, rx))
        return acc / area

    stage_end = np.asarray(arrs.stage_end)
    n_stages = int(stage_end.sum())
    sid = np.minimum(np.cumsum(np.concatenate([[0], stage_end[:-1]])),
                     n_stages - 1).astype(np.int32)

    def tree_step(carry, inp):
        st_sum, ms = carry
        row, is_end, s_thr, si = inp
        n0 = row[0]
        gl0 = jax.nn.sigmoid(-k * (node_value(n0) - thr[n0] * vnorm))
        n1 = row[1]
        gl1 = jax.nn.sigmoid(-k * (node_value(n1) - thr[n1] * vnorm))
        v1 = gl1 * ll[n1] + (1 - gl1) * lr[n1]
        has1 = (n1 >= 0).astype(jnp.float32)
        vl = jnp.where(cl[n0] >= 0, v1 * has1, ll[n0])
        vr = jnp.where(cr[n0] >= 0, v1 * has1, lr[n0])
        st_sum = st_sum + gl0 * vl + (1 - gl0) * vr
        ms = jnp.where(is_end, ms.at[si].set(st_sum - s_thr), ms)
        st_sum = st_sum * (1.0 - is_end.astype(jnp.float32))
        return (st_sum, ms), None

    init = (jnp.zeros((ny, nx), jnp.float32),
            jnp.zeros((n_stages, ny, nx), jnp.float32))
    (_, ms), _ = lax.scan(
        tree_step, init,
        (jnp.asarray(arrs.tree_nodes), jnp.asarray(arrs.stage_end),
         jnp.asarray(arrs.stage_thr), jnp.asarray(sid)))
    return ms


def main():
    from gstbad.io.haarcascade import parse_cascade
    from gstbad.ops import haar

    arrs = haar.compile_arrays(parse_cascade(CASCADE))
    fx, fy = FACE_XY
    # the 2x2 window block covering the patch at factor 2 on the grid
    wy = int(round(fy / FACTOR / haar.STRIDE))
    wx = int(round(fx / FACTOR / haar.STRIDE))
    targets = [(wy + dy, wx + dx) for dy in (0, 1) for dx in (0, 1)]

    def assemble(patch):
        frame = jnp.full((FRAME, FRAME), 128.0, jnp.float32)
        return lax.dynamic_update_slice(frame, patch, (fy, fx))

    def loss(patch):
        ms = soft_margins(assemble(patch), arrs)
        tot = 0.0
        for (ty, tx) in targets:
            tot = tot + jnp.sum(jnp.minimum(ms[:, ty, tx], 0.4))
        return -tot

    g = jax.jit(jax.grad(loss))
    rng = np.random.default_rng(7)
    patch = jnp.asarray(128 + 16 * rng.standard_normal((FACE_N, FACE_N)),
                        jnp.float32)
    for i in range(800):
        gr = g(patch)
        patch = jnp.clip(
            patch - 60.0 * gr / (jnp.linalg.norm(gr) + 1e-9), 0, 255)
        if i % 200 == 0:
            ms = soft_margins(assemble(patch), arrs)
            print(i, "target soft min margin",
                  float(ms[:, wy, wx].min()), flush=True)

    # verify with the REAL detector on the QUANTIZED u8 frame (what
    # the tests load)
    frame = np.rint(np.asarray(assemble(patch))).clip(0, 255)
    scales = haar.detect_multi_scale_arrays(
        jnp.asarray(frame.astype(np.float32)), arrs, 1.1, max_scales=10)
    ok = 0
    for s in scales:
        ps = np.asarray(s["passed"])
        cnt = np.asarray(s["counts"])
        n3 = int((ps & (cnt >= 3)).sum())
        if n3:
            print(f"factor {s['factor']:.2f}: {n3} passing, "
                  f"max count {int(cnt[ps].max())}", flush=True)
        ok += n3
    print("windows with count>=3:", ok)
    assert ok > 0, "fixture failed hard verification"
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "..", "gstbad", "data")
    np.savez(os.path.join(here, "face_fixture.npz"),
             patch=np.asarray(patch).astype(np.float32),
             frame=frame.astype(np.uint8), face_xy=np.asarray(FACE_XY),
             face_n=FACE_N)
    print("wrote face_fixture.npz")


if __name__ == "__main__":
    main()
