"""ivtc reconstruction kernels (gst/ivtc/gstivtc.c:340-490) vectorized.

reconstruct_single's edge-directed line doubling computes all five direction
filters for both orientations and selects per pixel — cheap for the VPU,
branch-free for XLA.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from gstbad.ops.comb import interleave  # noqa: F401 (re-export)

_WEIGHTS = [(0, 0, 0, 16), (0, 0, 8, 8), (0, 4, 8, 4), (1, 7, 7, 1),
            (4, 8, 4, 0)]


def _shift(x, k):
    """x[..., i+k] with edge clamp (borders are overwritten by the plain
    average anyway)."""
    w = x.shape[-1]
    idx = np.clip(np.arange(w) + k, 0, w - 1)
    return x[..., idx]


def _filters(A, B):
    """All 5 reconstruct_line variants for orientation (A, B) ->
    [5, ..., W] int32."""
    outs = []
    for a, b, c, d in _WEIGHTS:
        acc = (_shift(A, -3) * a + _shift(A, -2) * b + _shift(A, -1) * c
               + A * d + B * d + _shift(B, 1) * c + _shift(B, 2) * b
               + _shift(B, 3) * a)
        outs.append((acc + 16) >> 5)
    return jnp.stack(outs)


def interp_rows(l1: jnp.ndarray, l2: jnp.ndarray) -> jnp.ndarray:
    """Edge-directed interpolation of the row between l1 (above) and l2
    (below); both [..., W] uint8 -> [..., W] uint8."""
    A = l1.astype(jnp.int32)
    B = l2.astype(jnp.int32)
    dx = (-_shift(A, -1) - _shift(B, -1) + _shift(A, 1) + _shift(B, 1)) * 2
    dy = (-_shift(A, -1) - 2 * A - _shift(A, 1)
          + _shift(B, -1) + 2 * B + _shift(B, 1))
    flip = dy < 0
    dy = jnp.where(flip, -dy, dy)
    dx = jnp.where(flip, -dx, dx)

    avg = (A + B + 1) >> 1
    neg = _filters(A, B)   # dx < 0 orientation (line1, line2)
    pos = _filters(B, A)   # dx >= 0 orientation (line2, line1)

    def pick(f, c1, c2, c3, c4):
        return jnp.where(c1, f[0], jnp.where(c2, f[1], jnp.where(
            c3, f[2], jnp.where(c4, f[3], f[4]))))

    v_neg = pick(neg, dx < -2 * dy, dx < -dy, 2 * dx < -dy, 3 * dx < -dy)
    v_pos = pick(pos, dx > 2 * dy, dx > dy, 2 * dx > dy, 3 * dx > dy)
    v = jnp.where((dx == 0) & (dy == 0), avg, jnp.where(dx < 0, v_neg, v_pos))

    # MARGIN=3 borders: plain average (gstivtc.c:456-462)
    w = A.shape[-1]
    col = jnp.arange(w)
    border = (col < 3) | (col >= w - 3)
    v = jnp.where(border, avg, v)
    return jnp.clip(v, 0, 255).astype(jnp.uint8)


def _bpar(frame: jnp.ndarray, parity: jnp.ndarray) -> jnp.ndarray:
    """Broadcast parity against frame's leading (batch) dims."""
    p = jnp.asarray(parity)
    return p.reshape(p.shape + (1,) * (frame.ndim - p.ndim))


def reconstruct_single_luma(frame: jnp.ndarray, parity: jnp.ndarray
                            ) -> jnp.ndarray:
    """reconstruct_single luma plane (gstivtc.c:389-465).
    frame [..., H, W] uint8, parity int32 broadcast over the leading
    dims (0 top / 1 bottom) — batched so the r5 index-plan emission can
    build a whole chunk of output frames in one pass."""
    h = frame.shape[-2]
    up = jnp.concatenate([frame[..., :1, :], frame[..., :-1, :]], axis=-2)
    down = jnp.concatenate([frame[..., 1:, :], frame[..., -1:, :]],
                           axis=-2)
    interp = interp_rows(up, down)
    rows = jnp.arange(h)[:, None]
    keep = (rows % 2) == _bpar(frame, parity)
    mirrored = frame[..., np.array([j ^ 1 for j in range(h)]), :]
    edge = (rows == 0) | (rows == h - 1)
    return jnp.where(keep, frame, jnp.where(edge, mirrored, interp))


def reconstruct_single_chroma(plane: jnp.ndarray, parity: jnp.ndarray
                              ) -> jnp.ndarray:
    """reconstruct_single chroma: plain rounded average
    (gstivtc.c:467-490); batched like reconstruct_single_luma."""
    h = plane.shape[-2]
    up = jnp.concatenate([plane[..., :1, :], plane[..., :-1, :]],
                         axis=-2).astype(jnp.int32)
    down = jnp.concatenate([plane[..., 1:, :], plane[..., -1:, :]],
                           axis=-2).astype(jnp.int32)
    avg = ((up + down + 1) >> 1).astype(jnp.uint8)
    rows = jnp.arange(h)[:, None]
    keep = (rows % 2) == _bpar(plane, parity)
    mirrored = plane[..., np.array([j ^ 1 for j in range(h)]), :]
    edge = (rows == 0) | (rows == h - 1)
    return jnp.where(keep, plane, jnp.where(edge, mirrored, avg))


def weave(top: jnp.ndarray, bottom: jnp.ndarray) -> jnp.ndarray:
    return interleave(top, bottom)
