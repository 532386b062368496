"""fieldanalysis metrics (gst/fieldanalysis/gstfieldanalysisorc.orc and the
block-scored windowed comb) vectorized.

All metrics follow the ORC semantics: per-sample contributions are kept only
when strictly above the (scaled) noise floor, accumulated in integers per
row and summed in float32.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def _field(frame, parity):
    """Field rows of a [H, W] plane: parity 0 = even rows (top)."""
    return jnp.where(parity == 0, frame[0::2], frame[1::2])


def _sum2(d):
    """Exact whole-plane integer sum: per-row i32 partials (every metric's
    row total fits i32: ssd <= W*255^2 = 8.3e7 at 1280), then i64 over the
    tiny row vector, so 64-bit adds touch one value per row, not one per
    pixel."""
    return jnp.sum(jnp.sum(d, axis=-1, dtype=jnp.int32), dtype=jnp.int64)


def same_parity_sad(f0, p0, f1, p1, noise_floor):
    a = _field(f0, p0).astype(jnp.int32)
    b = _field(f1, p1).astype(jnp.int32)
    d = jnp.abs(a - b)
    d = jnp.where(d > noise_floor, d, 0)
    h, w = f0.shape
    return _sum2(d).astype(jnp.float32) / jnp.float32(0.5 * w * h)


def same_parity_ssd(f0, p0, f1, p1, noise_floor):
    a = _field(f0, p0).astype(jnp.int32)
    b = _field(f1, p1).astype(jnp.int32)
    d = (a - b) * (a - b)
    d = jnp.where(d > noise_floor * noise_floor, d, 0)
    h, w = f0.shape
    return _sum2(d).astype(jnp.float32) / jnp.float32(0.5 * w * h)


def same_parity_3_tap(f0, p0, f1, p1, noise_floor):
    """Horizontal [1,4,1] (gstfieldanalysis.c:898-955; see
    golden.fieldanalysis for the stride-padding caveat)."""
    a = _field(f0, p0).astype(jnp.int32)
    b = _field(f1, p1).astype(jnp.int32)
    nt = noise_floor * 6
    first = jnp.abs((a[:, 0] << 2) + (a[:, 1] << 1)
                    - ((b[:, 0] << 2) + (b[:, 1] << 1)))
    mid = jnp.abs((a[:, :-2] + 4 * a[:, 1:-1] + a[:, 2:])
                  - (b[:, :-2] + 4 * b[:, 1:-1] + b[:, 2:]))
    last = jnp.abs((a[:, -2] << 1) + (a[:, -1] << 2)
                   - ((b[:, -2] << 1) + (b[:, -1] << 2)))
    tot = (_sum2(jnp.where(mid > nt, mid, 0))
           + jnp.sum(jnp.where(first > nt, first, 0), dtype=jnp.int64)
           + jnp.sum(jnp.where(last > nt, last, 0), dtype=jnp.int64))
    h, w = f0.shape
    return tot.astype(jnp.float32) / jnp.float32(3.0 * w * h)


def _interleave_by_parity(f0, p0, f1):
    """Even rows from the parity-selected source (gstfieldanalysis.c:972+)."""
    h = f0.shape[0]
    rows = (jnp.arange(h) % 2)[:, None]
    top_src = jnp.where(p0 == 0, f0, f1)
    bottom_src = jnp.where(p0 == 0, f1, f0)
    return jnp.where(rows == 0, top_src, bottom_src)


def opposite_parity_5_tap(f0, p0, f1, noise_floor):
    """Vertical [1,-3,4,-3,1] around even rows with mirrored boundaries.

    Expressed over the even/odd row planes with static slice shifts
    (no row gathers), which XLA fuses into the reduction.
    For even row c = 2k the taps are E[k-1], O[k-1], E[k], O[k], E[k+1];
    first/last field lines mirror BOTH outer taps (gstfieldanalysis.c:
    1007-1010 first, 1034-1040 last: fjm2,fjm1,fj,fjm1,fjm2)."""
    h, w = f0.shape
    top_src = jnp.where(p0 == 0, f0, f1).astype(jnp.int32)
    bottom_src = jnp.where(p0 == 0, f1, f0).astype(jnp.int32)
    E = top_src[0::2]      # il rows 2k, [h//2, w]
    O = bottom_src[1::2]   # il rows 2k+1
    nt = noise_floor * 6
    # interior k in [1, n-2]: taps E[k-1], O[k-1], E[k], O[k], E[k+1] as
    # pure shifted slices (concat forms materialized 4 full tap arrays)
    v_mid = jnp.abs(E[:-2] - 3 * O[:-2] + 4 * E[1:-1] - 3 * O[1:-1]
                    + E[2:])
    # k=0 mirrors both outer taps to E[1]/O[0]; k=n-1 mirrors the forward
    # taps back to E[n-2]/O[n-2]
    v_first = jnp.abs(2 * E[1] - 6 * O[0] + 4 * E[0])
    v_last = jnp.abs(2 * E[-2] - 6 * O[-2] + 4 * E[-1])
    tot = (_sum2(jnp.where(v_mid > nt, v_mid, 0))
           + jnp.sum(jnp.where(v_first > nt, v_first, 0), dtype=jnp.int64)
           + jnp.sum(jnp.where(v_last > nt, v_last, 0), dtype=jnp.int64))
    return tot.astype(jnp.float32) / jnp.float32(3.0 * w * h)


def _segment_matrix(w_trunc: int, block_width: int) -> np.ndarray:
    """Static 0/1 matrix mapping triple positions to block columns per the
    reference's edge rules (block_score_for_row_*, gstfieldanalysis.c)."""
    n_blocks = w_trunc // block_width
    # triple at i (i in 2..w-1) -> block (i-1)//bw; pair i==1 -> block 0;
    # pair i==w-1 -> block (w-1)//bw (== n_blocks-1)
    m = np.zeros((w_trunc, n_blocks), np.float32)  # indexed by i
    for i in range(2, w_trunc):
        m[i, (i - 1) // block_width] = 1.0
    return m


def windowed_comb(f0, p0, f1, spatial_thresh, block_width, block_height,
                  block_thresh, ignored_lines, interlaced_input: bool):
    """opposite_parity_windowed_comb (gstfieldanalysis.c:1337-1400) with the
    5-tap block scorer; returns 0.0 / 1.0 / 2.0 like the reference."""
    il = _interleave_by_parity(f0, p0, f1).astype(jnp.int32)
    h, w_full = il.shape
    w = w_full - (w_full % block_width)
    il = il[:, :w]
    n_bands = max(0, (h - ignored_lines - block_height) // block_height + 1)
    if n_bands == 0:
        return jnp.float32(0.0)

    # absolute rows for every (band, row-in-band)
    c = (ignored_lines + np.arange(n_bands)[:, None] * block_height
         + np.arange(block_height)[None, :]).reshape(-1)
    rm2 = np.clip(c - 2, 0, h - 1)
    rm1 = np.clip(c - 1, 0, h - 1)
    rp1 = np.where(c + 1 <= h - 1, c + 1, c - 1)
    rp2 = np.where(c + 2 <= h - 1, c + 2, c - 2)
    fj = il[c]
    fjm1 = il[rm1]
    fjp1 = il[rp1]
    diff1 = fj - fjm1
    diff2 = fj - fjp1
    st = spatial_thresh
    dir_ok = ((diff1 > st) & (diff2 > st)) | ((diff1 < -st) & (diff2 < -st))
    five = jnp.abs(il[rm2] + (fj << 2) + il[rp2] - 3 * (fjm1 + fjp1))
    mask = (dir_ok & (five > 6 * st)).astype(jnp.float32)

    # triples at i in [2, w): mask[i-2]*mask[i-1]*mask[i]
    triple = mask[:, :-2] * mask[:, 1:-1] * mask[:, 2:]
    triple = jnp.pad(triple, ((0, 0), (2, 0)))
    seg = jnp.asarray(_segment_matrix(w, block_width))
    scores = triple @ seg  # [bands*bh, n_blocks]
    # edge pairs
    pair_left = mask[:, 0] * mask[:, 1]
    pair_right = mask[:, -2] * mask[:, -1]
    scores = scores.at[:, 0].add(pair_left)
    scores = scores.at[:, -1].add(pair_right)
    scores = scores.reshape(n_bands, block_height, -1).sum(axis=1)
    band_max = jnp.max(scores, axis=-1)  # [bands]
    combed = jnp.any(band_max > block_thresh)
    slightly = jnp.any((band_max > block_thresh // 2)
                       & (band_max <= block_thresh))
    full = jnp.float32(1.0 if interlaced_input else 2.0)
    return jnp.where(combed, full, jnp.where(slightly, 1.0, 0.0))
