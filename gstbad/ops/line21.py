"""JAX line-21 CEA-608 waveform synth/slice (golden/line21.py is the
spec; ext/closedcaption/io-sim.c + gstline21enc.c/gstline21dec.c are the
reference).

Encode is fully closed-form per sample, so a whole window of caption
lines synthesizes as one [N, 720] elementwise pass; decode samples the
known bit midpoints (static indices) and thresholds at the per-line
mid-range, vectorized over lines.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from gstbad.golden.line21 import (
    BIT_RATE, BLANK, D, H_OFFSET, Q1, Q2, SAMPLES_PER_LINE, SAMPLING_RATE,
    SIGNAL_HIGH, SIGNAL_MEAN, T1, T2, T3, bit_sample_index,
)

_T = H_OFFSET / SAMPLING_RATE + np.arange(SAMPLES_PER_LINE) / SAMPLING_RATE
_IN_CRI = (_T >= T1) & (_T < T2)
_CRI_VAL = np.clip((BLANK + (1.0 - np.cos(Q1 * (_T - T1))) * SIGNAL_MEAN)
                   .astype(np.int32), 0, 255)
_D0 = _T - T3
_BIT = np.where(_D0 < 0, 0, (_D0 * BIT_RATE).astype(np.int64)).astype(
    np.int32)
_DREM = _D0 - _BIT * D
_NEG = _D0 < 0
_RISE = np.clip((BLANK + (1.0 - np.cos(Q2 * _DREM)) * SIGNAL_MEAN)
                .astype(np.int32), 0, 255)
_FALL = np.clip((BLANK + (1.0 + np.cos(Q2 * _DREM)) * SIGNAL_MEAN)
                .astype(np.int32), 0, 255)
_NEAR_EDGE = np.abs(_DREM) < 0.120e-6
_HIGH = min(max(int(SIGNAL_HIGH), 0), 255)
_BIT_IDX = np.asarray([bit_sample_index(j) for j in range(20)], np.int32)


def encode_lines(pairs: jnp.ndarray) -> jnp.ndarray:
    """[N, 2] u8 byte pairs -> [N, 720] u8 waveforms."""
    b0 = pairs[:, 0].astype(jnp.int32)
    b1 = pairs[:, 1].astype(jnp.int32)
    data = (b1 << 12) + (b0 << 4) + 8                  # [N]
    bit = jnp.asarray(_BIT)[None, :]                   # [1, S]
    seq = (data[:, None] >> bit) & 3
    cur = (data[:, None] >> (bit + 1)) & 1             # data & (2 << bit)
    edge = ((seq == 1) | (seq == 2)) & jnp.asarray(_NEAR_EDGE)[None, :]
    edge_val = jnp.where(seq == 1, jnp.asarray(_FALL)[None, :],
                         jnp.asarray(_RISE)[None, :])
    flat = jnp.where(cur == 1, _HIGH, BLANK)
    val = jnp.where(jnp.asarray(_NEG)[None, :], BLANK,
                    jnp.where(edge, edge_val, flat))
    val = jnp.where(jnp.asarray(_IN_CRI)[None, :],
                    jnp.asarray(_CRI_VAL)[None, :], val)
    return val.astype(jnp.uint8)


def decode_lines(lines: jnp.ndarray):
    """[..., 720] u8 -> (found [...], pairs [..., 2] u8)."""
    x = lines.astype(jnp.int32)
    lo = jnp.min(x, axis=-1)
    hi = jnp.max(x, axis=-1)
    thr = (lo + hi).astype(jnp.float32) / 2.0
    samp = x[..., jnp.asarray(_BIT_IDX)]               # [..., 20]
    bits = samp > thr[..., None]
    cri_ok = jnp.ones(lo.shape, bool)
    for k in range(3):
        pk = int(round((T1 + (k + 0.5) * D) * SAMPLING_RATE - H_OFFSET))
        tr = int(round((T1 + (k + 1) * D) * SAMPLING_RATE - H_OFFSET))
        cri_ok = cri_ok & (x[..., pk] > thr) & (x[..., tr] <= thr)
    start_ok = (~bits[..., 0]) & (~bits[..., 1]) & (~bits[..., 2]) \
        & bits[..., 3]
    found = (hi - lo >= 30) & cri_ok & start_ok
    w = bits.astype(jnp.int32)
    b0 = sum(w[..., 4 + k] << k for k in range(8))
    b1 = sum(w[..., 12 + k] << k for k in range(8))
    pairs = jnp.stack([b0, b1], axis=-1).astype(jnp.uint8)
    zero = jnp.zeros_like(pairs)
    return found, jnp.where(found[..., None], pairs, zero)
