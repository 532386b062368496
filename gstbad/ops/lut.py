"""Byte LUTs for the reference's per-pixel table loops (coloreffects
tables, chromium's cosine table, solarize's ramp).

A 256-entry u8 table packs into 8 bit-planes x 8 u32 words; `table[idx]`
becomes 7 nested selects (word pick by idx>>5) + a variable shift
(idx & 31) per output bit — ~80 elementwise ops per pixel, gather-free
and fully fusable, and the packing is in-graph so tables built from
dynamic properties never recompile.  Whole-word tables
(`apply_word_table`) are one gather.
"""

from __future__ import annotations

import jax.numpy as jnp


def pack_table(table_u8: jnp.ndarray, nbits: int = 8) -> jnp.ndarray:
    """[..., 256] table with values < 2**nbits -> packed bit planes
    [..., nbits, 8 words] u32.  Leading dims support per-frame tables
    (the controllable-property-curve path).  nbits > 8 packs wider values
    (e.g. the 16-bit dilate luminance keys) at proportional lookup cost."""
    t = table_u8.astype(jnp.uint32)
    lead = t.shape[:-1]
    bits = (t[..., None, :]
            >> jnp.arange(nbits, dtype=jnp.uint32)[:, None]) & 1
    shifts = (jnp.arange(256, dtype=jnp.uint32) % 32)
    words = (bits << shifts).reshape(lead + (nbits, 8, 32)).sum(
        axis=-1, dtype=jnp.uint32)
    return words  # [..., bit, word]


def apply_lut(idx: jnp.ndarray, packed: jnp.ndarray) -> jnp.ndarray:
    """table[idx] for idx int32 in [0, 256); packed from pack_table.

    Flat mask-multiply word select.  Returns uint8 for <=8-bit tables,
    uint32 for wider ones (pack_table nbits > 8).
    """
    hi = (idx >> 5).astype(jnp.int32)
    lo = (idx & 31).astype(jnp.uint32)
    masks = [(hi == j).astype(jnp.uint32) for j in range(8)]
    lead = packed.shape[:-2]  # () or (B,) for per-frame tables
    nbits = packed.shape[-2]

    def word_of(b, j):
        w = packed[..., b, j]
        if lead:
            w = w.reshape(lead + (1,) * (idx.ndim - len(lead)))
        return w

    out = jnp.zeros(idx.shape, jnp.uint32)
    for b in range(nbits):
        word = masks[0] * word_of(b, 0)
        for j in range(1, 8):
            word = word + masks[j] * word_of(b, j)
        out = out | (((word >> lo) & 1) << b)
    return out.astype(jnp.uint8) if nbits <= 8 else out


def apply_lut3(idx: jnp.ndarray, packed3: jnp.ndarray):
    """Three tables on one index (coloreffects RGB columns).
    packed3: [3, 8, 8] u32 -> tuple of 3 uint8 arrays."""
    return tuple(apply_lut(idx, packed3[c]) for c in range(3))


def apply_word_table(idx: jnp.ndarray, table: jnp.ndarray) -> jnp.ndarray:
    """table[idx] for a 256-entry int32-valued table (e.g. a whole packed
    pixel per entry) over an idx plane in [0, 256): one gather."""
    return jnp.take(table.astype(jnp.int32), idx.astype(jnp.int32), axis=0)


# ---------------------------------------------------------------------------
# composed per-byte tables for the gaudieffects/coloreffects math.  Each
# builds the full 256-entry output table in-graph from the dynamic params
# (256-element vector math is free), then pack_table makes it gather-free.
# ---------------------------------------------------------------------------


def burn_table(adjustment: jnp.ndarray) -> jnp.ndarray:
    """gaudi_orc_burn as a byte map (ops/pointops.burn semantics)."""
    c = jnp.arange(256, dtype=jnp.int32)
    adj = adjustment.astype(jnp.int32)
    if adj.ndim:
        adj = adj[..., None]  # per-frame curve -> [B, 256] table
    # divluw saturates the quotient to 255 and yields 255 on /0 — verified
    # against the compiled reference backup (gstgaudieffectsorc-dist.c,
    # "/* 10: divluw */"); the divisor is the low byte of the shifted word.
    a = ((c + adj) >> 1) & 0xFF
    t = (255 - c) << 7
    q = jnp.where(a == 0, 255, jnp.minimum(t // jnp.maximum(a, 1), 255))
    return (255 - q).astype(jnp.uint8)


def chromium_table(edge_a: jnp.ndarray, edge_b: jnp.ndarray,
                   cos_table: jnp.ndarray) -> jnp.ndarray:
    """chromium composed to a byte map: only 256 of the 1024 cosine entries
    are reachable for a given (edge-a, edge-b)."""
    c = jnp.arange(256, dtype=jnp.int32)
    ea = edge_a.astype(jnp.int32)
    eb = edge_b.astype(jnp.int32)
    if ea.ndim:
        ea = ea[..., None]
    if eb.ndim:
        eb = eb[..., None]
    i = (c + ea + (c * eb) // 2) & 1023
    return jnp.clip(jnp.abs(cos_table[i]), 0, 255).astype(jnp.uint8)


def dodge_table() -> jnp.ndarray:
    c = jnp.arange(256, dtype=jnp.int32)
    return jnp.clip((256 * c) // (256 - c), 0, 255).astype(jnp.uint8)


def solarize_table(threshold: jnp.ndarray, start: jnp.ndarray,
                   end: jnp.ndarray) -> jnp.ndarray:
    """solarize's ramp as a byte map with exact C int/uint32 semantics
    (int64 math runs on 256 entries, never per pixel)."""
    threshold = threshold.astype(jnp.int32)
    start = start.astype(jnp.int32)
    end = end.astype(jnp.int32)
    if threshold.ndim or start.ndim or end.ndim:
        threshold, start, end = (v[..., None] for v in jnp.broadcast_arrays(
            threshold, start, end))
    period = jnp.where(end != start, end - start, 1).astype(jnp.int64)
    up_length = jnp.where(threshold != start, threshold - start, 1
                          ).astype(jnp.int64)
    down_length = jnp.where(threshold != end, end - threshold, 1
                            ).astype(jnp.int64)
    c = jnp.arange(256, dtype=jnp.int64)
    param = c + 256 - start.astype(jnp.int64)
    param = param - (param / period).astype(jnp.int64) * period
    M = jnp.int64(0xFFFFFFFF)
    up = ((param * 255) & M) // (up_length & M)
    v = (down_length - (param - up_length)) & M
    down = ((v * 255) & M) // (down_length & M)
    col = jnp.where(param < up_length, up, down)
    return jnp.where(col > 255, 255, col).astype(jnp.uint8)
