"""Per-pixel point ops in JAX — exact int32 transcriptions of the
gaudieffects / coloreffects / videofilters math.

All ops take [..., 4] uint8 (channel order = memory byte order) and return
uint8.  Channel-asymmetric ops take rgb channel indices (static Python ints)
so one traced program serves every packed format.  These are elementwise, so
XLA fuses arbitrary chains of them into one kernel — the whole-graph fusion
the reference cannot do across element threads.

Layout: every op bitcasts the 4xu8 pixel to ONE packed u32 word
([..., H, W], W minor), computes on shift/mask byte planes, and bitcasts
back, so each thread works on whole pixels instead of a 4-wide
channel-minor tail.  Adjacent ops' bitcast pairs cancel under XLA, so
fused chains stay packed end to end.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np
from jax import lax


def _i32(x):
    return x.astype(jnp.int32)


def _per_frame(p, ndim):
    """Broadcast a per-frame [B] param against [B, ...spatial] data."""
    return p.reshape(p.shape + (1,) * (ndim - p.ndim)) if p.ndim else p


def pack32(img: jnp.ndarray) -> jnp.ndarray:
    """[..., 4] uint8 -> packed u32 word [...] (memory byte order:
    byte c of the word == img[..., c] on little-endian)."""
    return lax.bitcast_convert_type(img, jnp.int32).reshape(img.shape[:-1])


def unpack32(p: jnp.ndarray) -> jnp.ndarray:
    """Packed u32 word [...] -> [..., 4] uint8."""
    return lax.bitcast_convert_type(p[..., None], jnp.uint8
                                    ).reshape(p.shape + (4,))


def byte_of(p: jnp.ndarray, c: int) -> jnp.ndarray:
    return (p >> (8 * c)) & 255 if c else p & 255


def repack(bytes_by_channel, passthrough=None, mask: int = 0):
    """Rebuild a packed word from {channel: byte plane}; bytes of
    `passthrough` selected by `mask` (e.g. 0xFF000000) pass unchanged,
    everything else not named is zero (the C codes rebuild the guint32
    word without the fill byte)."""
    out = None
    for c, v in bytes_by_channel.items():
        w = v.astype(jnp.int32) << (8 * c) if c else v.astype(jnp.int32)
        out = w if out is None else out | w
    if passthrough is not None and mask:
        keep = passthrough & jnp.int32(np.int32(np.uint32(mask)))
        out = keep if out is None else out | keep
    return out


def idiv_pos(a: jnp.ndarray, f: jnp.ndarray) -> jnp.ndarray:
    """Truncating a//f for a >= 0, 1 <= f, |a| < 2^22 — integer division
    lowers catastrophically on the VPU (measured 10x an entire op), so:
    f32-reciprocal estimate + one exact int correction step."""
    q = jnp.floor(a.astype(jnp.float32)
                  * (jnp.float32(1.0) / f.astype(jnp.float32))
                  ).astype(jnp.int32)
    r = a - q * f
    return q + jnp.where(r < 0, -1, 0) + jnp.where(r >= f, 1, 0)


def compose_byte_tables(t1: jnp.ndarray, t2: jnp.ndarray) -> jnp.ndarray:
    """Compose two per-channel byte maps [*, 4, 256]: result = t2 after t1.
    256-entry table composition replaces a whole extra per-pixel LUT pass —
    the LUT-chain fusion the Pipeline performs on adjacent byte-map
    elements."""
    t1b, t2b = jnp.broadcast_arrays(t1.astype(jnp.int32),
                                    t2.astype(jnp.int32))
    return jnp.take_along_axis(t2b, t1b, axis=-1)


def apply_byte_tables(img: jnp.ndarray, tables: jnp.ndarray) -> jnp.ndarray:
    """Apply per-channel byte maps [*, 4, 256] to [..., 4] uint8 pixels
    (leading * broadcasts per frame for controllable-curve tables)."""
    from gstbad.ops import lut
    p = pack32(img)
    out = repack({c: lut.apply_lut(byte_of(p, c),
                                   lut.pack_table(tables[..., c, :]))
                  for c in range(4)})
    return unpack32(out)


def identity_table() -> jnp.ndarray:
    return jnp.arange(256, dtype=jnp.int32)


def burn(img: jnp.ndarray, adjustment: jnp.ndarray) -> jnp.ndarray:
    """gaudi_orc_burn (gstgaudieffectsorc.orc:1-26); all 4 bytes processed.
    Evaluated as a composed byte LUT (ops/lut.py) — gather-free."""
    from gstbad.ops import lut
    packed = lut.pack_table(lut.burn_table(adjustment))
    p = pack32(img)
    out = repack({c: lut.apply_lut(byte_of(p, c), packed)
                  for c in range(4)})
    return unpack32(out)


def _lut_rgb_fill(img, packed_table, rgb) -> jnp.ndarray:
    """LUT on the three rgb bytes, fill byte zeroed."""
    from gstbad.ops import lut
    p = pack32(img)
    out = repack({c: lut.apply_lut(byte_of(p, c), packed_table)
                  for c in rgb})
    return unpack32(out)


def chromium(img: jnp.ndarray, edge_a: jnp.ndarray, edge_b: jnp.ndarray,
             cos_table: jnp.ndarray, rgb: Sequence[int], fill: Optional[int]
             ) -> jnp.ndarray:
    """gstchromium.c:315-360 cosine fold; cos_table from
    golden.gaudieffects.chromium_cos_table (int32 [1024])."""
    from gstbad.ops import lut
    return _lut_rgb_fill(
        img, lut.pack_table(lut.chromium_table(edge_a, edge_b, cos_table)),
        rgb)


def dodge(img: jnp.ndarray, rgb: Sequence[int], fill: Optional[int]
          ) -> jnp.ndarray:
    """gstdodge.c:232-255."""
    from gstbad.ops import lut
    return _lut_rgb_fill(img, lut.pack_table(lut.dodge_table()), rgb)


def exclusion_word(p: jnp.ndarray, factor: jnp.ndarray, rgb: Sequence[int]
                   ) -> jnp.ndarray:
    """exclusion on packed words (any shape — pixels or 256-entry tables)."""
    f = _per_frame(factor.astype(jnp.int32), p.ndim)
    r = byte_of(p, rgb[0])
    g = byte_of(p, rgb[1])
    b = byte_of(p, rgb[2])
    rr = f - (idiv_pos((f - r) * (f - r), f) + idiv_pos(g * r, f))
    gg = f - (idiv_pos((f - g) * (f - g), f) + idiv_pos(g * g, f))
    bb = f - (idiv_pos((f - b) * (f - b), f) + idiv_pos(b * b, f))
    return repack({rgb[0]: jnp.clip(rr, 0, 255),
                   rgb[1]: jnp.clip(gg, 0, 255),
                   rgb[2]: jnp.clip(bb, 0, 255)})


def exclusion(img: jnp.ndarray, factor: jnp.ndarray, rgb: Sequence[int],
              fill: Optional[int]) -> jnp.ndarray:
    """gstexclusion.c:257-290 (the green-in-red-term quirk preserved);
    factor is 1..175 (gstexclusion.c:156), dividends < 2^16, so the
    reciprocal division is exact after the correction step."""
    return unpack32(exclusion_word(pack32(img), factor, rgb))


def solarize(img: jnp.ndarray, threshold: jnp.ndarray, start: jnp.ndarray,
             end: jnp.ndarray, rgb: Sequence[int], fill: Optional[int]
             ) -> jnp.ndarray:
    """gstsolarize.c:287-339 as a composed byte LUT (the exact C int/uint32
    wrap semantics run on the 256 table entries, ops/lut.solarize_table)."""
    from gstbad.ops import lut
    return _lut_rgb_fill(
        img, lut.pack_table(lut.solarize_table(threshold, start, end)), rgb)


def dilate(img: jnp.ndarray, erode: jnp.ndarray, rgb: Sequence[int]
           ) -> jnp.ndarray:
    """gstdilate.c:273-350: sequential neighbor propagation over
    down, right, left (the reference's `up` pointer always clamps to self).
    Whole pixels copy (packed words); luminance = 90r + 115g + 51b."""
    p = pack32(img)

    def lum(w):
        return (90 * byte_of(w, rgb[0]) + 115 * byte_of(w, rgb[1])
                + 51 * byte_of(w, rgb[2]))

    # neighbors via edge-replicating shifts on H (axis -2) and W (axis -1)
    down = jnp.concatenate([p[..., 1:, :], p[..., -1:, :]], axis=-2)
    right = jnp.concatenate([p[..., :, 1:], p[..., :, -1:]], axis=-1)
    left = jnp.concatenate([p[..., :, :1], p[..., :, :-1]], axis=-1)

    out = p
    out_lum = lum(p)
    for n in (down, right, left):
        n_lum = lum(n)
        take = jnp.where(_per_frame(erode, n_lum.ndim),
                         n_lum < out_lum, n_lum > out_lum)
        out = jnp.where(take, n, out)
        out_lum = jnp.where(take, n_lum, out_lum)
    return unpack32(out)


def lut_rgb(img: jnp.ndarray, table: jnp.ndarray, map_luma: bool,
            rgb: Sequence[int]) -> jnp.ndarray:
    """coloreffects RGB path (gstcoloreffects.c:306-360); table int32
    [256, 3]; the non-rgb (fill) byte passes through unchanged."""
    from gstbad.ops import lut
    p = pack32(img)
    r = byte_of(p, rgb[0])
    g = byte_of(p, rgb[1])
    b = byte_of(p, rgb[2])
    packed = [lut.pack_table(table[:, c]) for c in range(3)]
    fill_mask = 0xFFFFFFFF ^ sum(0xFF << (8 * c) for c in rgb)
    if map_luma:
        luma = (((r << 8) * 54) + ((g << 8) * 183) + ((b << 8) * 19)) >> 16
        srcs = (luma, luma, luma)
    else:
        srcs = (r, g, b)
    out = repack({rgb[c]: lut.apply_lut(srcs[c], packed[c])
                  for c in range(3)}, passthrough=p, mask=fill_mask)
    return unpack32(out)


_YCBCR2RGB = np.array([[298, 0, 409, -57068],
                       [298, -100, -208, 34707],
                       [298, 516, 0, -70870]], np.int32)
_RGB2YCBCR = np.array([[66, 129, 25, 4096],
                       [-38, -74, 112, 32768],
                       [112, -94, -18, 32768]], np.int32)


def _apply_matrix(m, v1, v2, v3):
    """APPLY_MATRIX (gstcoloreffects.c:303-304) — >> 8 is arithmetic."""
    return [(m[o][0] * v1 + m[o][1] * v2 + m[o][2] * v3 + m[o][3]) >> 8
            for o in range(3)]


def lut_ayuv(img: jnp.ndarray, table: jnp.ndarray, map_luma: bool
             ) -> jnp.ndarray:
    """coloreffects AYUV path (gstcoloreffects.c:362-430); img byte order
    A,Y,U,V; alpha passes through."""
    from gstbad.ops import lut
    p = pack32(img)
    y = byte_of(p, 1)
    u = byte_of(p, 2)
    v = byte_of(p, 3)
    packed = [lut.pack_table(table[:, c]) for c in range(3)]
    if map_luma:
        r, g, b = (lut.apply_lut(y, packed[c]).astype(jnp.int32)
                   for c in range(3))
    else:
        r, g, b = _apply_matrix(_YCBCR2RGB, y, u, v)
        r = lut.apply_lut(jnp.clip(r, 0, 255), packed[0]).astype(jnp.int32)
        g = lut.apply_lut(jnp.clip(g, 0, 255), packed[1]).astype(jnp.int32)
        b = lut.apply_lut(jnp.clip(b, 0, 255), packed[2]).astype(jnp.int32)
    yy, uu, vv = _apply_matrix(_RGB2YCBCR, r, g, b)
    out = repack({1: jnp.clip(yy, 0, 255), 2: jnp.clip(uu, 0, 255),
                  3: jnp.clip(vv, 0, 255)}, passthrough=p, mask=0xFF)
    return unpack32(out)


def rgb_to_hue(r, g, b):
    """gstchromahold.c:271-299 in int32; -1 for achromatic."""
    m = jnp.minimum(jnp.minimum(r, g), b)
    M = jnp.maximum(jnp.maximum(r, g), b)
    C = M - m
    C2 = C >> 1
    Cs = jnp.maximum(C, 1)

    def cdiv(a, d):  # C division truncates toward zero
        return jnp.sign(a) * idiv_pos(jnp.abs(a), d)

    h_r = cdiv(256 * 60 * (g - b) + C2, Cs)
    h_g = cdiv(256 * 60 * (b - r) + C2, Cs) + 120 * 256
    h_b = cdiv(256 * 60 * (r - g) + C2, Cs) + 240 * 256
    h = jnp.where(M == r, h_r, jnp.where(M == g, h_g, h_b))
    h = h >> 8
    h = jnp.where(h >= 360, h - 360, h)
    h = jnp.where(h < 0, h + 360, h)
    return jnp.where(C == 0, -1, h)


def chromahold_word(p: jnp.ndarray, target_hue: jnp.ndarray,
                    tolerance: jnp.ndarray, rgb: Sequence[int]
                    ) -> jnp.ndarray:
    """chromahold on packed words (any shape — pixels or tables)."""
    r = byte_of(p, rgb[0])
    g = byte_of(p, rgb[1])
    b = byte_of(p, rgb[2])
    h1 = _per_frame(target_hue.astype(jnp.int32), p.ndim)
    tolerance = _per_frame(tolerance, p.ndim)
    h2 = rgb_to_hue(r, g, b)
    d1 = h1 - h2
    d2 = h2 - h1
    d1 = jnp.where(d1 < 0, d1 + 360, d1)
    d2 = jnp.where(d2 < 0, d2 + 360, d2)
    diff = jnp.minimum(d1, d2)
    grey = jnp.clip((13938 * r + 46869 * g + 4730 * b) >> 16, 0, 255)
    make_grey = (h1 == -1) | (diff > tolerance.astype(jnp.int32))
    fill_mask = 0xFFFFFFFF ^ sum(0xFF << (8 * c) for c in rgb)
    return repack({rgb[0]: jnp.where(make_grey, grey, r),
                   rgb[1]: jnp.where(make_grey, grey, g),
                   rgb[2]: jnp.where(make_grey, grey, b)},
                  passthrough=p, mask=fill_mask)


def chromahold(img: jnp.ndarray, target_hue: jnp.ndarray,
               tolerance: jnp.ndarray, rgb: Sequence[int]) -> jnp.ndarray:
    """gstchromahold.c:318-360; the fill byte passes through."""
    return unpack32(chromahold_word(pack32(img), target_hue, tolerance, rgb))


def rgb_word_to_ayuv_word(p: jnp.ndarray, offs, has_alpha: bool
                          ) -> jnp.ndarray:
    """Packed-RGB4 word -> AYUV word (videoconvert math on words; the same
    fixed-point SDTV matrix as elements/video/convert._to_ayuv)."""
    r = byte_of(p, offs[0])
    g = byte_of(p, offs[1])
    b = byte_of(p, offs[2])
    a = byte_of(p, offs[3]) if has_alpha else jnp.full_like(p, 255) & 255
    y, u, v = _apply_matrix(_RGB2YCBCR, r, g, b)
    return repack({0: a, 1: jnp.clip(y, 0, 255), 2: jnp.clip(u, 0, 255),
                   3: jnp.clip(v, 0, 255)})


def rgb_word_permute(p: jnp.ndarray, s_off, d_off, src_has_alpha: bool
                     ) -> jnp.ndarray:
    """Packed-RGB4 word -> packed-RGB4 word channel shuffle
    (videoconvert's RGB fast path on words)."""
    out = {d_off[i]: byte_of(p, s_off[i]) for i in range(3)}
    if d_off[3] is not None:
        out[d_off[3]] = (byte_of(p, s_off[3]) if src_has_alpha
                         else jnp.full_like(p, 255) & 255)
    return repack(out)


def zebrastripe(y: jnp.ndarray, y_threshold: jnp.ndarray, t: jnp.ndarray
                ) -> jnp.ndarray:
    """gstzebrastripe.c:205-253 on a luma plane [..., H, W]; t broadcasts
    per frame ([..., 1, 1] for a batch)."""
    h, w = y.shape[-2], y.shape[-1]
    i = jnp.arange(w, dtype=jnp.int32)[None, :]
    j = jnp.arange(h, dtype=jnp.int32)[:, None]
    stripe = ((i + j + t) & 0x4) != 0
    return jnp.where((y >= y_threshold.astype(jnp.uint8)) & stripe,
                     jnp.uint8(16), y)


def videodiff(cur: jnp.ndarray, old: jnp.ndarray, threshold: jnp.ndarray,
              t: jnp.ndarray) -> jnp.ndarray:
    """gstvideodiff.c:91-116 on luma planes."""
    h, w = cur.shape[-2], cur.shape[-1]
    s1 = _i32(old)
    s2 = _i32(cur)
    thr = threshold.astype(jnp.int32)
    moved = (s2 < s1 - thr) | (s2 > s1 + thr)
    i = jnp.arange(w, dtype=jnp.int32)[None, :]
    j = jnp.arange(h, dtype=jnp.int32)[:, None]
    stripe = ((i + j + t) & 0x4) != 0
    return jnp.where(moved,
                     jnp.where(stripe, jnp.uint8(16), jnp.uint8(240)),
                     cur)


def sad(f1: jnp.ndarray, f2: jnp.ndarray) -> jnp.ndarray:
    """orc_sad_nxm_u8 (gstscenechangeorc.orc) over [..., H, W] luma ->
    [...] float64 mean score (gstscenechange.c:146-160)."""
    d = jnp.abs(_i32(f1) - _i32(f2))
    total = jnp.sum(d, axis=(-2, -1), dtype=jnp.int64)
    area = f1.shape[-2] * f1.shape[-1]
    return total.astype(jnp.float64) / area
