"""Golden transcriptions of coloreffects and chromahold.

References: gst/coloreffects/gstcoloreffects.c (LUT paths, fixed-point
YCbCr<->RGB matrices), gst/coloreffects/gstchromahold.c (hue keep).
"""

from __future__ import annotations

import numpy as np

from gstbad.elements.video._coloreffects_tables import TABLES

# gstcoloreffects.c:286-301
COG_YCBCR_TO_RGB_8BIT_SDTV = np.array([
    [298, 0, 409, -57068],
    [298, -100, -208, 34707],
    [298, 516, 0, -70870],
], np.int64)

COG_RGB_TO_YCBCR_8BIT_SDTV = np.array([
    [66, 129, 25, 4096],
    [-38, -74, 112, 32768],
    [112, -94, -18, 32768],
], np.int64)

LUMA_PRESETS = {"heat": True, "sepia": True, "xray": True,
                "xpro": False, "yellowblue": False}


def _apply_matrix(m: np.ndarray, v1, v2, v3):
    """APPLY_MATRIX (gstcoloreffects.c:303-304): gint math with >> 8
    (arithmetic shift = floor division for negatives)."""
    out = []
    for o in range(3):
        acc = (m[o, 0] * v1 + m[o, 1] * v2 + m[o, 2] * v3 + m[o, 3])
        out.append(acc >> 8)
    return out


def coloreffects_rgb(img: np.ndarray, preset: str, rgb_off) -> np.ndarray:
    """gst_color_effects_transform_rgb (gstcoloreffects.c:306-360)."""
    table = TABLES[preset]
    map_luma = LUMA_PRESETS[preset]
    r = img[..., rgb_off[0]].astype(np.int64)
    g = img[..., rgb_off[1]].astype(np.int64)
    b = img[..., rgb_off[2]].astype(np.int64)
    out = img.copy()
    if map_luma:
        # BT.709 fixed point: ((r<<8)*54 + (g<<8)*183 + (b<<8)*19) >> 16
        luma = (((r << 8) * 54) + ((g << 8) * 183) + ((b << 8) * 19)) >> 16
        out[..., rgb_off[0]] = table[luma, 0]
        out[..., rgb_off[1]] = table[luma, 1]
        out[..., rgb_off[2]] = table[luma, 2]
    else:
        out[..., rgb_off[0]] = table[r, 0]
        out[..., rgb_off[1]] = table[g, 1]
        out[..., rgb_off[2]] = table[b, 2]
    return out


def coloreffects_ayuv(img: np.ndarray, preset: str) -> np.ndarray:
    """gst_color_effects_transform_ayuv (gstcoloreffects.c:362-430).

    img is [H, W, 4] in AYUV byte order (A=0, Y=1, U=2, V=3).
    """
    table = TABLES[preset].astype(np.int64)
    map_luma = LUMA_PRESETS[preset]
    y = img[..., 1].astype(np.int64)
    u = img[..., 2].astype(np.int64)
    v = img[..., 3].astype(np.int64)
    out = img.copy()
    if map_luma:
        r, g, b = table[y, 0], table[y, 1], table[y, 2]
    else:
        r, g, b = _apply_matrix(COG_YCBCR_TO_RGB_8BIT_SDTV, y, u, v)
        r = np.clip(r, 0, 255)
        g = np.clip(g, 0, 255)
        b = np.clip(b, 0, 255)
        r, g, b = table[r, 0], table[g, 1], table[b, 2]
    yy, uu, vv = _apply_matrix(COG_RGB_TO_YCBCR_8BIT_SDTV, r, g, b)
    out[..., 1] = np.clip(yy, 0, 255)
    out[..., 2] = np.clip(uu, 0, 255)
    out[..., 3] = np.clip(vv, 0, 255)
    return out


def rgb_to_hue(r, g, b):
    """rgb_to_hue (gstchromahold.c:271-299): fixed-point hue in [0,360),
    or -1 (the gint view of G_MAXUINT) for achromatic pixels."""
    r = np.asarray(r, np.int64)
    g = np.asarray(g, np.int64)
    b = np.asarray(b, np.int64)
    m = np.minimum(np.minimum(r, g), b)
    M = np.maximum(np.maximum(r, g), b)
    C = M - m
    C2 = C >> 1
    Csafe = np.maximum(C, 1)

    def cdiv(a, d):  # C division truncates toward zero
        return (np.sign(a) * (np.abs(a) // d)).astype(np.int64)

    h_r = cdiv(256 * 60 * (g - b) + C2, Csafe)
    h_g = cdiv(256 * 60 * (b - r) + C2, Csafe) + 120 * 256
    h_b = cdiv(256 * 60 * (r - g) + C2, Csafe) + 240 * 256
    h = np.where(M == r, h_r, np.where(M == g, h_g, h_b))
    h = h >> 8  # arithmetic shift (floor)
    h = np.where(h >= 360, h - 360, h)
    h = np.where(h < 0, h + 360, h)
    return np.where(C == 0, -1, h)


def hue_dist(h1, h2):
    """hue_dist (gstchromahold.c:302-316)."""
    d1 = h1 - h2
    d2 = h2 - h1
    d1 = np.where(d1 < 0, d1 + 360, d1)
    d2 = np.where(d2 < 0, d2 + 360, d2)
    return np.minimum(d1, d2)


def chromahold(img: np.ndarray, target_r=255, target_g=0, target_b=0,
               tolerance=30, rgb_off=(2, 1, 0)) -> np.ndarray:
    """gst_chroma_hold_process_xrgb (gstchromahold.c:318-360).

    Pixels whose hue is within `tolerance` of the target hue keep their
    color; others become grey = (13938r + 46869g + 4730b) >> 16.  If the
    target is achromatic (h1 == -1, matching G_MAXUINT in the C compare),
    everything goes grey.
    """
    h1 = int(rgb_to_hue(target_r, target_g, target_b))
    r = img[..., rgb_off[0]].astype(np.int64)
    g = img[..., rgb_off[1]].astype(np.int64)
    b = img[..., rgb_off[2]].astype(np.int64)
    h2 = rgb_to_hue(r, g, b)
    diff = hue_dist(h1, h2)
    grey = np.clip((13938 * r + 46869 * g + 4730 * b) >> 16, 0, 255)
    make_grey = (h1 == -1) | (diff > tolerance)
    out = img.copy()
    out[..., rgb_off[0]] = np.where(make_grey, grey, r).astype(np.uint8)
    out[..., rgb_off[1]] = np.where(make_grey, grey, g).astype(np.uint8)
    out[..., rgb_off[2]] = np.where(make_grey, grey, b).astype(np.uint8)
    return out
