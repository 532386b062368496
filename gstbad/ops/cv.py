"""JAX ops for the opencv element family (reference: ext/opencv).

The reference wraps OpenCV; OpenCV itself (cv2, in this environment) is the
fidelity oracle — tests compare these JAX implementations against cv2 calls
directly.  The arithmetic reproduces OpenCV's u8 paths exactly where they
are integer-exact (gray conversion, Sobel saturation, box/gaussian
fixed-point rounding, median/dilate/erode, equalizeHist LUT, Canny), and in
f32 elsewhere (retinex, matchTemplate).

Mapping: separable stencils are shifted-slice adds (small integer
kernels — no gather, no dynamic shapes); morphology is
lax.reduce_window; matchTemplate is lax.conv_general_dilated;
equalizeHist's per-frame LUT rides the bit-plane apply from ops/lut.py.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from gstbad.ops import lut as lut_ops

# ---------------------------------------------------------------------------
# kernels (host-side precompute, numpy)
# ---------------------------------------------------------------------------


def deriv_kernel(order: int, ksize: int) -> np.ndarray:
    """cv::getDerivKernels construction (modules/imgproc/src/deriv.cpp):
    Pascal smoothing [1,1]^(ksize-order-1) convolved with difference
    [-1,1]^order; ksize 1 means the 3-tap kernels without smoothing."""
    if ksize == 1:
        base = {0: [1], 1: [-1, 0, 1], 2: [1, -2, 1]}[order]
        return np.array(base, np.int64)
    k = np.array([1], np.int64)
    for _ in range(ksize - order - 1):
        k = np.convolve(k, [1, 1])
    for _ in range(order):
        k = np.convolve(k, [-1, 1])
    return k


_SMALL_GAUSSIAN = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125,
                 0.21875, 0.109375, 0.03125]),
}


def gaussian_kernel_cv(ksize: int, sigma: float) -> np.ndarray:
    """cv::getGaussianKernel (modules/imgproc/src/smooth.dispatch.cpp):
    fixed small kernels for sigma<=0 & ksize<=7, else exp in double."""
    if sigma <= 0 and ksize <= 7 and ksize in _SMALL_GAUSSIAN:
        return _SMALL_GAUSSIAN[ksize].copy()
    s = sigma if sigma > 0 else 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * s * s))
    return k / k.sum()


# ---------------------------------------------------------------------------
# elementwise building blocks
# ---------------------------------------------------------------------------


def _pad_hw(x: jnp.ndarray, ph: int, pw: int, mode: str) -> jnp.ndarray:
    """Pad H, W of [B, H, W, ...]; 'reflect' == OpenCV BORDER_REFLECT_101,
    'edge' == BORDER_REPLICATE."""
    cfg = [(0, 0), (ph, ph), (pw, pw)] + [(0, 0)] * (x.ndim - 3)
    return jnp.pad(x, cfg, mode=mode)


def _sep_correlate_i32(img: jnp.ndarray, kx: np.ndarray, ky: np.ndarray,
                       mode: str = "reflect") -> jnp.ndarray:
    """Separable integer correlation of [B, H, W] int32 (shifted slices)."""
    rw, rh = len(kx) // 2, len(ky) // 2
    x = _pad_hw(img, 0, rw, mode)
    w = img.shape[2]
    acc = jnp.zeros_like(img)
    for t, c in enumerate(kx):
        if c:
            acc = acc + jnp.int32(int(c)) * lax.slice_in_dim(x, t, t + w, axis=2)
    x = _pad_hw(acc, rh, 0, mode)
    h = img.shape[1]
    acc = jnp.zeros_like(img)
    for t, c in enumerate(ky):
        if c:
            acc = acc + jnp.int32(int(c)) * lax.slice_in_dim(x, t, t + h, axis=1)
    return acc


def rgb2gray_u8(rgb: jnp.ndarray, offsets=(0, 1, 2)) -> jnp.ndarray:
    """cv::cvtColor COLOR_RGB2GRAY u8 fixed point.

    cv2 5.0 uses (19596 R + 38470 G + 7470 B + 2^15) >> 16 — solved
    exhaustively against cv2 output (the sum of weights is exactly 2^16;
    the classic 4899/9617/1868 >> 14 set differs on rounding ties)."""
    r = rgb[..., offsets[0]].astype(jnp.int32)
    g = rgb[..., offsets[1]].astype(jnp.int32)
    b = rgb[..., offsets[2]].astype(jnp.int32)
    return ((19596 * r + 38470 * g + 7470 * b + (1 << 15)) >> 16
            ).astype(jnp.uint8)


def gray2rgb(gray: jnp.ndarray) -> jnp.ndarray:
    """cv::cvtColor COLOR_GRAY2RGB: replicate the channel."""
    return jnp.repeat(gray[..., None], 3, axis=-1)


# ---------------------------------------------------------------------------
# cvsobel / cvlaplace (gstcvsobel.cpp:258-273, gstcvlaplace.cpp:261-280)
# ---------------------------------------------------------------------------


def sobel_i32(gray: jnp.ndarray, dx: int, dy: int, ksize: int) -> jnp.ndarray:
    """cv::Sobel on u8 [B, H, W] -> int32 (unsaturated), reflect101 border.

    ksize=1 selects the unsmoothed 3-tap derivative on the derivative axis
    and [1] on the other (deriv_kernel handles both via its ksize==1 path).
    """
    kx = deriv_kernel(dx, ksize)
    ky = deriv_kernel(dy, ksize)
    return _sep_correlate_i32(gray.astype(jnp.int32), kx, ky)


def sobel_u8(gray: jnp.ndarray, dx: int, dy: int, ksize: int) -> jnp.ndarray:
    """cv::Sobel with ddepth=CV_8U: saturate_cast<uchar> of the int result."""
    return jnp.clip(sobel_i32(gray, dx, dy, ksize), 0, 255).astype(jnp.uint8)


def laplacian_i16(gray: jnp.ndarray, ksize: int) -> jnp.ndarray:
    """cv::Laplacian to CV_16S: ksize==1 uses the fixed 3x3 kernel, else
    Sobel(2,0) + Sobel(0,2); saturates to int16."""
    if ksize == 1:
        k = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.int64)
        x = _pad_hw(gray.astype(jnp.int32), 1, 1, "reflect")
        h, w = gray.shape[1], gray.shape[2]
        acc = jnp.zeros(gray.shape, jnp.int32)
        for i in range(3):
            for j in range(3):
                if k[i, j]:
                    acc = acc + jnp.int32(int(k[i, j])) * lax.dynamic_slice(
                        x, (0, i, j), (gray.shape[0], h, w))
        out = acc
    else:
        out = sobel_i32(gray, 2, 0, ksize) + sobel_i32(gray, 0, 2, ksize)
    return jnp.clip(out, -32768, 32767)


def convert_scale_u8(x: jnp.ndarray, scale: float, shift: float) -> jnp.ndarray:
    """cv::Mat::convertTo(CV_8U, scale, shift): round-half-even + saturate."""
    v = x.astype(jnp.float32) * jnp.float32(scale) + jnp.float32(shift)
    return jnp.clip(jnp.round(v), 0, 255).astype(jnp.uint8)


def apply_mask_rgb(rgb: jnp.ndarray, mask_u8: jnp.ndarray) -> jnp.ndarray:
    """img.copyTo(outimg, mask) onto a zeroed outimg: keep rgb where
    mask != 0, else 0 (gstcvsobel.cpp:267-270)."""
    return jnp.where((mask_u8 != 0)[..., None], rgb, jnp.uint8(0))


# ---------------------------------------------------------------------------
# cvsmooth (gstcvsmooth.cpp:385-430)
# ---------------------------------------------------------------------------


def box_blur_u8(img: jnp.ndarray, kw: int, kh: int) -> jnp.ndarray:
    """cv::blur u8: normalized box sum, floor(mean + 0.5), reflect101.
    img [B, H, W, C]."""
    x = _pad_hw(img.astype(jnp.int32), 0, kw // 2, "reflect")
    w = img.shape[2]
    acc = jnp.zeros(img.shape, jnp.int32)
    for t in range(kw):
        acc = acc + lax.slice_in_dim(x, t, t + w, axis=2)
    x = _pad_hw(acc, kh // 2, 0, "reflect")
    h = img.shape[1]
    acc = jnp.zeros(img.shape, jnp.int32)
    for t in range(kh):
        acc = acc + lax.slice_in_dim(x, t, t + h, axis=1)
    n = kw * kh
    return ((acc * 2 + n) // (2 * n)).astype(jnp.uint8)


def gaussian_blur_u8(img: jnp.ndarray, kw: int, kh: int,
                     sigma: float) -> jnp.ndarray:
    """cv::GaussianBlur u8 bit-exact path: ufixedpoint16 kernel (16
    fractional bits), horizontal pass rounded to 8 fractional bits, final
    (acc + 2^23) >> 24.

    Bit-exact vs cv2 5.0 for the sigma<=0 preset kernels (whose weights are
    exact multiples of 1/256, so the intermediate rounding is exact);
    within 1 LSB for explicit sigma (cv's softdouble kernel generation
    differs from the double-precision formula in the last ulp).
    """
    kxf = gaussian_kernel_cv(kw, sigma)
    kyf = gaussian_kernel_cv(kh if kh > 0 else kw, sigma)
    kx = np.rint(kxf * 65536).astype(np.int64)
    ky = np.rint(kyf * 65536).astype(np.int64)
    rw, rh = len(kx) // 2, len(ky) // 2
    x = _pad_hw(img.astype(jnp.int64), 0, rw, "reflect")
    w = img.shape[2]
    acc = jnp.zeros(img.shape, jnp.int64)
    for t, c in enumerate(kx):
        if c:
            acc = acc + jnp.int64(int(c)) * lax.slice_in_dim(x, t, t + w,
                                                             axis=2)
    acc = (acc + 128) >> 8  # intermediate ufixedpoint16, 8 frac bits
    x = _pad_hw(acc, rh, 0, "reflect")
    h = img.shape[1]
    acc = jnp.zeros(img.shape, jnp.int64)
    for t, c in enumerate(ky):
        if c:
            acc = acc + jnp.int64(int(c)) * lax.slice_in_dim(x, t, t + h,
                                                             axis=1)
    return jnp.clip((acc + (1 << 23)) >> 24, 0, 255).astype(jnp.uint8)


def gaussian_blur_f32(img: jnp.ndarray, ksize: int, sigma: float
                      ) -> jnp.ndarray:
    """cv::GaussianBlur on CV_32F [B, H, W, C], float64 kernel applied in
    f32 separable passes, reflect101 (retinex's blur)."""
    k = gaussian_kernel_cv(ksize, sigma).astype(np.float32)
    r = ksize // 2
    x = _pad_hw(img, 0, r, "reflect")
    w = img.shape[2]
    acc = jnp.zeros(img.shape, jnp.float32)
    for t in range(ksize):
        acc = acc + jnp.float32(k[t]) * lax.slice_in_dim(x, t, t + w, axis=2)
    x = _pad_hw(acc, r, 0, "reflect")
    h = img.shape[1]
    acc = jnp.zeros(img.shape, jnp.float32)
    for t in range(ksize):
        acc = acc + jnp.float32(k[t]) * lax.slice_in_dim(x, t, t + h, axis=1)
    return acc


def median_blur_u8(img: jnp.ndarray, ksize: int) -> jnp.ndarray:
    """cv::medianBlur u8 (BORDER_REPLICATE): sort the kxk neighborhood."""
    r = ksize // 2
    x = _pad_hw(img, r, r, "edge")
    h, w = img.shape[1], img.shape[2]
    taps = [lax.dynamic_slice_in_dim(
        lax.dynamic_slice_in_dim(x, i, h, axis=1), j, w, axis=2)
        for i in range(ksize) for j in range(ksize)]
    stacked = jnp.stack(taps, axis=-1)
    med = jnp.sort(stacked, axis=-1)[..., (ksize * ksize) // 2]
    return med


def bilateral_u8(img: jnp.ndarray, sigma_color: float,
                 sigma_space: float = 0.0, d: int = -1) -> jnp.ndarray:
    """cv::bilateralFilter u8 (gstcvsmooth calls d=-1, sigmaSpace=0):
    sigma_space<=0 -> 1, radius = round(1.5*sigma_space), gaussian color &
    space weights, reflect101.  Float path, matches cv2 within 1 LSB."""
    sc = sigma_color if sigma_color > 0 else 1.0
    ss = sigma_space if sigma_space > 0 else 1.0
    radius = d // 2 if d > 0 else int(np.rint(ss * 1.5))
    radius = max(radius, 1)
    gauss_color = -0.5 / (sc * sc)
    gauss_space = -0.5 / (ss * ss)
    x = _pad_hw(img.astype(jnp.float32), radius, radius, "reflect")
    h, w = img.shape[1], img.shape[2]
    num = jnp.zeros(img.shape, jnp.float32)
    den = jnp.zeros(img.shape[:-1] + (1,), jnp.float32)
    center = img.astype(jnp.float32)
    nch = img.shape[-1]
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            rr = i * i + j * j
            if rr > radius * radius:
                continue  # OpenCV uses the disk within radius
            sw = math.exp(gauss_space * rr)
            nb = lax.dynamic_slice(
                x, (0, i + radius, j + radius, 0),
                (img.shape[0], h, w, nch))
            # color distance = sum of |channel diffs| (OpenCV u8 path)
            cd = jnp.sum(jnp.abs(nb - center), axis=-1, keepdims=True)
            wgt = jnp.float32(sw) * jnp.exp(jnp.float32(gauss_color) * cd * cd)
            num = num + wgt * nb
            den = den + wgt
    out = num / den
    return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# cvdilate / cverode (gstcvdilate.cpp:104-111, gstcverode.cpp)
# ---------------------------------------------------------------------------


def dilate_u8(img: jnp.ndarray, iterations: int) -> jnp.ndarray:
    """cv::dilate default 3x3 rect kernel: iterated max-pool (border
    behaves as replicate for rect max)."""
    x = img
    for _ in range(max(iterations, 1)):
        x = lax.reduce_window(x, jnp.uint8(0), lax.max,
                              (1, 3, 3, 1), (1, 1, 1, 1),
                              [(0, 0), (1, 1), (1, 1), (0, 0)])
    return x


def erode_u8(img: jnp.ndarray, iterations: int) -> jnp.ndarray:
    x = img
    for _ in range(max(iterations, 1)):
        x = lax.reduce_window(x, jnp.uint8(255), lax.min,
                              (1, 3, 3, 1), (1, 1, 1, 1),
                              [(0, 0), (1, 1), (1, 1), (0, 0)])
    return x


# ---------------------------------------------------------------------------
# cvequalizehist (gstcvequalizehist.cpp:117-121)
# ---------------------------------------------------------------------------


def equalize_hist_u8(gray: jnp.ndarray) -> jnp.ndarray:
    """cv::equalizeHist on [B, H, W] u8: per-frame histogram -> LUT.

    OpenCV (histogram.cpp): i0 = first nonzero bin; scale = 255/(N-hist[i0]);
    lut[i0] = 0, lut[i>i0] = round(cumsum(hist[i0+1..i]) * scale); constant
    images pass through.  LUT applied via the gather-free bit-plane path.
    """
    b, h, w = gray.shape
    n = h * w
    flat = gray.reshape(b, n).astype(jnp.int32)
    hist = jax.vmap(lambda f: jnp.zeros(256, jnp.int32).at[f].add(1))(flat)
    nonzero = hist > 0
    i0 = jnp.argmax(nonzero, axis=1)  # first nonzero bin
    h_i0 = jnp.take_along_axis(hist, i0[:, None], axis=1)[:, 0]
    denom = jnp.maximum(n - h_i0, 1)
    scale = 255.0 / denom.astype(jnp.float64)
    csum = jnp.cumsum(hist, axis=1)
    c_i0 = jnp.take_along_axis(csum, i0[:, None], axis=1)
    lut = jnp.round((csum - c_i0).astype(jnp.float64) * scale[:, None])
    lut = jnp.clip(lut, 0, 255).astype(jnp.uint8)
    idx = jnp.arange(256)[None, :]
    lut = jnp.where(idx <= i0[:, None], jnp.uint8(0), lut)
    # constant image: pass through (OpenCV early-outs when N == hist[i0])
    const_frame = (h_i0 == n)[:, None, None]
    packed = lut_ops.pack_table(lut)  # [B, 8, 8] per-frame tables
    out = lut_ops.apply_lut(gray.astype(jnp.int32), packed)
    return jnp.where(const_frame, gray, out)


# ---------------------------------------------------------------------------
# edgedetect: cv::Canny (gstedgedetect.cpp:259-276)
# ---------------------------------------------------------------------------


def canny_u8(gray: jnp.ndarray, threshold1: float, threshold2: float,
             aperture: int, max_hysteresis_iters: int = 64) -> jnp.ndarray:
    """cv::Canny, L1 gradient (L2gradient=false default): Sobel(aperture),
    |gx|+|gy|, OpenCV's fixed-point sector NMS (TG22=13573, canny.cpp),
    double-threshold hysteresis by iterated masked dilation.

    The hysteresis fixpoint loop is bounded by max_hysteresis_iters
    (each iteration extends connectivity by one pixel; real edge chains
    converge in far fewer steps — the bound only caps pathological spirals).
    """
    low = int(min(threshold1, threshold2))
    high = int(max(threshold1, threshold2))
    # Canny's internal Sobel uses BORDER_REPLICATE (opencv canny.cpp), not
    # the standalone Sobel's reflect101 default
    kx1 = deriv_kernel(1, aperture)
    k0 = deriv_kernel(0, aperture)
    gi = gray.astype(jnp.int32)
    gx = _sep_correlate_i32(gi, kx1, k0, mode="edge")
    gy = _sep_correlate_i32(gi, k0, kx1, mode="edge")
    mag = jnp.abs(gx) + jnp.abs(gy)

    # neighbor magnitudes, zero-padded (OpenCV's map border is 0)
    mp = jnp.pad(mag, [(0, 0), (1, 1), (1, 1)])
    h, w = gray.shape[1], gray.shape[2]

    def nb(di, dj):
        return lax.dynamic_slice(mp, (0, 1 + di, 1 + dj),
                                 (gray.shape[0], h, w))

    TG22 = 13573
    xs = jnp.abs(gx).astype(jnp.int64)
    ys = jnp.abs(gy).astype(jnp.int64) << 15
    tg22x = xs * TG22
    tg67x = tg22x + (xs << 16)
    m = mag
    # horizontal sector: a > left && a >= right
    keep_h = (m > nb(0, -1)) & (m >= nb(0, 1))
    # vertical: a > up && a >= down
    keep_v = (m > nb(-1, 0)) & (m >= nb(1, 0))
    # diagonal: sign(gx) == sign(gy) -> main diagonal, else anti
    same_sign = (gx ^ gy) >= 0
    keep_d_main = (m > nb(-1, -1)) & (m > nb(1, 1))
    keep_d_anti = (m > nb(-1, 1)) & (m > nb(1, -1))
    keep_d = jnp.where(same_sign, keep_d_main, keep_d_anti)
    keep = jnp.where(ys < tg22x, keep_h,
                     jnp.where(ys > tg67x, keep_v, keep_d))

    cand = keep & (m > low)
    strong = cand & (m > high)

    def dil(x):
        return lax.reduce_window(x, False, lax.bitwise_or,
                                 (1, 3, 3, 1), (1, 1, 1, 1),
                                 [(0, 0), (1, 1), (1, 1), (0, 0)])

    def body(carry):
        cur, _, it = carry
        grown = dil(cur[..., None])[..., 0] & cand
        return grown, (grown != cur).any(), it + 1

    def cond(carry):
        _, changed, it = carry
        return changed & (it < max_hysteresis_iters)

    final, _, _ = lax.while_loop(cond, body, (strong, jnp.bool_(True),
                                              jnp.int32(0)))
    return jnp.where(final, jnp.uint8(255), jnp.uint8(0))


# ---------------------------------------------------------------------------
# retinex (gstretinex.cpp:333-411)
# ---------------------------------------------------------------------------


def retinex_basic(rgb: jnp.ndarray, sigma: float, gain: float,
                  offset: float) -> jnp.ndarray:
    """METHOD_BASIC: O = gain*(log(I) - log(gauss(I))) + offset, f32,
    filter_size = floor(sigma*6)/2*2+1 (gstretinex.cpp:343-361)."""
    fs = int(math.floor(sigma * 6) / 2) * 2 + 1
    a = rgb.astype(jnp.float32)
    logb = jnp.log(a)
    blurred = gaussian_blur_f32(a, fs, 0.0)
    logc = jnp.log(blurred)
    return convert_scale_u8(logb - logc, gain, offset)


def retinex_multiscale(rgb: jnp.ndarray, scales: int, gain: float,
                       offset: float) -> jnp.ndarray:
    """METHOD_MULTISCALE with the reference's weights 1/scales and sigmas
    10 + 4*scales for every scale (gstretinex.cpp:374-409)."""
    a = rgb.astype(jnp.float32)
    acc = jnp.log(a)
    weight = 1.0 / scales
    sigma_i = 10.0 + 4.0 * scales
    fs = int(math.floor(sigma_i * 6) / 2) * 2 + 1
    for _ in range(scales):
        blurred = gaussian_blur_f32(a, fs, 0.0)
        acc = acc - jnp.float32(weight) * jnp.log(blurred)
    return convert_scale_u8(acc, gain, offset)


# ---------------------------------------------------------------------------
# templatematch: cv::matchTemplate on the MXU (gsttemplatematch.cpp:289-306)
# ---------------------------------------------------------------------------


def match_template(img: jnp.ndarray, templ: jnp.ndarray, method: str
                   ) -> jnp.ndarray:
    """[B, H, W, C] u8 x [th, tw, C] u8 -> [B, H-th+1, W-tw+1] f32 score map.

    CCORR is one lax.conv (MXU); SQDIFF/CCOEFF and the _NORMED variants are
    assembled from CCORR, local box sums and template moments, matching
    cv::matchTemplate's definitions (templmatch.cpp)."""
    b, h, w, c = img.shape
    th, tw, _ = templ.shape
    x = img.astype(jnp.float32)
    t = templ.astype(jnp.float32)
    n = th * tw * c

    # cross-correlation via conv: NHWC x HWIO
    # HIGHEST: the default precision may run the f32 conv in TF32 or
    # bf16 on an accelerator (~1e-3 relative error)
    ccorr = lax.conv_general_dilated(
        x, t[:, :, :, None], (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)[..., 0]
    if method == "ccorr":
        return ccorr

    # exact local sums via f64 integral images (u8 data: integers < 2^53,
    # so cumsum is exact — avoids the f32 cancellation that wrecks ccoeff)
    def box_sums(v):
        ii = jnp.pad(jnp.cumsum(jnp.cumsum(v, axis=1), axis=2),
                     [(0, 0), (1, 0), (1, 0)])
        return (ii[:, th:, tw:] - ii[:, :-th, tw:]
                - ii[:, th:, :-tw] + ii[:, :-th, :-tw])

    n_pix = th * tw
    xd = img.astype(jnp.float64)
    s1c = jnp.stack([box_sums(xd[..., ch]) for ch in range(c)], -1)  # [B,.,.,C]
    s2 = box_sums((xd ** 2).sum(axis=-1))
    td = templ.astype(jnp.float64)
    t_sum_c = jnp.sum(td, axis=(0, 1))            # per-channel (OpenCV
    t_mean_c = t_sum_c / n_pix                    # subtracts means per cn)
    t_sq = jnp.sum(td * td)
    t_var = t_sq - jnp.sum(t_sum_c * t_sum_c) / n_pix

    if method == "sqdiff":
        return (s2 - 2.0 * ccorr.astype(jnp.float64) + t_sq).astype(jnp.float32)
    if method == "ccorr_normed":
        return (ccorr / jnp.sqrt(s2 * t_sq + 1e-30)).astype(jnp.float32)
    if method == "sqdiff_normed":
        return ((s2 - 2.0 * ccorr.astype(jnp.float64) + t_sq)
                / jnp.sqrt(s2 * t_sq + 1e-30)).astype(jnp.float32)
    if method in ("ccoeff", "ccoeff_normed"):
        # per-channel centered template -> single conv, no cancellation
        tc = (td - t_mean_c[None, None, :]).astype(jnp.float32)
        num = lax.conv_general_dilated(
            x, tc[:, :, :, None], (1, 1), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)[..., 0]
        if method == "ccoeff":
            return num
        img_var = s2 - jnp.sum(s1c * s1c, axis=-1) / n_pix
        return (num / jnp.sqrt(jnp.maximum(img_var * t_var, 0) + 1e-30)
                ).astype(jnp.float32)
    raise ValueError(f"unknown matchTemplate method {method!r}")


# ---------------------------------------------------------------------------
# skindetect / motioncells building blocks
# ---------------------------------------------------------------------------


def rgb2hsv_u8(rgb: jnp.ndarray) -> jnp.ndarray:
    """cv::cvtColor COLOR_RGB2HSV u8 fixed point (H in 0..180):
    hsv_shift=12, sdiv/hdiv LUTs — verified bit-exact vs cv2 5.0."""
    r = rgb[..., 0].astype(jnp.int32)
    g = rgb[..., 1].astype(jnp.int32)
    b = rgb[..., 2].astype(jnp.int32)
    v = jnp.maximum(jnp.maximum(r, g), b)
    m = jnp.minimum(jnp.minimum(r, g), b)
    c = v - m
    shift = 12
    idx = np.arange(256)
    sdiv_t = np.zeros(256, np.int64)
    sdiv_t[1:] = np.rint(255 * (1 << shift) / idx[1:])
    hdiv_t = np.zeros(256, np.int64)
    hdiv_t[1:] = np.rint((180 << shift) / (6 * idx[1:]))
    sdiv = jnp.asarray(sdiv_t, jnp.int64)
    hdiv = jnp.asarray(hdiv_t, jnp.int64)
    # 256-entry tables on int values: bit-plane LUTs hold u8 only; these
    # are 20-bit values, so select via where-chains is out — use the packed
    # byte planes trick: split into 3 u8 LUTs
    def lut32(tab, i):
        out = jnp.zeros(i.shape, jnp.int64)
        for byte in range(3):
            t8 = ((tab >> (8 * byte)) & 0xFF).astype(jnp.uint8)
            packed = lut_ops.pack_table(t8)
            out = out | (lut_ops.apply_lut(i, packed).astype(jnp.int64)
                         << (8 * byte))
        return out

    s = (c * lut32(sdiv, v) + (1 << (shift - 1))) >> shift
    hd = lut32(hdiv, c)
    h = jnp.where(v == r, (g - b) * hd,
                  jnp.where(v == g, ((b - r) + 2 * c) * hd,
                            ((r - g) + 4 * c) * hd))
    h = (h + (1 << (shift - 1))) >> shift
    h = jnp.where(h < 0, h + 180, h)
    return jnp.stack([h.astype(jnp.uint8), s.astype(jnp.uint8),
                      v.astype(jnp.uint8)], axis=-1)


def pyr_down_u8(img: jnp.ndarray) -> jnp.ndarray:
    """cv::pyrDown u8: [1,4,6,4,1]/16 separable (fixed point /256 with
    +128 rounding), reflect101, decimate even rows/cols."""
    k = [1, 4, 6, 4, 1]
    x = _pad_hw(img.astype(jnp.int32), 0, 2, "reflect")
    w = img.shape[2]
    acc = jnp.zeros(img.shape, jnp.int32)
    for t, c in enumerate(k):
        acc = acc + c * lax.slice_in_dim(x, t, t + w, axis=2)
    x = _pad_hw(acc, 2, 0, "reflect")
    h = img.shape[1]
    acc = jnp.zeros(img.shape, jnp.int32)
    for t, c in enumerate(k):
        acc = acc + c * lax.slice_in_dim(x, t, t + h, axis=1)
    out = (acc + 128) >> 8
    return jnp.clip(out[:, ::2, ::2], 0, 255).astype(jnp.uint8)


def adaptive_threshold_gaussian_inv(gray: jnp.ndarray, block: int,
                                    c: int, maxval: int = 255) -> jnp.ndarray:
    """cv::adaptiveThreshold(ADAPTIVE_THRESH_GAUSSIAN_C, THRESH_BINARY_INV):
    T = bit-exact u8 gaussian(block, sigma<=0) - c; dst = src > T ? 0 :
    maxval."""
    t = gaussian_blur_u8(gray[..., None], block, block, 0.0)[..., 0]
    keep = gray.astype(jnp.int32) > (t.astype(jnp.int32) - c)
    return jnp.where(keep, jnp.uint8(0), jnp.uint8(maxval))


def threshold_binary(x: jnp.ndarray, thresh, maxval: int = 255,
                     inverse: bool = False) -> jnp.ndarray:
    """cv::threshold THRESH_BINARY / _INV: (x > thresh) selects."""
    above = x.astype(jnp.float32) > jnp.float32(thresh)
    if inverse:
        above = ~above
    return jnp.where(above, jnp.uint8(maxval), jnp.uint8(0))
