"""audiovisualizers (gst/audiovisualizers/) — spectrascope, wavescope,
spacescope, synaescope: audio blocks -> rendered video frames.

wavescope and spacescope transcribe the reference render loops exactly
(gstwavescope.c:214-405, gstspacescope.c:213-400, gstdrawhelpers.h): the
four drawing styles (dots / lines / color-dots / color-lines), the
two-stage resonant filter (gdouble state carried across buffers, a
lax.scan here), the gfloat step interpolation and truncation casts, and
the flat-index x+1/y+1 wraparound of draw_line_aa (writes past the frame
are dropped).  Dots styles are bit-exact vs golden/visualizers; AA line
intensities accumulate-then-saturate instead of the C's per-dot
truncating read-modify-write, a +-few-LSB divergence where taps overlap
(segment joints) — positions are exact.

The base class shade machinery (GstAudioVisualizer in -base's pbutils:
shader + shade-amount, defaults fade / 0x000A0A0A) is implemented for
none|fade|fade-and-move-{up,down,left,right}: each frame starts from the
previous OUTPUT frame with a per-byte saturating subtract of the packed
shade bytes (a lax.scan over the window; the canvas carries across
windows in state).

spectrascope/synaescope transcribe their render loops exactly
(gstspectrascope.c:171-233 bar/column draw incl. the mono-mixdown guint
quirk; gstsynaescope.c:104-311 stars with the colors/shade LUTs and
both border branches) over the scale-faithful gst_fft_s16 model
(ops/ffts16.py + golden/ffts16.py — gst-plugins-base's fixed-point KISS
FFT is not in the reference tree; aggregate per-stage scaling is
reproduced, per-butterfly rounding noise is not, documented).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from gstbad.core.element import Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import AudioFormat, MediaSpec, require
from fractions import Fraction

_SHADERS = ("none", "fade", "fade-and-move-up", "fade-and-move-down",
            "fade-and-move-left", "fade-and-move-right")


class _Scope(Element):
    """Base: audio [B, S, C] -> video [B, H, W, 4] BGRx."""

    PROPERTIES = (
        Property("width", int, 320, 16, 4096, static=True),
        Property("height", int, 240, 16, 4096, static=True),
        Property("shader", str, "fade", static=True,
                 doc="|".join(_SHADERS)),
        Property("shade-amount", int, 0x000A0A0A, 0, 0xFFFFFFFF,
                 static=True),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "audio", f"{self.NAME}: needs audio")
        require(in_spec.format in (AudioFormat.S16, AudioFormat.F32),
                f"{self.NAME}: needs S16/F32")
        require(self.props["shader"] in _SHADERS,
                f"{self.NAME}: unknown shader {self.props['shader']!r}")
        self._audio_spec = in_spec
        return MediaSpec(kind="video", format="BGRx",
                         width=self.props["width"],
                         height=self.props["height"],
                         framerate=Fraction(25, 1))

    def init_state(self, batch: int):
        h, w = self.props["height"], self.props["width"]
        return {"canvas": jnp.zeros((h, w, 4), jnp.uint8)}

    def _s16(self, x):
        if self._audio_spec.format == AudioFormat.S16:
            return x.astype(jnp.int32)
        return jnp.clip(jnp.trunc(x.astype(jnp.float32) * 32768.0),
                        -32768, 32767).astype(jnp.int32)

    def _norm(self, x):
        if self._audio_spec.format == AudioFormat.S16:
            return x.astype(jnp.float32) / 32768.0
        return x.astype(jnp.float32)

    def _shade(self, prev: jnp.ndarray) -> jnp.ndarray:
        """Shaded canvas for the next frame (pbutils shader_fade)."""
        shader = self.props["shader"]
        if shader == "none":
            return jnp.zeros_like(prev)
        amount = self.props["shade-amount"]
        sub = jnp.array([(amount >> (8 * i)) & 0xFF for i in range(4)],
                        jnp.int16)
        faded = jnp.maximum(prev.astype(jnp.int16) - sub[None, None, :],
                            0).astype(jnp.uint8)
        z = jnp.zeros_like(faded)
        if shader == "fade-and-move-up":
            faded = jnp.concatenate([faded[1:], z[:1]], axis=0)
        elif shader == "fade-and-move-down":
            faded = jnp.concatenate([z[:1], faded[:-1]], axis=0)
        elif shader == "fade-and-move-left":
            faded = jnp.concatenate([faded[:, 1:], z[:, :1]], axis=1)
        elif shader == "fade-and-move-right":
            faded = jnp.concatenate([z[:, :1], faded[:, :-1]], axis=1)
        return faded

    def _scan_frames(self, state, data, draw_one, extra_carry=()):
        """Scan over the window's frames: canvas feedback + filter carry.
        draw_one(canvas_u8, adata_frame, *carry) -> (img_u8, *carry)."""
        def body(carry, adata):
            prev, rest = carry[0], carry[1:]
            out = draw_one(self._shade(prev), adata, *rest)
            img, rest = out[0], tuple(out[1:])
            return (img,) + rest, img
        carry0 = (state["canvas"],) + tuple(extra_carry)
        carry, imgs = lax.scan(body, carry0, data)
        new_state = dict(state)
        new_state["canvas"] = carry[0]
        return new_state, imgs, carry[1:]


def _g32(x):
    """Round to gfloat (f32) and return f64 — pins each step of the C's
    float chains to IEEE f32 rounding.  Under jit XLA's
    --xla_allow_excess_precision fuses f32 a+b*c into an FMA whose
    un-rounded product shifts (guint) truncations at exact pixel
    boundaries; explicit value-changing casts block that."""
    return x.astype(jnp.float32).astype(jnp.float64)


def _gfloat_axpy(base, a, scale):
    """trunc(f32(base + f32(a * scale))) as the C computes it: the f64
    product of two f32s is exact, each cast applies the single f32
    rounding the C's gfloat ops do."""
    prod = _g32(a.astype(jnp.float64) * jnp.float64(scale))
    return _g32(jnp.float64(base) + prod).astype(jnp.int32)


def _dots_word(img_flat, x, y, w, limit, word):
    idx = y * w + x
    ok = (idx >= 0) & (idx < limit)
    idx = jnp.where(ok, idx, limit)  # limit -> dropped
    return img_flat.at[idx].set(jnp.int32(word), mode="drop")


def _dots_or(img_flat, x, y, w, limit, word):
    idx = y * w + x
    ok = (idx >= 0) & (idx < limit)
    idx = jnp.where(ok, idx, limit)
    cur = img_flat.at[idx].get(mode="fill", fill_value=0)
    return img_flat.at[idx].set(cur | jnp.int32(word), mode="drop")


def _lines_aa(acc_flat, x1, y1, x2, y2, w, limit, color_word, k_max):
    """Vectorized draw_line_aa: acc_flat [H*W+1, 3] float32 accumulator
    (last row = drop slot), segments [N].  Returns updated accumulator."""
    dx = x2 - x1
    dy = y2 - y1
    j = jnp.maximum(jnp.abs(dx), jnp.abs(dy))  # [N]
    k = jnp.arange(k_max, dtype=jnp.int32)[None, :]
    mask = k < j[:, None]
    f = _g32(k.astype(jnp.float64)
             / jnp.maximum(j, 1)[:, None].astype(jnp.float64))
    rx = _g32(x1[:, None].astype(jnp.float64)
              + _g32(dx[:, None].astype(jnp.float64) * f))
    ry = _g32(y1[:, None].astype(jnp.float64)
              + _g32(dy[:, None].astype(jnp.float64) * f))
    x = rx.astype(jnp.int32)
    y = ry.astype(jnp.int32)
    fx = (rx - x).astype(jnp.float32)
    fy = (ry - y).astype(jnp.float32)
    cb = jnp.array([(color_word >> (8 * c)) & 0xFF for c in range(3)],
                   jnp.float32)
    taps = (
        (0, 0, ((1.0 - fx) + (1.0 - fy)) / 2.0),
        (1, 0, (fx + (1.0 - fy)) / 2.0),
        (0, 1, ((1.0 - fx) + fy) / 2.0),
        (1, 1, (fx + fy) / 2.0),
    )
    for ox, oy, wgt in taps:
        idx = (y + oy) * w + (x + ox)
        ok = mask & (idx >= 0) & (idx < limit)
        idx = jnp.where(ok, idx, limit).reshape(-1)
        add = jnp.where(ok, wgt, 0.0).reshape(-1)[:, None] * cb[None, :]
        acc_flat = acc_flat.at[idx].add(add)
    return acc_flat


def _word_img(img_flat_i32, h, w):
    return lax.bitcast_convert_type(
        img_flat_i32.reshape(h, w)[..., None], jnp.uint8).reshape(h, w, 4)


def _img_word(img_u8):
    h, w, _ = img_u8.shape
    return lax.bitcast_convert_type(img_u8, jnp.int32).reshape(h * w)


@register
class WaveScope(_Scope):
    """wavescope (gstwavescope.c): waveform oscilloscope, styles dots |
    lines | color-dots | color-lines (gstwavescope.c:145-151)."""

    NAME = "wavescope"
    PROPERTIES = _Scope.PROPERTIES + (
        Property("style", str, "dots", static=True,
                 doc="dots | lines | color-dots | color-lines"),)

    def init_state(self, batch: int):
        st = super().init_state(batch)
        st["flt"] = jnp.zeros((6 * self._audio_spec.channels,), jnp.float64)
        return st

    def _filter_scan(self, flt, a):
        """The 2-stage resonant filter (gstwavescope.c:302-310) over one
        frame's samples [S, C] -> per-sample (y0, y1, y2) f64 [S, C]."""
        def step(f, inp):  # f [6, C], inp [C]
            f2 = inp - f[1] * 2.0 - f[0]
            f1 = f[1] + f2 * 0.15
            f0 = f[0] + f1 * 0.15
            f5 = (f1 + f2) - f[4] * 2.0 - f[3]
            f4 = f[4] + f5 * 0.45
            f3 = f[3] + f4 * 0.45
            nf = jnp.stack([f0, f1, f2, f3, f4, f5])
            return nf, (f0, f3, f4 + f5)
        fmat = flt.reshape(self._audio_spec.channels, 6).T
        fmat, ys = lax.scan(step, fmat, a.astype(jnp.float64))
        return fmat.T.reshape(-1), ys

    def process(self, params, state, batch: FrameBatch):
        w, h = self.props["width"], self.props["height"]
        style = self.props["style"]
        limit = h * w
        s = batch.data.shape[1]
        c = batch.data.shape[2]
        adata = self._s16(batch.data)  # [B, S, C]

        if style == "dots":
            dx = jnp.float32(w) / jnp.float32(s)
            dy = jnp.float32(h / 65536.0)
            oy = h // 2
            xs = _g32(jnp.arange(s, dtype=jnp.float64)
                      * dx.astype(jnp.float64)).astype(jnp.int32)

            def draw(canvas, a):
                y = _gfloat_axpy(oy, a, dy)
                img = _img_word(canvas)
                for ch in range(c):
                    img = _dots_word(img, xs, y[:, ch], w, limit, 0x00FFFFFF)
                return (_word_img(img, h, w),)

            state, imgs, _ = self._scan_frames(state, adata, draw)
        elif style == "lines":
            dx = jnp.float32(w - 1) / jnp.float32(s)
            dy = jnp.float32((h - 1) / 65536.0)
            oy = (h - 1) // 2
            xs = _g32(jnp.arange(s, dtype=jnp.float64)
                      * dx.astype(jnp.float64)).astype(jnp.int32)
            xs = xs.at[0].set(0)  # first segment starts at x2=0
            # reference quirk (gstwavescope.c:246-258): y2 is computed
            # from sample 0 and the loop reads adata[s] BEFORE s +=
            # channels — sample 0 enters twice, the last sample never
            shift = jnp.maximum(jnp.arange(s) - 1, 0)

            def draw(canvas, a):
                a = a[shift]
                y = _gfloat_axpy(oy, a, dy)
                acc = jnp.concatenate(
                    [canvas[..., :3].reshape(limit, 3).astype(jnp.float32),
                     jnp.zeros((1, 3), jnp.float32)])
                k_max = max(h, -(-w // s) + 1)
                for ch in range(c):
                    acc = _lines_aa(acc, xs[:-1], y[:-1, ch], xs[1:],
                                    y[1:, ch], w, limit, 0x00FFFFFF, k_max)
                out = jnp.minimum(acc[:limit], 255).astype(jnp.uint8)
                img = jnp.concatenate(
                    [out.reshape(h, w, 3),
                     canvas[..., 3:]], axis=-1)
                return (img,)

            state, imgs, _ = self._scan_frames(state, adata, draw)
        elif style in ("color-dots", "color-lines"):
            lines = style == "color-lines"
            if lines:
                dx = jnp.float32(w - 1) / jnp.float32(s)
                dy = float(np.float32((h - 1) / 65536.0))  # gfloat, f64 math
                oy = (h - 1) // 2
            else:
                dx = jnp.float32(w) / jnp.float32(s)
                dy = float(np.float32(h / 65536.0))
                oy = h // 2
            h1 = h - 2
            xs = _g32(jnp.arange(s, dtype=jnp.float64)
                      * dx.astype(jnp.float64)).astype(jnp.int32)

            def ypix(v):
                iv = jnp.trunc(jnp.float64(oy) + v * dy).astype(jnp.int32)
                return jnp.where(iv < 0, h1, jnp.minimum(iv, h1))

            # color-lines: same pre-increment read quirk as lines; the
            # filter is fed sample 0 twice (gstwavescope.c:371-375)
            shift = jnp.maximum(jnp.arange(s) - 1, 0)

            def draw(canvas, a, flt):
                if lines:
                    a = a[shift]
                flt, (y0, y1, y2) = self._filter_scan(flt, a)
                ys = [ypix(y0), ypix(y1), ypix(y2)]  # each [S, C]
                colors = (0x00FF0000, 0x0000FF00, 0x000000FF)
                if lines:
                    acc = jnp.concatenate(
                        [canvas[..., :3].reshape(limit, 3)
                         .astype(jnp.float32),
                         jnp.zeros((1, 3), jnp.float32)])
                    x1 = xs[:-1].at[0].set(0)
                    k_max = max(h, -(-w // s) + 1)
                    for ch in range(c):
                        for yy, col in zip(ys, colors):
                            acc = _lines_aa(acc, x1, yy[:-1, ch], xs[1:],
                                            yy[1:, ch], w, limit, col,
                                            k_max)
                    out = jnp.minimum(acc[:limit], 255).astype(jnp.uint8)
                    img = jnp.concatenate([out.reshape(h, w, 3),
                                           canvas[..., 3:]], axis=-1)
                else:
                    img = _img_word(canvas)
                    for ch in range(c):
                        for yy, col in zip(ys, colors):
                            img = _dots_or(img, xs, yy[:, ch], w, limit,
                                           col)
                    img = _word_img(img, h, w)
                return (img, flt)

            state, imgs, extra = self._scan_frames(state, adata, draw,
                                                   (state["flt"],))
            state["flt"] = extra[0]
        else:
            raise ValueError(f"wavescope: unknown style {style!r}")
        return state, batch.with_data(imgs)


@register
class SpaceScope(_Scope):
    """spacescope (gstspacescope.c): stereo X-Y scope, styles dots |
    lines | color-dots | color-lines."""

    NAME = "spacescope"
    PROPERTIES = _Scope.PROPERTIES + (
        Property("style", str, "dots", static=True,
                 doc="dots | lines | color-dots | color-lines"),)

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.channels == 2, "spacescope: needs stereo")
        return super().negotiate(in_spec)

    def init_state(self, batch: int):
        st = super().init_state(batch)
        st["flt"] = jnp.zeros((12,), jnp.float64)
        return st

    def _filter_scan(self, flt, a):
        """gstspacescope.c:263-283 stereo filter over [S, 2] samples."""
        def step(f, inp):
            il, ir = inp[0], inp[1]
            l2 = il - f[1] * 2.0 - f[0]
            l1 = f[1] + l2 * 0.15
            l0 = f[0] + l1 * 0.15
            l5 = (l1 + l2) - f[4] * 2.0 - f[3]
            l4 = f[4] + l5 * 0.45
            l3 = f[3] + l4 * 0.45
            r2 = ir - f[7] * 2.0 - f[6]
            r1 = f[7] + r2 * 0.15
            r0 = f[6] + r1 * 0.15
            r5 = (r1 + r2) - f[10] * 2.0 - f[9]
            r4 = f[10] + r5 * 0.45
            r3 = f[9] + r4 * 0.45
            nf = jnp.stack([l0, l1, l2, l3, l4, l5,
                            r0, r1, r2, r3, r4, r5])
            return nf, (l0, r0, l3, r3, l4 + l5, r4 + r5)
        return lax.scan(step, flt, a.astype(jnp.float64))

    def process(self, params, state, batch: FrameBatch):
        w, h = self.props["width"], self.props["height"]
        style = self.props["style"]
        limit = h * w
        adata = self._s16(batch.data)  # [B, S, 2]

        if style == "dots":
            dx = jnp.float32(w / 65536.0)
            dy = jnp.float32(h / 65536.0)
            ox, oy = w // 2, h // 2

            def draw(canvas, a):
                x = _gfloat_axpy(ox, a[:, 0], dx)
                y = _gfloat_axpy(oy, a[:, 1], dy)
                img = _dots_word(_img_word(canvas), x, y, w, limit,
                                 0x00FFFFFF)
                return (_word_img(img, h, w),)

            state, imgs, _ = self._scan_frames(state, adata, draw)
        elif style == "lines":
            dx = jnp.float32((w - 1) / 65536.0)
            dy = jnp.float32((h - 1) / 65536.0)
            ox, oy = (w - 1) // 2, (h - 1) // 2

            def draw(canvas, a):
                x = _gfloat_axpy(ox, a[:, 0], dx)
                y = _gfloat_axpy(oy, a[:, 1], dy)
                acc = jnp.concatenate(
                    [canvas[..., :3].reshape(limit, 3).astype(jnp.float32),
                     jnp.zeros((1, 3), jnp.float32)])
                acc = _lines_aa(acc, x[:-1], y[:-1], x[1:], y[1:], w,
                                limit, 0x00FFFFFF, max(w, h))
                out = jnp.minimum(acc[:limit], 255).astype(jnp.uint8)
                img = jnp.concatenate([out.reshape(h, w, 3),
                                       canvas[..., 3:]], axis=-1)
                return (img,)

            state, imgs, _ = self._scan_frames(state, adata, draw)
        elif style in ("color-dots", "color-lines"):
            lines = style == "color-lines"
            dx = float(np.float32(w / 65536.0))  # gfloat, promoted to f64
            dy = float(np.float32(h / 65536.0))
            ox, oy = w // 2, h // 2
            w1, h1 = w - 2, h - 2

            def clampxy(vx, vy):
                x = jnp.clip(jnp.trunc(jnp.float64(ox) + vx * dx
                                       ).astype(jnp.int32), 0, w1)
                y = jnp.clip(jnp.trunc(jnp.float64(oy) + vy * dy
                                       ).astype(jnp.int32), 0, h1)
                return x, y

            def draw(canvas, a, flt):
                flt, outs = self._filter_scan(flt, a)
                pts = [clampxy(outs[0], outs[1]),
                       clampxy(outs[2], outs[3]),
                       clampxy(outs[4], outs[5])]
                colors = (0x00FF0000, 0x0000FF00, 0x000000FF)
                if lines:
                    acc = jnp.concatenate(
                        [canvas[..., :3].reshape(limit, 3)
                         .astype(jnp.float32),
                         jnp.zeros((1, 3), jnp.float32)])
                    for (x, y), col in zip(pts, colors):
                        acc = _lines_aa(acc, x[:-1], y[:-1], x[1:], y[1:],
                                        w, limit, col, max(w, h))
                    out = jnp.minimum(acc[:limit], 255).astype(jnp.uint8)
                    img = jnp.concatenate([out.reshape(h, w, 3),
                                           canvas[..., 3:]], axis=-1)
                else:
                    img = _img_word(canvas)
                    for (x, y), col in zip(pts, colors):
                        img = _dots_or(img, x, y, w, limit, col)
                    img = _word_img(img, h, w)
                return (img, flt)

            state, imgs, extra = self._scan_frames(state, adata, draw,
                                                   (state["flt"],))
            state["flt"] = extra[0]
        else:
            raise ValueError(f"spacescope: unknown style {style!r}")
        return state, batch.with_data(imgs)


@register
class SpectraScope(_Scope):
    """spectrascope (gstspectrascope.c:126-233): the exact draw loop —
    fdata[1+x]/512.0 in gfloat, y = (guint)(h*sqrt(..)) with h =
    height-1, the 0x00FFFFFF peak overwrite, add_pixel 0x007F7F7F down
    the column plus the doubled bottom-row add — over the scale-faithful
    gst_fft_s16 model (ops/ffts16.py; bit-level FFT divergence
    documented there).  The mono mixdown reproduces the reference's
    guint accumulator with unsigned division (gstspectrascope.c:
    190-203).  req_spf is 2*width samples; each frame renders the first
    2*width samples of its block (zero-padded if the block is shorter)
    — the reference's ring-buffer slide, documented approximation."""

    NAME = "spectrascope"

    def process(self, params, state, batch: FrameBatch):
        from gstbad.ops import ffts16
        w, height = self.props["width"], self.props["height"]
        h = height - 1
        nfft = 2 * w                       # req_spf = num_freq*2 - 2
        data = self._s16(batch.data)       # [B, S, C] int32
        b_, s_, ch = data.shape
        if ch == 1:
            mono = data[..., 0]
        else:
            v = jnp.sum(data.astype(jnp.int64), axis=-1) & 0xFFFFFFFF
            lo = (v // ch) & 0xFFFF        # unsigned div, (gint16) trunc
            mono = jnp.where(lo >= 0x8000, lo - 0x10000, lo
                             ).astype(jnp.int32)
        if s_ >= nfft:
            mono = mono[:, :nfft]
        else:
            mono = jnp.pad(mono, ((0, 0), (0, nfft - s_)))
        fr_, fi_ = ffts16.fft_s16(ffts16.window_hamming(mono))
        fr = fr_[:, 1:w + 1].astype(jnp.float32) / jnp.float32(512.0)
        fi = fi_[:, 1:w + 1].astype(jnp.float32) / jnp.float32(512.0)
        mag2 = fr * fr + fi * fi           # gfloat arithmetic
        y = (h * jnp.sqrt(mag2.astype(jnp.float64))).astype(jnp.int32)
        y = h - jnp.minimum(y, h)          # [B, w]

        rows = jnp.arange(height, dtype=jnp.int32)[None, :, None]
        count = (rows > y[:, None, :]).astype(jnp.int32) \
            + (rows == h).astype(jnp.int32)
        white = rows == y[:, None, :]

        def draw(canvas, cnt, wh):
            bgr = jnp.minimum(canvas[..., :3].astype(jnp.int32)
                              + 0x7F * cnt[..., None], 255)
            img = jnp.concatenate(
                [bgr.astype(jnp.uint8), canvas[..., 3:]], axis=-1)
            # peak pixel: vdata[off] = 0x00FFFFFF (overwrite incl. the
            # x byte; order-equivalent to the C's set-before-add)
            wword = jnp.asarray([255, 255, 255, 0], jnp.uint8)
            return jnp.where(wh[..., None], wword, img)

        def body(carry, inp):
            cnt, wh = inp
            out = draw(self._shade(carry), cnt, wh)
            return out, out

        canvas, imgs = lax.scan(body, state["canvas"], (count, white))
        state = dict(state)
        state["canvas"] = canvas
        return state, batch.with_data(imgs)


_SYNAE_MAXI = 20   # shade decay from 255 reaches 0 in 19 steps


@register
class SynaeScope(_Scope):
    """synaescope (gstsynaescope.c:104-311): the exact stars render —
    per-bin stereo sum/difference magnitudes, clarity from the
    out-of-phase projection, x = r*w/fc, br = b*fc*0.01, the
    colors/shade LUTs (PEAKIFY palette, *200>>8 decay), the star arms
    with the interior (unchecked) vs border (per-direction strict
    bounds) branches, saturating add_pixel accumulation — over the
    scale-faithful gst_fft_s16 model (no window; ops/ffts16.py).  A
    silent bin (ll+rr == 0) is skipped: the reference indexes with the
    0.0/0.0 NaN there — an out-of-bounds write fixed, not reproduced
    (documented, golden/ffts16.py).  Flat-offset semantics (x == w
    wrapping into the next row, bottom guard band cropped) match
    golden/visualizers.py's canvas convention."""

    NAME = "synaescope"

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.channels == 2, "synaescope: needs stereo")
        return super().negotiate(in_spec)

    def prepare(self):
        from gstbad.golden.ffts16 import synaescope_tables
        colors, shade = synaescope_tables()
        cb = np.stack([colors & 0xFF, (colors >> 8) & 0xFF,
                       (colors >> 16) & 0xFF], axis=-1)   # B, G, R
        self._colors = jnp.asarray(cb.astype(np.int32))
        self._shade_lut = jnp.asarray(shade.astype(np.int32))

    def _star_acc(self, fl_r, fl_i, fr_r, fr_i, w, h):
        """One frame's saturating-add contributions as an int32 flat
        accumulation [h*w + w + 2, 3] (add_pixel of non-negative colors
        is order-free: min(base + sum, 255))."""
        from gstbad.golden.ffts16 import SYNAE_SL as sl
        y = jnp.arange(h, dtype=jnp.int32)
        b = h - y
        frl = fl_r[b].astype(jnp.float64)
        fil = fl_i[b].astype(jnp.float64)
        frr = fr_r[b].astype(jnp.float64)
        fir = fr_i[b].astype(jnp.float64)
        ll = (frl + fil) ** 2 + (frr - fir) ** 2
        rr = (frl - fil) ** 2 + (frr + fir) ** 2
        l = jnp.sqrt(ll)
        r = jnp.sqrt(rr)
        tot = ll + rr
        live = tot > 0
        safe = jnp.where(live, tot, 1.0)
        clarity = (((frl + fil) * (frl - fil)
                    + (frr + fir) * (frr - fir)) / safe * 256
                   ).astype(jnp.int32)
        fc = r + l
        x = jnp.where(live, (r * w / jnp.where(live, fc, 1.0)),
                      0.0).astype(jnp.int32)
        br = (b.astype(jnp.float64) * fc * 0.01).astype(jnp.int32)
        br1 = jnp.clip((br * (clarity + 128)) >> 8, 0, 255)
        br2 = jnp.clip((br * (128 - clarity)) >> 8, 0, 255)

        off = y * w + x
        interior = (x > sl - 1) & (x < w - sl) & (y > sl - 1) & (y < h - sl)

        size = h * w + w + 2
        acc = jnp.zeros((size + 1, 3), jnp.int32)   # +1 = dump slot
        cidx = (br1 >> 4) | (br2 & 0xF0)
        ctr = jnp.where(live[:, None], self._colors[cidx], 0)
        acc = acc.at[jnp.where(live, off, size)].add(ctr)

        def arm_step(carry, _):
            acc, s1, s2, i = carry
            active = live & ((s1 | s2) != 0)
            c = jnp.where(active[:, None],
                          self._colors[(s1 >> 4) | (s2 & 0xF0)], 0)
            for idx, chk in (
                    (off - i, x - i > 0),
                    (off + i, x + i < w - 1),
                    (off - i * w, y - i > 0),
                    (off + i * w, y + i < h - 1)):
                ok = active & (interior | chk)
                acc = acc.at[jnp.where(ok, idx, size)].add(c)
            return (acc, self._shade_lut[s1], self._shade_lut[s2],
                    i + 1), None

        (acc, _, _, _), _ = lax.scan(
            arm_step, (acc, br1, br2, jnp.int32(1)), None,
            length=_SYNAE_MAXI)
        return acc[:size]

    def process(self, params, state, batch: FrameBatch):
        from gstbad.ops import ffts16
        w, h = self.props["width"], self.props["height"]
        nfft = 2 * h                       # num_freq = height + 1
        data = self._s16(batch.data)       # [B, S, 2]
        s_ = data.shape[1]
        if s_ >= nfft:
            data = data[:, :nfft]
        else:
            data = jnp.pad(data, ((0, 0), (0, nfft - s_), (0, 0)))
        fl_r, fl_i = ffts16.fft_s16(data[..., 0])   # no window
        fr_r, fr_i = ffts16.fft_s16(data[..., 1])
        accs = jax.vmap(lambda a, b, c, d:
                        self._star_acc(a, b, c, d, w, h)
                        )(fl_r, fl_i, fr_r, fr_i)

        size = h * w + w + 2

        def body(carry, acc):
            shaded = self._shade(carry)
            flat = jnp.zeros((size, 4), jnp.int32)
            flat = flat.at[:h * w].set(
                shaded.reshape(h * w, 4).astype(jnp.int32))
            bgr = jnp.minimum(flat[:, :3] + acc, 255)
            out = jnp.concatenate([bgr, flat[:, 3:]], axis=-1)
            img = out[:h * w].reshape(h, w, 4).astype(jnp.uint8)
            return img, img

        canvas, imgs = lax.scan(body, state["canvas"], accs)
        state = dict(state)
        state["canvas"] = canvas
        return state, batch.with_data(imgs)
