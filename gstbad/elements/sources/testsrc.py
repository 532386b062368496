"""Test sources — videotestsrc / audiotestsrc analogs.

The reference consumes gst-plugins-base's videotestsrc/audiotestsrc in every
launch line and test; these generate batched frames directly on device so
benchmarks aren't host-transfer bound.
"""

from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from gstbad.core.element import Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import MediaSpec, AudioFormat, VideoFormat

# SMPTE-ish color bars in RGB (white, yellow, cyan, green, magenta, red,
# blue, black at 75%)
_BARS_RGB = np.array([
    [191, 191, 191], [191, 191, 0], [0, 191, 191], [0, 191, 0],
    [191, 0, 191], [191, 0, 0], [0, 0, 191], [0, 0, 0]], np.uint8)


def _rgb_to_yuv_bt601(rgb: np.ndarray) -> np.ndarray:
    r, g, b = [rgb[..., i].astype(np.float64) for i in range(3)]
    y = 16 + (65.738 * r + 129.057 * g + 25.064 * b) / 256.0
    u = 128 + (-37.945 * r - 74.494 * g + 112.439 * b) / 256.0
    v = 128 + (112.439 * r - 94.154 * g - 18.285 * b) / 256.0
    return np.stack([y, u, v], -1).round().clip(0, 255).astype(np.uint8)


@register
class VideoTestSrc(Element):
    """Pattern generator.  Patterns: bars (SMPTE-ish), solid-color, ball
    (moving ball, frame-dependent), gradient, checkers, noise, black, white.
    """

    NAME = "videotestsrc"
    KIND = "source"
    PROPERTIES = (
        Property("pattern", str, "bars", static=True),
        Property("format", str, VideoFormat.BGRx, static=True),
        Property("width", int, 320, 1, None, static=True),
        Property("height", int, 240, 1, None, static=True),
        Property("framerate", str, "30/1", static=True),
        Property("foreground-color", int, 0xFFFFFFFF, static=True),
        Property("seed", int, 0, static=True),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        num, _, den = self.props["framerate"].partition("/")
        return MediaSpec(kind="video", format=self.props["format"],
                         width=self.props["width"],
                         height=self.props["height"],
                         framerate=Fraction(int(num), int(den or "1")))

    def prepare(self):
        spec = self.out_spec
        h, w = spec.height, spec.width
        fmt = spec.format
        self._is_ayuv = fmt == VideoFormat.AYUV
        self._is_gray = fmt == VideoFormat.GRAY8
        pattern = self.props["pattern"]
        # static background in RGB
        if pattern in ("bars", "smpte"):
            idx = (np.arange(w) * 8) // w
            rgb = np.broadcast_to(_BARS_RGB[idx][None, :, :], (h, w, 3))
        elif pattern == "gradient":
            g = np.broadcast_to(
                np.linspace(0, 255, w, dtype=np.float64)[None, :], (h, w))
            rgb = np.stack([g, g, g], -1).astype(np.uint8)
        elif pattern == "checkers":
            yy, xx = np.mgrid[:h, :w]
            c = (((yy // 8) + (xx // 8)) % 2) * 255
            rgb = np.stack([c, c, c], -1).astype(np.uint8)
        elif pattern in ("black", "solid-color", "white", "ball", "noise"):
            if pattern == "white":
                color = (255, 255, 255)
            elif pattern == "black" or pattern == "ball" or pattern == "noise":
                color = (0, 0, 0) if pattern != "ball" else (32, 32, 32)
            else:
                fg = self.props["foreground-color"]
                color = ((fg >> 16) & 0xFF, (fg >> 8) & 0xFF, fg & 0xFF)
            rgb = np.broadcast_to(np.array(color, np.uint8)[None, None, :],
                                  (h, w, 3))
        else:
            raise ValueError(f"unknown pattern {pattern!r}")
        self._bg_rgb = np.ascontiguousarray(rgb)
        packed = self._pack(self._bg_rgb)
        if isinstance(packed, dict):
            self._bg = {k: jnp.asarray(v) for k, v in packed.items()}
            self._bg_word = None
            self._ball_word = None
        else:
            self._bg = jnp.asarray(packed)
            self._bg_word = None
            self._ball_word = None
            if packed.ndim == 3 and packed.shape[-1] == 4:
                # packed-u32 word image: broadcasting [H, W] i32 keeps the
                # whole downstream chain in the dense lane layout (a
                # channel-minor [B,H,W,4] u8 broadcast puts 4 of 128 lanes
                # to work and cost ~6 ms/window at 1080p)
                self._bg_word = jnp.asarray(
                    np.ascontiguousarray(packed).view("<i4")[..., 0])
                ball = self._pack(self._bg_rgb)
                if self._is_ayuv:
                    ball[..., 1] = 235   # luma overlay
                else:
                    ball[..., :] = 255   # matches _apply_luma_overlay
                self._ball_word = jnp.asarray(
                    np.ascontiguousarray(ball).view("<i4")[..., 0])

    def _pack(self, rgb: np.ndarray):
        """RGB [H,W,3] -> negotiated format layout."""
        fmt = self.out_spec.format
        h, w = rgb.shape[:2]
        if fmt == VideoFormat.GRAY8:
            yuv = _rgb_to_yuv_bt601(rgb)
            return yuv[..., 0]
        if fmt == VideoFormat.AYUV:
            yuv = _rgb_to_yuv_bt601(rgb)
            out = np.empty((h, w, 4), np.uint8)
            out[..., 0] = 255
            out[..., 1:] = yuv
            return out
        if fmt in (VideoFormat.I420, VideoFormat.YV12):
            yuv = _rgb_to_yuv_bt601(rgb)
            return {"y": yuv[..., 0],
                    "u": yuv[::2, ::2, 1].copy(),
                    "v": yuv[::2, ::2, 2].copy()}
        if fmt == VideoFormat.Y444:
            yuv = _rgb_to_yuv_bt601(rgb)
            return {"y": yuv[..., 0], "u": yuv[..., 1].copy(),
                    "v": yuv[..., 2].copy()}
        if fmt in (VideoFormat.Y42B, VideoFormat.Y41B):
            step = 2 if fmt == VideoFormat.Y42B else 4
            yuv = _rgb_to_yuv_bt601(rgb)
            return {"y": yuv[..., 0], "u": yuv[:, ::step, 1].copy(),
                    "v": yuv[:, ::step, 2].copy()}
        if fmt in VideoFormat.SEMIPLANAR_YUV:
            yuv = _rgb_to_yuv_bt601(rgb)
            u = yuv[::2, ::2, 1]
            v = yuv[::2, ::2, 2]
            first, second = ((u, v) if fmt == VideoFormat.NV12
                             else (v, u))
            uv = np.stack([first, second], axis=-1).reshape(h // 2, w)
            return {"y": yuv[..., 0], "uv": uv.copy()}
        if fmt in VideoFormat.PACKED_YUV422:
            yuv = _rgb_to_yuv_bt601(rgb)
            out = np.empty((h, 2 * w), np.uint8)
            if fmt == VideoFormat.YUY2:
                out[:, 0::2] = yuv[..., 0]
                out[:, 1::4] = yuv[:, ::2, 1]
                out[:, 3::4] = yuv[:, ::2, 2]
            else:
                out[:, 1::2] = yuv[..., 0]
                out[:, 0::4] = yuv[:, ::2, 1]
                out[:, 2::4] = yuv[:, ::2, 2]
            return out
        if fmt in VideoFormat.PACKED_RGB16:
            rs, rb, gs, gb, bs, bb = VideoFormat.rgb16_fields(fmt)
            r = rgb[..., 0].astype(np.uint16)
            g = rgb[..., 1].astype(np.uint16)
            b = rgb[..., 2].astype(np.uint16)
            return ((r >> (8 - rb)) << rs | (g >> (8 - gb)) << gs
                    | (b >> (8 - bb)) << bs).astype(np.uint16)
        r_off, g_off, b_off, x_off = VideoFormat.rgb_offsets(fmt)
        n = VideoFormat.n_channels(fmt)
        out = np.empty((h, w, n), np.uint8)
        out[..., r_off] = rgb[..., 0]
        out[..., g_off] = rgb[..., 1]
        out[..., b_off] = rgb[..., 2]
        if x_off is not None:
            out[..., x_off] = 255
        return out

    def init_state(self, batch: int):
        return jnp.int64(0)  # frame counter

    def generate(self, params, state, window: int):
        spec = self.out_spec
        h, w = spec.height, spec.width
        n = jnp.arange(window, dtype=jnp.int64) + state
        pattern = self.props["pattern"]

        def broadcast(bg):
            if isinstance(bg, dict):
                return {k: jnp.broadcast_to(v, (window,) + v.shape)
                        for k, v in bg.items()}
            return jnp.broadcast_to(bg, (window,) + bg.shape)

        word = None  # packed-u32 twin attached for 4-byte packed formats
        word_base = None  # [1, H, W] base when the twin is a broadcast
        if pattern == "ball":
            # moving bright ball on the static background luma
            t = n.astype(jnp.float64)
            cx = (w / 2.0) + (w / 3.0) * jnp.cos(t * 0.1)
            cy = (h / 2.0) + (h / 3.0) * jnp.sin(t * 0.13)
            yy = jnp.arange(h, dtype=jnp.float64)[None, :, None]
            xx = jnp.arange(w, dtype=jnp.float64)[None, None, :]
            r2 = ((xx - cx[:, None, None]) ** 2
                  + (yy - cy[:, None, None]) ** 2)
            radius = max(4.0, min(h, w) / 16.0)
            mask = r2 < radius * radius
            if self._ball_word is not None:
                word = jnp.where(mask, self._ball_word[None],
                                 self._bg_word[None])
                data = jax.lax.bitcast_convert_type(
                    word[..., None], jnp.uint8).reshape(window, h, w, 4)
            else:
                data = self._apply_luma_overlay(broadcast(self._bg), mask)
        elif pattern == "noise":
            key = jax.random.PRNGKey(self.props["seed"])
            keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(n)
            if isinstance(self._bg, dict):
                data = {
                    "y": jax.vmap(lambda k: jax.random.randint(
                        k, (h, w), 0, 256, jnp.int32).astype(jnp.uint8))(keys),
                }
                for k2, v2 in self._bg.items():
                    if k2 != "y":
                        data[k2] = jnp.full((window,) + v2.shape, 128,
                                            jnp.uint8)
            else:
                shape = self._bg.shape
                data = jax.vmap(lambda k: jax.random.randint(
                    k, shape, 0, 256, jnp.int32).astype(jnp.uint8))(keys)
                if self._is_ayuv:
                    data = data.at[..., 0].set(255)
        elif self._bg_word is not None:
            word = jnp.broadcast_to(self._bg_word, (window, h, w))
            word_base = self._bg_word[None]  # [1, H, W] broadcast base
            data = jax.lax.bitcast_convert_type(
                word[..., None], jnp.uint8).reshape(window, h, w, 4)
        else:
            data = broadcast(self._bg)

        dur = spec.frame_duration_ns
        pts = n * dur
        batch = FrameBatch.make(data, pts=pts)
        if word is not None:
            batch = batch.replace(word=word, word_base=word_base)
        return state + window, batch

    def _apply_luma_overlay(self, data, mask):
        fmt = self.out_spec.format
        if isinstance(data, dict):
            y = jnp.where(mask, jnp.uint8(235), data["y"])
            return {**data, "y": y}
        if self._is_ayuv or fmt in VideoFormat.PACKED_YUV422:
            y = VideoFormat.luma_view(fmt, data)
            return VideoFormat.luma_set(
                fmt, data, jnp.where(mask, jnp.uint8(235), y))
        if self._is_gray:
            return jnp.where(mask, jnp.uint8(235), data)
        if fmt in VideoFormat.PACKED_RGB16:
            rs, rb, gs, gb, bs, bb = VideoFormat.rgb16_fields(fmt)
            white = ((0xFF >> (8 - rb)) << rs | (0xFF >> (8 - gb)) << gs
                     | (0xFF >> (8 - bb)) << bs)
            return jnp.where(mask, jnp.uint16(white), data)
        return jnp.where(mask[..., None], jnp.uint8(255), data)


@register
class AudioTestSrc(Element):
    """Sine/square/silence/white-noise PCM generator, [B, S, C] blocks."""

    NAME = "audiotestsrc"
    KIND = "source"
    PROPERTIES = (
        Property("wave", str, "sine", static=True),
        Property("freq", float, 440.0, static=True),
        Property("volume", float, 0.8, 0.0, 1.0, static=True),
        Property("format", str, AudioFormat.F32, static=True),
        Property("rate", int, 48000, static=True),
        Property("channels", int, 2, 1, 64, static=True),
        Property("samplesperbuffer", int, 1024, 1, None, static=True),
        Property("seed", int, 0, static=True),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        return MediaSpec(kind="audio", format=self.props["format"],
                         rate=self.props["rate"],
                         channels=self.props["channels"])

    def init_state(self, batch: int):
        return jnp.int64(0)  # sample counter

    def generate(self, params, state, window: int):
        spec = self.out_spec
        s = self.props["samplesperbuffer"]
        c = spec.channels
        n0 = state
        idx = (n0 + jnp.arange(window * s, dtype=jnp.int64)
               ).reshape(window, s)
        t = idx.astype(jnp.float64) / spec.rate
        wave = self.props["wave"]
        vol = self.props["volume"]
        if wave == "sine":
            x = vol * jnp.sin(2 * jnp.pi * self.props["freq"] * t)
        elif wave == "square":
            x = vol * jnp.sign(jnp.sin(2 * jnp.pi * self.props["freq"] * t))
        elif wave == "silence":
            x = jnp.zeros_like(t)
        elif wave == "white-noise":
            key = jax.random.PRNGKey(self.props["seed"])
            x = vol * (jax.random.uniform(key, t.shape, jnp.float64) * 2 - 1)
        else:
            raise ValueError(f"unknown wave {wave!r}")
        x = jnp.broadcast_to(x[..., None], (window, s, c))
        fmt = spec.format
        if fmt == AudioFormat.S16:
            data = jnp.clip(x * 32767.0, -32768, 32767).astype(jnp.int16)
        elif fmt == AudioFormat.S32:
            data = jnp.clip(x * 2147483647.0, -2147483648,
                            2147483647).astype(jnp.int32)
        elif fmt == AudioFormat.F64:
            data = x.astype(jnp.float64)
        else:
            data = x.astype(jnp.float32)
        dur = int(1e9 * s / spec.rate)
        pts = (n0 // s + jnp.arange(window, dtype=jnp.int64)) * dur
        return n0 + window * s, FrameBatch.make(data, pts=pts)


@register
class TestSrcBin(Element):
    """testsrcbin (gst/debugutils/gsttestsrcbin.c): wraps
    audiotestsrc/videotestsrc per a stream spec.  The reference is a bin
    exposing one sometimes-pad per stream and is consumed mainly through
    `playbin uri=testbin://...`; here the factory returns the configured
    inner source directly (the pad-proxy analog), so
    `testsrcbin stream-types=video,pattern=ball ! ...` works inline.
    Multi-stream specs (`audio+video`) expand to one chain per stream at
    the session layer — see session/testbin.py testbin_launch and
    Play.from_uri."""

    NAME = "testsrcbin"
    KIND = "source"
    PROPERTIES = (Property("stream-types", str, "video", static=True),)

    def __new__(cls, **props):
        from gstbad.core.registry import make
        from gstbad.session.testbin import parse_testbin_uri
        streams = parse_testbin_uri(
            "testbin://" + str(props.get("stream-types", "video")))
        if len(streams) != 1:
            raise ValueError(
                "testsrcbin: one stream per launch-chain instance; for "
                f"{len(streams)} streams use Play.from_uri('testbin://...') "
                "or session.testbin.testbin_launch")
        kind, sprops = streams[0]
        return make("videotestsrc" if kind == "video" else "audiotestsrc",
                    **sprops)
