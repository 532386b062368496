"""videoconvert — format conversion (the gst-plugins-base videoconvert
dependency every reference launch line assumes).

Conversions use the same fixed-point 8-bit SDTV matrices the in-tree
coloreffects AYUV path uses (gstcoloreffects.c:286-301), so converted
pipelines stay consistent with the in-tree color math.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from gstbad.core.element import Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import MediaSpec, VideoFormat, require
from gstbad.ops.pointops import _apply_matrix, _RGB2YCBCR, _YCBCR2RGB


def _to_ayuv(data, fmt):
    """Any supported format -> AYUV [B, H, W, 4]."""
    if fmt == VideoFormat.AYUV:
        return data
    if fmt == VideoFormat.GRAY8:
        b, h, w = data.shape
        out = jnp.empty((b, h, w, 4), jnp.uint8)
        out = out.at[..., 0].set(255)
        out = out.at[..., 1].set(data)
        out = out.at[..., 2].set(128)
        out = out.at[..., 3].set(128)
        return out
    if fmt in (VideoFormat.I420, VideoFormat.YV12):
        y = data["y"]
        u = jnp.repeat(jnp.repeat(data["u"], 2, axis=-2), 2, axis=-1)
        v = jnp.repeat(jnp.repeat(data["v"], 2, axis=-2), 2, axis=-1)
        u = u[..., :y.shape[-2], :y.shape[-1]]
        v = v[..., :y.shape[-2], :y.shape[-1]]
        out = jnp.stack([jnp.full_like(y, 255), y, u, v], axis=-1)
        return out
    if fmt == VideoFormat.Y444:
        y = data["y"]
        return jnp.stack([jnp.full_like(y, 255), y, data["u"], data["v"]],
                         axis=-1)
    if fmt in (VideoFormat.Y42B, VideoFormat.Y41B):
        rep = 2 if fmt == VideoFormat.Y42B else 4
        y = data["y"]
        u = jnp.repeat(data["u"], rep, axis=-1)[..., :y.shape[-1]]
        v = jnp.repeat(data["v"], rep, axis=-1)[..., :y.shape[-1]]
        return jnp.stack([jnp.full_like(y, 255), y, u, v], axis=-1)
    if fmt in (VideoFormat.NV12, VideoFormat.NV21):
        y = data["y"]
        uv = data["uv"]  # [B, H/2, W] raw interleaved bytes
        c0 = uv[..., 0::2]
        c1 = uv[..., 1::2]
        u2, v2 = (c0, c1) if fmt == VideoFormat.NV12 else (c1, c0)
        u = jnp.repeat(jnp.repeat(u2, 2, axis=-2), 2, axis=-1)
        v = jnp.repeat(jnp.repeat(v2, 2, axis=-2), 2, axis=-1)
        u = u[..., :y.shape[-2], :y.shape[-1]]
        v = v[..., :y.shape[-2], :y.shape[-1]]
        return jnp.stack([jnp.full_like(y, 255), y, u, v], axis=-1)
    if fmt in VideoFormat.PACKED_YUV422:
        # [B, H, 2W] raw line bytes
        if fmt == VideoFormat.YUY2:
            y = data[..., 0::2]
            u2 = data[..., 1::4]
            v2 = data[..., 3::4]
        else:  # UYVY
            y = data[..., 1::2]
            u2 = data[..., 0::4]
            v2 = data[..., 2::4]
        u = jnp.repeat(u2, 2, axis=-1)[..., :y.shape[-1]]
        v = jnp.repeat(v2, 2, axis=-1)[..., :y.shape[-1]]
        return jnp.stack([jnp.full_like(y, 255), y, u, v], axis=-1)
    if fmt in VideoFormat.PACKED_RGB16:
        # 16-bit bit fields -> 8-bit by bit replication (GStreamer
        # video-format.c's RGB16/RGB15 unpack)
        rs, rb, gs, gb, bs, bb = VideoFormat.rgb16_fields(fmt)
        p = data.astype(jnp.int32)

        def expand(shift, bits):
            v = (p >> shift) & ((1 << bits) - 1)
            return (v << (8 - bits)) | (v >> (2 * bits - 8))
        r, g, b = expand(rs, rb), expand(gs, gb), expand(bs, bb)
        y, u, v = _apply_matrix(_RGB2YCBCR, r, g, b)
        return jnp.stack([jnp.full_like(y, 255).astype(jnp.uint8),
                          jnp.clip(y, 0, 255).astype(jnp.uint8),
                          jnp.clip(u, 0, 255).astype(jnp.uint8),
                          jnp.clip(v, 0, 255).astype(jnp.uint8)], axis=-1)
    if fmt == VideoFormat.ARGB64:
        # 16 -> 8 bit per component: high byte (GStreamer's ARGB64
        # unpack v >> 8), then the usual RGB->YCbCr
        p = (data.astype(jnp.int32) >> 8)
        a8 = p[..., 0].astype(jnp.uint8)
        y, u, v = _apply_matrix(_RGB2YCBCR, p[..., 1], p[..., 2],
                                p[..., 3])
        return jnp.stack([a8,
                          jnp.clip(y, 0, 255).astype(jnp.uint8),
                          jnp.clip(u, 0, 255).astype(jnp.uint8),
                          jnp.clip(v, 0, 255).astype(jnp.uint8)], axis=-1)
    # packed RGB
    offs = VideoFormat.rgb_offsets(fmt)
    r = data[..., offs[0]].astype(jnp.int32)
    g = data[..., offs[1]].astype(jnp.int32)
    b = data[..., offs[2]].astype(jnp.int32)
    a = (data[..., offs[3]] if VideoFormat.has_alpha(fmt)
         else jnp.full_like(data[..., 0], 255))
    y, u, v = _apply_matrix(_RGB2YCBCR, r, g, b)
    return jnp.stack([a,
                      jnp.clip(y, 0, 255).astype(jnp.uint8),
                      jnp.clip(u, 0, 255).astype(jnp.uint8),
                      jnp.clip(v, 0, 255).astype(jnp.uint8)], axis=-1)


def _sub420(c):
    """2x2 rounded average subsample of a chroma plane."""
    c = c.astype(jnp.uint16)
    return ((c[..., ::2, ::2] + c[..., ::2, 1::2] + c[..., 1::2, ::2]
             + c[..., 1::2, 1::2] + 2) >> 2).astype(jnp.uint8)


def _sub422(c):
    """2x1 rounded average horizontal subsample."""
    c = c.astype(jnp.uint16)
    return ((c[..., 0::2] + c[..., 1::2] + 1) >> 1).astype(jnp.uint8)


def _from_ayuv(ayuv, fmt):
    if fmt == VideoFormat.AYUV:
        return ayuv
    if fmt == VideoFormat.GRAY8:
        return ayuv[..., 1]
    if fmt in (VideoFormat.I420, VideoFormat.YV12):
        return {"y": ayuv[..., 1], "u": _sub420(ayuv[..., 2]),
                "v": _sub420(ayuv[..., 3])}
    if fmt == VideoFormat.Y444:
        return {"y": ayuv[..., 1], "u": ayuv[..., 2], "v": ayuv[..., 3]}
    if fmt == VideoFormat.Y42B:
        return {"y": ayuv[..., 1], "u": _sub422(ayuv[..., 2]),
                "v": _sub422(ayuv[..., 3])}
    if fmt == VideoFormat.Y41B:
        def sub4(c):
            c = c.astype(jnp.uint16)
            return ((c[..., 0::4] + c[..., 1::4] + c[..., 2::4]
                     + c[..., 3::4] + 2) >> 2).astype(jnp.uint8)
        return {"y": ayuv[..., 1], "u": sub4(ayuv[..., 2]),
                "v": sub4(ayuv[..., 3])}
    if fmt in (VideoFormat.NV12, VideoFormat.NV21):
        u = _sub420(ayuv[..., 2])
        v = _sub420(ayuv[..., 3])
        first, second = ((u, v) if fmt == VideoFormat.NV12 else (v, u))
        uv = jnp.stack([first, second], axis=-1)
        return {"y": ayuv[..., 1],
                "uv": uv.reshape(uv.shape[:-2] + (uv.shape[-2] * 2,))}
    if fmt in VideoFormat.PACKED_YUV422:
        y = ayuv[..., 1]
        u = _sub422(ayuv[..., 2])
        v = _sub422(ayuv[..., 3])
        b, h, w = y.shape
        out = jnp.empty((b, h, 2 * w), jnp.uint8)
        if fmt == VideoFormat.YUY2:
            out = out.at[..., 0::2].set(y)
            out = out.at[..., 1::4].set(u)
            out = out.at[..., 3::4].set(v)
        else:  # UYVY
            out = out.at[..., 1::2].set(y)
            out = out.at[..., 0::4].set(u)
            out = out.at[..., 2::4].set(v)
        return out
    if fmt in VideoFormat.PACKED_RGB16:
        y = ayuv[..., 1].astype(jnp.int32)
        u = ayuv[..., 2].astype(jnp.int32)
        v = ayuv[..., 3].astype(jnp.int32)
        r, g, b = _apply_matrix(_YCBCR2RGB, y, u, v)
        rs, rb, gs, gb, bs, bb = VideoFormat.rgb16_fields(fmt)
        p = ((jnp.clip(r, 0, 255) >> (8 - rb)) << rs
             | (jnp.clip(g, 0, 255) >> (8 - gb)) << gs
             | (jnp.clip(b, 0, 255) >> (8 - bb)) << bs)
        return p.astype(jnp.uint16)
    if fmt == VideoFormat.ARGB64:
        y = ayuv[..., 1].astype(jnp.int32)
        u = ayuv[..., 2].astype(jnp.int32)
        v = ayuv[..., 3].astype(jnp.int32)
        r, g, b = _apply_matrix(_YCBCR2RGB, y, u, v)
        # 8 -> 16 bit: v * 257 = (v << 8) | v (GStreamer's pack)
        return (jnp.stack([ayuv[..., 0].astype(jnp.int32),
                           jnp.clip(r, 0, 255), jnp.clip(g, 0, 255),
                           jnp.clip(b, 0, 255)], axis=-1)
                * 257).astype(jnp.uint16)
    # packed RGB
    y = ayuv[..., 1].astype(jnp.int32)
    u = ayuv[..., 2].astype(jnp.int32)
    v = ayuv[..., 3].astype(jnp.int32)
    r, g, b = _apply_matrix(_YCBCR2RGB, y, u, v)
    offs = VideoFormat.rgb_offsets(fmt)
    n = VideoFormat.n_channels(fmt)
    out = jnp.empty(ayuv.shape[:-1] + (n,), jnp.uint8)
    out = out.at[..., offs[0]].set(jnp.clip(r, 0, 255).astype(jnp.uint8))
    out = out.at[..., offs[1]].set(jnp.clip(g, 0, 255).astype(jnp.uint8))
    out = out.at[..., offs[2]].set(jnp.clip(b, 0, 255).astype(jnp.uint8))
    if offs[3] is not None:
        out = out.at[..., offs[3]].set(ayuv[..., 0])
    return out


_ALL = (VideoFormat.PACKED_RGB4 + VideoFormat.PACKED_RGB3
        + VideoFormat.PACKED_RGB16 + (VideoFormat.ARGB64,)
        + (VideoFormat.AYUV, VideoFormat.GRAY8)
        + VideoFormat.PLANAR_YUV + VideoFormat.SEMIPLANAR_YUV
        + VideoFormat.PACKED_YUV422)


@register
class VideoConvert(Element):
    NAME = "videoconvert"
    PROPERTIES = (Property("format", str, VideoFormat.AYUV, static=True),)

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "video", "videoconvert: needs video")
        require(in_spec.format in _ALL,
                f"videoconvert: unsupported source {in_spec.format}")
        require(self.props["format"] in _ALL,
                f"videoconvert: unsupported target {self.props['format']}")
        dst = self.props["format"]
        if dst in (VideoFormat.I420, VideoFormat.YV12) \
                or dst in VideoFormat.SEMIPLANAR_YUV:
            require(in_spec.width % 2 == 0 and in_spec.height % 2 == 0,
                    f"videoconvert: {dst} needs even dimensions")
        elif dst == VideoFormat.Y42B or dst in VideoFormat.PACKED_YUV422:
            require(in_spec.width % 2 == 0,
                    f"videoconvert: {dst} needs even width")
        elif dst == VideoFormat.Y41B:
            require(in_spec.width % 4 == 0,
                    "videoconvert: Y41B needs width % 4 == 0")
        return in_spec.with_(format=dst)

    def process(self, params, state, batch: FrameBatch):
        src = self.in_spec.format
        dst = self.out_spec.format
        if src == dst:
            return state, batch
        data = batch.data
        # 16-bit RGB <-> 8-bit RGB stay in the RGB domain (no YUV round
        # trip): bit-replicate expansion / truncating field pack
        if (src in VideoFormat.PACKED_RGB16
                or dst in VideoFormat.PACKED_RGB16) \
                and (VideoFormat.is_rgb(src)
                     or src in VideoFormat.PACKED_RGB16) \
                and (VideoFormat.is_rgb(dst)
                     or dst in VideoFormat.PACKED_RGB16):
            if src in VideoFormat.PACKED_RGB16:
                rs, rb, gs, gb, bs, bb = VideoFormat.rgb16_fields(src)
                p = data.astype(jnp.int32)

                def expand(shift, bits):
                    v = (p >> shift) & ((1 << bits) - 1)
                    return (v << (8 - bits)) | (v >> (2 * bits - 8))
                r, g, b = expand(rs, rb), expand(gs, gb), expand(bs, bb)
                a = jnp.full_like(r, 255)
            else:
                offs = VideoFormat.rgb_offsets(src)
                r = data[..., offs[0]].astype(jnp.int32)
                g = data[..., offs[1]].astype(jnp.int32)
                b = data[..., offs[2]].astype(jnp.int32)
                a = (data[..., offs[3]].astype(jnp.int32)
                     if VideoFormat.has_alpha(src)
                     else jnp.full_like(r, 255))
            if dst in VideoFormat.PACKED_RGB16:
                rs, rb, gs, gb, bs, bb = VideoFormat.rgb16_fields(dst)
                p = ((r >> (8 - rb)) << rs | (g >> (8 - gb)) << gs
                     | (b >> (8 - bb)) << bs)
                return state, batch.with_data(p.astype(jnp.uint16))
            offs = VideoFormat.rgb_offsets(dst)
            n = VideoFormat.n_channels(dst)
            out = jnp.empty(r.shape + (n,), jnp.uint8)
            for i, ch in enumerate((r, g, b)):
                out = out.at[..., offs[i]].set(ch.astype(jnp.uint8))
            if offs[3] is not None:
                out = out.at[..., offs[3]].set(a.astype(jnp.uint8))
            return state, batch.with_data(out)
        # ARGB64 <-> 8-bit packed RGB stay in the RGB domain: high-byte
        # truncation down, (v << 8) | v expansion up (GStreamer's
        # ARGB64 pack/unpack), no YUV round trip
        if src == VideoFormat.ARGB64 and VideoFormat.is_rgb(dst):
            p = (data.astype(jnp.int32) >> 8).astype(jnp.uint8)
            offs = VideoFormat.rgb_offsets(dst)
            n = VideoFormat.n_channels(dst)
            out = jnp.empty(data.shape[:-1] + (n,), jnp.uint8)
            for i in range(3):
                out = out.at[..., offs[i]].set(p[..., 1 + i])
            if offs[3] is not None:
                out = out.at[..., offs[3]].set(p[..., 0])
            return state, batch.with_data(out)
        if VideoFormat.is_rgb(src) and dst == VideoFormat.ARGB64:
            offs = VideoFormat.rgb_offsets(src)
            r = data[..., offs[0]].astype(jnp.int32)
            g = data[..., offs[1]].astype(jnp.int32)
            b = data[..., offs[2]].astype(jnp.int32)
            a = (data[..., offs[3]].astype(jnp.int32)
                 if VideoFormat.has_alpha(src) else jnp.full_like(r, 255))
            return state, batch.with_data(
                (jnp.stack([a, r, g, b], axis=-1) * 257)
                .astype(jnp.uint16))
        # pure packed-RGB permutation fast path
        if VideoFormat.is_rgb(src) and VideoFormat.is_rgb(dst):
            s_off = VideoFormat.rgb_offsets(src)
            d_off = VideoFormat.rgb_offsets(dst)
            n = VideoFormat.n_channels(dst)
            out = jnp.empty(data.shape[:-1] + (n,), jnp.uint8)
            for i in range(3):
                out = out.at[..., d_off[i]].set(data[..., s_off[i]])
            if d_off[3] is not None:
                alpha = (data[..., s_off[3]] if VideoFormat.has_alpha(src)
                         else jnp.full_like(data[..., 0], 255))
                out = out.at[..., d_off[3]].set(alpha)
            return state, batch.with_data(out)
        return state, batch.with_data(_from_ayuv(_to_ayuv(data, src), dst))

    def word_map(self, params):
        """Packed-4 -> packed-4 conversions are pure word functions, so the
        table-fusion pass can run them on 256-entry tables."""
        from gstbad.ops import pointops
        src = self.in_spec.format
        dst = self.out_spec.format
        if src == dst:
            return lambda w: w
        if not (VideoFormat.is_rgb(src)
                and src in VideoFormat.PACKED_RGB4):
            return None
        s_off = VideoFormat.rgb_offsets(src)
        has_a = VideoFormat.has_alpha(src)
        if dst == VideoFormat.AYUV:
            return lambda w: pointops.rgb_word_to_ayuv_word(w, s_off, has_a)
        if VideoFormat.is_rgb(dst) and dst in VideoFormat.PACKED_RGB4:
            d_off = VideoFormat.rgb_offsets(dst)
            return lambda w: pointops.rgb_word_permute(w, s_off, d_off,
                                                       has_a)
        return None
