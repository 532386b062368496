"""lcms — ICC color correction (reference: ext/colormanagement/gstlcms.c).

The reference builds an lcms2 transform between two ICC profiles (defaults:
sRGB for both ends, gstlcms.c:429,616) and runs it per pixel — with an
optional precalculated 2^24-entry LUT (gst_lcms_init_lookup_table:505-530).

Device form: matrix/TRC profiles decompose into per-channel decode
curves -> 3x3 PCS matrix -> per-channel encode curves.  The decode curves
fold into three 256-entry f32 LUTs applied gather-free (bit planes); the
matrix is one fused f32 matmul; encode curves evaluate in closed form for
gamma/parametric TRCs (table TRCs via a dense host-built inverse +
jnp.interp).  Fidelity vs lcms2 (PIL.ImageCms, the oracle in tests): ±1 —
lcms runs a 16-bit fixed-point pipeline internally.

The lookup property is accepted for launch-line compatibility and ignored:
every mode here is "precalculated" by construction (the curves/matrix ARE
the transform; there is no 16 M-entry cache to manage).  embedded-profile
is accepted and ignored (no container metadata path carries ICC blobs in
this framework yet).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from gstbad.core.element import Property, VideoFilter
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import VideoFormat
from gstbad.io import icc
from gstbad.ops import lut as lut_ops

_INTENTS = ("perceptual", "relative", "saturation", "absolute")


def _apply_f32_lut(idx: jnp.ndarray, table: np.ndarray) -> jnp.ndarray:
    """256-entry f32 table lookup via 4 byte-plane LUTs + bitcast."""
    raw = np.ascontiguousarray(table.astype(np.float32)).view(np.uint8)
    raw = raw.reshape(256, 4)
    out = jnp.zeros(idx.shape, jnp.uint32)
    for byte in range(4):
        packed = lut_ops.pack_table(jnp.asarray(raw[:, byte]))
        out = out | (lut_ops.apply_lut(idx, packed).astype(jnp.uint32)
                     << (8 * byte))
    from jax import lax
    return lax.bitcast_convert_type(out, jnp.float32)


def _encode_jnp(curve: icc.Curve, y: jnp.ndarray) -> jnp.ndarray:
    """Inverse TRC (linear -> encoded) in-graph."""
    y = jnp.clip(y, 0.0, 1.0)
    if curve.kind == "gamma":
        return jnp.power(y, jnp.float32(1.0 / curve.gamma))
    if curve.kind == "para":
        g = curve.params[0]
        if curve.para_type == 0:
            return jnp.power(y, jnp.float32(1.0 / g))
        if curve.para_type == 1:
            _, a, b = curve.params
            return (jnp.power(y, jnp.float32(1 / g)) - b) / a
        if curve.para_type == 2:
            _, a, b, c = curve.params
            return (jnp.power(jnp.maximum(y - c, 0), jnp.float32(1 / g))
                    - b) / a
        if curve.para_type == 3:
            _, a, b, c, d = curve.params
            knee = c * d
            lin = y / max(c, 1e-12)
            pw = (jnp.power(y, jnp.float32(1.0 / g)) - b) / a
            return jnp.where(y >= knee, pw, lin)
        if curve.para_type == 4:
            _, a, b, c, d, e, f = curve.params
            knee = c * d + f
            lin = (y - f) / max(c, 1e-12)
            pw = (jnp.power(jnp.maximum(y - e, 0), jnp.float32(1 / g))
                  - b) / a
            return jnp.where(y >= knee, pw, lin)
    # table TRC: dense host inverse, piecewise linear in-graph
    xs = np.linspace(0, 1, 4096)
    ys = curve.evaluate(xs)
    return jnp.interp(y, jnp.asarray(ys, jnp.float32),
                      jnp.asarray(xs, jnp.float32))


@register
class Lcms(VideoFilter):
    """lcms (gstlcms.c): input-profile -> dest-profile ICC correction;
    both default to sRGB (:429,616).  preserve-black keeps pure-black
    pixels black (:199-203)."""

    NAME = "lcms"
    FORMATS = VideoFormat.PACKED_RGB4 + VideoFormat.PACKED_RGB3
    PROPERTIES = (
        Property("intent", str, "perceptual", static=True,
                 doc="perceptual | relative | saturation | absolute"),
        Property("input-profile", str, "", static=True),
        Property("dest-profile", str, "", static=True),
        Property("lookup", str, "cached", static=True,
                 doc="accepted for compatibility; always precalculated"),
        Property("preserve-black", bool, False, static=True),
        Property("embedded-profile", bool, True, static=True),
    )

    def _load(self, path: str) -> icc.IccProfile:
        if not path:
            return icc.srgb_profile()
        with open(path, "rb") as f:
            return icc.parse_icc(f.read())

    def prepare(self):
        if self.props["intent"] not in _INTENTS:
            raise ValueError(f"lcms: unknown intent {self.props['intent']!r}")
        src = self._load(self.props["input-profile"])
        dst = self._load(self.props["dest-profile"])
        # decode LUTs folded with the source matrix: lin = M_src @ dec(rgb)
        levels = np.arange(256) / 255.0
        self._dec = [src.trc[c].evaluate(levels).astype(np.float32)
                     for c in range(3)]
        m = np.linalg.inv(dst.matrix) @ src.matrix
        if self.props["intent"] == "absolute":
            # absolute colorimetric: scale by the white-point ratio in XYZ
            # (lcms' D50-relative pipeline)
            scale = np.diag(src.white / dst.white)
            m = np.linalg.inv(dst.matrix) @ scale @ src.matrix
        self._m = m.astype(np.float32)
        self._dst_trc = dst.trc

    def process(self, params, state, batch: FrameBatch):
        spec = self.out_spec
        offs = VideoFormat._RGB_OFFSETS[spec.format]
        img = batch.data
        idx = [img[..., offs[c]].astype(jnp.int32) for c in range(3)]
        lin = [ _apply_f32_lut(idx[c], self._dec[c]) for c in range(3)]
        m = self._m
        mixed = [m[o, 0] * lin[0] + m[o, 1] * lin[1] + m[o, 2] * lin[2]
                 for o in range(3)]
        enc = [_encode_jnp(self._dst_trc[o], mixed[o]) for o in range(3)]
        out = img
        for c in range(3):
            v = jnp.clip(jnp.round(enc[c] * 255.0), 0, 255).astype(jnp.uint8)
            out = out.at[..., offs[c]].set(v)
        if self.props["preserve-black"]:
            black = ((idx[0] == 0) & (idx[1] == 0) & (idx[2] == 0))
            out = jnp.where(black[..., None], batch.data, out)
        return state, batch.with_data(out)
