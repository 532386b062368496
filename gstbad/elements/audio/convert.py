"""audioconvert — sample-format + channel-count conversion (the
gst-plugins-base audioconvert dependency many reference launch lines
assume, e.g. BASELINE config 3's `freeverb ! audioconvert !
removesilence`; removesilence is S16 mono only,
gst/removesilence/gstremovesilence.c:87-98).

gst-base is not in the reference tree, so the conversion math is
documented here rather than cited: float->int scales by 2^(bits-1),
rounds half away from zero and clamps to the integer range (the
GstAudioConverter default, no dithering); int->float divides by
2^(bits-1); int->int shifts.  Channel conversion uses the flat GstAudioCh
defaults for the channel counts this framework carries (no positioning
metadata): downmix averages equally-weighted inputs, upmix from mono
duplicates, other expansions zero-fill the new channels; an explicit
`mix-matrix` property (rows=out, cols=in, same syntax as audiomixmatrix)
overrides.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from gstbad.core.element import Element, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import AudioFormat, MediaSpec, require

_BITS = {AudioFormat.S16: 16, AudioFormat.S32: 32}


def _to_f64(data, fmt):
    if fmt in _BITS:
        return data.astype(jnp.float64) / np.float64(2 ** (_BITS[fmt] - 1))
    return data.astype(jnp.float64)


def _from_f64(x, fmt):
    if fmt in _BITS:
        bits = _BITS[fmt]
        scale = np.float64(2 ** (bits - 1))
        lo = np.float64(-(2 ** (bits - 1)))
        hi = np.float64(2 ** (bits - 1) - 1)
        v = jnp.clip(jnp.round(x * scale), lo, hi)
        return v.astype(jnp.int16 if bits == 16 else jnp.int32)
    if fmt == AudioFormat.F32:
        return x.astype(jnp.float32)
    return x


@register
class AudioConvert(Element):
    """Pure per-sample conversion: [B, S, Cin] -> [B, S, Cout]."""

    NAME = "audioconvert"
    PROPERTIES = (
        Property("format", str, "", static=True),    # "" = keep input
        Property("channels", int, 0, 0, 256, static=True),  # 0 = keep
        Property("mix-matrix", str, "", static=True),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "audio", f"{self.NAME}: needs audio input")
        fmt = self.props["format"] or in_spec.format
        require(fmt in AudioFormat.ALL,
                f"{self.NAME}: unknown format {fmt!r}")
        ch = self.props["channels"]
        if not ch and self.props["mix-matrix"]:
            from gstbad.elements.audio.mixmatrix import parse_matrix
            ch = np.asarray(parse_matrix(self.props["mix-matrix"])).shape[0]
        ch = ch or in_spec.channels
        self._in_fmt = in_spec.format
        self._in_ch = in_spec.channels
        return in_spec.with_(format=fmt, channels=ch)

    def prepare(self):
        cin, cout = self._in_ch, self.out_spec.channels
        mm = self.props["mix-matrix"]
        if mm:
            from gstbad.elements.audio.mixmatrix import parse_matrix
            mat = np.asarray(parse_matrix(mm), np.float64)
            require(mat.shape == (cout, cin),
                    f"{self.NAME}: mix-matrix shape {mat.shape} != "
                    f"({cout}, {cin})")
        elif cin == cout:
            mat = np.eye(cout, dtype=np.float64)
        elif cin == 1:
            mat = np.ones((cout, 1), np.float64)    # mono upmix: duplicate
        elif cout == 1:
            mat = np.full((1, cin), 1.0 / cin)      # downmix: equal average
        else:
            mat = np.zeros((cout, cin), np.float64)  # copy the overlap,
            k = min(cin, cout)                       # zero-fill the rest
            mat[:k, :k] = np.eye(k)
        self._matrix = jnp.asarray(mat)
        self._identity_mix = (cin == cout
                              and bool(np.all(mat == np.eye(cout))))

    def process(self, params, state, batch: FrameBatch):
        x = _to_f64(batch.data, self._in_fmt)
        if not self._identity_mix:
            x = jnp.einsum("bsc,oc->bso", x, self._matrix,
                           precision=lax.Precision.HIGHEST)
        return state, batch.with_data(_from_f64(x, self.out_spec.format))
