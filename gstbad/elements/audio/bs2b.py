"""bs2b — Bauer stereophonic-to-binaural headphone crossfeed
(ext/bs2b/gstbs2b.c, DSP from the public-domain libbs2b).

The reference element wraps libbs2b's one-pole crossfeed pair: each output
channel is its own input through a first-order high-boost plus the opposite
channel through a first-order lowpass at ``fcut``, renormalized by a gain
term (see golden/audio.py Bs2b for the per-sample spec).  First-order IIRs
are exactly solvable in parallel, so unlike freeverb this runs as two
``lax.associative_scan`` passes over the whole window — no sample-serial
scan at all.
"""

from __future__ import annotations

import jax.numpy as jnp

from gstbad.core.element import AudioFilter, Property
from gstbad.core.frame import FrameBatch
from gstbad.core.registry import register
from gstbad.core.spec import AudioFormat, MediaSpec, require
from gstbad.golden.audio import BS2B_PRESETS
from gstbad.ops import audio as ops

# libbs2b bs2b.h range macros (caps at gstbs2b.c:49-54)
MINFCUT, MAXFCUT = 300, 2000
MINFEED, MAXFEED = 10, 150
MINSRATE, MAXSRATE = 2000, 384000

_CLIP = {AudioFormat.S16: (-32768.0, 32767.0),
         AudioFormat.S32: (-2147483648.0, 2147483647.0),
         AudioFormat.F32: (-1.0, 1.0),
         AudioFormat.F64: (-1.0, 1.0)}


@register
class Bs2b(AudioFilter):
    """Props fcut/feed with libbs2b ranges and defaults
    (gstbs2b.c:213-221: defaults from BS2B_DEFAULT_CLEVEL = 700 Hz, 4.5 dB);
    `preset` loads the GstPreset table default/cmoy/jmeier
    (gstbs2b.c:85-98; note the jmeier constant is 9.5 dB though the
    description string says 9.0).  Mono input is passthrough
    (gstbs2b.c:252-254).  Stereo interleaved only, like the reference's
    channel-mask 0x3 template."""

    NAME = "bs2b"
    FORMATS = (AudioFormat.F32, AudioFormat.F64,
               AudioFormat.S16, AudioFormat.S32)
    CHANNELS = (1, 2)
    PROPERTIES = (
        Property("fcut", int, 700, MINFCUT, MAXFCUT, controllable=True),
        Property("feed", int, 45, MINFEED, MAXFEED, controllable=True),
        Property("preset", str, "", static=True),
    )

    def __init__(self, **props):
        preset = props.get("preset", "")
        if preset:
            require(preset in BS2B_PRESETS,
                    f"bs2b: unknown preset {preset!r} "
                    f"(have {sorted(BS2B_PRESETS)})")
            fcut, feed = BS2B_PRESETS[preset]
            props.setdefault("fcut", fcut)
            props.setdefault("feed", feed)
        super().__init__(**props)

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        spec = super().negotiate(in_spec)
        require(MINSRATE <= spec.rate <= MAXSRATE,
                f"bs2b: rate {spec.rate} outside "
                f"[{MINSRATE},{MAXSRATE}]")
        return spec

    def init_state(self, batch: int):
        z = jnp.zeros((2,), jnp.float64)
        return {"lo": z, "hi": z + 0, "asis": z + 0}

    def dynamic_params(self):
        return ops.bs2b_coefficients(self.props["fcut"], self.props["feed"],
                                     self.in_spec.rate)

    def process(self, params, state, batch: FrameBatch):
        if self.in_spec.channels == 1:  # passthrough, gstbs2b.c:252-254
            return state, batch
        x = batch.data
        b, s = x.shape[0], x.shape[1]
        fmt = self.in_spec.format
        xf = x.reshape(b * s, 2).astype(jnp.float64)
        state, y = ops.bs2b_cross_feed(state, xf, params)
        lo, hi = _CLIP[fmt]
        y = jnp.clip(y, lo, hi)  # libbs2b clipping of overloaded samples
        out = y.reshape(b, s, 2).astype(jnp.dtype(AudioFormat.dtype(fmt)))
        return state, batch.with_data(out)
